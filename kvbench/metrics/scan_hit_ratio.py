"""Per cent of fresh scans whose descent the scan-anchor cache skipped over
the window (``StoreStats.scan_hits / scan_probes``)."""


def read(rec):
    c = rec["counters"]
    probes = c.get("scan_probes", 0)
    return 100.0 * c.get("scan_hits", 0) / probes if probes else None
