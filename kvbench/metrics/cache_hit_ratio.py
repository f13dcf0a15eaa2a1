"""Per cent of GET requests the hot cache answered over the window
(``StoreStats.cache_hits / cache_probes``)."""


def read(rec):
    c = rec["counters"]
    probes = c.get("cache_probes", 0)
    return 100.0 * c.get("cache_hits", 0) / probes if probes else None
