"""Per cent of the scan waves' device time in the profiled slice that their
bytes need at the card's published HBM peak (``kvbench/roofline.py``)."""

from kvbench import roofline


def read(rec):
    t = rec["trace"]
    if not t or not t.get("scan_requests"):
        return None
    b = roofline.scan_bytes(t["scan_requests"], t["scan_rows"])
    return roofline.share(b, t["device_s_by_kind"].get("scan", 0.0), rec["device"]["kind"])
