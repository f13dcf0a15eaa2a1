"""Per cent of the GET waves' device time in the profiled slice that their
bytes need at the card's published HBM peak (``kvbench/roofline.py``)."""

from kvbench import roofline


def read(rec):
    t = rec["trace"]
    if not t or not t.get("get_requests"):
        return None
    b = roofline.get_bytes(t["get_requests"], t["get_distinct"])
    return roofline.share(b, t["device_s_by_kind"].get("read", 0.0), rec["device"]["kind"])
