"""Flush cycles (patch plan + stitch) per thousand acknowledged writes of
the window (``StoreStats.flush_cycles``)."""


def read(rec):
    acked = rec["window"]["writes_acked"]
    return rec["counters"].get("flush_cycles", 0) / (acked / 1e3) if acked else None
