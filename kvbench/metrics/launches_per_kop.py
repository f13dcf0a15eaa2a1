"""Device operations (kernels, copies, memsets) launched in the profiled
slice per thousand operations of its groups."""


def read(rec):
    t = rec["trace"]
    if not t or not t["device_ops"] or not t["ops"]:
        return None
    return t["device_ops"] / (t["ops"] / 1e3)
