"""Device rounds a scan wave runs: continuation rounds after the first
(``range_rounds_in_mesh``) per scan wave of the window, plus 1."""


def read(rec):
    waves = rec["window"]["waves"].get("scan", 0)
    if not waves:
        return None
    return rec["counters"].get("range_rounds_in_mesh", 0) / waves + 1.0
