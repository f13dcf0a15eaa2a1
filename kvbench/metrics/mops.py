"""Operations completed (reads, updates, inserts, scans, each counted once)
per second of the whole window, in millions."""


def read(rec):
    w = rec["window"]
    return w["ops"] / w["seconds"] / 1e6 if w["seconds"] > 0 else None
