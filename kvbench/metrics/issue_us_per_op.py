"""Host microseconds of the pipeline's issue phases (wave build, write
proof, serial write path, launches) per operation of the window, the
profiled slice's waves left out, from ``WaveLedger.wave_issue_ns``."""


def read(rec):
    led = rec["ledger"]
    return led["issue_ns"] / 1e3 / led["ops"] if led["ops"] else None
