"""Host microseconds of the pipeline's drain phases (copies to the host,
host epilogue) per operation of the window, the profiled slice's waves
left out, from ``WaveLedger.wave_drain_ns``."""


def read(rec):
    led = rec["ledger"]
    return led["drain_ns"] / 1e3 / led["ops"] if led["ops"] else None
