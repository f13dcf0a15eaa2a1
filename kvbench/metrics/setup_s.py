"""Seconds from process start to the first timed operation: CUDA init,
kernel load or build, key draw, store build, traffic draw, warm-up."""


def read(rec):
    return rec["setup"]["total_s"]
