"""The yardstick of the device metrics: published peaks, and the bytes that
the requests themselves need, counted from the requests and their answers
and never from the program's own state, so that a change that moves work
between kernels leaves the count as it is."""

from __future__ import annotations

# Published peaks by ``torch.cuda.get_device_name()``: NVIDIA's H100 SXM
# data sheet, 3.35 TB/s of HBM3 at the card's full 700 W.
PEAK_BYTES_PER_S = {
    "NVIDIA H100 80GB HBM3": 3.35e12,
}

KEY = 8
VALUE = 8
RECORD = KEY + VALUE
FOUND_FLAG = 1
COUNT = 8


def get_bytes(requests: int, distinct_keys: int) -> int:
    """A GET wave: each request's key read, its value and found flag
    written; the record of each distinct key read once."""
    return requests * (KEY + VALUE + FOUND_FLAG) + distinct_keys * RECORD


def scan_bytes(requests: int, rows: int) -> int:
    """A scan wave: each request's start key read and its count written;
    each returned row read once and written once."""
    return requests * (KEY + COUNT) + rows * 2 * RECORD


def share(bytes_moved: int, device_s: float, kind: str):
    """Per cent of the least time (bytes at the peak) in ``device_s``, or
    None where the card or the time is unknown."""
    peak = PEAK_BYTES_PER_S.get(kind)
    if peak is None or not device_s or device_s <= 0 or bytes_moved <= 0:
        return None
    return 100.0 * (bytes_moved / peak) / device_s
