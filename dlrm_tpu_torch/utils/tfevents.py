"""Self-contained TensorBoard event-file writer (the port's copy of
dlrm_tpu/utils/tfevents.py; the standard library only).

The reference gets TB event files from torch's SummaryWriter
(dlrm_s_pytorch.py:1509-1510), which needs the tensorboard package; this
writer produces the same on-disk format directly, so
`tensorboard --logdir <dir>` works without it.

Format, bottom-up:
  * Event / Summary protobufs — hand-encoded with the 3 wire types the
    scalar path needs (varint, fixed64 double, length-delimited).
      Event:   wall_time=1 (double), step=2 (int64),
               file_version=3 (string) | summary=5 (message)
      Summary: value=1 (repeated Value); Value: tag=1 (string),
               simple_value=2 (float, fixed32)
  * TFRecord framing — each record is
      uint64 length | uint32 masked_crc32c(length) | data |
      uint32 masked_crc32c(data)
    with CRC32C (Castagnoli) and the TF mask rot15 + 0xa282ead8.
  * File naming — `events.out.tfevents.<ts>.<host>`; TensorBoard discovers
    any file with "tfevents" in the name; the first record must be an
    Event carrying file_version "brain.Event:2".
"""

from __future__ import annotations

import os
import socket
import struct
import time

# ---------------------------------------------------------------- crc32c
# Table-driven CRC32C (Castagnoli polynomial 0x82F63B78, reflected).
_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------------- protobuf
def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _key(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _f_double(field: int, v: float) -> bytes:  # wire 1 = fixed64
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:  # wire 5 = fixed32
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:  # wire 0
    return _key(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


def _f_bytes(field: int, v: bytes) -> bytes:  # wire 2
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
    summary = _f_bytes(1, val)
    return (
        _f_double(1, wall_time) + _f_varint(2, int(step)) + _f_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _f_double(1, wall_time) + _f_bytes(3, b"brain.Event:2")


class TFEventsWriter:
    """Minimal SummaryWriter-equivalent: add_scalar/flush/close."""

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        ts = time.time()
        name = f"events.out.tfevents.{int(ts)}.{socket.gethostname()}"
        self._f = open(os.path.join(logdir, name), "wb")
        self._write_record(_version_event(ts))

    def _write_record(self, data: bytes) -> None:
        header = struct.pack("<Q", len(data))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(data)
        self._f.write(struct.pack("<I", _masked_crc(data)))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if self._f is None:
            return
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def flush(self) -> None:
        if self._f is not None:
            self._f.flush()

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None
