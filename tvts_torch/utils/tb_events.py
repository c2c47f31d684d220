"""TensorBoard event files without a TensorBoard dependency (a copy of
tvts_tpu/utils/tb_events.py; reference v2/logger/visualization.py:5, whose
TensorboardWriter proxies `add_scalar`): a TFRecord stream of
`tensorflow.Event` protobuf messages (scalar summaries), written by hand.

Wire format:
- TFRecord framing: u64 length | u32 masked-crc32c(length) | payload |
  u32 masked-crc32c(payload), crc mask = ((crc >> 15 | crc << 17) + 0xa282ead8).
- Event proto fields used: wall_time (1, double), step (2, int64),
  file_version (3, string), summary (5, message).
- Summary.value (1, repeated message) with Value.tag (1, string) and
  Value.simple_value (2, float).
"""

from __future__ import annotations

import os
import socket
import struct
import time

_CRC_TABLE = []
_POLY = 0x82F63B78  # crc32c (Castagnoli), reflected


def _crc_table():
    if not _CRC_TABLE:
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ _POLY if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = 0xFFFFFFFF
    for b in data:
        crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


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


def _pb_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _pb_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _pb_int(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _pb_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    val = _pb_bytes(1, tag.encode()) + _pb_float(2, float(value))
    summary = _pb_bytes(1, val)
    return (_pb_double(1, wall_time) + _pb_int(2, int(step))
            + _pb_bytes(5, summary))


def _version_event(wall_time: float) -> bytes:
    return _pb_double(1, wall_time) + _pb_bytes(3, b"brain.Event:2")


class EventWriter:
    """Minimal `SummaryWriter`-alike: `add_scalar(tag, value, step)`."""

    def __init__(self, log_dir: str, filename_suffix: str = ""):
        os.makedirs(log_dir, exist_ok=True)
        name = (f"events.out.tfevents.{int(time.time())}."
                f"{socket.gethostname()}.{os.getpid()}{filename_suffix}")
        self.path = os.path.join(log_dir, name)
        self._f = open(self.path, "ab")
        self._write_record(_version_event(time.time()))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        self._write_record(_scalar_event(tag, value, step, time.time()))

    def flush(self):
        self._f.flush()

    def close(self):
        self._f.close()


def read_events(path: str):
    """Parse an event file back into [(step, tag, value)] — used by tests and
    as a fallback reader; validates CRCs."""
    out = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = struct.unpack("<Q", header)
            (hcrc,) = struct.unpack("<I", f.read(4))
            assert hcrc == _masked_crc(header), "corrupt record header"
            payload = f.read(length)
            (pcrc,) = struct.unpack("<I", f.read(4))
            assert pcrc == _masked_crc(payload), "corrupt record payload"
            out.extend(_parse_event(payload))
    return out


def _read_varint(buf: bytes, i: int):
    shift, val = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val, i = buf[i:i + 8], i + 8
        elif wire == 5:
            val, i = buf[i:i + 4], i + 4
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        else:  # pragma: no cover
            raise ValueError(f"wire type {wire}")
        yield field, wire, val


def _parse_event(payload: bytes):
    step, summary = 0, None
    for field, _, val in _fields(payload):
        if field == 2:
            step = val
        elif field == 5:
            summary = val
    if summary is None:
        return []
    out = []
    for field, _, val in _fields(summary):
        if field != 1:
            continue
        tag, simple = None, None
        for f2, _, v2 in _fields(val):
            if f2 == 1:
                tag = v2.decode()
            elif f2 == 2:
                simple = struct.unpack("<f", v2)[0]
        if tag is not None and simple is not None:
            out.append((step, tag, simple))
    return out
