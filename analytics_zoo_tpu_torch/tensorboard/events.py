"""TensorBoard event-file encoding with no TensorFlow or protobuf
dependency: a copy of ``analytics_zoo_tpu/tensorboard/events.py`` (host-only,
copied because any ``analytics_zoo_tpu`` import loads jax).

Hand-encoded ``Event`` / ``Summary`` protos framed as TFRecords (length and
masked-CRC32C framing), and the decoder that reads them back.
"""

from __future__ import annotations

import struct
import time
from typing import Optional

# ---- CRC32C (Castagnoli), software table ----------------------------------
_CRC_TABLE = []


def _build_table() -> None:
    poly = 0x82F63B78
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = (crc >> 1) ^ poly if crc & 1 else crc >> 1
        _CRC_TABLE.append(crc)


_build_table()


def crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = _CRC_TABLE[(crc ^ b) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal protobuf wire encoding ---------------------------------------

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


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _double(field: int, v: float) -> bytes:
    return _tag(field, 1) + struct.pack("<d", v)


def _float(field: int, v: float) -> bytes:
    return _tag(field, 5) + struct.pack("<f", v)


def _int64(field: int, v: int) -> bytes:
    return _tag(field, 0) + _varint(v & 0xFFFFFFFFFFFFFFFF)


# ---- Event / Summary protos -----------------------------------------------

def encode_scalar_summary(tag: str, value: float) -> bytes:
    # Summary.Value{ tag=1, simple_value=2 }; Summary{ value=1 repeated }
    v = _len_delim(1, tag.encode("utf-8")) + _float(2, value)
    return _len_delim(1, v)


def encode_histogram_summary(tag: str, values) -> bytes:
    """HistogramProto{min=1,max=2,num=3,sum=4,sum_squares=5,
    bucket_limit=6 repeated double, bucket=7 repeated double}."""
    import numpy as np

    arr = np.asarray(values, dtype=np.float64).ravel()
    if arr.size == 0:
        v = _len_delim(1, tag.encode("utf-8")) + _len_delim(
            5, _double(1, 0.0) + _double(2, 0.0) + _double(3, 0.0))
        return _len_delim(1, v)
    counts, edges = np.histogram(arr, bins=min(30, max(1, arr.size)))
    h = (_double(1, float(arr.min())) + _double(2, float(arr.max())) +
         _double(3, float(arr.size)) + _double(4, float(arr.sum())) +
         _double(5, float((arr * arr).sum())))
    for edge in edges[1:]:
        h += _double(6, float(edge))
    for c in counts:
        h += _double(7, float(c))
    v = _len_delim(1, tag.encode("utf-8")) + _len_delim(5, h)
    return _len_delim(1, v)


def encode_event(summary: Optional[bytes] = None, step: int = 0,
                 wall_time: Optional[float] = None,
                 file_version: Optional[str] = None) -> bytes:
    ev = _double(1, wall_time if wall_time is not None else time.time())
    ev += _int64(2, step)
    if file_version is not None:
        ev += _len_delim(3, file_version.encode("utf-8"))
    if summary is not None:
        ev += _len_delim(5, summary)
    return ev


def frame_record(payload: bytes) -> bytes:
    """TFRecord framing: u64 length, masked crc of length, data, crc of data."""
    header = struct.pack("<Q", len(payload))
    return (header + struct.pack("<I", masked_crc32c(header)) +
            payload + struct.pack("<I", masked_crc32c(payload)))


# ---- decoding (read-back: TrainSummary.read_scalar parity) -----------------

def iter_records(path: str):
    """Yield raw record payloads from a TFRecord-framed event file.

    A torn FINAL record (live writer mid-flush) is tolerated silently —
    TF's reader does the same; a CRC mismatch with more data after it is
    real corruption and raises (silently truncating the curve would read
    as "training stopped early")."""
    with open(path, "rb") as fh:
        while True:
            header = fh.read(8)
            if len(header) < 8:
                return
            (n,) = struct.unpack("<Q", header)
            len_crc = fh.read(4)
            if len(len_crc) < 4:
                return
            if struct.unpack("<I", len_crc)[0] != masked_crc32c(header):
                # a corrupt LENGTH makes everything after unparseable —
                # never silently truncate (reads as "training stopped")
                raise ValueError(
                    f"corrupt record length header in {path}")
            payload = fh.read(n)
            crc = fh.read(4)
            if len(payload) < n or len(crc) < 4:
                return
            if struct.unpack("<I", crc)[0] != masked_crc32c(payload):
                if fh.read(1):
                    raise ValueError(
                        f"corrupt record mid-file in {path} (CRC "
                        "mismatch with trailing data)")
                return
            yield payload


def _read_varint(buf: bytes, i: int):
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _iter_fields(buf: bytes):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        field, wire = key >> 3, key & 7
        if wire == 0:
            val, i = _read_varint(buf, i)
        elif wire == 1:
            val = buf[i:i + 8]
            i += 8
        elif wire == 2:
            ln, i = _read_varint(buf, i)
            val = buf[i:i + ln]
            i += ln
        elif wire == 5:
            val = buf[i:i + 4]
            i += 4
        else:  # groups (3/4) never appear in Event protos
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def decode_scalar_events(path: str):
    """Yield ``(wall_time, step, tag, value)`` for every scalar summary in
    an event file (ref ``Topology.scala:207-246`` read-back surface)."""
    for rec in iter_records(path):
        wall, step, summaries = 0.0, 0, []
        for field, wire, val in _iter_fields(rec):
            if field == 1 and wire == 1:
                wall = struct.unpack("<d", val)[0]
            elif field == 2 and wire == 0:
                step = val
            elif field == 5 and wire == 2:
                summaries.append(val)
        for summary in summaries:
            for field, wire, val in _iter_fields(summary):
                if field != 1 or wire != 2:
                    continue
                tag, sv = None, None
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        tag = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        sv = struct.unpack("<f", v2)[0]
                if tag is not None and sv is not None:
                    yield (wall, step, tag, sv)
