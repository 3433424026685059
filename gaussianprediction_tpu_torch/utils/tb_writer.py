"""Minimal TensorBoard event-file writer (no tensorboard/protobuf deps).

A copy of gaussianprediction_tpu/utils/tb_writer.py (numpy only; the port
imports nothing of the JAX package), so both packages write the same
bytes for the same events. Observability parity with the reference's
SummaryWriter usage (its train.py: scalar losses + iter_time, rendered
images, opacity histograms, total_points) in an offline-friendly form: the
Event protobuf and TFRecord framing are hand-encoded (the wire format is
stable and tiny — varints, length-delimited submessages, crc32c framing),
so real TensorBoard can read the logs wherever it is installed, and this
environment needs no extra packages.

Wire references:
  TFRecord: uint64 length | masked_crc32c(length) | payload |
            masked_crc32c(payload); masked = ((c>>15 | c<<17) + 0xa282ead8)
  Event    { 1: double wall_time; 2: int64 step; 3: string file_version;
             5: Summary }
  Summary  { 1: repeated Value }
  Value    { 1: string tag; 2: float simple_value; 4: Image; 5: Histogram }
  Image    { 1: int32 height; 2: int32 width; 3: int32 colorspace;
             4: bytes encoded_image_string }
  Histogram{ 1: double min; 2: double max; 3: double num; 4: double sum;
             5: double sum_squares; 6: repeated double bucket_limit (packed);
             7: repeated double bucket (packed) }
"""
from __future__ import annotations

import io
import os
import socket
import struct
import time
from typing import Optional

import numpy as np

# ---------------------------------------------------------------- crc32c

_CRC_TABLE = []


def _crc_table():
    global _CRC_TABLE
    if not _CRC_TABLE:
        poly = 0x82F63B78  # Castagnoli, reflected
        tbl = []
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            tbl.append(c)
        _CRC_TABLE = tbl
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    tbl = _crc_table()
    c = 0xFFFFFFFF
    for b in data:
        c = tbl[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ------------------------------------------------------- protobuf encoding

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


def _f_double(field: int, v: float) -> bytes:
    return _key(field, 1) + struct.pack("<d", v)


def _f_float(field: int, v: float) -> bytes:
    return _key(field, 5) + struct.pack("<f", v)


def _f_varint(field: int, v: int) -> bytes:
    return _key(field, 0) + _varint(v)


def _f_bytes(field: int, v: bytes) -> bytes:
    return _key(field, 2) + _varint(len(v)) + v


def _f_packed_doubles(field: int, vals) -> bytes:
    payload = b"".join(struct.pack("<d", float(v)) for v in vals)
    return _f_bytes(field, payload)


def _encode_event(step: Optional[int] = None, wall_time: Optional[float] = None,
                  file_version: Optional[str] = None,
                  summary: Optional[bytes] = None) -> bytes:
    out = _f_double(1, time.time() if wall_time is None else wall_time)
    if step is not None:
        out += _f_varint(2, int(step))
    if file_version is not None:
        out += _f_bytes(3, file_version.encode())
    if summary is not None:
        out += _f_bytes(5, summary)
    return out


def _png_encode(img_u8: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (imageio if present, else stdlib zlib
    with a minimal PNG encoder)."""
    try:
        import imageio.v2 as imageio

        buf = io.BytesIO()
        imageio.imwrite(buf, img_u8, format="png")
        return buf.getvalue()
    except Exception:
        import zlib

        h, w = img_u8.shape[:2]
        raw = b"".join(
            b"\x00" + img_u8[y].tobytes() for y in range(h)
        )

        def chunk(typ, data):
            c = struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)
            return struct.pack(">I", len(data)) + typ + data + c

        ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
        return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
                + chunk(b"IDAT", zlib.compress(raw))
                + chunk(b"IEND", b""))


def _tb_bucket_limits() -> np.ndarray:
    """TensorBoard's default exponential bucket edges (1.1 growth, mirrored
    negatives, closed with a huge sentinel)."""
    pos = []
    v = 1e-12
    while v < 1e20:
        pos.append(v)
        v *= 1.1
    limits = [-x for x in reversed(pos)] + [0.0] + pos + [1.7e308]
    return np.asarray(limits)


class SummaryWriter:
    """Append-only events.out.tfevents writer.

    Usage: w = SummaryWriter(logdir); w.add_scalar("loss", 0.5, step);
    w.add_image("render", hwc_float_or_u8, step);
    w.add_histogram("opacity", values, step); w.close().
    """

    def __init__(self, logdir: str):
        os.makedirs(logdir, exist_ok=True)
        host = socket.gethostname()
        self.path = os.path.join(
            logdir, f"events.out.tfevents.{int(time.time())}.{host}"
        )
        self._f = open(self.path, "ab")
        self._write_record(_encode_event(file_version="brain.Event:2"))

    def _write_record(self, payload: bytes):
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def add_scalar(self, tag: str, value: float, step: int):
        val = _f_bytes(1, tag.encode()) + _f_float(2, float(value))
        self._write_record(
            _encode_event(step=step, summary=_f_bytes(1, val))
        )

    def add_image(self, tag: str, img: np.ndarray, step: int):
        """img: [H, W, 3] float in [0,1] or uint8."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        png = _png_encode(np.ascontiguousarray(img))
        image_msg = (_f_varint(1, img.shape[0]) + _f_varint(2, img.shape[1])
                     + _f_varint(3, 3) + _f_bytes(4, png))
        val = _f_bytes(1, tag.encode()) + _f_bytes(4, image_msg)
        self._write_record(
            _encode_event(step=step, summary=_f_bytes(1, val))
        )

    def add_histogram(self, tag: str, values, step: int):
        v = np.asarray(values, np.float64).reshape(-1)
        v = v[np.isfinite(v)]
        if v.size == 0:
            v = np.zeros((1,))
        limits = _tb_bucket_limits()
        idx = np.searchsorted(limits, v, side="left")
        counts = np.bincount(idx, minlength=len(limits)).astype(np.float64)
        nz = np.nonzero(counts)[0]
        lo, hi = (int(nz[0]), int(nz[-1]) + 1) if nz.size else (0, 1)
        hist = (_f_double(1, float(v.min())) + _f_double(2, float(v.max()))
                + _f_double(3, float(v.size)) + _f_double(4, float(v.sum()))
                + _f_double(5, float((v * v).sum()))
                + _f_packed_doubles(6, limits[lo:hi])
                + _f_packed_doubles(7, counts[lo:hi]))
        val = _f_bytes(1, tag.encode()) + _f_bytes(5, hist)
        self._write_record(
            _encode_event(step=step, summary=_f_bytes(1, val))
        )

    def flush(self):
        self._f.flush()

    def close(self):
        if not self._f.closed:
            self._f.flush()
            self._f.close()


# ----------------------------------------------------- minimal reader (tests)

def read_events(path: str):
    """Parse an event file back into dicts (framing + field decode); used by
    tests to validate the writer without TensorBoard installed."""
    events = []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos < len(data):
        (ln,) = struct.unpack_from("<Q", data, pos)
        (hc,) = struct.unpack_from("<I", data, pos + 8)
        assert hc == _masked_crc(data[pos:pos + 8]), "header crc mismatch"
        payload = data[pos + 12: pos + 12 + ln]
        (pc,) = struct.unpack_from("<I", data, pos + 12 + ln)
        assert pc == _masked_crc(payload), "payload crc mismatch"
        pos += 12 + ln + 4
        events.append(_decode_event(payload))
    return events


def _decode_fields(buf: bytes):
    fields = []
    pos = 0
    while pos < len(buf):
        key = 0
        shift = 0
        while True:
            b = buf[pos]
            pos += 1
            key |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        field, wire = key >> 3, key & 7
        if wire == 0:
            v = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                v |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
        elif wire == 1:
            v = struct.unpack_from("<d", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln2 = 0
            shift = 0
            while True:
                b = buf[pos]
                pos += 1
                ln2 |= (b & 0x7F) << shift
                if not b & 0x80:
                    break
                shift += 7
            v = buf[pos:pos + ln2]
            pos += ln2
        elif wire == 5:
            v = struct.unpack_from("<f", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"wire type {wire}")
        fields.append((field, wire, v))
    return fields


def _decode_event(payload: bytes):
    ev = {}
    for field, wire, v in _decode_fields(payload):
        if field == 1:
            ev["wall_time"] = v
        elif field == 2:
            ev["step"] = v
        elif field == 3:
            ev["file_version"] = v.decode()
        elif field == 5:
            vals = []
            for f2, _, v2 in _decode_fields(v):
                if f2 == 1:
                    val = {}
                    for f3, w3, v3 in _decode_fields(v2):
                        if f3 == 1:
                            val["tag"] = v3.decode()
                        elif f3 == 2:
                            val["simple_value"] = v3
                        elif f3 == 4:
                            val["image"] = v3
                        elif f3 == 5:
                            val["histo"] = v3
                    vals.append(val)
            ev["values"] = vals
    return ev
