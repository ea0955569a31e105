"""TFRecord-compatible training-record I/O — TensorFlow-free (a copy of
``sequitr_tpu.data.records``: host-only numpy; the same bytes out).

The reference serializes (image, label, weight-map) examples into TFRecord
shards with ``tf.python_io.TFRecordWriter`` and parses them back with
``tf.parse_single_example`` (SURVEY.md §2 'TFRecord pipeline'). This module
reimplements the wire formats from scratch so existing sequitr record shards
remain readable and shards written here remain readable by TF tooling:

* the TFRecord framing (length + masked-crc32c + payload + masked-crc32c),
  with the Castagnoli CRC implemented in numpy (table-driven, vectorized);
* the ``tf.train.Example`` protobuf subset (Features map of
  BytesList/FloatList/Int64List), hand-encoded — no protobuf runtime.

Typed helpers pack segmentation examples (image/labels/weights + shape
metadata) the way sequitr's record writer does (spec decision: exact
reference feature keys unavailable; keys are documented constants below).
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

import numpy as np

__all__ = [
    "RecordWriter",
    "read_records",
    "encode_example",
    "decode_example",
    "write_shards",
    "write_segmentation_shards",
    "read_segmentation_examples",
    "SegExample",
]

# ---------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven, vectorized over the payload with numpy
# ---------------------------------------------------------------------------

_CRC_TABLE = None


def _crc_table() -> np.ndarray:
    global _CRC_TABLE
    if _CRC_TABLE is None:
        poly = 0x82F63B78
        table = np.empty(256, dtype=np.uint32)
        for i in range(256):
            crc = i
            for _ in range(8):
                crc = (crc >> 1) ^ (poly if crc & 1 else 0)
            table[i] = crc
        _CRC_TABLE = table
    return _CRC_TABLE


def crc32c(data: bytes) -> int:
    table = _crc_table()
    crc = np.uint32(0xFFFFFFFF)
    for b in np.frombuffer(data, dtype=np.uint8):
        crc = table[(crc ^ b) & np.uint32(0xFF)] ^ (crc >> np.uint8(8))
    return int(crc ^ np.uint32(0xFFFFFFFF))


_native_crc = None


def _best_crc32c(data: bytes) -> int:
    """Native slice-by-8 crc32c when built, else the numpy fallback."""
    global _native_crc
    if _native_crc is None:
        try:
            from sequitr_tpu_torch import native

            _native_crc = native.crc32c if native.available() else crc32c
        except ImportError:
            _native_crc = crc32c
    return _native_crc(data)


def _masked_crc(data: bytes) -> int:
    crc = _best_crc32c(data)
    return ((((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF)


# ---------------------------------------------------------------------------
# minimal protobuf wire codec for tf.train.Example
# ---------------------------------------------------------------------------


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


def _read_varint(buf: bytes, pos: int):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _len_delim(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


FeatureValue = Union[bytes, Sequence[bytes], Sequence[int], Sequence[float], np.ndarray]


def _encode_feature(value: FeatureValue) -> bytes:
    """Encode one Feature message: bytes_list=1 | float_list=2 | int64_list=3."""
    if isinstance(value, bytes):
        value = [value]
    if isinstance(value, np.ndarray):
        if value.dtype == np.float32 or value.dtype == np.float64:
            value = value.astype(np.float32).reshape(-1)
            packed = value.astype("<f4").tobytes()
            return _len_delim(2, _len_delim(1, packed))
        value = [int(v) for v in value.reshape(-1)]
    value = list(value)
    if value and isinstance(value[0], bytes):
        body = b"".join(_len_delim(1, v) for v in value)
        return _len_delim(1, body)
    if value and isinstance(value[0], float):
        packed = np.asarray(value, dtype="<f4").tobytes()
        return _len_delim(2, _len_delim(1, packed))
    # int64 list (packed varints), also the empty-list default
    packed = b"".join(_varint(int(v) & 0xFFFFFFFFFFFFFFFF) for v in value)
    return _len_delim(3, _len_delim(1, packed))


def encode_example(features: Dict[str, FeatureValue]) -> bytes:
    """Encode a tf.train.Example: Example.features(1) -> map entries (1)."""
    entries = b""
    for key in sorted(features):
        kv = _len_delim(1, key.encode()) + _len_delim(2, _encode_feature(features[key]))
        entries += _len_delim(1, kv)
    return _len_delim(1, entries)


def _decode_feature(buf: bytes):
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        assert wire == 2, f"unexpected wire type {wire} in Feature"
        ln, pos = _read_varint(buf, pos)
        body = buf[pos : pos + ln]
        pos += ln
        if field == 1:  # BytesList
            out: List[bytes] = []
            p = 0
            while p < len(body):
                t, p = _read_varint(body, p)
                assert t >> 3 == 1
                l2, p = _read_varint(body, p)
                out.append(body[p : p + l2])
                p += l2
            return out
        if field == 2:  # FloatList
            p = 0
            vals: List[float] = []
            while p < len(body):
                t, p = _read_varint(body, p)
                if (t & 7) == 2:  # packed
                    l2, p = _read_varint(body, p)
                    vals.extend(np.frombuffer(body[p : p + l2], dtype="<f4").tolist())
                    p += l2
                else:  # unpacked fixed32
                    vals.append(struct.unpack("<f", body[p : p + 4])[0])
                    p += 4
            return vals
        if field == 3:  # Int64List
            p = 0
            ivals: List[int] = []

            def signed(v: int) -> int:
                # protobuf int64 is two's complement in a 64-bit varint
                return v - (1 << 64) if v >= (1 << 63) else v

            while p < len(body):
                t, p = _read_varint(body, p)
                if (t & 7) == 2:  # packed
                    l2, p = _read_varint(body, p)
                    end = p + l2
                    while p < end:
                        v, p = _read_varint(body, p)
                        ivals.append(signed(v))
                else:
                    v, p = _read_varint(body, p)
                    ivals.append(signed(v))
            return ivals
    return []


def decode_example(data: bytes) -> Dict[str, object]:
    """Decode a tf.train.Example payload into {key: list-of-values}."""
    features: Dict[str, object] = {}
    pos = 0
    tag, pos = _read_varint(data, pos)
    assert tag >> 3 == 1, "not an Example"
    ln, pos = _read_varint(data, pos)
    fbuf = data[pos : pos + ln]
    p = 0
    while p < len(fbuf):
        t, p = _read_varint(fbuf, p)
        assert t >> 3 == 1, "expected Features map entry"
        ln2, p = _read_varint(fbuf, p)
        entry = fbuf[p : p + ln2]
        p += ln2
        q = 0
        key = None
        val = None
        while q < len(entry):
            t2, q = _read_varint(entry, q)
            l3, q = _read_varint(entry, q)
            body = entry[q : q + l3]
            q += l3
            if t2 >> 3 == 1:
                key = body.decode()
            else:
                val = _decode_feature(body)
        features[key] = val
    return features


# ---------------------------------------------------------------------------
# TFRecord framing
# ---------------------------------------------------------------------------


class RecordWriter:
    """Write TFRecord-framed byte records (context manager).

    ``compression="gzip"`` wraps the whole file in a gzip stream — exactly
    TF's ``TFRecordOptions(compression_type="GZIP")`` layout, so gzip
    shards interchange with TF both ways. mtime is pinned to 0 so output
    bytes are deterministic.
    """

    def __init__(self, path: str, compression: Optional[str] = None):
        if compression not in (None, "none", "gzip"):
            raise ValueError(
                f"compression must be None or 'gzip', got {compression!r}"
            )
        self._raw = open(path, "wb")
        if compression == "gzip":
            import gzip

            self._f = gzip.GzipFile(fileobj=self._raw, mode="wb", mtime=0)
        else:
            self._f = self._raw

    def write(self, payload: bytes) -> None:
        header = struct.pack("<Q", len(payload))
        self._f.write(header)
        self._f.write(struct.pack("<I", _masked_crc(header)))
        self._f.write(payload)
        self._f.write(struct.pack("<I", _masked_crc(payload)))

    def close(self) -> None:
        try:
            if self._f is not self._raw:
                self._f.close()  # flush the gzip trailer first
        finally:
            # the raw fd must not leak even if the trailer flush raises
            # (e.g. ENOSPC) - callers' cleanup paths rely on close()
            # releasing the descriptor
            self._raw.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_records(path: str, verify_crc: bool = True) -> Iterator[bytes]:
    """Yield raw record payloads from a TFRecord file.

    GZIP-compressed shards (TF's ``compression_type="GZIP"``, magic
    ``1f 8b``) are detected by content and decompressed transparently, so
    every consumer (training input pipelines, shard validation) accepts
    both layouts.
    """
    with open(path, "rb") as raw:
        head = raw.read(12)
        raw.seek(0)
        # An uncompressed shard whose first record is ~35615 bytes also
        # starts 1f 8b (little-endian length field) - so the plain-TFRecord
        # interpretation is checked FIRST via its header crc, and gzip is
        # only chosen when that fails AND the gzip magic matches.
        plain_tfrecord = len(head) >= 12 and _masked_crc(
            head[:8]
        ) == struct.unpack("<I", head[8:12])[0]
        if not plain_tfrecord and head[:2] == b"\x1f\x8b":
            import gzip

            f = gzip.GzipFile(fileobj=raw, mode="rb")
        else:
            f = raw
        import os as _os
        import zlib

        file_size = _os.fstat(raw.fileno()).st_size
        try:
            while True:
                header = f.read(8)
                if len(header) < 8:
                    return
                (length,) = struct.unpack("<Q", header)
                hcrc_raw = f.read(4)
                if len(hcrc_raw) < 4:
                    raise IOError(f"truncated record header in {path}")
                (hcrc,) = struct.unpack("<I", hcrc_raw)
                # the header crc covers the LENGTH field — validate it
                # BEFORE the payload read, so a forged multi-GB length
                # is an error, not an up-front allocation of that size
                if verify_crc and _masked_crc(header) != hcrc:
                    raise IOError(f"corrupt record header in {path}")
                if f is raw and length > file_size:
                    # verify_crc=False path: still refuse impossible reads
                    raise IOError(
                        f"record length {length} exceeds the file "
                        f"({file_size} bytes) in {path}"
                    )
                payload = f.read(length)
                if len(payload) < length:
                    raise IOError(f"truncated record payload in {path}")
                pcrc_raw = f.read(4)
                if len(pcrc_raw) < 4:
                    raise IOError(f"truncated record trailer in {path}")
                (pcrc,) = struct.unpack("<I", pcrc_raw)
                if verify_crc and _masked_crc(payload) != pcrc:
                    raise IOError(f"corrupt record payload in {path}")
                yield payload
        except (zlib.error, EOFError) as e:
            # gzip-layer corruption raises its own types mid-read; the
            # documented corruption error for shards is IOError
            raise IOError(f"corrupt gzip record stream in {path}: {e}")


# ---------------------------------------------------------------------------
# segmentation example schema (sequitr record writer equivalent)
# ---------------------------------------------------------------------------

# Feature keys (spec decision — reference keys unavailable; documented here)
K_IMAGE, K_LABELS, K_WEIGHTS = "image/encoded", "labels/encoded", "weights/encoded"
K_SHAPE, K_IMAGE_DTYPE = "image/shape", "image/dtype"
K_LABELS_SHAPE = "labels/shape"  # written only when != image shape (C>1)


class SegExample:
    """One (image, labels, weights) training example."""

    def __init__(self, image: np.ndarray, labels: np.ndarray, weights: Optional[np.ndarray] = None):
        self.image = np.asarray(image)
        self.labels = np.asarray(labels, dtype=np.int32)
        self.weights = None if weights is None else np.asarray(weights, dtype=np.float32)


def _encode_seg(ex: SegExample) -> bytes:
    img = ex.image.astype(np.float32)
    feats: Dict[str, FeatureValue] = {
        K_IMAGE: img.astype("<f4").tobytes(),
        K_LABELS: ex.labels.astype("<i4").tobytes(),
        K_SHAPE: list(img.shape),
        K_IMAGE_DTYPE: b"float32",
    }
    if ex.labels.shape != img.shape:
        # multi-channel images: labels/weights cover the spatial axes only
        feats[K_LABELS_SHAPE] = list(ex.labels.shape)
    if ex.weights is not None:
        feats[K_WEIGHTS] = ex.weights.astype("<f4").tobytes()
    return encode_example(feats)


def _decode_seg(payload: bytes) -> SegExample:
    f = decode_example(payload)
    shape = tuple(int(v) for v in f[K_SHAPE])
    lab_shape = (
        tuple(int(v) for v in f[K_LABELS_SHAPE]) if K_LABELS_SHAPE in f else shape
    )
    image = np.frombuffer(f[K_IMAGE][0], dtype="<f4").reshape(shape)
    labels = np.frombuffer(f[K_LABELS][0], dtype="<i4").reshape(lab_shape)
    weights = None
    if K_WEIGHTS in f:
        weights = np.frombuffer(f[K_WEIGHTS][0], dtype="<f4").reshape(lab_shape)
    return SegExample(image, labels, weights)


def write_shards(
    prefix: str,
    payloads: Iterable[bytes],
    shard_size: int = 128,
    compression: Optional[str] = None,
) -> List[str]:
    """Write encoded payloads to ``{prefix}-00000-of-NNNNN.tfrecord`` shards.

    The schema-agnostic core of ``write_segmentation_shards`` (any example
    encoding rides the same sharding/atomicity machinery). Streams:
    payloads may be a generator — each shard is written as it fills
    (O(shard) memory) to a temporary name, and all shards rename to their
    final ``-of-NNNNN`` names once the total is known (atomic per file;
    readers never see a partial set under the final glob).
    ``compression="gzip"`` writes TF-interchangeable gzip shards (readers
    sniff the layout, so consumers need no flag).
    """
    tmp_paths: List[str] = []
    w: RecordWriter = None  # type: ignore[assignment]
    count = 0
    try:
        for payload in payloads:
            if count % shard_size == 0:
                if w is not None:
                    w.close()
                tmp = f"{prefix}-{len(tmp_paths):05d}.tfrecord.tmp"
                tmp_paths.append(tmp)
                w = RecordWriter(tmp, compression=compression)
            w.write(payload)
            count += 1
        if w is not None:
            w.close()
        if not tmp_paths:  # zero examples: one (empty) shard, as before
            tmp = f"{prefix}-00000.tfrecord.tmp"
            RecordWriter(tmp, compression=compression).close()
            tmp_paths.append(tmp)
    except BaseException:
        if w is not None:
            try:
                w.close()
            except OSError:
                pass  # e.g. ENOSPC on the gzip trailer; still unlink tmps
        for t in tmp_paths:
            try:
                os.unlink(t)
            except OSError:
                pass
        raise
    n_shards = len(tmp_paths)
    paths = []
    for s, tmp in enumerate(tmp_paths):
        path = f"{prefix}-{s:05d}-of-{n_shards:05d}.tfrecord"
        os.replace(tmp, path)
        paths.append(path)
    return paths


def write_segmentation_shards(
    prefix: str,
    examples: Iterable[SegExample],
    shard_size: int = 128,
    compression: Optional[str] = None,
) -> List[str]:
    """Write segmentation examples to sharded records (see ``write_shards``)."""
    return write_shards(
        prefix, (_encode_seg(ex) for ex in examples),
        shard_size=shard_size, compression=compression,
    )


def read_segmentation_examples(paths: Sequence[str]) -> Iterator[SegExample]:
    for path in paths:
        for payload in read_records(path):
            yield _decode_seg(payload)
