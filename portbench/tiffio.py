"""The benchmark's own TIFF reader and writer (numpy and zlib only).

``write_stack`` writes the inputs: classic little-endian TIFF, one
uncompressed strip a page. ``read_stack`` reads back what the job server
wrote: classic or BigTIFF, either byte order, uncompressed or Deflate (8,
32946) strips, with or without the horizontal predictor, grayscale
unsigned pages.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

__all__ = ["write_stack", "read_stack"]

_SHORT, _LONG, _LONG8 = 3, 4, 16
_FMT = {1: "B", 3: "H", 4: "I", 16: "Q"}
_SIZE = {1: 1, 3: 2, 4: 4, 16: 8}


def write_stack(path: str, stack: np.ndarray) -> None:
    """(T, H, W) or (H, W) uint16 -> a T-page TIFF."""
    stack = np.ascontiguousarray(stack, dtype="<u2")
    if stack.ndim == 2:
        stack = stack[None]
    t, h, w = stack.shape
    page = h * w * 2
    n_tags = 10
    ifd_size = 2 + 12 * n_tags + 4
    with open(path, "wb") as f:
        f.write(b"II" + struct.pack("<HI", 42, 8 + page))  # page 0's IFD follows its data
        pos = 8
        for i in range(t):
            data_at = pos
            ifd_at = data_at + page
            nxt = ifd_at + ifd_size + page if i + 1 < t else 0  # the next page's IFD
            f.write(stack[i].tobytes())
            entries = [
                (256, _LONG, w), (257, _LONG, h), (258, _SHORT, 16), (259, _SHORT, 1),
                (262, _SHORT, 1), (273, _LONG, data_at), (277, _SHORT, 1),
                (278, _LONG, h), (279, _LONG, page), (339, _SHORT, 1),
            ]
            f.write(struct.pack("<H", n_tags))
            for tag, typ, val in entries:
                value = struct.pack("<H", val) + b"\0\0" if typ == _SHORT else struct.pack("<I", val)
                f.write(struct.pack("<HHI", tag, typ, 1) + value)
            f.write(struct.pack("<I", nxt))
            pos = ifd_at + ifd_size


def read_stack(path: str) -> np.ndarray:
    """Every page of a TIFF as one (T, H, W) array of its stored dtype."""
    with open(path, "rb") as f:
        buf = f.read()
    e = {b"II": "<", b"MM": ">"}[buf[:2]]
    magic = struct.unpack(e + "H", buf[2:4])[0]
    big = magic == 43
    if not big and magic != 42:
        raise ValueError(f"{path}: not a TIFF")
    ifd = struct.unpack(e + ("Q" if big else "I"), buf[8:16] if big else buf[4:8])[0]
    cnt_fmt, ent_size, off_fmt, inline = ("Q", 20, "Q", 8) if big else ("H", 12, "I", 4)
    pages = []
    while ifd:
        n = struct.unpack_from(e + cnt_fmt, buf, ifd)[0]
        base = ifd + (8 if big else 2)
        tags = {}
        for k in range(n):
            at = base + k * ent_size
            tag, typ = struct.unpack_from(e + "HH", buf, at)
            count = struct.unpack_from(e + ("Q" if big else "I"), buf, at + 4)[0]
            field = at + (12 if big else 8)
            size = _SIZE.get(typ, 0) * count
            if typ not in _FMT:
                continue
            src = field if size <= inline else struct.unpack_from(e + off_fmt, buf, field)[0]
            tags[tag] = list(struct.unpack_from(e + _FMT[typ] * count, buf, src))
        ifd = struct.unpack_from(e + off_fmt, buf, base + n * ent_size)[0]
        w, h = tags[256][0], tags[257][0]
        bits, fmt = tags.get(258, [8])[0], tags.get(339, [1])[0]
        if fmt != 1 or tags.get(277, [1])[0] != 1:
            raise ValueError(f"{path}: only grayscale unsigned pages are read")
        dt = np.dtype(f"{e}u{bits // 8}")
        comp = tags.get(259, [1])[0]
        if comp not in (1, 8, 32946):
            raise ValueError(f"{path}: compression {comp} is not read")
        raw = b"".join(
            buf[o:o + c] if comp == 1 else zlib.decompress(buf[o:o + c])
            for o, c in zip(tags[273], tags[279])
        )
        img = np.frombuffer(raw, dt, count=h * w).reshape(h, w)
        if comp != 1 and tags.get(317, [1])[0] == 2:
            img = np.cumsum(img, axis=1, dtype=dt)
        pages.append(img.astype(dt.newbyteorder("=")))
    return np.stack(pages)
