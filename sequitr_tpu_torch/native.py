"""ctypes loader for the native C++ runtime helpers (``csrc/seqnative.cpp``).

Builds on demand with g++ (cached as ``csrc/libseqnative.so``); every entry
point has a pure-Python/scipy fallback, so the framework works without a
toolchain — the native path is a host-side throughput optimization for
connected-component labelling, TIFF LZW decoding, watershed splitting and
the TFRecord crc32c. The device-side kernels live in
``sequitr_tpu_torch.ops.kernels``; this covers the host hot loops. A copy
of ``sequitr_tpu.native``.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "csrc", "seqnative.cpp")
_LIB = os.path.join(_HERE, "csrc", "libseqnative.so")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()
_build_failed = False

__all__ = [
    "available",
    "build",
    "crc32c",
    "label_components",
    "label_full_stats",
    "label_full_stats_3d",
    "lzw_decode",
    "watershed",
]


def build(force: bool = False) -> bool:
    """Compile the native library with g++. Returns True on success.

    A cached ``.so`` older than the source is rebuilt — otherwise an
    upgraded checkout would load a stale library missing new symbols."""
    global _build_failed
    if (
        os.path.exists(_LIB)
        and not force
        and os.path.getmtime(_LIB) >= os.path.getmtime(_SRC)
    ):
        return True
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _LIB],
            check=True,
            capture_output=True,
        )
        return True
    except (subprocess.CalledProcessError, FileNotFoundError):
        _build_failed = True
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None:
        return _lib
    if _build_failed:
        return None
    with _lock:
        if _lib is not None:
            return _lib
        if not build():  # rebuilds stale cached .so too (mtime check)
            return None
        try:
            lib = ctypes.CDLL(_LIB)
            _bind(lib)
        except OSError:
            _build_failed = True
            return None
        except AttributeError:
            # a stale .so missing new symbols that somehow survived the
            # mtime check (e.g. copied into place): rebuild once, then
            # fall back to scipy for good rather than poisoning every call
            if not build(force=True):
                return None
            try:
                lib = ctypes.CDLL(_LIB)
                _bind(lib)
            except (OSError, AttributeError):
                _build_failed = True
                return None
        _lib = lib
        return _lib


def _bind(lib) -> None:
    lib.seq_label_components.restype = ctypes.c_int32
    lib.seq_label_components.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.seq_label_full_stats.restype = None
    lib.seq_label_full_stats.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # labels
        ctypes.POINTER(ctypes.c_int32),   # class_map
        ctypes.POINTER(ctypes.c_float),   # intensity (may be null)
        ctypes.c_int32,                   # h
        ctypes.c_int32,                   # w
        ctypes.c_int32,                   # n_labels
        ctypes.c_int32,                   # n_classes
        ctypes.POINTER(ctypes.c_int64),   # counts scratch
        ctypes.POINTER(ctypes.c_int64),   # areas
        ctypes.POINTER(ctypes.c_double),  # cy
        ctypes.POINTER(ctypes.c_double),  # cx
        ctypes.POINTER(ctypes.c_double),  # imean
        ctypes.POINTER(ctypes.c_int32),   # cls_out
    ]
    lib.seq_label_full_stats_3d.restype = None
    lib.seq_label_full_stats_3d.argtypes = [
        ctypes.POINTER(ctypes.c_int32),   # labels
        ctypes.POINTER(ctypes.c_int32),   # class_map
        ctypes.POINTER(ctypes.c_float),   # intensity (may be null)
        ctypes.c_int32,                   # z
        ctypes.c_int32,                   # h
        ctypes.c_int32,                   # w
        ctypes.c_int32,                   # n_labels
        ctypes.c_int32,                   # n_classes
        ctypes.POINTER(ctypes.c_int64),   # counts scratch
        ctypes.POINTER(ctypes.c_int64),   # areas
        ctypes.POINTER(ctypes.c_double),  # cz
        ctypes.POINTER(ctypes.c_double),  # cy
        ctypes.POINTER(ctypes.c_double),  # cx
        ctypes.POINTER(ctypes.c_double),  # imean
        ctypes.POINTER(ctypes.c_int32),   # cls_out
    ]
    lib.seq_crc32c.restype = ctypes.c_uint32
    lib.seq_crc32c.argtypes = [ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]
    lib.seq_lzw_decode.restype = ctypes.c_int64
    lib.seq_lzw_decode.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),  # src
        ctypes.c_int64,                  # n_src
        ctypes.POINTER(ctypes.c_uint8),  # dst
        ctypes.c_int64,                  # n_dst
    ]
    lib.seq_watershed.restype = None
    lib.seq_watershed.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # mask
        ctypes.POINTER(ctypes.c_float),   # priority
        ctypes.c_int32,                   # h
        ctypes.c_int32,                   # w
        ctypes.POINTER(ctypes.c_int32),   # labels (seeds in, basins out)
    ]
    lib.seq_watershed_3d.restype = None
    lib.seq_watershed_3d.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # mask
        ctypes.POINTER(ctypes.c_float),   # priority
        ctypes.c_int32,                   # z
        ctypes.c_int32,                   # h
        ctypes.c_int32,                   # w
        ctypes.POINTER(ctypes.c_int32),   # labels (seeds in, basins out)
    ]


def available() -> bool:
    return _load() is not None


def label_components(mask: np.ndarray) -> np.ndarray:
    """4-connected components of a 2D boolean mask -> int32 labels (1..n)."""
    lib = _load()
    mask = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
    h, w = mask.shape
    out = np.empty((h, w), dtype=np.int32)
    if lib is None:
        from scipy import ndimage

        labelled, _ = ndimage.label(mask)
        return labelled.astype(np.int32)
    lib.seq_label_components(
        mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        h,
        w,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out


def _majority(v: np.ndarray, k: int) -> int:
    """Majority class among ids in [0, k) — matches the C sweep, which
    ignores out-of-range class ids (the scipy bincount argmax would not)."""
    v = np.asarray(v).astype(np.int64).ravel()
    v = v[(v >= 0) & (v < k)]
    if v.size == 0:
        return 0
    return int(np.bincount(v, minlength=k).argmax())


def label_full_stats(
    labels: np.ndarray,
    class_map: np.ndarray,
    intensity: Optional[np.ndarray],
    n_labels: int,
    n_classes: int,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Single-pass per-label (areas, cy, cx, intensity_mean, majority_class).

    The scipy fallback makes four passes per frame (sum_labels,
    center_of_mass, mean, labeled_comprehension); the native path fuses
    them into one sweep and preserves behavior.
    """
    lib = _load()
    labels = np.ascontiguousarray(np.asarray(labels, dtype=np.int32))
    class_map = np.asarray(class_map)
    if class_map.shape != labels.shape:
        raise ValueError(
            f"class_map shape {class_map.shape} != labels {labels.shape}"
        )
    if intensity is not None:
        intensity = np.asarray(intensity)
        if intensity.shape != labels.shape:
            raise ValueError(
                f"intensity shape {intensity.shape} != labels {labels.shape}"
            )
    h, w = labels.shape
    if lib is None:
        from scipy import ndimage

        ids = np.arange(1, n_labels + 1)
        areas = ndimage.sum_labels(
            np.ones_like(labels), labels, ids
        ).astype(np.int64)
        if n_labels:
            com = ndimage.center_of_mass(np.ones_like(labels), labels, ids)
            cy = np.asarray([c[0] for c in com])
            cx = np.asarray([c[1] for c in com])
            means = (
                np.asarray(ndimage.mean(intensity, labels, ids))
                if intensity is not None else np.zeros(n_labels)
            )
            classes = ndimage.labeled_comprehension(
                class_map, labels, ids,
                lambda v: _majority(v, n_classes), np.int32, 0,
            )
        else:
            cy = cx = means = np.zeros(0)
            classes = np.zeros(0, dtype=np.int32)
        return areas, cy, cx, means, np.asarray(classes, dtype=np.int32)
    class_map = np.ascontiguousarray(np.asarray(class_map, dtype=np.int32))
    if intensity is not None:
        intensity = np.ascontiguousarray(np.asarray(intensity, dtype=np.float32))
        inten_ptr = intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        inten_ptr = ctypes.POINTER(ctypes.c_float)()
    counts = np.zeros(max(n_labels * n_classes, 1), dtype=np.int64)
    areas = np.zeros(n_labels, dtype=np.int64)
    cy = np.zeros(n_labels, dtype=np.float64)
    cx = np.zeros(n_labels, dtype=np.float64)
    imean = np.zeros(n_labels, dtype=np.float64)
    classes = np.zeros(n_labels, dtype=np.int32)
    lib.seq_label_full_stats(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        class_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inten_ptr,
        h,
        w,
        n_labels,
        n_classes,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        areas.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        imean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return areas, cy, cx, imean, classes


def label_full_stats_3d(
    labels: np.ndarray,
    class_map: np.ndarray,
    intensity: Optional[np.ndarray],
    n_labels: int,
    n_classes: int,
):
    """3D single-pass per-label stats: (areas, cz, cy, cx, imean, classes).

    Volumetric counterpart of ``label_full_stats`` for (Z, H, W) instance
    maps (the ``localize_volume`` hot loop); scipy fallback preserved.
    """
    lib = _load()
    labels = np.ascontiguousarray(np.asarray(labels, dtype=np.int32))
    class_map = np.asarray(class_map)
    if class_map.shape != labels.shape:
        raise ValueError(
            f"class_map shape {class_map.shape} != labels {labels.shape}"
        )
    if intensity is not None:
        intensity = np.asarray(intensity)
        if intensity.shape != labels.shape:
            raise ValueError(
                f"intensity shape {intensity.shape} != labels {labels.shape}"
            )
    z, h, w = labels.shape
    if lib is None:
        from scipy import ndimage

        ids = np.arange(1, n_labels + 1)
        areas = ndimage.sum_labels(
            np.ones_like(labels), labels, ids
        ).astype(np.int64)
        if n_labels:
            com = ndimage.center_of_mass(np.ones_like(labels), labels, ids)
            cz = np.asarray([c[0] for c in com])
            cy = np.asarray([c[1] for c in com])
            cx = np.asarray([c[2] for c in com])
            means = (
                np.asarray(ndimage.mean(intensity, labels, ids))
                if intensity is not None else np.zeros(n_labels)
            )
            classes = ndimage.labeled_comprehension(
                class_map, labels, ids,
                lambda v: _majority(v, n_classes), np.int32, 0,
            )
        else:
            cz = cy = cx = means = np.zeros(0)
            classes = np.zeros(0, dtype=np.int32)
        return areas, cz, cy, cx, means, np.asarray(classes, dtype=np.int32)
    class_map = np.ascontiguousarray(np.asarray(class_map, dtype=np.int32))
    if intensity is not None:
        intensity = np.ascontiguousarray(np.asarray(intensity, dtype=np.float32))
        inten_ptr = intensity.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    else:
        inten_ptr = ctypes.POINTER(ctypes.c_float)()
    counts = np.zeros(max(n_labels * n_classes, 1), dtype=np.int64)
    areas = np.zeros(n_labels, dtype=np.int64)
    cz = np.zeros(n_labels, dtype=np.float64)
    cy = np.zeros(n_labels, dtype=np.float64)
    cx = np.zeros(n_labels, dtype=np.float64)
    imean = np.zeros(n_labels, dtype=np.float64)
    classes = np.zeros(n_labels, dtype=np.int32)
    lib.seq_label_full_stats_3d(
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        class_map.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        inten_ptr,
        z,
        h,
        w,
        n_labels,
        n_classes,
        counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        areas.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        cz.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cy.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        cx.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        imean.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        classes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return areas, cz, cy, cx, imean, classes


def lzw_decode(data: bytes, expected: int) -> Optional[bytes]:
    """Decode a TIFF LZW strip to exactly ``expected`` bytes.

    Returns None when the native library is unavailable (callers fall back
    to the pure-Python decoder in ``data.tiff`` — ~100x slower, same
    output). Raises ValueError on a malformed or truncated strip.
    """
    lib = _load()
    if lib is None:
        return None
    src = np.frombuffer(data, dtype=np.uint8)
    dst = np.empty(expected, dtype=np.uint8)
    n = lib.seq_lzw_decode(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        len(data),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        expected,
    )
    if n < 0:
        raise ValueError("corrupt LZW strip")
    if n < expected:
        raise ValueError(f"truncated compressed strip: {n} < {expected} bytes")
    return dst.tobytes()


def watershed(
    mask: np.ndarray, priority: np.ndarray, seeds: np.ndarray
) -> np.ndarray:
    """Marker-seeded watershed (Meyer's flooding, 4-conn) over ``priority``.

    Floods DOWN from high priority (pass the EDT to split touching blobs
    at their distance-transform saddles). 2D arrays flood 4-connected,
    3D (Z, H, W) volumes 6-connected. ``seeds``: int32 labels 1..n, 0
    elsewhere; returns the basin label map covering ``mask``. Deterministic
    (FIFO tie-break). skimage is the usual home of this algorithm but is
    absent in this environment; a heapq fallback preserves behavior
    without the toolchain.
    """
    mask = np.ascontiguousarray(np.asarray(mask, dtype=np.uint8))
    priority = np.ascontiguousarray(np.asarray(priority, dtype=np.float32))
    out = np.ascontiguousarray(np.asarray(seeds, dtype=np.int32)).copy()
    if mask.shape != priority.shape or mask.shape != out.shape:
        raise ValueError(
            f"shape mismatch: mask {mask.shape}, priority {priority.shape}, "
            f"seeds {out.shape}"
        )
    if mask.ndim not in (2, 3):
        raise ValueError(f"watershed expects a 2D or 3D array, got {mask.shape}")
    lib = _load()
    if lib is not None:
        if mask.ndim == 2:
            lib.seq_watershed(
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                priority.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mask.shape[0],
                mask.shape[1],
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        else:
            lib.seq_watershed_3d(
                mask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                priority.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                mask.shape[0],
                mask.shape[1],
                mask.shape[2],
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            )
        return out
    # pure-Python fallback: identical flood order (max priority, FIFO ties)
    import heapq

    # neighbor index offsets + the coordinate axis each one steps along
    strides = [int(np.prod(mask.shape[d + 1 :])) for d in range(mask.ndim)]
    shape = mask.shape
    heap = []
    order = 0
    mflat = mask.ravel()
    pflat = priority.ravel()
    lflat = out.ravel()
    for i in np.flatnonzero((lflat > 0) & (mflat != 0)):
        heapq.heappush(heap, (-float(pflat[i]), order, int(i)))
        order += 1
    while heap:
        _, _, i = heapq.heappop(heap)
        lab = lflat[i]
        rem = i
        coords = []
        for s in strides:
            coords.append(rem // s)
            rem %= s
        for d, s in enumerate(strides):
            for step, ok in ((-1, coords[d] > 0), (1, coords[d] + 1 < shape[d])):
                if not ok:
                    continue
                j = i + step * s
                if mflat[j] and lflat[j] == 0:
                    lflat[j] = lab
                    heapq.heappush(heap, (-float(pflat[j]), order, int(j)))
                    order += 1
    return out


def crc32c(data: bytes) -> int:
    """Castagnoli CRC of ``data`` (native slice-by-8; Python fallback)."""
    lib = _load()
    if lib is None:
        from sequitr_tpu_torch.data.records import crc32c as py_crc

        return py_crc(data)
    buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
    return int(lib.seq_crc32c(buf, len(data)))
