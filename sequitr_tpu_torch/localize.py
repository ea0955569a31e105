"""Object localization: label maps -> per-object features -> btrack HDF5.

Rebuilds sequitr's localization export (SURVEY.md §3.5): connected-component
labelling of segmentation masks, per-object centroid/area/class features,
and an HDF5 file in the layout btrack's ``HDF5FileHandler`` consumes
(``objects/obj_type_N/coords`` (n, 5) [t, x, y, z, label] + ``map`` frame
index; spec decision — layout reconstructed from btrack's public reader,
reference export unavailable).

This is irregular, data-dependent host work (SURVEY.md §3.5), so it runs
in numpy/scipy on the host; a native C++ union-find labeller
(``sequitr_tpu_torch.native``) accelerates the labelling hot loop when built,
with scipy as the always-available fallback.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence

import numpy as np
from scipy import ndimage

__all__ = [
    "LocalizedObject",
    "FrameTable",
    "label_components",
    "split_touching_instances",
    "localize_frame",
    "localize_frame_table",
    "localize_instances_table",
    "export_btrack_h5",
    "export_btrack_h5_tables",
    "export_objects_csv",
    "read_objects_h5",
]


@dataclasses.dataclass
class LocalizedObject:
    t: int
    x: float  # centroid column
    y: float  # centroid row
    z: float
    label: int  # semantic class
    area: int
    intensity_mean: float = 0.0


def label_components(mask: np.ndarray, connectivity: int = 1) -> np.ndarray:
    """Connected components of a boolean/int mask -> int32 instance map.

    Uses the native C++ union-find labeller when available (4-connectivity,
    2D), else scipy.ndimage.label.
    """
    mask = np.asarray(mask)
    if mask.ndim == 2 and connectivity == 1:
        try:
            from sequitr_tpu_torch import native

            if native.available():
                return native.label_components(mask != 0)
        except ImportError:
            pass
    structure = ndimage.generate_binary_structure(mask.ndim, connectivity)
    labelled, _ = ndimage.label(mask != 0, structure=structure)
    return labelled.astype(np.int32)


def split_touching_instances(
    class_map: np.ndarray, min_distance: int = 5
) -> np.ndarray:
    """Instance map that SPLITS touching cells, via distance-transform
    watershed (2D frames or 3D volumes).

    Plain connected components merge abutting cells of any class into one
    object (confluent monolayers, dividing cells) — the classic failure
    feeding a tracker. The standard fix: Euclidean distance transform of
    the foreground, seeds at its local maxima (one per cell body,
    ``min_distance`` sets the scale), then marker-seeded watershed flooding
    down the EDT so each basin becomes one instance (``native.watershed``,
    4-conn in 2D / 6-conn in 3D — skimage is absent in this environment).

    Returns int32 instance labels 1..n covering ``class_map > 0``.
    """
    from sequitr_tpu_torch import native

    mask = np.asarray(class_map) > 0
    if not mask.any():
        return np.zeros(mask.shape, np.int32)
    edt = ndimage.distance_transform_edt(mask).astype(np.float32)
    size = 2 * int(min_distance) + 1
    maxima = (edt >= ndimage.maximum_filter(edt, size=size)) & mask
    seeds = label_components(maxima)
    if seeds.max() == 0:  # pragma: no cover - mask nonempty => maxima exist
        return label_components(mask)
    out = native.watershed(mask, edt, seeds)
    # A small component NEXT TO a bigger one can end up seedless: the
    # maximum filter's window sees the neighbour's larger EDT, so no pixel
    # of the small blob is a local max, and flooding cannot cross
    # background to reach it. Such components must not vanish (plain CCL
    # finds them) — label the leftovers as their own instances.
    left = mask & (out == 0)
    if left.any():
        extra = label_components(left)
        out = np.where(left, extra + np.int32(out.max()), out)
    return out


@dataclasses.dataclass
class FrameTable:
    """Compact per-frame localization table (plain numpy columns).

    The serving hot path keeps objects in these instead of per-object
    ``LocalizedObject`` instances: a noisy frame can carry hundreds of
    objects, and Python dataclass overhead is ~20x the 24 bytes of actual
    feature data per object.
    """

    coords: np.ndarray  # (n, 5) float32 [t, x, y, z, label]
    area: np.ndarray  # (n,) int32
    intensity_mean: np.ndarray  # (n,) float32

    def __len__(self) -> int:
        return len(self.coords)

    @staticmethod
    def empty() -> "FrameTable":
        return FrameTable(
            coords=np.zeros((0, 5), np.float32),
            area=np.zeros(0, np.int32),
            intensity_mean=np.zeros(0, np.float32),
        )


def localize_frame_table(
    class_map: np.ndarray,
    t: int = 0,
    intensity: Optional[np.ndarray] = None,
    min_area: int = 1,
    z: float = 0.0,
    n_classes: Optional[int] = None,
    split_touching: bool = False,
    min_distance: int = 5,
) -> FrameTable:
    """Per-object features of a 2D class label map as a compact table.

    Foreground = ``class_map > 0``; instances come from connected components
    of the foreground — or, with ``split_touching``, from the
    distance-transform watershed (``split_touching_instances``) so abutting
    cells count as separate objects; each object's semantic ``label`` is
    the majority class over its pixels (spec decision). Area, centroid,
    mean intensity and majority class all come from ONE native sweep over
    the frame (``native.label_full_stats``; scipy fallback inside).
    """
    from sequitr_tpu_torch import native

    class_map = np.asarray(class_map)
    if split_touching:
        inst = split_touching_instances(class_map, min_distance=min_distance)
    else:
        inst = label_components(class_map > 0)
    n = int(inst.max())
    if n == 0:
        return FrameTable.empty()
    k = int(n_classes) if n_classes is not None else int(class_map.max()) + 1
    areas, cy, cx, imean, classes = native.label_full_stats(
        inst, class_map, intensity, n, k
    )
    keep = areas >= min_area
    kept = int(keep.sum())
    coords = np.empty((kept, 5), dtype=np.float32)
    coords[:, 0] = t
    coords[:, 1] = cx[keep]
    coords[:, 2] = cy[keep]
    coords[:, 3] = z
    coords[:, 4] = classes[keep]
    return FrameTable(
        coords=coords,
        area=areas[keep].astype(np.int32),
        intensity_mean=imean[keep].astype(np.float32),
    )


def localize_instances_table(
    instances: np.ndarray,
    t: int = 0,
    intensity: Optional[np.ndarray] = None,
    min_area: int = 1,
    z: float = 0.0,
) -> FrameTable:
    """Per-object features of a PRE-LABELLED instance map (2D or 3D).

    ``localize_frame_table`` re-derives instances from connected
    components of the foreground — which would re-merge the touching
    cells an instance segmenter (flow following, watershed) just
    separated, since abutting instances share a connected foreground.
    This variant trusts the provided instance ids (0 = background,
    1..n = objects) and runs only the fused per-label stats sweep.
    The semantic ``label`` column is 1 for every object (instance
    segmentation carries no class). A (Z, H, W) instance map fills the
    table's z column with per-object z centroids (``z`` ignored)."""
    from sequitr_tpu_torch import native

    instances = np.ascontiguousarray(np.asarray(instances, dtype=np.int32))
    n = int(instances.max())
    if n == 0:
        return FrameTable.empty()
    fg = (instances > 0).astype(np.int32)
    if instances.ndim == 3:
        areas, cz, cy, cx, imean, _classes = native.label_full_stats_3d(
            instances, fg, intensity, n, 2
        )
    elif instances.ndim == 2:
        areas, cy, cx, imean, _classes = native.label_full_stats(
            instances, fg, intensity, n, 2
        )
        cz = np.full_like(cy, float(z))
    else:
        raise ValueError(
            f"instances must be 2D or 3D, got {instances.shape}"
        )
    keep = areas >= min_area
    kept = int(keep.sum())
    coords = np.empty((kept, 5), dtype=np.float32)
    coords[:, 0] = t
    coords[:, 1] = cx[keep]
    coords[:, 2] = cy[keep]
    coords[:, 3] = cz[keep]
    coords[:, 4] = 1.0
    return FrameTable(
        coords=coords,
        area=areas[keep].astype(np.int32),
        intensity_mean=imean[keep].astype(np.float32),
    )


def localize_frame(
    class_map: np.ndarray,
    t: int = 0,
    intensity: Optional[np.ndarray] = None,
    min_area: int = 1,
    z: float = 0.0,
) -> List[LocalizedObject]:
    """Extract per-object centroids/features from a 2D class label map.

    Object-list convenience wrapper over ``localize_frame_table`` (the
    serving pipelines use the table form directly).
    """
    tbl = localize_frame_table(
        class_map, t=t, intensity=intensity, min_area=min_area, z=z
    )
    return [
        LocalizedObject(
            t=int(c[0]),
            x=float(c[1]),
            y=float(c[2]),
            z=float(c[3]),
            label=int(c[4]),
            area=int(a),
            intensity_mean=float(m),
        )
        for c, a, m in zip(tbl.coords, tbl.area, tbl.intensity_mean)
    ]


def localize_volume(
    class_map: np.ndarray,
    t: int = 0,
    intensity: Optional[np.ndarray] = None,
    min_area: int = 1,
    n_classes: Optional[int] = None,
    split_touching: bool = False,
    min_distance: int = 5,
) -> List[LocalizedObject]:
    """3D variant: per-object centroids from a (Z, H, W) class label map.

    Instances from 3D connected components of the foreground — or the 3D
    distance-transform watershed with ``split_touching`` (6-connected
    flooding; abutting nuclei in a z-stack count separately); ``z`` is the
    centroid plane (BASELINE config #4's volumetric output feeding btrack).
    All per-object features come from ONE native sweep
    (``native.label_full_stats_3d``; scipy fallback inside).
    """
    from sequitr_tpu_torch import native

    class_map = np.asarray(class_map)
    if class_map.ndim != 3:
        raise ValueError(f"expected (Z, H, W), got {class_map.shape}")
    if split_touching:
        inst = split_touching_instances(class_map, min_distance=min_distance)
        n = int(inst.max())
    else:
        structure = ndimage.generate_binary_structure(3, 1)
        inst, n = ndimage.label(class_map > 0, structure=structure)
    if n == 0:
        return []
    k = int(n_classes) if n_classes is not None else int(class_map.max()) + 1
    areas, cz, cy, cx, means, classes = native.label_full_stats_3d(
        inst, class_map, intensity, n, k
    )
    out = []
    for i in range(n):
        if areas[i] < min_area:
            continue
        out.append(
            LocalizedObject(
                t=t, x=float(cx[i]), y=float(cy[i]), z=float(cz[i]),
                label=int(classes[i]), area=int(areas[i]),
                intensity_mean=float(means[i]),
            )
        )
    return out


def export_btrack_h5(
    path: str,
    objects: Sequence[LocalizedObject],
    obj_type: int = 1,
    n_frames: Optional[int] = None,
) -> None:
    """Write objects to HDF5 in btrack's object-file layout.

    Layout (btrack HDF5FileHandler convention):
      /objects/obj_type_{N}/coords : (n, 5) float32 [t, x, y, z, label]
      /objects/obj_type_{N}/map    : (n_frames, 2) int32 per-frame
                                     [start, end) slices into coords
    Objects are sorted by t; properties (area, intensity) are stored
    alongside under .../properties. Pass ``n_frames`` (the SOURCE stack's
    frame count) so trailing object-free frames still get (empty) map
    rows — otherwise a per-frame consumer sees a shorter movie and
    misaligns tracks with the stack; without it the map ends at the last
    detected object's frame.
    """
    objs = sorted(objects, key=lambda o: o.t)
    coords = np.asarray(
        [[o.t, o.x, o.y, o.z, o.label] for o in objs], dtype=np.float32
    ).reshape(-1, 5)
    area = np.asarray([o.area for o in objs], dtype=np.int32)
    imean = np.asarray([o.intensity_mean for o in objs], dtype=np.float32)
    _write_btrack(path, coords, area, imean, n_frames, obj_type)


def export_btrack_h5_tables(
    path: str,
    tables: Sequence[FrameTable],
    obj_type: int = 1,
    n_frames: Optional[int] = None,
) -> int:
    """Write per-frame ``FrameTable``s (in t order) to the btrack layout.

    The zero-Python-object export path the streaming server uses; returns
    the total object count. Same file layout as ``export_btrack_h5``.
    """
    if tables:
        coords = np.concatenate([tb.coords for tb in tables])
        area = np.concatenate([tb.area for tb in tables])
        imean = np.concatenate([tb.intensity_mean for tb in tables])
    else:
        e = FrameTable.empty()
        coords, area, imean = e.coords, e.area, e.intensity_mean
    if len(coords) and np.any(np.diff(coords[:, 0]) < 0):
        order = np.argsort(coords[:, 0], kind="stable")
        coords, area, imean = coords[order], area[order], imean[order]
    _write_btrack(path, coords, area, imean, n_frames, obj_type)
    return len(coords)


def export_objects_csv(path: str, items) -> int:
    """``objects.csv`` companion of the btrack HDF5 export.

    One row per object, ``t,x,y,z,label,area,intensity_mean``, t-sorted,
    written atomically (tmp + rename). The HDF5 stays the TRACKING
    contract (btrack / track_objects slice its map rows); the CSV is the
    zero-dependency QC surface — pandas, a spreadsheet, or awk can
    answer "how many mitotic cells per frame" without touching h5py.
    Accepts either per-frame ``FrameTable``s (the streaming path) or a
    sequence of ``LocalizedObject``s; returns the row count.
    """
    items = list(items)
    if items and isinstance(items[0], FrameTable):
        coords = np.concatenate([tb.coords for tb in items])
        area = np.concatenate([tb.area for tb in items])
        imean = np.concatenate([tb.intensity_mean for tb in items])
    elif items:
        objs = sorted(items, key=lambda o: o.t)
        coords = np.asarray(
            [[o.t, o.x, o.y, o.z, o.label] for o in objs], np.float32
        ).reshape(-1, 5)
        area = np.asarray([o.area for o in objs], np.int32)
        imean = np.asarray([o.intensity_mean for o in objs], np.float32)
    else:
        e = FrameTable.empty()
        coords, area, imean = e.coords, e.area, e.intensity_mean
    if len(coords) and np.any(np.diff(coords[:, 0]) < 0):
        order = np.argsort(coords[:, 0], kind="stable")
        coords, area, imean = coords[order], area[order], imean[order]
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write("t,x,y,z,label,area,intensity_mean\n")
        for k in range(len(coords)):
            t, x, y, z, lab = coords[k]
            f.write(
                f"{int(t)},{x:.4f},{y:.4f},{z:.4f},{int(lab)},"
                f"{int(area[k])},{imean[k]:.4f}\n"
            )
    os.replace(tmp, path)
    return len(coords)


def read_objects_h5(path: str, obj_type: int = 1) -> List[FrameTable]:
    """Read an ``objects.h5`` (btrack object-file layout) back into
    per-frame ``FrameTable``s.

    The inverse of ``export_btrack_h5_tables`` and the library form of the
    read semantics validated against the layout in
    ``tests/test_btrack_shim.py``: per-frame object lists come from the
    ``map`` dataset's [start, end) slices into ``coords``, with the
    ``properties`` arrays joined by position. Trailing object-free frames
    (map rows with start == end) yield empty tables, so ``len(result)``
    is the SOURCE stack's frame count.
    """
    import h5py

    with h5py.File(path, "r") as f:
        grp = f[f"objects/obj_type_{obj_type}"]
        coords = np.asarray(grp["coords"], dtype=np.float32)
        fmap = np.asarray(grp["map"], dtype=np.int64)
        props = grp["properties"]
        area = np.asarray(props["area"], dtype=np.int32)
        imean = np.asarray(props["intensity_mean"], dtype=np.float32)
    # validate the layout contract UP FRONT so an out-of-spec file fails
    # here (where the pipeline converts it to a deterministic JobError)
    # instead of deep inside a consumer after the linking work is done
    if coords.ndim != 2 or coords.shape[1] != 5:
        raise ValueError(
            f"{path}: coords must be (n, 5) [t, x, y, z, label], "
            f"got {coords.shape}"
        )
    if fmap.ndim != 2 or fmap.shape[1] != 2:
        raise ValueError(f"{path}: map must be (n_frames, 2), got {fmap.shape}")
    n = len(coords)
    if len(area) != n or len(imean) != n:
        raise ValueError(
            f"{path}: properties misaligned with coords "
            f"({len(area)}/{len(imean)} vs {n})"
        )
    if len(fmap) and (
        np.any(fmap < 0) or np.any(fmap > n) or np.any(fmap[:, 0] > fmap[:, 1])
    ):
        raise ValueError(f"{path}: map slices out of bounds for {n} objects")
    tables: List[FrameTable] = []
    for start, end in fmap:
        tables.append(
            FrameTable(
                coords=coords[start:end],
                area=area[start:end],
                intensity_mean=imean[start:end],
            )
        )
    return tables


def _write_btrack(
    path: str,
    coords: np.ndarray,
    area: np.ndarray,
    imean: np.ndarray,
    n_frames: Optional[int],
    obj_type: int,
) -> None:
    import h5py

    t_max = int(coords[:, 0].max()) if len(coords) else -1
    nf = int(n_frames) if n_frames is not None else t_max + 1
    if len(coords) and nf <= t_max:
        raise ValueError(f"n_frames={nf} but objects reach t={t_max}")
    if nf:
        starts = np.searchsorted(coords[:, 0], np.arange(nf), side="left")
        ends = np.searchsorted(coords[:, 0], np.arange(nf), side="right")
        fmap = np.stack([starts, ends], axis=1).astype(np.int32)
    else:
        fmap = np.zeros((0, 2), dtype=np.int32)

    with h5py.File(path, "w") as f:
        grp = f.create_group(f"objects/obj_type_{obj_type}")
        grp.create_dataset("coords", data=coords)
        grp.create_dataset("map", data=fmap)
        props = grp.create_group("properties")
        props.create_dataset("area", data=area)
        props.create_dataset("intensity_mean", data=imean)
