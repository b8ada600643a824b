"""Host-side (numpy) reference voxelizers — the golden oracle for the device path.

These reimplement, from scratch but with *identical semantics*, the reference
CPU preprocessors:

  * ``lidar_to_top``   (reference src/data.py:296-367): BEV multi-channel map —
    per-z-slice max height, intensity of the highest point, log-count density.
  * ``lidar_to_front`` (reference src/data.py:56-111): cylindrical front view —
    per-pixel mean of (height above ground, distance, intensity).

They are used (a) as the oracle in golden-parity tests of the XLA
voxelizers — the same testing pattern the reference uses for its CUDA kernels
(src/net/utility/front_top_preprocess.py:195-223, asserts bitwise equality) —
and (b) as the CPU baseline denominator in bench.py.

Semantic notes replicated exactly:
  * crops are strict inequalities on both ends (src/data.py:298-311);
  * a point whose fractional z lands exactly on a slice boundary contributes to
    *both* slices (the reference's ``>= z & <= z+1`` interval, src/data.py:359);
  * the intensity channel takes the reflectance of the np.argmax-height point,
    i.e. first occurrence of the max in crop order (src/data.py:355-356);
  * front-view "distance" includes the reflectance in the norm — a reference
    quirk (``sqrt(sum(point**2))`` over the 4-vector, src/data.py:61) kept for
    bit parity;
  * front-view int coordinates truncate toward zero (``int()``/int32 cast).
"""

from __future__ import annotations

import math

import numpy as np

from ..config import Config, cfg as _default_cfg


def crop_mask(points: np.ndarray, cfg: Config = _default_cfg,
              filter_center_car: bool = True) -> np.ndarray:
    """Strict-inequality crop to the top-view bounds (src/data.py:298-311).

    The center-car filter is a *top-view-only* step in the reference
    (src/data.py:224-227); the front view crops to the grid bounds alone
    (src/data.py:72-85), so front callers pass filter_center_car=False."""
    t = cfg.top
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    m = ((x > t.x_min) & (x < t.x_max) &
         (y > t.y_min) & (y < t.y_max) &
         (z > t.z_min) & (z < t.z_max))
    if filter_center_car and cfg.dataset_type in ("didi", "didi2", "test"):
        # remove returns from the capture vehicle itself (src/data.py:224-227)
        m &= (np.abs(x) > 4.7 / 2) | (np.abs(y) > 2.1 / 2)
    return m


def lidar_to_top_np(points: np.ndarray, cfg: Config = _default_cfg) -> np.ndarray:
    """(N, 4) lidar -> (Xn, Yn, Zn+2) BEV map, float32."""
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    p = points[crop_mask(points, cfg)]

    # floor(a/b) rather than numpy floor_divide: keeps cell assignment
    # bit-identical to the XLA path (the f64-era reference's ``//`` can differ
    # by one ulp exactly on cell boundaries — a measure-zero set)
    qx = np.floor((p[:, 0] - t.x_min) / t.x_div).astype(np.int64)
    qy = np.floor((p[:, 1] - t.y_min) / t.y_div).astype(np.int64)
    qz = ((p[:, 2] - t.z_min) / t.z_div).astype(np.float32)
    refl = p[:, 3].astype(np.float32)

    # flipped output indexing: top[xn-1-qx, yn-1-qy, ...] (src/data.py:345-352)
    row = xn - 1 - qx
    col = yn - 1 - qy
    cell = row * yn + col
    n_cells = xn * yn

    top = np.zeros((n_cells, zn + 2), dtype=np.float32)

    # density channel: min(1, log(count+1)/log(32))
    cnt = np.bincount(cell, minlength=n_cells).astype(np.float32)
    top[:, zn + 1] = np.minimum(1.0, np.log(cnt + 1.0) / math.log(32))

    if len(p):
        # intensity channel: reflectance of the first-max-height point per cell
        order = np.lexsort((np.arange(len(p)), -qz, cell))
        first = np.ones(len(p), dtype=bool)
        first[1:] = cell[order][1:] != cell[order][:-1]
        best = order[first]
        top[cell[best], zn] = refl[best]

        # per-slice heights: slice s=floor(qz) gets frac, and an exact integer
        # qz==s also closes out slice s-1 with value 1 (the inclusive interval)
        s = np.floor(qz).astype(np.int64)
        s = np.minimum(s, zn - 1)
        frac = qz - s
        np.maximum.at(top[:, :zn], (cell, s), frac)
        exact = (frac == 0) & (s >= 1)
        if np.any(exact):
            np.maximum.at(top[:, :zn], (cell[exact], s[exact] - 1),
                          np.ones(int(exact.sum()), dtype=np.float32))

    return top.reshape(xn, yn, zn + 2)


def lidar_to_front_np(points: np.ndarray, cfg: Config = _default_cfg) -> np.ndarray:
    """(N, 4) lidar -> (front.width, front.height, 3) front view, float32."""
    f = cfg.front
    p = points[crop_mask(points, cfg, filter_center_car=False)]

    with np.errstate(invalid="ignore"):
        pc = (np.arctan2(p[:, 1], p[:, 0]) / f.angular_res).astype(np.int32)
        pr = (np.arctan2(p[:, 2], np.sqrt(p[:, 0] ** 2 + p[:, 1] ** 2))
              / f.vertical_res).astype(np.int32)

    m = ((pc > f.c_min) & (pc < f.c_max) & (pr > f.r_min) & (pr < f.r_max))
    p, pc, pr = p[m], pc[m], pr[m]
    pc = pc + f.c_offset
    pr = pr + f.r_offset
    m = (pc >= 0) & (pc < f.width) & (pr >= 0) & (pr < f.height)
    p, pc, pr = p[m], pc[m], pr[m]

    height = np.clip(p[:, 2] + f.velodyne_height, 0, None).astype(np.float32)
    # reference quirk: distance norm includes the reflectance component
    distance = np.sqrt(np.sum(p ** 2, axis=1)).astype(np.float32)
    intensity = p[:, 3].astype(np.float32)

    pix = pc.astype(np.int64) * f.height + pr
    n_pix = f.width * f.height
    front = np.zeros((n_pix, 3), dtype=np.float32)
    np.add.at(front[:, 0], pix, height)
    np.add.at(front[:, 1], pix, distance)
    np.add.at(front[:, 2], pix, intensity)
    cnt = np.bincount(pix, minlength=n_pix).astype(np.float32)
    cnt[cnt == 0] = 1.0
    front /= cnt[:, None]
    return front.reshape(f.width, f.height, 3)
