"""Lidar voxelization: BEV ("top") and cylindrical front views.

This replaces the reference's entire preprocessing zoo — the pure-python triple
loop (src/data.py:296-367), the PyCUDA kernels
(src/net/utility/front_top_kernel.cu + front_top_preprocess.py:29-193) and the
ctypes C voxelizer
(src/lidar_data_preprocess/Python_to_C_Interface/ver3/LidarTopPreprocess.c) —
with a
single jit-able XLA program:

  * fixed-size padded point buffer (static shapes; invalid points are routed to
    a dump cell so there is no data-dependent control flow);
  * per-cell reductions expressed as scatter-max / scatter-add / scatter-min,
    which XLA lowers to atomic updates on the GPU;
  * batched via ``jax.vmap`` — frames are embarrassingly parallel.

Crucially this runs *inside* the model graph, so `lidar -> boxes` is one XLA
program with zero host round-trips (the reference crosses the device boundary
several times per frame, SURVEY.md §3.2).

Semantics are identical to :mod:`mv3d_tpu.ops.voxelize_ref` (the numpy
oracle), which the tests assert like the reference's own CUDA-vs-CPU golden
test (src/net/utility/front_top_preprocess.py:195-223). Values agree to the
last bit or two: XLA turns the quantization's divisions into reciprocal
multiplies on the CPU, and its f32 division on the GPU is one ulp off IEEE
division for ~14% of quotients (measured on an H100), so a height may differ
by an ulp and a point within an ulp of a cell boundary may land in the
neighbouring cell. Heights, intensity and counts are maxima and
integer-valued sums, so they do not depend on the order in which atomics
land; the front view's per-pixel means are float sums whose order does.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..config import Config, cfg as _default_cfg


def _crop_mask(points: jnp.ndarray, cfg: Config,
               num_points: Optional[jnp.ndarray],
               filter_center_car: bool = True) -> jnp.ndarray:
    """Strict-bound crop + optional didi center-car filter + padding mask.

    The center-car filter applies only to the *top* view (reference
    filter_center_car is called on the top path, src/data.py:224-227, while
    Preprocess.lidar_to_front crops to the top-grid bounds alone,
    src/data.py:72-85)."""
    t = cfg.top
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    m = ((x > t.x_min) & (x < t.x_max) &
         (y > t.y_min) & (y < t.y_max) &
         (z > t.z_min) & (z < t.z_max))
    if filter_center_car and cfg.dataset_type in ("didi", "didi2", "test"):
        m &= (jnp.abs(x) > 4.7 / 2) | (jnp.abs(y) > 2.1 / 2)
    if num_points is not None:
        idx = jnp.arange(points.shape[0])
        m &= idx < num_points
    return m


def _top_prep(points: jnp.ndarray, cfg: Config,
              num_points: Optional[jnp.ndarray]):
    """Per-frame point quantization for the top view.

    Returns (valid, cell, flat, val, refl, qz): crop mask, per-point cell
    id (dump cell = n_cells for invalid), flat (cell*zn + s_eff)
    height-slice id with the inclusive-boundary redirect applied (dump =
    n_cells*zn), the slice height value, reflectance, and the height in
    slice units.
    """
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n_cells = xn * yn

    valid = _crop_mask(points, cfg, num_points)

    qx = jnp.floor((points[:, 0] - t.x_min) / t.x_div).astype(jnp.int32)
    qy = jnp.floor((points[:, 1] - t.y_min) / t.y_div).astype(jnp.int32)
    qz = ((points[:, 2] - t.z_min) / t.z_div).astype(jnp.float32)
    refl = points[:, 3].astype(jnp.float32)

    row = xn - 1 - qx
    col = yn - 1 - qy
    s = jnp.minimum(jnp.floor(qz), zn - 1).astype(jnp.int32)
    frac = qz - s.astype(jnp.float32)
    exact = (frac == 0.0) & (s >= 1)
    s_eff = jnp.where(exact, s - 1, s)
    val = jnp.where(valid, jnp.where(exact, 1.0, frac), 0.0)

    cell = jnp.where(valid, row * yn + col, n_cells)        # dump cell
    flat = jnp.where(valid, cell * zn + s_eff, n_cells * zn)
    return valid, cell, flat, val, refl, qz


def _occ_from_cells(heights2d, intensity, density, counts, cfg: Config):
    """Per-cell occupancy mass for the empty-anchor filter.

    The filter thresholds RECT SUMS of the view's channel sum
    (remove_empty_box.py:46-47). Every channel is non-negative (heights are
    frac/1.0 values in [0, 1], intensity is reflectance in [0, 1], density
    in [0, 1]) and density > 0 exactly when the cell holds >= 1 point — so
    at the default threshold 0.0 the point COUNT has the same zero-set as
    the channel sum and yields a bit-identical mask, without reducing the
    46 MB height volume. Non-zero thresholds need the true sums; only then
    is the reduction paid.
    """
    if cfg.pipeline.remove_empty_thresh == 0.0:
        return counts.astype(jnp.float32)
    return (jnp.sum(heights2d.astype(jnp.float32), axis=-1)
            + intensity + density)


def lidar_to_top(points: jnp.ndarray, cfg: Config = _default_cfg,
                 num_points: Optional[jnp.ndarray] = None,
                 aux: Optional[jnp.ndarray] = None,
                 return_occ: bool = False) -> jnp.ndarray:
    """(N, 4) padded lidar points -> (Xn, Yn, Zn+2) BEV map, float32.

    ``return_occ``: also return the (Xn, Yn) per-cell channel sum ("occupancy
    mass", what the empty-anchor filter consumes). Computing it here from
    the per-cell arrays that already exist spares the filter a reduction
    over the whole 46 MB view.

    Channels 0..Zn-1: per-slice max height above the slice floor (in z-cell
    units); channel Zn: reflectance of the highest point in the cell; channel
    Zn+1: ``min(1, log(count+1)/log 32)`` density. Output rows/cols are flipped
    exactly like the reference (top[Xn-1-qx, Yn-1-qy], src/data.py:345-352).

    Scatter cost scales with the number of scattered *elements*, so the
    implementation minimizes total scatter volume to three scalar scatters:

      1. heights: ONE scatter-max per point — a point exactly on a slice
         boundary (frac==0, s>=1) is *redirected* to slice s-1 with value 1.0
         (the reference's inclusive [z, z+1] interval, data.py:359; its
         nominal slice-s contribution would be 0 == the init value, so the
         redirect is exact);
      2. density: one scatter-add of 1.0;
      3. intensity: one scatter-min of the point index among per-cell
         max-height points. The per-cell max height itself needs NO scatter:
         it is reconstructed exactly from the height channels as
         max_s (s + h[s]) over occupied slices (f32-exact because qz - s and
         s + frac are exact for s in [0, 25)).

    ``aux``: optional precomputed (Xn, Yn, 2) [intensity, density] plane
    (e.g. from the native C++ host library via the prefetch loader,
    mv3d_tpu.native.lidar_to_top_aux). When given, the device computes only
    the height channels — the production serving/training configuration: the
    host's single-pass C++ aux computation (~1 ms) overlaps with device
    compute through the loader's prefetch thread.
    """
    t = cfg.top
    xn, yn, zn = t.xn, t.yn, t.zn
    n = points.shape[0]
    n_cells = xn * yn

    # per-slice heights use ONE scatter-max with the boundary redirect
    # folded into flat/val (see _top_prep)
    valid, cell, flat, val, refl, qz = _top_prep(points, cfg, num_points)

    heights = jnp.zeros(n_cells * zn + 1, jnp.float32).at[flat].max(
        val)[:n_cells * zn]
    heights = heights.reshape(n_cells, zn)

    if aux is not None:
        top = jnp.concatenate(
            [heights.reshape(xn, yn, zn), aux.astype(jnp.float32)], axis=-1)
        if return_occ:
            return top, jnp.sum(top, axis=-1)
        return top

    # per-cell max height reconstructed from the slices (no scatter):
    # occupied slices have h > 0 (qz > 0 strictly inside the crop)
    slice_base = jnp.arange(zn, dtype=jnp.float32)[None, :]
    zmax_cells = jnp.max(
        jnp.where(heights > 0.0, slice_base + heights, -1.0), axis=1)
    zmax = jnp.concatenate([zmax_cells, jnp.full((1,), -1.0, jnp.float32)])

    # --- density -------------------------------------------------------------
    counts = jnp.zeros(n_cells + 1, jnp.float32).at[cell].add(1.0)
    density = jnp.minimum(1.0, jnp.log(counts[:n_cells] + 1.0) / math.log(32))

    # --- intensity of the first-max-height point per cell --------------------
    # scatter-min the winning point's index, then scatter its reflectance back
    # (all per-point-sized ops; a dense 480k-cell gather would cost ~4x more)
    zq = jnp.where(valid, qz, -1.0)
    is_best = valid & (zq == zmax[cell])
    idx = jnp.arange(n, dtype=jnp.int32)
    best_idx = (jnp.full(n_cells + 1, n, jnp.int32)
                .at[cell].min(jnp.where(is_best, idx, n)))
    chosen = valid & (idx == best_idx[cell])
    intensity = (jnp.zeros(n_cells + 1, jnp.float32)
                 .at[cell].max(jnp.where(chosen, refl, 0.0)))[:n_cells]

    top = jnp.concatenate(
        [heights, intensity[:, None], density[:, None]], axis=1)
    top = top.reshape(xn, yn, zn + 2)
    if return_occ:
        occ = _occ_from_cells(heights, intensity, density,
                              counts[:n_cells], cfg)
        return top, occ.reshape(xn, yn)
    return top


def lidar_to_front(points: jnp.ndarray, cfg: Config = _default_cfg,
                   num_points: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(N, 4) padded lidar points -> (width, height, 3) cylindrical front view.

    Channels: per-pixel mean of (height above ground, distance, intensity).
    Parity: reference ``Preprocess.lidar_to_front`` (src/data.py:56-111),
    including the reflectance-in-norm distance quirk.
    """
    f = cfg.front
    n = points.shape[0]
    n_pix = f.width * f.height

    valid = _crop_mask(points, cfg, num_points, filter_center_car=False)

    # int() truncation toward zero — f32 -> int32 cast semantics
    pc = (jnp.arctan2(points[:, 1], points[:, 0]) / f.angular_res
          ).astype(jnp.int32)
    pr = (jnp.arctan2(points[:, 2],
                      jnp.sqrt(points[:, 0] ** 2 + points[:, 1] ** 2))
          / f.vertical_res).astype(jnp.int32)

    valid &= ((pc > f.c_min) & (pc < f.c_max) &
              (pr > f.r_min) & (pr < f.r_max))
    pc = pc + f.c_offset
    pr = pr + f.r_offset
    valid &= (pc >= 0) & (pc < f.width) & (pr >= 0) & (pr < f.height)

    pix = jnp.where(valid, pc * f.height + pr, n_pix)

    height = jnp.clip(points[:, 2] + f.velodyne_height, 0.0, None)
    distance = jnp.sqrt(jnp.sum(points[:, :4] ** 2, axis=1))
    intensity = points[:, 3]
    vals = jnp.stack([height, distance, intensity,
                      jnp.ones_like(height)], axis=1).astype(jnp.float32)
    vals = jnp.where(valid[:, None], vals, 0.0)

    acc = jnp.zeros((n_pix + 1, 4), jnp.float32).at[pix].add(vals)
    cnt = jnp.maximum(acc[:n_pix, 3:4], 1.0)
    front = acc[:n_pix, :3] / cnt
    return front.reshape(f.width, f.height, 3)


# ---------------------------------------------------------------------------
# batched entry points
# ---------------------------------------------------------------------------

def lidar_to_top_batch(points: jnp.ndarray, cfg: Config = _default_cfg,
                       num_points: Optional[jnp.ndarray] = None,
                       aux: Optional[jnp.ndarray] = None,
                       return_occ: bool = False) -> jnp.ndarray:
    """(B, N, 4) -> (B, Xn, Yn, Zn+2). Optional (B, Xn, Yn, 2) host aux.

    ``return_occ``: also return the (B, Xn, Yn) occupancy mass for the
    empty-anchor filter (see :func:`lidar_to_top`)."""
    fn = partial(lidar_to_top, cfg=cfg, return_occ=return_occ)
    args = [points]
    in_axes = [0]
    kw = {}
    if num_points is not None:
        args.append(num_points)
        in_axes.append(0)
        kw["num"] = len(args) - 1
    if aux is not None:
        args.append(aux)
        in_axes.append(0)
        kw["aux"] = len(args) - 1

    def call(*a):
        return fn(a[0],
                  num_points=a[kw["num"]] if "num" in kw else None,
                  aux=a[kw["aux"]] if "aux" in kw else None)

    return jax.vmap(call, in_axes=tuple(in_axes))(*args)


def lidar_to_front_batch(points: jnp.ndarray, cfg: Config = _default_cfg,
                         num_points: Optional[jnp.ndarray] = None) -> jnp.ndarray:
    """(B, N, 4) -> (B, width, height, 3)."""
    fn = partial(lidar_to_front, cfg=cfg)
    if num_points is None:
        return jax.vmap(lambda p: fn(p))(points)
    return jax.vmap(lambda p, m: fn(p, num_points=m))(points, num_points)


def pad_points(points, max_points: int) -> Tuple[jnp.ndarray, int]:
    """Pad/truncate an (N, 4) host point cloud to (max_points, 4).

    Padding rows are placed far outside every crop bound so they are inert even
    without an explicit ``num_points`` mask.
    """
    import numpy as np
    n = min(len(points), max_points)
    out = np.full((max_points, 4), -1e9, dtype=np.float32)
    out[:n] = points[:n]
    return out, n
