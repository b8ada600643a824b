"""Anchor generation and the empty-anchor filter.

Anchor machinery parity: reference ``make_bases``/``make_anchors``
(src/net/rpn_target_op.py:9-115) — these run once at setup time in numpy (the
results are static arrays baked into the jitted graph).

The empty-anchor filter replaces the reference's dedicated PyCUDA kernel
(src/net/utility/remove_empty_box_kernel.cu + remove_empty_box.py:25-47, run
on the host before *every* forward, mv3d.py:280,1139) with a 2D-cumsum
integral image + 4 gathers inside the graph: O(HW + A) instead of O(A * area),
and zero host round-trips.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, cfg as _default_cfg


# ---------------------------------------------------------------------------
# bases (numpy, setup time)
# ---------------------------------------------------------------------------

def _bases_given_ws_hs(ws, hs, cx, cy):
    ws = ws[:, None]
    hs = hs[:, None]
    return np.hstack((cx - 0.5 * (ws - 1), cy - 0.5 * (hs - 1),
                      cx + 0.5 * (ws - 1), cy + 0.5 * (hs - 1)))


def make_bases(base_size=16, ratios=(0.5, 1, 2), scales=(8, 16, 32)) -> np.ndarray:
    """Enumerate ratio x scale anchor bases around a reference box.

    Parity: reference ``make_bases`` (rpn_target_op.py:53-64).
    """
    ratios = np.asarray(ratios, dtype=np.float64)
    scales = np.asarray(scales, dtype=np.float64)
    base = np.array([1, 1, base_size, base_size], dtype=np.float64) - 1
    w = base[2] - base[0] + 1
    h = base[3] - base[1] + 1
    cx = base[0] + 0.5 * (w - 1)
    cy = base[1] + 0.5 * (h - 1)
    size = w * h
    ws_r = np.round(np.sqrt(size / ratios))
    hs_r = np.round(ws_r * ratios)
    ratio_bases = _bases_given_ws_hs(ws_r, hs_r, cx, cy)

    out = []
    for rb in ratio_bases:
        w = rb[2] - rb[0] + 1
        h = rb[3] - rb[1] + 1
        cx = rb[0] + 0.5 * (w - 1)
        cy = rb[1] + 0.5 * (h - 1)
        out.append(_bases_given_ws_hs(w * scales, h * scales, cx, cy))
    return np.vstack(out)


def mv3d_car_bases() -> np.ndarray:
    """The 4 hard-coded MV3D car bases actually used (reference mv3d.py:186-191)."""
    return np.array([
        [4.5, 2.5, 10.5, 12.5],
        [2.5, 4.5, 12.5, 10.5],
        [-0.5, -12.0, 15.5, 27.0],
        [-12.0, -0.5, 27.0, 15.5],
    ])


def make_anchors(bases: np.ndarray, stride: int,
                 image_shape: Tuple[int, int],
                 feature_shape: Tuple[int, int],
                 allowed_border: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Shift bases over the stride grid; returns (anchors (A,4) int32,
    inside_mask (A,) bool).

    Parity: reference ``make_anchors`` (rpn_target_op.py:86-115), except the
    inside set is returned as a mask rather than dynamic indices (jit-friendly).
    Note: like the reference, x spans the feature *width* (image dim 1) and y
    the *height* (image dim 0).
    """
    H, W = feature_shape
    img_height, img_width = image_shape

    shift_x = np.arange(0, W) * stride
    shift_y = np.arange(0, H) * stride
    shift_x, shift_y = np.meshgrid(shift_x, shift_y)
    shifts = np.vstack((shift_x.ravel(), shift_y.ravel(),
                        shift_x.ravel(), shift_y.ravel())).transpose()

    B = len(bases)
    HW = len(shifts)
    anchors = (bases.reshape((1, B, 4)) +
               shifts.reshape((1, HW, 4)).transpose((1, 0, 2)))
    anchors = anchors.reshape((HW * B, 4)).astype(np.int32)

    inside = ((anchors[:, 0] >= -allowed_border) &
              (anchors[:, 1] >= -allowed_border) &
              (anchors[:, 2] < img_width + allowed_border) &
              (anchors[:, 3] < img_height + allowed_border))
    return anchors, inside


# ---------------------------------------------------------------------------
# empty-anchor filter (in-graph)
# ---------------------------------------------------------------------------

def non_empty_anchor_mask(top_view: jnp.ndarray, anchors: jnp.ndarray,
                          threshold: float = 0.0) -> jnp.ndarray:
    """Mask of anchors whose footprint on the BEV map has mass > threshold.

    Replaces the reference PyCUDA ``remove_empty`` kernel
    (remove_empty_box_kernel.cu:12-42): the kernel sums
    ``view[y1:y2, x1:x2, :]`` (box coords (x1,y1,x2,y2) with y indexing view
    rows; bounds exclusive at the top; each coordinate clamped into
    [0, dim-1]) and keeps anchors with ``sum > threshold``
    (remove_empty_box.py:46-47).

    Implemented with an integral image (exclusive 2D cumsum) + 4 gathers.

    Args:
      top_view: (H, W, C) BEV map.
      anchors: (A, 4) int32 (x1, y1, x2, y2) with x across W, y across H.
    Returns:
      (A,) bool mask.
    """
    h, w = top_view.shape[0], top_view.shape[1]
    occ = jnp.sum(top_view, axis=-1)
    # exclusive-prefix integral image: S[i, j] = sum(occ[:i, :j])
    s = jnp.pad(jnp.cumsum(jnp.cumsum(occ, axis=0), axis=1),
                ((1, 0), (1, 0)))

    # the CUDA wrapper clamps every coordinate into [0, dim-1]
    x1 = jnp.clip(anchors[:, 0], 0, w - 1)
    y1 = jnp.clip(anchors[:, 1], 0, h - 1)
    x2 = jnp.clip(anchors[:, 2], 0, w - 1)
    y2 = jnp.clip(anchors[:, 3], 0, h - 1)
    # empty rect when x2<=x1 or y2<=y1 (kernel loops over x2-x1, y2-y1 lines)
    x2 = jnp.maximum(x2, x1)
    y2 = jnp.maximum(y2, y1)

    rect = (s[y2, x2] - s[y1, x2] - s[y2, x1] + s[y1, x1])
    return rect > threshold


def _interval_matrix(lo: np.ndarray, hi: np.ndarray, dim: int) -> np.ndarray:
    """(G, dim) 0/1 matrix; row g selects indices lo[g] <= i < hi[g]."""
    i = np.arange(dim)
    return ((i[None, :] >= lo[:, None]) &
            (i[None, :] < hi[:, None])).astype(np.float32)


def non_empty_anchor_mask_structured(top_view: jnp.ndarray, bases: np.ndarray,
                                     stride: int,
                                     feature_shape: Tuple[int, int],
                                     threshold: float = 0.0,
                                     mode: str = "window",
                                     occ: jnp.ndarray = None) -> jnp.ndarray:
    """Gather-free empty-anchor filter for base+stride anchor grids.

    Same semantics as :func:`non_empty_anchor_mask`, exploiting that anchors
    are ``base + stride * grid`` (ops/anchors.make_anchors).

    ``mode="window"`` (default): the clamped rect sum
    equals a ZERO-PADDED sliding-window sum once the last row/col of the
    occupancy map are zeroed (the reference's corner clamp into [0, dim-1]
    with an exclusive upper bound excludes row h-1 / col w-1 exactly when
    the window sticks out — which is exactly what the zeroed border + plain
    interval intersection reproduces). Two separable ``lax.reduce_window``
    sum passes per base (window (dy,1) stride (s,1), then (1,dx) stride
    (1,s)) with negative padding aligning output 0 to the base corner — a
    pooling pattern, no integral image, no strided slices, no large
    constants.

    ``mode="rect-matmul"``: the interval-matrix formulation
    (R_b @ occ @ C_b^T), kept as a cross-check.

    ``mode="integral"``: the round-1 formulation — exclusive 2D cumsum
    integral image, edge-replicated pad, 4 stride-``stride`` corner slices
    per base. Kept as the parity cross-check.

    f32 note: window/rect-matmul accumulate each rect directly (no
    inclusion-exclusion cancellation), so they are at least as accurate as
    the integral path; all compare against ``threshold`` identically on
    the oracle tests.

    Returns the (A,) mask in make_anchors' flat order (grid-major,
    base-minor).
    """
    h, w = top_view.shape[0], top_view.shape[1]
    gh, gw = feature_shape
    if occ is None:
        # a reduction over the whole view: callers on the hot path pass the
        # voxelizer's ``return_occ`` output instead
        occ = jnp.sum(top_view, axis=-1)
    masks = []

    if mode == "window":
        # zero the clamp-excluded border, then per base: two separable
        # window-sum passes whose negative low padding aligns output 0 with
        # the base corner (reduce_window crops on negative padding)
        occ_z = occ.at[h - 1, :].set(0.0).at[:, w - 1].set(0.0)
        for b in bases:
            x1, y1, x2, y2 = (int(b[0]), int(b[1]), int(b[2]), int(b[3]))
            if y2 <= y1 or x2 <= x1:     # degenerate base: empty rect
                masks.append(jnp.zeros((gh, gw), bool))
                continue
            dy, dx = y2 - y1, x2 - x1
            pad_y = (-y1, y1 + (gh - 1) * stride + dy - h)
            pad_x = (-x1, x1 + (gw - 1) * stride + dx - w)
            rows = jax.lax.reduce_window(
                occ_z, 0.0, jax.lax.add, (dy, 1), (stride, 1),
                (pad_y, (0, 0)))                                 # (gh, w)
            rect = jax.lax.reduce_window(
                rows, 0.0, jax.lax.add, (1, dx), (1, stride),
                ((0, 0), pad_x))                                 # (gh, gw)
            masks.append(rect > threshold)
        return jnp.stack(masks, axis=-1).reshape(-1)

    if mode == "rect-matmul":
        gi = np.arange(gh) * stride
        gj = np.arange(gw) * stride
        for b in bases:
            x1, y1, x2, y2 = (int(b[0]), int(b[1]), int(b[2]), int(b[3]))
            # the CUDA wrapper clamps each corner into [0, dim-1], then the
            # exclusive-integral lookup sums y in [Y1, max(Y2, Y1))
            ylo = np.clip(y1 + gi, 0, h - 1)
            yhi = np.maximum(np.clip(y2 + gi, 0, h - 1), ylo)
            xlo = np.clip(x1 + gj, 0, w - 1)
            xhi = np.maximum(np.clip(x2 + gj, 0, w - 1), xlo)
            ry = jnp.asarray(_interval_matrix(ylo, yhi, h))      # (gh, h)
            cx = jnp.asarray(_interval_matrix(xlo, xhi, w))      # (gw, w)
            # full f32 products: a TF32 product would round the sums
            rect = jax.lax.dot_general(
                jax.lax.dot_general(ry, occ, (((1,), (0,)), ((), ())),
                                    precision="highest",
                                    preferred_element_type=jnp.float32),
                cx, (((1,), (1,)), ((), ())), precision="highest",
                preferred_element_type=jnp.float32)              # (gh, gw)
            masks.append(rect > threshold)
        return jnp.stack(masks, axis=-1).reshape(-1)

    assert mode == "integral", mode
    s = jnp.pad(jnp.cumsum(jnp.cumsum(occ, axis=0), axis=1),
                ((1, 0), (1, 0)))                       # (h+1, w+1)

    # the kernel clamps every coordinate into [0, dim-1] before reading the
    # integral image, so only s[0:h, 0:w] is ever addressed; emulate the clamp
    # with edge replication: padded index (pad + i) reads s[clip(i, 0, dim-1)]
    pad = int(np.abs(bases).max()) + stride + 2
    s_ext = jnp.pad(s[:h, :w], ((pad, pad), (pad, pad)), mode="edge")

    def corner(yo: int, xo: int):
        ys, xs = pad + yo, pad + xo
        return jax.lax.slice(
            s_ext, (ys, xs),
            (ys + (gh - 1) * stride + 1, xs + (gw - 1) * stride + 1),
            (stride, stride))

    for b in bases:
        x1, y1, x2, y2 = (int(b[0]), int(b[1]), int(b[2]), int(b[3]))
        rect = (corner(y2, x2) - corner(y1, x2) -
                corner(y2, x1) + corner(y1, x1))
        masks.append(rect > threshold)             # (gh, gw)

    # flat order: grid-major, base-minor
    return jnp.stack(masks, axis=-1).reshape(-1)


def anchor_setup(cfg: Config = _default_cfg) -> Tuple[np.ndarray, np.ndarray]:
    """Build the full static anchor set for the configured top view.

    Parity with MV3D.__init__ (mv3d.py:226-231): MV3D car bases over the
    stride-8 feature grid; the reference then overrides inside_inds with
    "use all", which we mirror by returning an all-true mask.
    """
    bases = mv3d_car_bases()
    feat = cfg.top_feature_shape()
    anchors, _ = make_anchors(bases, cfg.model.rpn_stride,
                              cfg.top.shape[:2], feat)
    inside = np.ones(len(anchors), dtype=bool)
    return anchors, inside
