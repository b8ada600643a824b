"""2D axis-aligned box geometry (pure jnp, fully vectorized, jit-safe).

In-graph equivalents of the reference numpy/cython box utilities:
  * ``box_transform`` / ``box_transform_inv``  (reference src/net/processing/boxes.py:32-84)
  * ``clip_boxes``                             (reference src/net/processing/boxes.py:15-26)
  * ``bbox_overlaps`` IoU matrix               (reference src/net/lib/utils/bbox.pyx:14-57)

All functions use the Faster-RCNN "+1" pixel box convention exactly as the
reference does, so targets/IoU values match bit-for-bit (up to f32 rounding).
"""

from __future__ import annotations

import jax.numpy as jnp


def box_transform(et_boxes: jnp.ndarray, gt_boxes: jnp.ndarray) -> jnp.ndarray:
    """Encode gt boxes as (dx, dy, dw, dh) deltas wrt estimated boxes.

    Parity: reference ``box_transform`` (src/net/processing/boxes.py:32-49).
    Shapes: (N, 4) x (N, 4) -> (N, 4).
    """
    et_ws = et_boxes[..., 2] - et_boxes[..., 0] + 1.0
    et_hs = et_boxes[..., 3] - et_boxes[..., 1] + 1.0
    et_cxs = et_boxes[..., 0] + 0.5 * et_ws
    et_cys = et_boxes[..., 1] + 0.5 * et_hs

    gt_ws = gt_boxes[..., 2] - gt_boxes[..., 0] + 1.0
    gt_hs = gt_boxes[..., 3] - gt_boxes[..., 1] + 1.0
    gt_cxs = gt_boxes[..., 0] + 0.5 * gt_ws
    gt_cys = gt_boxes[..., 1] + 0.5 * gt_hs

    dxs = (gt_cxs - et_cxs) / et_ws
    dys = (gt_cys - et_cys) / et_hs
    dws = jnp.log(gt_ws / et_ws)
    dhs = jnp.log(gt_hs / et_hs)
    return jnp.stack([dxs, dys, dws, dhs], axis=-1)


def box_transform_inv(et_boxes: jnp.ndarray, deltas: jnp.ndarray) -> jnp.ndarray:
    """Apply (dx, dy, dw, dh) deltas to boxes.

    Parity: reference ``box_transform_inv`` (src/net/processing/boxes.py:53-84).
    Shapes: (N, 4) x (N, 4) -> (N, 4).
    """
    et_ws = et_boxes[..., 2] - et_boxes[..., 0] + 1.0
    et_hs = et_boxes[..., 3] - et_boxes[..., 1] + 1.0
    et_cxs = et_boxes[..., 0] + 0.5 * et_ws
    et_cys = et_boxes[..., 1] + 0.5 * et_hs

    cxs = deltas[..., 0] * et_ws + et_cxs
    cys = deltas[..., 1] * et_hs + et_cys
    ws = jnp.exp(deltas[..., 2]) * et_ws
    hs = jnp.exp(deltas[..., 3]) * et_hs

    return jnp.stack([cxs - 0.5 * ws, cys - 0.5 * hs,
                      cxs + 0.5 * ws, cys + 0.5 * hs], axis=-1)


def clip_boxes(boxes: jnp.ndarray, width: float, height: float) -> jnp.ndarray:
    """Clip boxes to [0, width-1] x [0, height-1].

    Parity: reference ``clip_boxes`` (src/net/processing/boxes.py:15-26).
    """
    x1 = jnp.clip(boxes[..., 0], 0.0, width - 1.0)
    y1 = jnp.clip(boxes[..., 1], 0.0, height - 1.0)
    x2 = jnp.clip(boxes[..., 2], 0.0, width - 1.0)
    y2 = jnp.clip(boxes[..., 3], 0.0, height - 1.0)
    return jnp.stack([x1, y1, x2, y2], axis=-1)


def box_areas(boxes: jnp.ndarray) -> jnp.ndarray:
    """Pixel-convention area (w+1)*(h+1)."""
    return ((boxes[..., 2] - boxes[..., 0] + 1.0) *
            (boxes[..., 3] - boxes[..., 1] + 1.0))


def bbox_overlaps(boxes: jnp.ndarray, query_boxes: jnp.ndarray) -> jnp.ndarray:
    """Dense (N, K) IoU matrix in the "+1" pixel convention.

    Vectorized jnp replacement of the cython ``bbox_overlaps``
    (reference src/net/lib/utils/bbox.pyx:14-57); runs elementwise
    entirely in-graph — no host round trip.
    """
    b = boxes[:, None, :]       # (N, 1, 4)
    q = query_boxes[None, :, :]  # (1, K, 4)
    iw = (jnp.minimum(b[..., 2], q[..., 2]) -
          jnp.maximum(b[..., 0], q[..., 0]) + 1.0)
    ih = (jnp.minimum(b[..., 3], q[..., 3]) -
          jnp.maximum(b[..., 1], q[..., 1]) + 1.0)
    iw = jnp.maximum(iw, 0.0)
    ih = jnp.maximum(ih, 0.0)
    inter = iw * ih
    area_b = box_areas(boxes)[:, None]
    area_q = box_areas(query_boxes)[None, :]
    union = area_b + area_q - inter
    return jnp.where(union > 0, inter / union, 0.0)


def filter_boxes_mask(boxes: jnp.ndarray, min_size: float) -> jnp.ndarray:
    """Mask of boxes with both sides >= min_size.

    Parity: reference ``filter_boxes`` (src/net/rpn_nms_op.py:73-78), returned
    as a mask instead of dynamic indices (jit-friendly).
    """
    ws = boxes[..., 2] - boxes[..., 0] + 1.0
    hs = boxes[..., 3] - boxes[..., 1] + 1.0
    return (ws >= min_size) & (hs >= min_size)
