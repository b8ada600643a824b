"""In-graph greedy non-max suppression on fixed-size, masked arrays.

Replaces the reference's host/CUDA NMS zoo — cython ``cpu_nms``
(src/net/lib/nms/cpu_nms.pyx), bitmask CUDA ``gpu_nms``
(src/net/lib/nms/nms_kernel.cu) and the ``tf.py_func`` escape hatch that pulls
proposal NMS onto the host mid-graph (src/net/rpn_nms_op.py:150-165) — with a
jit-safe masked implementation: sort once, then ``max_out`` sequential
pick-and-suppress steps over the fixed candidate set (O(max_out * K) VPU work,
no data-dependent shapes).

Suppression rule parity: IoU in the "+1" pixel convention, suppress when
``iou > threshold`` (strict), identical to cpu_nms.pyx:45-63.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

NEG_INF = -1e30


def greedy_nms(boxes: jnp.ndarray, scores: jnp.ndarray, valid: jnp.ndarray,
               iou_threshold: float, max_out: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Greedy NMS over a fixed-size candidate set.

    Args:
      boxes:  (K, 4) candidate boxes (x1, y1, x2, y2).
      scores: (K,) candidate scores.
      valid:  (K,) bool mask of live candidates.
      iou_threshold: suppress candidates with IoU > threshold vs a kept box.
      max_out: number of output slots (static).

    Returns:
      keep_idx:  (max_out,) int32 indices into the candidate set, in
                 descending-score order (garbage where keep_mask is False).
      keep_mask: (max_out,) bool — which output slots hold real detections.
    """
    k = boxes.shape[0]
    # Division-free pairwise suppression matrix: iou > t  <=>
    # inter * (1 + t) > t * (area_i + area_j)  (union = a_i + a_j - inter
    # >= 1 in the +1 pixel convention, so the rearrangement is sign-safe).
    # Same suppression rule as cpu_nms.pyx:45-63 without the per-pair f32
    # divide, and the bool matrix moves 1/4 the bytes of an f32 one.
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    area = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    iw = (jnp.minimum(x2[:, None], x2[None, :])
          - jnp.maximum(x1[:, None], x1[None, :]) + 1.0)
    ih = (jnp.minimum(y2[:, None], y2[None, :])
          - jnp.maximum(y1[:, None], y1[None, :]) + 1.0)
    inter = jnp.clip(iw, 0.0) * jnp.clip(ih, 0.0)
    t = jnp.float32(iou_threshold)
    suppress_mat = inter * (1.0 + t) > t * (area[:, None] + area[None, :])
    # materialize the bool matrix ONCE: without the barrier XLA sinks the
    # row computation into the loop and recomputes it every iteration
    # (traced at 120 us/frame of per-iteration multiply_compare fusions vs
    # ~25 us to write the (K, K) bool matrix up front)
    suppress_mat = jax.lax.optimization_barrier(suppress_mat)
    live_scores = jnp.where(valid, scores, NEG_INF)

    def body(_, state):
        live, keep_idx, keep_mask, slot = state
        best = jnp.argmax(live)
        ok = live[best] > NEG_INF / 2
        keep_idx = keep_idx.at[slot].set(jnp.int32(best))
        keep_mask = keep_mask.at[slot].set(ok)
        # suppress the pick itself and everything overlapping it
        suppress = suppress_mat[best] | (jnp.arange(k) == best)
        live = jnp.where(ok & suppress, NEG_INF, live)
        return live, keep_idx, keep_mask, slot + 1

    init = (live_scores,
            jnp.zeros(max_out, jnp.int32),
            jnp.zeros(max_out, bool),
            jnp.int32(0))
    _, keep_idx, keep_mask, _ = jax.lax.fori_loop(0, max_out, body, init)
    return keep_idx, keep_mask


def nms_select(boxes: jnp.ndarray, scores: jnp.ndarray, valid: jnp.ndarray,
               iou_threshold: float, max_out: int
               ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Greedy NMS returning gathered (boxes, scores, mask) of size max_out."""
    keep_idx, keep_mask = greedy_nms(boxes, scores, valid, iou_threshold, max_out)
    return boxes[keep_idx], jnp.where(keep_mask, scores[keep_idx], 0.0), keep_mask


def box_vote(nms_dets, all_dets):
    """Box voting: refine each NMS survivor by the score-weighted average of
    all boxes overlapping it with IoU >= 0.5.

    Host-side numpy utility (parity: reference ``box_vote``,
    src/net/lib/utils/bbox.pyx:96-143). dets are (K, 5) [x1,y1,x2,y2,score].
    """
    import numpy as np
    nms_dets = np.asarray(nms_dets, np.float32)
    all_dets = np.asarray(all_dets, np.float32)
    out = nms_dets.copy()
    if len(all_dets) == 0:
        return out
    areas = ((all_dets[:, 2] - all_dets[:, 0] + 1) *
             (all_dets[:, 3] - all_dets[:, 1] + 1))
    for i, det in enumerate(nms_dets):
        iw = (np.minimum(det[2], all_dets[:, 2]) -
              np.maximum(det[0], all_dets[:, 0]) + 1)
        ih = (np.minimum(det[3], all_dets[:, 3]) -
              np.maximum(det[1], all_dets[:, 1]) + 1)
        inter = np.clip(iw, 0, None) * np.clip(ih, 0, None)
        a = (det[2] - det[0] + 1) * (det[3] - det[1] + 1)
        iou = inter / (a + areas - inter)
        sel = iou >= 0.5
        w = all_dets[sel, 4]
        out[i, :4] = (w[:, None] * all_dets[sel, :4]).sum(0) / max(w.sum(), 1e-12)
    return out


def greedy_nms_np(boxes, scores, iou_threshold):
    """Pure-numpy greedy NMS — host-side twin of :func:`greedy_nms`.

    Same pick order (stable descending score, lowest index wins ties, like
    jnp.argmax) and the same division-free strict suppression rule
    ``inter * (1 + t) > t * (area_i + area_j)``, so the keep-set matches the
    in-graph kernel bit-for-bit on float32 inputs (tests/test_ops.py asserts
    this). Exists because calling the jitted kernel with ``max_out =
    len(candidates)`` retraces per distinct candidate count — a recompile
    storm when host tooling loops it per frame.

    Returns keep indices (int64 array, descending-score order).
    """
    import numpy as np
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    x1, y1, x2, y2 = boxes[:, 0], boxes[:, 1], boxes[:, 2], boxes[:, 3]
    areas = (x2 - x1 + 1.0) * (y2 - y1 + 1.0)
    t = np.float32(iou_threshold)
    order = np.argsort(-scores, kind="stable")
    keep = []
    while order.size:
        i = order[0]
        keep.append(i)
        rest = order[1:]
        iw = np.minimum(x2[i], x2[rest]) - np.maximum(x1[i], x1[rest]) + 1.0
        ih = np.minimum(y2[i], y2[rest]) - np.maximum(y1[i], y1[rest]) + 1.0
        inter = np.clip(iw, 0.0, None) * np.clip(ih, 0.0, None)
        suppress = inter * (1.0 + t) > t * (areas[i] + areas[rest])
        order = rest[~suppress]
    return np.asarray(keep, np.int64)


def non_max_suppress(boxes, scores, num_classes, nms_after_thresh=0.3,
                     nms_before_score_thresh=0.05, is_box_vote=False,
                     max_per_image=100):
    """Multi-class host-side NMS with optional box voting and a global
    per-image detection cap.

    Parity: reference ``non_max_suppress`` (src/net/processing/boxes.py:
    87-128): per class (skipping background), score-gate, greedy NMS,
    optional box_vote, then keep the top max_per_image detections overall.

    Args:
      boxes:  (N, num_classes*4) per-class boxes.
      scores: (N, num_classes) per-class scores.
    Returns: list of per-class (K_c, 5) [x1,y1,x2,y2,score] arrays (index 0 =
      background, empty).
    """
    import numpy as np
    boxes = np.asarray(boxes, np.float32)
    scores = np.asarray(scores, np.float32)
    nms_boxes = [np.zeros((0, 5), np.float32) for _ in range(num_classes)]
    for j in range(1, num_classes):
        inds = np.where(scores[:, j] > nms_before_score_thresh)[0]
        cls_scores = scores[inds, j]
        cls_boxes = boxes[inds, j * 4:(j + 1) * 4]
        cls_dets = np.hstack([cls_boxes, cls_scores[:, None]])
        if len(inds):
            keep = greedy_nms_np(cls_boxes, cls_scores, nms_after_thresh)
            kept = cls_dets[keep]
            cls_dets = box_vote(kept, cls_dets) if is_box_vote else kept
        nms_boxes[j] = cls_dets

    if max_per_image > 0:
        all_scores = np.hstack([nms_boxes[j][:, -1]
                                for j in range(1, num_classes)])
        if len(all_scores) > max_per_image:
            thresh = np.sort(all_scores)[-max_per_image]
            for j in range(1, num_classes):
                keep = nms_boxes[j][:, -1] >= thresh
                nms_boxes[j] = nms_boxes[j][keep]
    return nms_boxes
