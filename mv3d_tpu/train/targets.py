"""In-graph RPN / fusion target assignment (padded, masked, PRNG-sampled).

In-graph replacements for the host-side numpy target ops that force the
reference to split every training step into two ``sess.run`` calls with CPU
work in between (SURVEY.md §3.2):

  * ``rpn_target``    (reference src/net/rpn_target_op.py:120-200)
  * ``fusion_target`` (reference src/net/rcnn_target_op.py:77-133)

Design notes:
  * dynamic index lists become fixed-size masks/slots;
  * ``np.random.choice`` subsampling becomes rank-by-uniform-noise selection
    with ``jax.random`` — identical in distribution (uniform without
    replacement), deterministic given the PRNG key;
  * the reference's "anchor achieving a gt's max overlap is positive" rule is
    implemented per-gt-column (the standard Faster-RCNN rule); the reference
    matches max values across the whole matrix (rpn_target_op.py:157-167),
    which differs only on exact float collisions between unrelated pairs.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import Config, cfg as _default_cfg
from ..ops import boxes as box_ops
from ..ops import boxes3d as box3d_ops


def _rank_among(mask: jnp.ndarray, noise: jnp.ndarray) -> jnp.ndarray:
    """Rank (0-based, by descending noise) of each element within ``mask``.

    Elements outside the mask get a rank of len(mask) (never selected).
    """
    n = mask.shape[0]
    keyed = jnp.where(mask, noise, -jnp.inf)
    order = jnp.argsort(-keyed)                   # masked entries sort last
    ranks = jnp.zeros(n, jnp.int32).at[order].set(jnp.arange(n, dtype=jnp.int32))
    return jnp.where(mask, ranks, n)


class RpnTargets(NamedTuple):
    cls_mask: jnp.ndarray   # (A,) bool — sampled (pos or neg) anchors
    labels: jnp.ndarray     # (A,) int32 — 0/1 where cls_mask
    pos_mask: jnp.ndarray   # (A,) bool — sampled positive anchors
    targets: jnp.ndarray    # (A, 4) f32 — regression targets (valid at pos)


def rpn_target(anchors: jnp.ndarray, inside_mask: jnp.ndarray,
               gt_boxes: jnp.ndarray, gt_labels: jnp.ndarray,
               gt_mask: jnp.ndarray, key: jax.Array,
               cfg: Config = _default_cfg) -> RpnTargets:
    """Assign RPN training targets over the dense anchor set.

    Args:
      anchors: (A, 4) static anchors (float or int).
      inside_mask: (A,) bool — anchors eligible for sampling (non-empty filter).
      gt_boxes: (G, 4) padded top-view gt boxes.
      gt_labels: (G,) int32 class labels (1 = positive class).
      gt_mask: (G,) bool validity of gt rows.
    """
    r = cfg.rpn
    A = anchors.shape[0]
    anchors_f = anchors.astype(jnp.float32)

    # only positive-class gt participate (rpn_target_op.py:139)
    gt_ok = gt_mask & (gt_labels == 1)

    ov = box_ops.bbox_overlaps(anchors_f, gt_boxes)            # (A, G)
    ov = jnp.where(gt_ok[None, :], ov, -1.0)
    max_ov = jnp.max(ov, axis=1)
    argmax = jnp.argmax(ov, axis=1)

    # per-gt best anchors (ties included) are forced positive
    gt_max = jnp.max(jnp.where(inside_mask[:, None], ov, -1.0), axis=0)  # (G,)
    force_pos = jnp.any((ov == gt_max[None, :]) & (gt_max[None, :] > 0.0)
                        & gt_ok[None, :], axis=1)

    neg = inside_mask & (max_ov >= 0.0) & (max_ov < r.bg_thresh_hi)
    pos = inside_mask & (force_pos | (max_ov >= r.fg_thresh_lo))
    neg = neg & ~pos

    # subsample: at most fg_fraction*batch positives, fill the rest with
    # negatives (rpn_target_op.py:174-187)
    k_pos, k_neg = jax.random.split(key)
    num_fg_cap = int(r.fg_fraction * r.batch_size)
    pos_rank = _rank_among(pos, jax.random.uniform(k_pos, (A,)))
    pos_keep = pos & (pos_rank < num_fg_cap)
    num_fg = jnp.sum(pos_keep)

    neg_quota = r.batch_size - num_fg
    neg_rank = _rank_among(neg, jax.random.uniform(k_neg, (A,)))
    neg_keep = neg & (neg_rank < neg_quota)

    labels = jnp.where(pos_keep, 1, 0).astype(jnp.int32)
    targets = box_ops.box_transform(anchors_f, gt_boxes[argmax])
    return RpnTargets(cls_mask=pos_keep | neg_keep, labels=labels,
                      pos_mask=pos_keep, targets=targets)


class FusionTargets(NamedTuple):
    rois: jnp.ndarray       # (R, 5) sampled rois (batch_ind, x1, y1, x2, y2)
    labels: jnp.ndarray     # (R,) int32 — 0 for background/fp slots
    targets: jnp.ndarray    # (R, 8, 3) corner-delta regression targets
    mask: jnp.ndarray       # (R,) bool — live slots
    pos_mask: jnp.ndarray   # (R,) bool — positive slots
    rois3d: jnp.ndarray     # (R, 8, 3) lifted 3D rois (for logging/projection)


def fusion_target(proposal_rois: jnp.ndarray, proposal_mask: jnp.ndarray,
                  gt_boxes: jnp.ndarray, gt_boxes3d: jnp.ndarray,
                  gt_labels: jnp.ndarray, gt_mask: jnp.ndarray,
                  key: jax.Array, cfg: Config = _default_cfg) -> FusionTargets:
    """Sample fusion-stage rois and assign 3D corner-delta targets.

    Mirrors reference ``fusion_target`` (rcnn_target_op.py:77-133): gt boxes
    are fused into the proposal set, fg = IoU >= 0.5 (capped at
    fg_fraction*batch), "fp" = IoU in [bg_lo, bg_hi] fills the remainder.
    """
    rc = cfg.rcnn
    R = rc.batch_size
    P = proposal_rois.shape[0]
    G = gt_boxes.shape[0]

    # extend proposals with gt boxes (rcnn_target_op.py:82-84)
    ext_boxes = jnp.concatenate([proposal_rois[:, 1:5], gt_boxes], axis=0)
    ext_valid = jnp.concatenate([proposal_mask, gt_mask], axis=0)
    E = P + G

    ov = box_ops.bbox_overlaps(ext_boxes, gt_boxes)            # (E, G)
    ov = jnp.where(gt_mask[None, :], ov, -1.0)
    max_ov = jnp.max(ov, axis=1)
    argmax = jnp.argmax(ov, axis=1)
    labels_g = gt_labels[argmax]

    fg = ext_valid & (max_ov >= rc.fg_thresh_lo)
    fp = ext_valid & (max_ov <= rc.bg_thresh_hi) & (max_ov >= rc.bg_thresh_lo)

    k_fg, k_fp = jax.random.split(key)
    num_fg_cap = int(round(rc.fg_fraction * R))
    fg_rank = _rank_among(fg, jax.random.uniform(k_fg, (E,)))
    fg_keep = fg & (fg_rank < num_fg_cap)

    # slot priority: selected fg in [2, 3), fp candidates in [1, 2); taking the
    # top R reproduces "all selected fg + fp fills the remaining quota"
    priority = jnp.where(fg_keep, 2.0 + jax.random.uniform(k_fg, (E,)),
                         jnp.where(fp, 1.0 + jax.random.uniform(k_fp, (E,)),
                                   -jnp.inf))
    if E < R:   # fewer candidates than roi slots: pad with dead entries
        priority = jnp.pad(priority, (0, R - E), constant_values=-jnp.inf)
    vals, idx = jax.lax.top_k(priority, R)
    idx = jnp.minimum(idx, E - 1)
    slot_valid = vals > 0.0
    slot_is_fg = vals >= 2.0

    sel_boxes = ext_boxes[idx]
    rois = jnp.concatenate([jnp.zeros((R, 1), jnp.float32), sel_boxes], axis=1)
    rois = jnp.where(slot_valid[:, None], rois, 0.0)
    labels = jnp.where(slot_is_fg & slot_valid, labels_g[idx], 0).astype(jnp.int32)

    rois3d = box3d_ops.top_box_to_box3d(sel_boxes, cfg)
    gt3d = gt_boxes3d[argmax[idx]]
    targets = box3d_ops.box3d_transform(rois3d, gt3d)
    targets = jnp.where((labels != 0)[:, None, None], targets, 0.0)

    return FusionTargets(rois=rois, labels=labels, targets=targets,
                         mask=slot_valid, pos_mask=(labels != 0) & slot_valid,
                         rois3d=rois3d)
