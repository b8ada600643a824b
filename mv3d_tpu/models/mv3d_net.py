"""MV3DNet — the assembled multi-view detector and its jit-able pipelines.

The reference builds one giant TF-1 placeholder graph (``mv3d_net.load``,
reference src/mv3d_net.py:761-1066) and then stitches training steps together
on the *host*: a PyCUDA anchor filter, numpy target ops and a py_func NMS
between two ``sess.run`` calls (SURVEY.md §3.2 — ≥3 device crossings/step).

Here the entire step is one XLA program:

    views -> trunks -> RPN -> (in-graph) anchor filter -> proposals/NMS
          -> (in-graph) target sampling -> ROI align -> fusion head
          -> losses | detections

Per-frame stages are ``vmap``-ed over the batch; the model is batched natively.
Parameters live in a dict keyed by subnet name (``top_view_rpn`` /
``image_feature`` / ``front_feature`` / ``fusion``) to support the reference's
staged-training and mix-and-match per-subnet checkpointing (mv3d.py:117-161).
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config, cfg as _default_cfg
from ..ops import boxes3d as box3d_ops
from ..ops.anchors import (anchor_setup,
                           non_empty_anchor_mask_structured)
from ..ops.detect import Detections, rcnn_nms
from ..ops.proposal import Proposals, rpn_proposals
from ..ops.roi_align import roi_align, roi_align_matmul
from ..train import losses as loss_lib
from ..train import targets as target_lib
from .nets import (FRONT_FEATURE, FUSION, IMAGE_FEATURE, SUBNET_NAMES,
                   TOP_VIEW_RPN, FrontFeatureNet, FusionHead, RgbFeatureNet,
                   TopRPN)


# ---------------------------------------------------------------------------
# roi projections (in-graph equivalents of mv3d.py:60-114)
# ---------------------------------------------------------------------------

def project_to_rgb_roi(rois3d: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """(R, 8, 3) -> (R, 4) enveloping image-space boxes.

    Parity: reference ``project_to_rgb_roi`` (mv3d.py:77-89)."""
    proj = box3d_ops.box3d_to_rgb_box(rois3d, cfg).astype(jnp.float32)
    return jnp.stack([
        jnp.min(proj[..., 0], axis=-1), jnp.min(proj[..., 1], axis=-1),
        jnp.max(proj[..., 0], axis=-1), jnp.max(proj[..., 1], axis=-1)],
        axis=-1)


def enlarge_rois(rois: jnp.ndarray, ratio: float) -> jnp.ndarray:
    """Scale (R, 4) boxes about their centers (parity: fusion_net's
    enlarge_roi, mv3d_net.py:536-552)."""
    cx = (rois[..., 0] + rois[..., 2]) / 2.0
    cy = (rois[..., 1] + rois[..., 3]) / 2.0
    w = (rois[..., 2] - rois[..., 0]) * ratio
    h = (rois[..., 3] - rois[..., 1]) * ratio
    return jnp.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=-1)


def project_to_front_roi(rois3d: jnp.ndarray, cfg: Config) -> jnp.ndarray:
    """(R, 8, 3) -> (R, 4) front-view boxes as (r1, c1, r2, c2).

    The reference's version (mv3d.py:91-114) uses drawing coordinates with a
    legacy ``/2`` and feeds (c, r) into the ROI pool, whose "x" is the *other*
    view axis — a latent bug in the (deprecated) front path. We project with
    the voxelizer's own pixel mapping so the ROI aligns with the front feature
    map: x spans the vertical axis (dim 1, size front.height) and y spans the
    azimuth axis (dim 0, size front.width).
    """
    f = cfg.front
    c = jnp.trunc(jnp.arctan2(rois3d[..., 1], rois3d[..., 0])
                  / f.angular_res) + f.c_offset
    r = jnp.trunc(jnp.arctan2(
        rois3d[..., 2],
        jnp.sqrt(rois3d[..., 0] ** 2 + rois3d[..., 1] ** 2))
        / f.vertical_res) + f.r_offset
    return jnp.stack([
        jnp.min(r, axis=-1), jnp.min(c, axis=-1),
        jnp.max(r, axis=-1), jnp.max(c, axis=-1)], axis=-1).astype(jnp.float32)


# ---------------------------------------------------------------------------
# the assembled model
# ---------------------------------------------------------------------------

class MV3DNet:
    """Owns the four subnet modules, static anchors, and pipeline functions."""

    def __init__(self, cfg: Config = _default_cfg):
        self.cfg = cfg
        dtype = (jnp.bfloat16 if cfg.model.compute_dtype == "bfloat16"
                 else jnp.float32)
        self.dtype = dtype
        m = cfg.model
        s2d_top = 2 if m.stem_space_to_depth else 0
        s2d_rgb = 4 if m.stem_space_to_depth else 0
        reps = tuple(m.backbone_repetitions)
        assert m.rpn_stride == 4 * 2 ** (len(reps) - 1), \
            ("backbone_repetitions implies stride 4*2^(len-1); set "
             "model.rpn_stride to match", reps, m.rpn_stride)
        self.top_rpn = TopRPN(num_bases=len(m.bases), dtype=dtype,
                              upsample=m.upsample_features, s2d_factor=s2d_top,
                              block=m.backbone_block, repetitions=reps,
                              quant=m.quant)
        self.rgb_net = RgbFeatureNet(dtype=dtype, upsample=m.upsample_features,
                                     s2d_factor=s2d_rgb,
                                     basenet=m.rgb_basenet,
                                     block=m.backbone_block, repetitions=reps,
                                     quant=m.quant)
        self.front_net = FrontFeatureNet(dtype=dtype,
                                         upsample=m.upsample_features,
                                         s2d_factor=s2d_top,
                                         block=m.backbone_block,
                                         repetitions=reps,
                                         quant=m.quant)
        self.fusion = FusionHead(cfg=cfg, dtype=dtype)
        anchors_np, _ = anchor_setup(cfg)
        self.anchors = jnp.asarray(anchors_np)
        self._bases_np = np.asarray(cfg.model.bases)
        self._feat_shape = cfg.top_feature_shape()

        m = cfg.model
        self.views = ["top"]
        if m.use_front and not m.use_top_only:
            self.views.append("front")
        if not m.use_top_only:
            self.views.append("rgb")

    # -- init ---------------------------------------------------------------

    def init_variables(self, key: jax.Array) -> Dict[str, Any]:
        """Initialize all subnet variables with correctly shaped dummies."""
        cfg = self.cfg
        k1, k2, k3, k4 = jax.random.split(key, 4)
        top = jnp.zeros((1, *cfg.top_shape), jnp.float32)
        rgb = jnp.zeros((1, *cfg.rgb_shape), jnp.float32)
        front = jnp.zeros((1, *cfg.front_shape), jnp.float32)

        variables = {TOP_VIEW_RPN: self.top_rpn.init(k1, top)}
        variables[IMAGE_FEATURE] = self.rgb_net.init(k2, rgb)
        variables[FRONT_FEATURE] = self.front_net.init(k3, front)

        ph, pw = cfg.model.roi_pool_size
        roi_feats = {v: jnp.zeros((2, ph, pw, 128), jnp.float32)
                     for v in self.views}
        if cfg.model.use_siamese_fusion:
            roi_feats.update({v + "_ctx": jnp.zeros((2, ph, pw, 128),
                                                    jnp.float32)
                              for v in self.views})
        variables[FUSION] = self.fusion.init(k4, roi_feats)
        return jax.tree.map(lambda x: x, variables)   # plain dict copy

    def anchor_mask(self, top_view_frame: jnp.ndarray,
                    occ: jnp.ndarray = None) -> jnp.ndarray:
        """In-graph empty-anchor filter for one frame (separable
        reduce_window formulation — the anchors are a static base+stride
        grid). Pass ``occ`` (the voxelizer's ``return_occ`` output) to avoid
        re-deriving the channel sum from the assembled view, a reduction
        over the whole height volume."""
        cfg = self.cfg
        return non_empty_anchor_mask_structured(
            top_view_frame, self._bases_np, cfg.model.rpn_stride,
            self._feat_shape, cfg.pipeline.remove_empty_thresh, occ=occ)

    # -- feature extraction ---------------------------------------------------

    def _apply(self, module, variables, *args, train: bool):
        if train:
            def fwd(v, *a):
                return module.apply(v, *a, True, mutable=["batch_stats"])
            if self.cfg.train.remat:
                # rematerialize the trunk in the backward pass: only
                # (variables, inputs) are saved, the full-resolution conv
                # activations are recomputed — the standard XLA trade of one
                # extra forward for the dominant training HBM cost
                fwd = jax.checkpoint(fwd)
            return fwd(variables, *args)
        return module.apply(variables, *args, False), None

    def extract_features(self, variables, top, rgb, front, train=False):
        """Run the three trunks; returns (outputs, batch_stats updates)."""
        rpn_out, up1 = self._apply(self.top_rpn, variables[TOP_VIEW_RPN],
                                   top, train=train)
        out = {"rpn": rpn_out}
        updates = {TOP_VIEW_RPN: up1}
        if "rgb" in self.views:
            out["rgb_features"], updates[IMAGE_FEATURE] = self._apply(
                self.rgb_net, variables[IMAGE_FEATURE], rgb, train=train)
        if "front" in self.views:
            out["front_features"], updates[FRONT_FEATURE] = self._apply(
                self.front_net, variables[FRONT_FEATURE], front, train=train)
        return out, updates

    # -- roi pooling ----------------------------------------------------------

    def pool_rois(self, feats: Dict[str, jnp.ndarray], rois3d: jnp.ndarray,
                  top_rois: jnp.ndarray) -> Dict[str, jnp.ndarray]:
        """Per-frame multi-view ROI align. All inputs are single-frame.

        Args:
          feats: view name -> (H, W, C) feature map.
          rois3d: (R, 8, 3) lifted rois.
          top_rois: (R, 4) top-view boxes (x1, y1, x2, y2).
        """
        cfg = self.cfg
        m = cfg.model
        pooled = m.roi_pool_size
        align = (roi_align_matmul if m.roi_align_impl == "matmul"
                 else roi_align)

        def pool(name, rois):
            out = {name: align(feats[name], rois,
                               1.0 / m.pool_stride(name), pooled)}
            if m.use_siamese_fusion:
                out[name + "_ctx"] = align(
                    feats[name], enlarge_rois(rois, m.roi_enlarge_ratio),
                    1.0 / m.pool_stride(name), pooled)
            return out

        out = pool("top", top_rois)
        if "rgb" in self.views:
            out.update(pool("rgb", project_to_rgb_roi(rois3d, cfg)))
        if "front" in self.views:
            out.update(pool("front", project_to_front_roi(rois3d, cfg)))
        return out

    # -- inference ------------------------------------------------------------

    def forward_inference(self, variables, top, rgb, front,
                          score_threshold: Optional[float] = None,
                          nms_thresh: Optional[float] = None,
                          top_occ: Optional[jnp.ndarray] = None
                          ) -> Tuple[Detections, Proposals]:
        """Batched views -> final 3D detections. Pure function of variables.

        Equivalent of reference ``MV3D.predict`` (mv3d.py:272-328) minus the
        host round-trips. ``top_occ``: optional (B, H, W) occupancy mass from
        the voxelizer's ``return_occ`` (avoids re-materializing the view for
        the anchor filter — see anchor_mask).
        """
        cfg = self.cfg
        outs, _ = self.extract_features(variables, top, rgb, front, train=False)
        rpn = outs["rpn"]

        def per_frame(top_i, occ_i, scores_i, deltas_i, feat_top_i,
                      feat_rgb_i, feat_front_i):
            inside = self.anchor_mask(top_i, occ=occ_i)
            props = rpn_proposals(scores_i, deltas_i, self.anchors, inside,
                                  cfg, nms_thresh=nms_thresh)
            rois3d = box3d_ops.top_box_to_box3d(props.rois[:, 1:5], cfg)
            feats = {"top": feat_top_i}
            if feat_rgb_i is not None:
                feats["rgb"] = feat_rgb_i
            if feat_front_i is not None:
                feats["front"] = feat_front_i
            pooled = self.pool_rois(feats, rois3d, props.rois[:, 1:5])
            return props, rois3d, pooled

        frgb = outs.get("rgb_features")
        ffront = outs.get("front_features")
        in_axes = (0, 0 if top_occ is not None else None, 0, 0, 0,
                   0 if frgb is not None else None,
                   0 if ffront is not None else None)
        props, rois3d, pooled = jax.vmap(per_frame, in_axes=in_axes)(
            top, top_occ, rpn["scores"], rpn["deltas"], rpn["features"],
            frgb, ffront)

        b, r = props.rois.shape[0], props.rois.shape[1]
        flat = {k: v.reshape((b * r,) + v.shape[2:]) for k, v in pooled.items()}
        fuse = self.fusion.apply(variables[FUSION], flat, False)
        probs = fuse["probs"].reshape(b, r, -1)
        deltas = fuse["deltas"].reshape(b, r, cfg.model.num_class, 8, 3)

        dets = jax.vmap(partial(rcnn_nms, cfg=cfg,
                                score_threshold=score_threshold))(
            probs, deltas, rois3d, props.mask)
        return dets, props

    # -- training -------------------------------------------------------------

    def forward_train(self, variables, batch: Dict[str, jnp.ndarray],
                      key: jax.Array, train: bool = True):
        """Batched training forward: views + gt -> losses dict (+ BN updates).

        Equivalent of reference ``fit_iteration``'s two sess.runs + host ops
        (mv3d.py:1118-1407) as one differentiable program.

        batch keys: top (B,H,W,C), rgb, front, gt_boxes3d (B,G,8,3),
                    gt_labels (B,G) int32, gt_mask (B,G) bool.
        """
        cfg = self.cfg
        top, rgb, front = batch["top"], batch["rgb"], batch["front"]
        gt3d, gt_labels = batch["gt_boxes3d"], batch["gt_labels"]
        gt_mask = batch["gt_mask"]
        b = top.shape[0]

        outs, updates = self.extract_features(variables, top, rgb, front,
                                              train=train)
        rpn = outs["rpn"]
        gt_top = jax.vmap(partial(box3d_ops.box3d_to_top_box, cfg=cfg))(gt3d)

        keys = jax.random.split(key, b)

        top_occ = batch.get("top_occ")

        def per_frame(top_i, occ_i, scores_i, deltas_i, gt_top_i, gt3d_i,
                      gl_i, gm_i, key_i):
            k1, k2 = jax.random.split(key_i)
            inside = self.anchor_mask(top_i, occ=occ_i)
            rpn_tg = target_lib.rpn_target(self.anchors, inside, gt_top_i,
                                           gl_i, gm_i, k1, cfg)
            props = rpn_proposals(scores_i, deltas_i, self.anchors, inside, cfg)
            fus_tg = target_lib.fusion_target(props.rois, props.mask, gt_top_i,
                                              gt3d_i, gl_i, gm_i, k2, cfg)
            return rpn_tg, fus_tg

        rpn_tg, fus_tg = jax.vmap(
            per_frame,
            in_axes=(0, 0 if top_occ is not None else None) + (0,) * 7)(
            top, top_occ, rpn["scores"], rpn["deltas"], gt_top, gt3d,
            gt_labels, gt_mask, keys)

        # roi pooling over the sampled rcnn rois
        def pool_frame(feat_top_i, feat_rgb_i, feat_front_i, rois_i, rois3d_i):
            feats = {"top": feat_top_i}
            if feat_rgb_i is not None:
                feats["rgb"] = feat_rgb_i
            if feat_front_i is not None:
                feats["front"] = feat_front_i
            return self.pool_rois(feats, rois3d_i, rois_i[:, 1:5])

        frgb = outs.get("rgb_features")
        ffront = outs.get("front_features")
        pooled = jax.vmap(pool_frame, in_axes=(
            0, 0 if frgb is not None else None,
            0 if ffront is not None else None, 0, 0))(
            rpn["features"], frgb, ffront, fus_tg.rois, fus_tg.rois3d)

        r = fus_tg.rois.shape[1]
        flat = {k: v.reshape((b * r,) + v.shape[2:]) for k, v in pooled.items()}
        if train:
            fuse, fusion_updates = self.fusion.apply(
                variables[FUSION], flat, True, mutable=["batch_stats"])
            updates[FUSION] = fusion_updates
        else:
            fuse = self.fusion.apply(variables[FUSION], flat, False)
            updates[FUSION] = None

        # losses (batch-meaned)
        def rpn_loss_frame(scores_i, deltas_i, tg):
            return loss_lib.rpn_loss(scores_i, deltas_i, tg)

        top_cls, top_reg = jax.vmap(rpn_loss_frame)(
            rpn["scores"], rpn["deltas"], rpn_tg)
        top_cls, top_reg = jnp.mean(top_cls), jnp.mean(top_reg)

        flat_tg = target_lib.FusionTargets(
            rois=fus_tg.rois.reshape(b * r, 5),
            labels=fus_tg.labels.reshape(b * r),
            targets=fus_tg.targets.reshape(b * r, 8, 3),
            mask=fus_tg.mask.reshape(b * r),
            pos_mask=fus_tg.pos_mask.reshape(b * r),
            rois3d=fus_tg.rois3d.reshape(b * r, 8, 3))
        fuse_cls, fuse_reg = loss_lib.fuse_loss(
            fuse["scores"], fuse["deltas"], flat_tg)

        loss_dict = {
            "top_cls_loss": top_cls, "top_reg_loss": top_reg,
            "fuse_cls_loss": fuse_cls, "fuse_reg_loss": fuse_reg,
        }
        aux = {"rpn_targets": rpn_tg, "fusion_targets": fus_tg,
               "proposals_scores": rpn["scores"], "updates": updates}
        return loss_dict, aux


def total_loss(loss_dict: Dict[str, jnp.ndarray], train_targets,
               cfg: Config) -> jnp.ndarray:
    """Per-stage loss mix (reference Trainer.__init__, mv3d.py:797-829)."""
    names = set(train_targets)
    if names == {TOP_VIEW_RPN}:
        return loss_dict["top_cls_loss"] + loss_dict["top_reg_loss"]
    if names == set(SUBNET_NAMES):
        w1, w2, w3, w4, w5 = cfg.train.loss_weights
        return (w1 * (w2 * loss_dict["top_cls_loss"] +
                      w3 * loss_dict["top_reg_loss"]) +
                w4 * loss_dict["fuse_cls_loss"] +
                w5 * loss_dict["fuse_reg_loss"])
    # any fusion-side stage: fuse losses only (mv3d.py:802-820)
    return loss_dict["fuse_cls_loss"] + loss_dict["fuse_reg_loss"]
