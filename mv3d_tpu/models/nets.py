"""The four MV3D subnets, plus the assembled model wrapper.

Subnet structure and naming mirror the reference graph scopes so staged
training and per-subnet checkpointing carry over directly
(reference mv3d_net.py:24-28: ``top_view_rpn``, ``image_feature``,
``front_feature``, ``fusion``; per-scope savers mv3d.py:117-161):

  * :class:`TopRPN`        — BEV trunk + RPN heads + x4 upsampled RCNN feature
                             (reference ``top_feature_net_r``, mv3d_net.py:97-149)
  * :class:`RgbFeatureNet` — RGB trunk, stride 4 (``rgb_feature_net_r``, :254-274)
  * :class:`FrontFeatureNet` — front trunk, stride 2 (``front_feature_net_r``,
                             :432-461)
  * :class:`FusionHead`    — per-view ROI towers + concat + twin
                             with/without-RGB heads + optional
                             handcraft/learnable late fusion
                             (``fusion_net`` + predict heads, :479-958)

All convs/matmuls run in bfloat16 on the tensor cores; logits/probabilities
are returned in float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Tuple

import jax
import jax.numpy as jnp

from ..config import Config
from .backbone import ConvBnRelu, DenseBnRelu, ResnetTiny, Upsample2D
from .layers import Module, Scope, avg_pool, conv, dense, max_pool

Dtype = Any

TOP_VIEW_RPN = "top_view_rpn"
IMAGE_FEATURE = "image_feature"
FRONT_FEATURE = "front_feature"
FUSION = "fusion"
SUBNET_NAMES = (TOP_VIEW_RPN, IMAGE_FEATURE, FRONT_FEATURE, FUSION)


@dataclass(frozen=True)
class TopRPN(Module):
    """BEV feature trunk + RPN score/delta heads + RCNN feature.

    With ``upsample`` the RCNN feature is the reference's x4 bilinear-init
    deconv (stride 2, mv3d_net.py:134-136); otherwise it is the stride-8
    reduced map itself (ROI-align samples it with 1/8 scale — same
    information, far cheaper).
    """
    num_bases: int
    upsample: bool = False
    s2d_factor: int = 0
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, top_view, train: bool = False):
        x = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                       block=self.block, repetitions=self.repetitions,
                       quant=self.quant)(s, top_view, train, name="trunk")
        x = ConvBnRelu(128, (1, 1), quant=self.quant,
                       dtype=self.dtype)(s, x, train, name="reduce")

        up = ConvBnRelu(128, (3, 3), quant=self.quant,
                        dtype=self.dtype)(s, x, train, name="rpn_conv")
        scores = conv(s, up, 2 * self.num_bases, (1, 1), dtype=self.dtype,
                      name="rpn_score")
        deltas = conv(s, up, 4 * self.num_bases, (1, 1), dtype=self.dtype,
                      name="rpn_delta")

        if self.upsample:
            feature = Upsample2D(128, factor=4, dtype=self.dtype)(
                s, x, name="rcnn_upsample")
        else:
            feature = x
        b = top_view.shape[0]
        return {
            "features": feature,                               # (B, H/2, W/2, 128)
            "scores": scores.reshape(b, -1, 2).astype(jnp.float32),   # (B, A, 2)
            "deltas": deltas.reshape(b, -1, 4).astype(jnp.float32),   # (B, A, 4)
            "score_map": scores.astype(jnp.float32),           # rpn heatmap
        }


@dataclass(frozen=True)
class VggTrunk(Module):
    """VGG-style stride-8 trunk — the reference's plain ``rgb_feature_net``
    (mv3d_net.py:214-252, selected by cfg.RGB_BASENET='VGG'): conv blocks
    (32,32)/pool, (64,64)/pool, (128,128,128)/pool, (128,128,128)."""
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x, train: bool = False):
        x = x.astype(self.dtype)
        for bi, (reps, ch, pool) in enumerate(
                [(2, 32, True), (2, 64, True), (3, 128, True), (3, 128, False)]):
            for j in range(reps):
                # first conv sees raw pixels: stays float (PTQ first-layer rule)
                q = "none" if (bi == 0 and j == 0) else self.quant
                x = ConvBnRelu(ch, (3, 3), quant=q, dtype=self.dtype)(
                    s, x, train, name=f"block{bi+1}_conv{j+1}")
            if pool:
                x = max_pool(x, (2, 2), (2, 2))
        return x


@dataclass(frozen=True)
class RgbFeatureNet(Module):
    """RGB trunk: resnet_tiny (default) or VGG -> 1x1/128 (-> optional x2
    upsample). ``basenet`` mirrors cfg.RGB_BASENET (reference config.py:63)."""
    upsample: bool = False
    s2d_factor: int = 0
    basenet: str = "resnet"
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, rgb: jnp.ndarray, train: bool = False):
        if self.basenet == "vgg":
            trunk = VggTrunk(quant=self.quant, dtype=self.dtype)
        else:
            trunk = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                               block=self.block, repetitions=self.repetitions,
                               quant=self.quant)
        x = trunk(s, rgb, train, name="trunk")
        x = ConvBnRelu(128, (1, 1), quant=self.quant,
                       dtype=self.dtype)(s, x, train, name="reduce")
        if self.upsample:
            x = Upsample2D(128, factor=2, dtype=self.dtype)(
                s, x, name="upsample")
        return x


@dataclass(frozen=True)
class FrontFeatureNet(Module):
    """Front trunk: resnet_tiny -> 1x1/128 (-> optional x4 upsample)."""
    upsample: bool = False
    s2d_factor: int = 0
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, front: jnp.ndarray, train: bool = False):
        x = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                       block=self.block, repetitions=self.repetitions,
                       quant=self.quant)(s, front, train, name="trunk")
        x = ConvBnRelu(128, (1, 1), quant=self.quant,
                       dtype=self.dtype)(s, x, train, name="reduce")
        if self.upsample:
            x = Upsample2D(128, factor=4, dtype=self.dtype)(
                s, x, name="upsample")
        return x


@dataclass(frozen=True)
class _RoiTower(Module):
    """Per-view ROI feature tower: 3 residual conv blocks with avg-pool /2
    (reference fusion_net blocks, mv3d_net.py:499-530): 6x6 -> 3 -> 2 -> 1."""
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x, train: bool = False):
        for i, ch in enumerate((128, 256, 512)):
            h = ConvBnRelu(ch, (3, 3), quant=self.quant, dtype=self.dtype)(
                s, x, train, name=f"block{i+1}_conv1")
            h = ConvBnRelu(ch, (3, 3), quant=self.quant, dtype=self.dtype)(
                s, h, train, name=f"block{i+1}_conv2") + h
            x = avg_pool(h, (2, 2), (2, 2))
        return x.reshape(x.shape[0], -1)    # (R, 512)


@dataclass(frozen=True)
class _PredictHead(Module):
    """Score + corner-delta head over a fused 512-d roi feature.

    The delta path is a proper 256-256-out MLP chain. NOTE the reference's
    ``box_1``/``box_2`` layers are computed but *discarded* (each layer reads
    ``fuse_output`` again, mv3d_net.py:884-886) — we implement the evidently
    intended chain instead.
    """
    num_class: int
    out_dim: int = 24   # 8 corners x 3
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, feat, train: bool = False):
        # score / box_3 output layers stay float (PTQ last-layer rule)
        scores = dense(s, feat, self.num_class, dtype=self.dtype,
                       name="score").astype(jnp.float32)
        h = DenseBnRelu(256, quant=self.quant, dtype=self.dtype)(
            s, feat, train, name="box_1")
        h = DenseBnRelu(256, quant=self.quant, dtype=self.dtype)(
            s, h, train, name="box_2")
        deltas = dense(s, h, self.num_class * self.out_dim, dtype=self.dtype,
                       name="box_3").astype(jnp.float32)
        deltas = deltas.reshape(-1, self.num_class, 8, 3)
        return scores, deltas


@dataclass(frozen=True)
class FusionHead(Module):
    """Multi-view ROI fusion with twin with/without-RGB heads.

    Input: dict of per-view pooled roi features (R, ph, pw, C) under keys
    'top', optionally 'front', 'rgb'. Views are concatenated after their
    towers; the "without_rgb" branch sees every view except 'rgb'
    (mv3d_net.py:601-620). Output probs/deltas for both branches plus the
    fused head per the configured fusion mode (:868-958).
    """
    cfg: Config
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, roi_feats: Dict[str, jnp.ndarray],
                train: bool = False):
        m = self.cfg.model
        quant = m.quant
        dt = self.dtype
        feats = {}
        for name in ("top", "front", "rgb"):
            if name in roi_feats:
                f = _RoiTower(quant=quant, dtype=dt)(
                    s, roi_feats[name].astype(dt), train,
                    name=f"{name}_tower")
                ctx_key = name + "_ctx"
                if ctx_key in roi_feats:
                    # siamese context branch: twin tower over the enlarged-roi
                    # features, concatenated per view (mv3d_net.py:535-599)
                    fc = _RoiTower(quant=quant, dtype=dt)(
                        s, roi_feats[ctx_key].astype(dt), train,
                        name=f"{name}_ctx_tower")
                    f = jnp.concatenate([f, fc], axis=1)
                feats[name] = f

        non_rgb = [feats[k] for k in ("top", "front") if k in feats]
        all_views = non_rgb + ([feats["rgb"]] if "rgb" in feats else [])

        def fc(h, name):
            return DenseBnRelu(512, quant=quant, dtype=dt)(s, h, train,
                                                           name=name)

        wo = fc(fc(jnp.concatenate(non_rgb, axis=1), "fc_wo_rgb_1"),
                "fc_wo_rgb_2")
        w = fc(fc(jnp.concatenate(all_views, axis=1), "fc_all_1"),
               "fc_all_2")
        if m.use_siamese_fusion:
            # extra mixing layer for the siamese features (mv3d_net.py:607-618)
            wo = fc(wo, "fc_wo_rgb_3")
            w = fc(w, "fc_all_3")

        scores_w, deltas_w = _PredictHead(
            m.num_class, quant=quant, dtype=dt)(s, w, train,
                                                name="head_with_rgb")
        probs_w = jax.nn.softmax(scores_w, axis=-1)

        need_twin = m.use_handcraft_fusion or m.use_learnable_fusion
        if need_twin:
            scores_wo, deltas_wo = _PredictHead(
                m.num_class, quant=quant, dtype=dt)(s, wo, train,
                                                    name="head_without_rgb")
            probs_wo = jax.nn.softmax(scores_wo, axis=-1)
        else:
            # reference default: single head, twin outputs aliased
            # (mv3d_net.py:955-958)
            scores_wo, deltas_wo, probs_wo = scores_w, deltas_w, probs_w

        if m.use_handcraft_fusion:
            # per-roi: if either branch is confident, take the more confident
            # branch's outputs; else average (mv3d_net.py:896-946)
            thr = m.high_score_threshold
            conf = (probs_w[:, 1] > thr) | (probs_wo[:, 1] > thr)
            pick_w = probs_w[:, 1] > probs_wo[:, 1]
            probs = jnp.where(conf[:, None],
                              jnp.where(pick_w[:, None], probs_w, probs_wo),
                              (probs_w + probs_wo) / 2.0)
            scores = jnp.where(conf[:, None],
                               jnp.where(pick_w[:, None], scores_w, scores_wo),
                               (scores_w + scores_wo) / 2.0)
            sel = conf & pick_w
            deltas = jnp.where(conf[:, None, None, None],
                               jnp.where(sel[:, None, None, None],
                                         deltas_w, deltas_wo),
                               (deltas_w + deltas_wo) / 2.0)
        elif m.use_learnable_fusion:
            nc = m.num_class
            dim = nc * 24
            scores = dense(s, jnp.concatenate([scores_w, scores_wo], axis=1),
                           nc, dtype=dt,
                           name="fuse_scores").astype(jnp.float32)
            probs = jax.nn.softmax(scores, axis=-1)
            d = jnp.concatenate([deltas_w.reshape(-1, dim),
                                 deltas_wo.reshape(-1, dim)], axis=1)
            deltas = DenseBnRelu(dim, dtype=dt)(
                s, d, train, name="fuse_deltas").astype(
                    jnp.float32).reshape(-1, nc, 8, 3)
        else:
            scores, probs, deltas = scores_w, probs_w, deltas_w

        return {
            "scores": scores, "probs": probs, "deltas": deltas,
            "scores_with_rgb": scores_w, "probs_with_rgb": probs_w,
            "deltas_with_rgb": deltas_w,
            "scores_without_rgb": scores_wo, "probs_without_rgb": probs_wo,
            "deltas_without_rgb": deltas_wo,
        }
