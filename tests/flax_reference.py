"""flax.linen twins of the model's subnets and of the GRU tracker: the
reference that tests/test_layers.py holds the plain-JAX layers to.

These are the definitions the model's variable trees (names, shapes,
initial values) were first written against. Only the tests import this
module, and only after ``pytest.importorskip("flax")``.
"""

from typing import Any, Dict, Sequence, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp

from mv3d_tpu.config import Config
from mv3d_tpu.models.backbone import bilinear_kernel_init, space_to_depth
from mv3d_tpu.ops.quantized import int8_conv, int8_dense

Dtype = Any


class QuantDense(nn.Module):
    features: int
    use_bias: bool = False
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        w = self.param("kernel", nn.initializers.lecun_normal(),
                       (x.shape[-1], self.features), jnp.float32)
        return int8_dense(x, w, out_dtype=self.dtype)


class QuantConv(nn.Module):
    features: int
    kernel_size: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    padding: str = "SAME"
    use_bias: bool = False
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        w = self.param(
            "kernel", nn.initializers.lecun_normal(),
            (*self.kernel_size, x.shape[-1], self.features), jnp.float32)
        return int8_conv(x, w, strides=self.strides, padding=self.padding,
                         out_dtype=self.dtype)


def conv_cls(quant):
    return QuantConv if quant == "int8" else nn.Conv


def dense_cls(quant):
    return QuantDense if quant == "int8" else nn.Dense


def _bn(train, name=None):
    return nn.BatchNorm(use_running_average=not train, momentum=0.9,
                        dtype=jnp.float32, name=name)


class ConvBnRelu(nn.Module):
    features: int
    kernel: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = conv_cls("none" if train else self.quant)(
            self.features, self.kernel, self.strides, padding="SAME",
            use_bias=False, dtype=self.dtype, name="Conv_0")(x)
        x = _bn(train)(x.astype(jnp.float32))
        return nn.relu(x).astype(self.dtype)


class DenseBnRelu(nn.Module):
    features: int
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = dense_cls("none" if train else self.quant)(
            self.features, use_bias=False, dtype=self.dtype,
            name="Dense_0")(x)
        x = _bn(train)(x.astype(jnp.float32))
        return nn.relu(x).astype(self.dtype)


class Upsample2D(nn.Module):
    features: int
    factor: int
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        f = self.factor
        size = 2 * f - f % 2
        return nn.ConvTranspose(
            self.features, (size, size), strides=(f, f), padding="SAME",
            kernel_init=bilinear_kernel_init(f), use_bias=True,
            dtype=self.dtype)(x)


class Bottleneck(nn.Module):
    filters: int
    strides: Tuple[int, int] = (1, 1)
    plain_entry: bool = False
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        conv = conv_cls("none" if train else self.quant)

        def bn_relu(h):
            return nn.relu(_bn(train)(h.astype(jnp.float32))).astype(
                self.dtype)

        out_c = self.filters * 4
        h = x if self.plain_entry else bn_relu(x)
        h = conv(self.filters, (1, 1), self.strides, padding="SAME",
                 use_bias=False, dtype=self.dtype, name="Conv_0")(h)
        h = bn_relu(h)
        h = conv(self.filters, (3, 3), padding="SAME", use_bias=False,
                 dtype=self.dtype, name="Conv_1")(h)
        h = bn_relu(h)
        h = conv(out_c, (1, 1), padding="SAME", use_bias=False,
                 dtype=self.dtype, name="Conv_2")(h)
        shortcut = x
        if x.shape[-1] != out_c or self.strides != (1, 1):
            shortcut = conv(out_c, (1, 1), self.strides, padding="SAME",
                            use_bias=False, dtype=self.dtype,
                            name="Conv_3")(x)
        return h + shortcut


class BasicBlock(nn.Module):
    filters: int
    strides: Tuple[int, int] = (1, 1)
    plain_entry: bool = False
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        conv = conv_cls("none" if train else self.quant)

        def bn_relu(h):
            return nn.relu(_bn(train)(h.astype(jnp.float32))).astype(
                self.dtype)

        h = x if self.plain_entry else bn_relu(x)
        h = conv(self.filters, (3, 3), self.strides, padding="SAME",
                 use_bias=False, dtype=self.dtype, name="Conv_0")(h)
        h = bn_relu(h)
        h = conv(self.filters, (3, 3), padding="SAME", use_bias=False,
                 dtype=self.dtype, name="Conv_1")(h)
        shortcut = x
        if x.shape[-1] != self.filters or self.strides != (1, 1):
            shortcut = conv(self.filters, (1, 1), self.strides,
                            padding="SAME", use_bias=False,
                            dtype=self.dtype, name="Conv_2")(x)
        return h + shortcut


class ResnetTiny(nn.Module):
    repetitions: Sequence[int] = (3, 4)
    base_filters: int = 64
    s2d_factor: int = 0
    block: str = "bottleneck"
    dtype: Dtype = jnp.bfloat16
    quant: str = "none"

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = x.astype(self.dtype)
        if self.s2d_factor == 0:
            x = ConvBnRelu(self.base_filters, (7, 7), (2, 2),
                           dtype=self.dtype)(x, train)
            x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        elif self.s2d_factor == 2:
            x = ConvBnRelu(self.base_filters, (3, 3), (1, 1),
                           dtype=self.dtype)(space_to_depth(x, 2), train)
            x = nn.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
        else:
            x = ConvBnRelu(self.base_filters, (3, 3), (1, 1),
                           dtype=self.dtype)(space_to_depth(x, 4), train)
        block_cls = {"bottleneck": Bottleneck, "basic": BasicBlock}[self.block]
        filters = self.base_filters
        for i, reps in enumerate(self.repetitions):
            for j in range(reps):
                strides = (2, 2) if (j == 0 and i != 0) else (1, 1)
                x = block_cls(filters, strides,
                              plain_entry=(i == 0 and j == 0),
                              quant=self.quant, dtype=self.dtype)(x, train)
            filters *= 2
        return x


class TopRPN(nn.Module):
    num_bases: int
    upsample: bool = False
    s2d_factor: int = 0
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, top_view, train: bool = False):
        x = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                       block=self.block, repetitions=self.repetitions,
                       quant=self.quant, name="trunk")(top_view, train)
        x = ConvBnRelu(128, (1, 1), quant=self.quant, dtype=self.dtype,
                       name="reduce")(x, train)
        up = ConvBnRelu(128, (3, 3), quant=self.quant, dtype=self.dtype,
                        name="rpn_conv")(x, train)
        scores = nn.Conv(2 * self.num_bases, (1, 1), padding="SAME",
                         dtype=self.dtype, name="rpn_score")(up)
        deltas = nn.Conv(4 * self.num_bases, (1, 1), padding="SAME",
                         dtype=self.dtype, name="rpn_delta")(up)
        feature = (Upsample2D(128, factor=4, dtype=self.dtype,
                              name="rcnn_upsample")(x)
                   if self.upsample else x)
        b = top_view.shape[0]
        return {
            "features": feature,
            "scores": scores.reshape(b, -1, 2).astype(jnp.float32),
            "deltas": deltas.reshape(b, -1, 4).astype(jnp.float32),
            "score_map": scores.astype(jnp.float32),
        }


class VggTrunk(nn.Module):
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = x.astype(self.dtype)
        for bi, (reps, ch, pool) in enumerate(
                [(2, 32, True), (2, 64, True), (3, 128, True), (3, 128, False)]):
            for j in range(reps):
                q = "none" if (bi == 0 and j == 0) else self.quant
                x = ConvBnRelu(ch, (3, 3), quant=q, dtype=self.dtype,
                               name=f"block{bi+1}_conv{j+1}")(x, train)
            if pool:
                x = nn.max_pool(x, (2, 2), strides=(2, 2), padding="SAME")
        return x


class RgbFeatureNet(nn.Module):
    upsample: bool = False
    s2d_factor: int = 0
    basenet: str = "resnet"
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, rgb, train: bool = False):
        if self.basenet == "vgg":
            x = VggTrunk(quant=self.quant, dtype=self.dtype,
                         name="trunk")(rgb, train)
        else:
            x = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                           block=self.block, repetitions=self.repetitions,
                           quant=self.quant, name="trunk")(rgb, train)
        x = ConvBnRelu(128, (1, 1), quant=self.quant, dtype=self.dtype,
                       name="reduce")(x, train)
        if self.upsample:
            x = Upsample2D(128, factor=2, dtype=self.dtype, name="upsample")(x)
        return x


class FrontFeatureNet(nn.Module):
    upsample: bool = False
    s2d_factor: int = 0
    block: str = "bottleneck"
    repetitions: Tuple[int, ...] = (3, 4)
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, front, train: bool = False):
        x = ResnetTiny(s2d_factor=self.s2d_factor, dtype=self.dtype,
                       block=self.block, repetitions=self.repetitions,
                       quant=self.quant, name="trunk")(front, train)
        x = ConvBnRelu(128, (1, 1), quant=self.quant, dtype=self.dtype,
                       name="reduce")(x, train)
        if self.upsample:
            x = Upsample2D(128, factor=4, dtype=self.dtype, name="upsample")(x)
        return x


class _RoiTower(nn.Module):
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x, train: bool = False):
        for i, ch in enumerate((128, 256, 512)):
            h = ConvBnRelu(ch, (3, 3), quant=self.quant, dtype=self.dtype,
                           name=f"block{i+1}_conv1")(x, train)
            h = ConvBnRelu(ch, (3, 3), quant=self.quant, dtype=self.dtype,
                           name=f"block{i+1}_conv2")(h, train) + h
            x = nn.avg_pool(h, (2, 2), strides=(2, 2), padding="SAME")
        return x.reshape(x.shape[0], -1)


class _PredictHead(nn.Module):
    num_class: int
    out_dim: int = 24
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, feat, train: bool = False):
        scores = nn.Dense(self.num_class, dtype=self.dtype,
                          name="score")(feat).astype(jnp.float32)
        h = DenseBnRelu(256, quant=self.quant, dtype=self.dtype,
                        name="box_1")(feat, train)
        h = DenseBnRelu(256, quant=self.quant, dtype=self.dtype,
                        name="box_2")(h, train)
        deltas = nn.Dense(self.num_class * self.out_dim, dtype=self.dtype,
                          name="box_3")(h).astype(jnp.float32)
        return scores, deltas.reshape(-1, self.num_class, 8, 3)


class FusionHead(nn.Module):
    cfg: Config
    dtype: Dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, roi_feats: Dict[str, jnp.ndarray], train: bool = False):
        m = self.cfg.model
        quant = m.quant
        feats = {}
        for name in ("top", "front", "rgb"):
            if name in roi_feats:
                f = _RoiTower(quant=quant, dtype=self.dtype,
                              name=f"{name}_tower")(
                    roi_feats[name].astype(self.dtype), train)
                if name + "_ctx" in roi_feats:
                    fc = _RoiTower(quant=quant, dtype=self.dtype,
                                   name=f"{name}_ctx_tower")(
                        roi_feats[name + "_ctx"].astype(self.dtype), train)
                    f = jnp.concatenate([f, fc], axis=1)
                feats[name] = f
        non_rgb = [feats[k] for k in ("top", "front") if k in feats]
        all_views = non_rgb + ([feats["rgb"]] if "rgb" in feats else [])

        def fc(h, name):
            return DenseBnRelu(512, quant=quant, dtype=self.dtype,
                               name=name)(h, train)

        wo = fc(fc(jnp.concatenate(non_rgb, axis=1), "fc_wo_rgb_1"),
                "fc_wo_rgb_2")
        w = fc(fc(jnp.concatenate(all_views, axis=1), "fc_all_1"), "fc_all_2")
        if m.use_siamese_fusion:
            wo = fc(wo, "fc_wo_rgb_3")
            w = fc(w, "fc_all_3")
        scores_w, deltas_w = _PredictHead(
            m.num_class, quant=quant, dtype=self.dtype,
            name="head_with_rgb")(w, train)
        probs_w = jax.nn.softmax(scores_w, axis=-1)
        if m.use_handcraft_fusion or m.use_learnable_fusion:
            scores_wo, deltas_wo = _PredictHead(
                m.num_class, quant=quant, dtype=self.dtype,
                name="head_without_rgb")(wo, train)
            probs_wo = jax.nn.softmax(scores_wo, axis=-1)
        else:
            scores_wo, deltas_wo, probs_wo = scores_w, deltas_w, probs_w
        if m.use_learnable_fusion:
            nc = m.num_class
            dim = nc * 24
            scores = nn.Dense(nc, dtype=self.dtype, name="fuse_scores")(
                jnp.concatenate([scores_w, scores_wo], axis=1)).astype(
                    jnp.float32)
            probs = jax.nn.softmax(scores, axis=-1)
            d = jnp.concatenate([deltas_w.reshape(-1, dim),
                                 deltas_wo.reshape(-1, dim)], axis=1)
            deltas = DenseBnRelu(dim, dtype=self.dtype, name="fuse_deltas")(
                d, train).astype(jnp.float32).reshape(-1, nc, 8, 3)
        else:
            scores, probs, deltas = scores_w, probs_w, deltas_w
        return {"scores": scores, "probs": probs, "deltas": deltas,
                "probs_without_rgb": probs_wo,
                "deltas_without_rgb": deltas_wo}


class MotionGRU(nn.Module):
    hidden: int = 64

    @nn.compact
    def __call__(self, deltas):
        hs = nn.RNN(nn.GRUCell(features=self.hidden))(deltas)
        return nn.Dense(3)(hs)
