"""Backbone building blocks, bf16-compute / f32-params.

Replacements for the reference's NN primitives and Keras ResNet:
  * ``conv2d_bn_relu`` / ``linear_bn_relu``  (reference src/net/blocks.py:296-313)
  * bilinear-initialized ``upsample2d`` deconv (blocks.py:254-293)
  * ``ResnetBuilder.resnet_tiny``: conv7x7/2 + maxpool/2 + pre-activation
    bottleneck stages [3, 4] -> stride 8, 512 channels
    (reference src/net/resnet.py:237-259)

Convs run in ``compute_dtype`` (bfloat16 by default) on the tensor cores;
parameters and batch-norm statistics stay float32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .layers import (Module, Scope, batch_norm, conv, conv_transpose, dense,
                     max_pool)

Dtype = Any


def bilinear_kernel_init(factor: int):
    """Bilinear-interpolation ConvTranspose kernel, per-channel (depthwise
    pattern over a dense kernel). Parity with the reference's bilinear deconv
    initialization (blocks.py:254-276)."""
    size = 2 * factor - factor % 2
    center = (size - 1) / 2.0 if size % 2 == 1 else factor - 0.5
    og = np.ogrid[:size, :size]
    filt = ((1 - abs(og[0] - center) / factor) *
            (1 - abs(og[1] - center) / factor))

    def init(key, shape, dtype=jnp.float32):
        # transposed-conv kernel: (kh, kw, in_c, out_c)
        kh, kw, in_c, out_c = shape
        k = np.zeros(shape, np.float32)
        for c in range(min(in_c, out_c)):
            k[:, :, c, c] = filt[:kh, :kw]
        return jnp.asarray(k, dtype)

    return init


def _bn_relu(s: Scope, h, train: bool, dtype):
    h = batch_norm(s, h.astype(jnp.float32), train)
    return jax.nn.relu(h).astype(dtype)


@dataclass(frozen=True)
class ConvBnRelu(Module):
    features: int
    kernel: Tuple[int, int] = (3, 3)
    strides: Tuple[int, int] = (1, 1)
    quant: str = "none"       # "int8" -> int8 conv (ops/quantized.py)
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x, train: bool = False):
        # int8 is a serving-time forward: training always runs the float
        # path (round() has zero gradient); the param tree is identical
        x = conv(s, x, self.features, self.kernel, self.strides,
                 use_bias=False, dtype=self.dtype,
                 quant="none" if train else self.quant)
        return _bn_relu(s, x, train, self.dtype)


@dataclass(frozen=True)
class DenseBnRelu(Module):
    features: int
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x, train: bool = False):
        x = dense(s, x, self.features, use_bias=False, dtype=self.dtype,
                  quant="none" if train else self.quant)
        return _bn_relu(s, x, train, self.dtype)


@dataclass(frozen=True)
class Upsample2D(Module):
    """Trainable deconv upsampling with bilinear initialization
    (parity: reference ``upsample2d``, blocks.py:254-293)."""
    features: int
    factor: int
    dtype: Dtype = jnp.bfloat16

    def forward(self, s: Scope, x):
        f = self.factor
        size = 2 * f - f % 2
        return conv_transpose(s, x, self.features, (size, size), (f, f),
                              kernel_init=bilinear_kernel_init(f),
                              dtype=self.dtype)


@dataclass(frozen=True)
class _Block(Module):
    """Fields and the bias-free conv shared by the residual blocks."""
    filters: int
    strides: Tuple[int, int] = (1, 1)
    plain_entry: bool = False   # first block right after the stem's bn-relu
    quant: str = "none"
    dtype: Dtype = jnp.bfloat16

    def _conv(self, s: Scope, h, features, kernel, strides, train, name):
        return conv(s, h, features, kernel, strides, use_bias=False,
                    dtype=self.dtype, quant="none" if train else self.quant,
                    name=name)


class Bottleneck(_Block):
    """Pre-activation bottleneck block (He et al. 1603.05027), the block family
    of reference ``resnet.py:135-159``."""

    def forward(self, s: Scope, x, train: bool = False):
        out_c = self.filters * 4
        h = x if self.plain_entry else _bn_relu(s, x, train, self.dtype)
        h = self._conv(s, h, self.filters, (1, 1), self.strides, train,
                       "Conv_0")
        h = _bn_relu(s, h, train, self.dtype)
        h = self._conv(s, h, self.filters, (3, 3), (1, 1), train, "Conv_1")
        h = _bn_relu(s, h, train, self.dtype)
        h = self._conv(s, h, out_c, (1, 1), (1, 1), train, "Conv_2")

        shortcut = x
        if x.shape[-1] != out_c or self.strides != (1, 1):
            shortcut = self._conv(s, x, out_c, (1, 1), self.strides, train,
                                  "Conv_3")
        return h + shortcut


class BasicBlock(_Block):
    """Pre-activation basic block (two 3x3 convs) — the reference's
    ``basic_block`` family (resnet.py:111-132), used by its resnet_18/34
    builders. Output channels = filters (no 4x expansion)."""

    def forward(self, s: Scope, x, train: bool = False):
        h = x if self.plain_entry else _bn_relu(s, x, train, self.dtype)
        h = self._conv(s, h, self.filters, (3, 3), self.strides, train,
                       "Conv_0")
        h = _bn_relu(s, h, train, self.dtype)
        h = self._conv(s, h, self.filters, (3, 3), (1, 1), train, "Conv_1")

        shortcut = x
        if x.shape[-1] != self.filters or self.strides != (1, 1):
            shortcut = self._conv(s, x, self.filters, (1, 1), self.strides,
                                  train, "Conv_2")
        return h + shortcut


def space_to_depth(x: jnp.ndarray, factor: int) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H/f, W/f, C*f*f): fold spatial blocks into
    channels, so the stem conv sees 108 (top) / 48 (rgb) input channels
    instead of 27 / 3 at identical information content. Trailing rows/cols
    are zero-padded to a multiple of the factor.
    """
    b, h, w, c = x.shape
    ph = (-h) % factor
    pw = (-w) % factor
    if ph or pw:
        x = jnp.pad(x, ((0, 0), (0, ph), (0, pw), (0, 0)))
        h, w = h + ph, w + pw
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.transpose(0, 1, 3, 2, 4, 5).reshape(
        b, h // factor, w // factor, factor * factor * c)


@dataclass(frozen=True)
class ResnetTiny(Module):
    """Stride-8 tiny bottleneck ResNet: stem/2, pool/2, stages [3, 4] (/2).

    Parity: reference ``ResnetBuilder.resnet_tiny`` (resnet.py:237-259) —
    output is 512 channels at stride 8.

    ``s2d_factor`` > 0 replaces the 7x7/2 conv stem with space-to-depth + a
    3x3/1 conv at the same output stride (factor 2: s2d/2+conv+pool/2;
    factor 4: s2d/4+conv, no pool) — same stride-8 output contract.

    ``repetitions``/``block`` expose the reference's ResnetBuilder ablation
    family (resnet.py:185-258): e.g. (2, 2, 2, 2) + "basic" = resnet_18's
    body at stride 4*2^(len-1). The live default matches resnet_tiny.
    """
    repetitions: Sequence[int] = (3, 4)
    base_filters: int = 64
    s2d_factor: int = 0
    block: str = "bottleneck"          # "bottleneck" | "basic"
    dtype: Dtype = jnp.bfloat16
    # "int8": residual-block convs run int8 (ops/quantized.py). The stem
    # stays float — first-layer quantization is the standard PTQ accuracy
    # cliff, and the stem sees raw voxel statistics.
    quant: str = "none"

    def forward(self, s: Scope, x, train: bool = False):
        x = x.astype(self.dtype)
        if self.s2d_factor == 0:
            x = ConvBnRelu(self.base_filters, (7, 7), (2, 2),
                           dtype=self.dtype)(s, x, train)
            x = max_pool(x, (3, 3), (2, 2))
        elif self.s2d_factor == 2:
            x = ConvBnRelu(self.base_filters, (3, 3), (1, 1),
                           dtype=self.dtype)(s, space_to_depth(x, 2), train)
            x = max_pool(x, (3, 3), (2, 2))
        elif self.s2d_factor == 4:
            x = ConvBnRelu(self.base_filters, (3, 3), (1, 1),
                           dtype=self.dtype)(s, space_to_depth(x, 4), train)
        else:
            raise ValueError(f"unsupported s2d_factor {self.s2d_factor}")

        block_cls = {"bottleneck": Bottleneck, "basic": BasicBlock}[self.block]
        filters = self.base_filters
        for i, reps in enumerate(self.repetitions):
            for j in range(reps):
                strides = (2, 2) if (j == 0 and i != 0) else (1, 1)
                x = block_cls(filters, strides,
                              plain_entry=(i == 0 and j == 0),
                              quant=self.quant, dtype=self.dtype)(s, x, train)
            filters *= 2
        return x
