"""int8 quantized matmul/conv building blocks for serving.

Post-training dynamic quantization of the model's hot matmuls (ROADMAP
item: "int8 quantization of the fusion-head matmuls / ROI features"; the
reference has no quantization story — serving there is f32 TF-1 on GPU).

Scheme (standard symmetric PTQ, no calibration pass needed):
  * weights: per-output-channel symmetric int8 — ``s_w[oc] =
    amax(|W[..., oc]|) / 127``, ``W_q = round(W / s_w)``; quantized
    IN-GRAPH from the float checkpoint params, so checkpoints, staged
    training, and every load/save path are unchanged (XLA hoists the
    weight-quantize out of the serving loop; it is a one-time cost per
    weight, ~bytes-of-weights of work).
  * activations: per-tensor dynamic symmetric int8 — ``s_x = amax(|x|) /
    127`` computed per call (one cheap reduction), so no calibration data
    is required and accuracy degrades gracefully out of distribution.
  * accumulation: int8 x int8 -> int32 via ``preferred_element_type``.
    Dequantize with ``s_x * s_w`` back to the requested float dtype.

The layers in ``models/layers.py`` (``conv`` / ``dense`` with
``quant="int8"``) call these on the same float "kernel" parameter as the
float forward, selected by ``ModelConfig.quant`` (config.py).
"""

from __future__ import annotations

from typing import Any, Sequence, Tuple

import jax
import jax.numpy as jnp

Dtype = Any

_QMAX = 127.0


def _per_channel_scale(w: jnp.ndarray) -> jnp.ndarray:
    """Symmetric per-output-channel scale for a (..., out_c) weight."""
    axes = tuple(range(w.ndim - 1))
    amax = jnp.max(jnp.abs(w), axis=axes)
    return jnp.maximum(amax, 1e-12) / _QMAX


def quantize_weight(w: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """f32 (..., out_c) weight -> (int8 weight, f32 (out_c,) scale)."""
    s = _per_channel_scale(w.astype(jnp.float32))
    q = jnp.clip(jnp.round(w.astype(jnp.float32) / s), -_QMAX, _QMAX)
    return q.astype(jnp.int8), s


def quantize_activation(x: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """f32/bf16 activation -> (int8, scalar f32 scale), per-tensor dynamic."""
    xf = x.astype(jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(xf)), 1e-12) / _QMAX
    q = jnp.clip(jnp.round(xf / s), -_QMAX, _QMAX)
    return q.astype(jnp.int8), s


def int8_dense(x: jnp.ndarray, w: jnp.ndarray,
               out_dtype: Dtype = jnp.bfloat16) -> jnp.ndarray:
    """``x @ w`` with both operands dynamically quantized to int8.

    x: (..., K) float; w: (K, N) float (checkpoint param). Accumulates in
    int32, dequantizes to ``out_dtype``.
    """
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(w)
    acc = jax.lax.dot_general(
        xq, wq, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32)
    return (acc.astype(jnp.float32) * (sx * sw)).astype(out_dtype)


def int8_conv(x: jnp.ndarray, w: jnp.ndarray,
              strides: Sequence[int] = (1, 1), padding: str = "SAME",
              out_dtype: Dtype = jnp.bfloat16) -> jnp.ndarray:
    """NHWC conv with int8 operands and int32 accumulation.

    x: (B, H, W, Cin) float; w: (kh, kw, Cin, Cout) float checkpoint param.
    """
    xq, sx = quantize_activation(x)
    wq, sw = quantize_weight(w)
    acc = jax.lax.conv_general_dilated(
        xq, wq, window_strides=tuple(strides), padding=padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32)
    return (acc.astype(jnp.float32) * (sx * sw)).astype(out_dtype)
