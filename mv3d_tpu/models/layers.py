"""Plain-JAX layers with named variables: conv, dense, batch norm,
transposed conv and pooling.

A network is a :class:`Module` whose ``forward(scope, *inputs)`` builds its
layers through a :class:`Scope`. ``Module.init`` / ``Module.apply`` give the
call shape every caller uses, and the variable tree
``{"params": ..., "batch_stats": ...}`` that checkpoints, serving artifacts
and optimizer state are keyed by:

  * a layer without an explicit name is called ``<Kind>_<n>``, counted per
    kind within its parent (``Conv_0``, ``BatchNorm_1``, ``Bottleneck_3``);
  * a parameter's initial value is drawn from the root key folded with its
    scope path and its index within that scope, so a tree is reproducible
    from its seed, independent of which layers run in int8, and equal to
    the trees of earlier releases of this model.

Compute dtype: inputs and weights are cast to the layer's ``dtype``
(bfloat16 for the trunks); parameters and batch statistics stay float32.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.quantized import int8_conv, int8_dense

Dtype = Any
Initializer = Callable[..., jnp.ndarray]

lecun_normal = jax.nn.initializers.lecun_normal()
orthogonal = jax.nn.initializers.orthogonal()
zeros = jax.nn.initializers.zeros
ones = jax.nn.initializers.ones

_NHWC = ("NHWC", "HWIO", "NHWC")


def _fold_path(key: jax.Array, parts: Sequence[Any]) -> jax.Array:
    """Fold static path parts (names and ints) into ``key`` through the
    first 32 bits of their SHA-1."""
    m = hashlib.sha1()
    for p in parts:
        if isinstance(p, str):
            m.update(p.encode("utf-8"))
        else:
            m.update(p.to_bytes((p.bit_length() + 7) // 8, byteorder="big"))
    h = int.from_bytes(m.digest()[:4], byteorder="big")
    return jax.random.fold_in(key, jnp.uint32(h))


class Scope:
    """The variables of one layer and the names handed out under it.

    While initialising (``key`` given) parameters and statistics are
    created; otherwise they are read. ``update_stats`` lets batch norm write
    new running statistics into ``stats`` (a private copy, see
    :meth:`Module.apply`)."""

    def __init__(self, params: Dict[str, Any], stats: Dict[str, Any],
                 key: Optional[jax.Array] = None, path: Tuple[str, ...] = (),
                 update_stats: bool = False):
        self.params = params
        self.stats = stats
        self.key = key
        self.path = path
        self.update_stats = update_stats
        self._auto: Dict[str, int] = {}
        self._n_params = 0

    @property
    def initializing(self) -> bool:
        return self.key is not None

    def child(self, name: Optional[str], kind: str) -> "Scope":
        if name is None:
            n = self._auto.get(kind, 0)
            self._auto[kind] = n + 1
            name = f"{kind}_{n}"
        if self.initializing:
            params = self.params.setdefault(name, {})
            stats = self.stats.setdefault(name, {})
        else:
            params = self.params.get(name, {})
            stats = self.stats.get(name, {})
        return Scope(params, stats, self.key, self.path + (name,),
                     self.update_stats)

    def param(self, name: str, init: Initializer, shape: Sequence[int]):
        if not self.initializing:
            return self.params[name]
        self._n_params += 1
        key = _fold_path(self.key, self.path + (self._n_params,))
        value = init(key, tuple(shape), jnp.float32)
        self.params[name] = value
        return value

    def stat(self, name: str, init: Callable, shape: Sequence[int]):
        if self.initializing:
            self.stats[name] = init(tuple(shape), jnp.float32)
        return self.stats[name]

    def set_stat(self, name: str, value: jnp.ndarray) -> None:
        if self.update_stats and not self.initializing:
            self.stats[name] = value


def _prune(tree: Dict[str, Any]) -> Dict[str, Any]:
    """Drop sub-trees that hold no arrays."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            v = _prune(v)
            if not v:
                continue
        out[k] = v
    return out


def _copy_tree(tree: Dict[str, Any]) -> Dict[str, Any]:
    return {k: _copy_tree(v) if isinstance(v, dict) else v
            for k, v in tree.items()}


class Module:
    """A layer or network built by ``forward(scope, *inputs)``.

    Used as a child: ``Block(...)(scope, *inputs, name=None)``."""

    def forward(self, scope: Scope, *args):
        raise NotImplementedError

    def __call__(self, scope: Scope, *args, name: Optional[str] = None):
        return self.forward(scope.child(name, type(self).__name__), *args)

    def init(self, key: jax.Array, *args) -> Dict[str, Any]:
        """Create the variables by running the forward once on ``args``."""
        params: Dict[str, Any] = {}
        stats: Dict[str, Any] = {}
        self.forward(Scope(params, stats, key=key), *args)
        variables = {"params": _prune(params)}
        stats = _prune(stats)
        if stats:
            variables["batch_stats"] = stats
        return variables

    def apply(self, variables: Dict[str, Any], *args,
              mutable: Sequence[str] = ()):
        """Run the forward. With ``mutable=["batch_stats"]`` also return
        ``{"batch_stats": updated}`` (the running averages after a
        training-mode pass)."""
        update = "batch_stats" in mutable
        stats = variables.get("batch_stats", {})
        if update:
            stats = _copy_tree(stats)
        out = self.forward(Scope(variables["params"], stats,
                                 update_stats=update), *args)
        if update:
            return out, {"batch_stats": stats}
        return out


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def conv(scope: Scope, x, features: int, kernel: Tuple[int, int] = (3, 3),
         strides: Tuple[int, int] = (1, 1), *, use_bias: bool = True,
         dtype: Dtype = jnp.bfloat16, quant: str = "none",
         name: Optional[str] = None):
    """NHWC convolution with SAME padding; HWIO kernel. ``quant="int8"``
    runs the bias-free forward in int8 (ops/quantized.py) on the same
    float parameter."""
    s = scope.child(name, "Conv")
    w = s.param("kernel", lecun_normal, (*kernel, x.shape[-1], features))
    b = s.param("bias", zeros, (features,)) if use_bias else None
    if quant == "int8":
        if b is not None:
            raise ValueError("int8 convolutions are bias-free")
        return int8_conv(x, w, strides=strides, out_dtype=dtype)
    y = lax.conv_general_dilated(x.astype(dtype), w.astype(dtype), strides,
                                 "SAME", dimension_numbers=_NHWC)
    if b is not None:
        y = y + b.astype(dtype)
    return y


def dense(scope: Scope, x, features: int, *, use_bias: bool = True,
          dtype: Dtype = jnp.bfloat16, quant: str = "none",
          name: Optional[str] = None):
    """``x @ kernel (+ bias)`` over the last axis."""
    s = scope.child(name, "Dense")
    w = s.param("kernel", lecun_normal, (x.shape[-1], features))
    b = s.param("bias", zeros, (features,)) if use_bias else None
    if quant == "int8":
        if b is not None:
            raise ValueError("int8 dense layers are bias-free")
        return int8_dense(x, w, out_dtype=dtype)
    y = lax.dot_general(x.astype(dtype), w.astype(dtype),
                        (((x.ndim - 1,), (0,)), ((), ())))
    if b is not None:
        y = y + b.astype(dtype)
    return y


def batch_norm(scope: Scope, x, train: bool, *, momentum: float = 0.9,
               epsilon: float = 1e-5, name: Optional[str] = None):
    """Batch norm over every axis but the last, in float32. ``train`` uses
    the batch's statistics and (when the scope may) updates the running
    ones; otherwise the running statistics normalise."""
    s = scope.child(name, "BatchNorm")
    feat = (x.shape[-1],)
    ra_mean = s.stat("mean", jnp.zeros, feat)
    ra_var = s.stat("var", jnp.ones, feat)
    x = x.astype(jnp.float32)
    if train:
        axes = tuple(range(x.ndim - 1))
        mean = x.mean(axes)
        var = jnp.maximum(0.0, lax.square(x).mean(axes) - lax.square(mean))
        s.set_stat("mean", momentum * ra_mean + (1 - momentum) * mean)
        s.set_stat("var", momentum * ra_var + (1 - momentum) * var)
    else:
        mean, var = ra_mean, ra_var
    y = x - mean
    mul = lax.rsqrt(var + epsilon) * s.param("scale", ones, feat)
    return y * mul + s.param("bias", zeros, feat)


def conv_transpose(scope: Scope, x, features: int, kernel: Tuple[int, int],
                   strides: Tuple[int, int], *, kernel_init: Initializer,
                   dtype: Dtype = jnp.bfloat16, name: Optional[str] = None):
    """Transposed NHWC convolution with SAME padding and a bias."""
    s = scope.child(name, "ConvTranspose")
    w = s.param("kernel", kernel_init, (*kernel, x.shape[-1], features))
    b = s.param("bias", zeros, (features,))
    y = lax.conv_transpose(x.astype(dtype), w.astype(dtype), strides, "SAME",
                           rhs_dilation=(1, 1), transpose_kernel=False)
    return y + b.astype(dtype)


def max_pool(x, window: Tuple[int, int], strides: Tuple[int, int],
             padding: str = "SAME"):
    return lax.reduce_window(x, -jnp.inf, lax.max, (1, *window, 1),
                             (1, *strides, 1), padding)


def avg_pool(x, window: Tuple[int, int], strides: Tuple[int, int],
             padding: str = "SAME"):
    """Window mean that counts padding as zeros."""
    y = lax.reduce_window(x, 0.0, lax.add, (1, *window, 1), (1, *strides, 1),
                          padding)
    return y / np.prod(window)
