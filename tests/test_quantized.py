"""int8 serving quantization (ops/quantized.py + model.quant plumbing).

The reference has no quantization story; this is serving surface
(ROADMAP: "int8 quantization of the fusion-head matmuls / ROI features").
Contract under test:
  * int8 dense/conv approximate their float counterparts within PTQ error
  * int8 conv / dense layers are param-compatible with the float ones
    (same names, shapes, init) so float checkpoints load unchanged
  * model.quant="int8" changes ONLY the inference forward — training steps
    keep the float path, and the variables tree is identical
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mv3d_tpu.ops import quantized as q


def test_int8_dense_close_to_float():
    rng = np.random.RandomState(0)
    x = jnp.asarray(rng.randn(64, 96).astype(np.float32))
    w = jnp.asarray(rng.randn(96, 32).astype(np.float32) * 0.1)
    ref = x @ w
    got = q.int8_dense(x, w, out_dtype=jnp.float32)
    # dynamic symmetric PTQ on gaussian data: relative error well under 2%
    err = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    assert err < 0.02, err


def test_int8_conv_close_to_float():
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.rand(2, 12, 14, 16).astype(np.float32))  # relu-like
    w = jnp.asarray(rng.randn(3, 3, 16, 24).astype(np.float32) * 0.1)
    ref = jax.lax.conv_general_dilated(
        x, w, (1, 1), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = q.int8_conv(x, w, out_dtype=jnp.float32)
    err = float(jnp.linalg.norm(got - ref) / jnp.linalg.norm(ref))
    assert err < 0.02, err


def test_int8_weight_scale_per_channel():
    rng = np.random.RandomState(2)
    w = rng.randn(5, 5, 8, 4).astype(np.float32)
    w[..., 2] *= 100.0            # one huge output channel
    wq, s = q.quantize_weight(jnp.asarray(w))
    assert wq.dtype == jnp.int8 and s.shape == (4,)
    # the huge channel must not destroy the others' resolution
    back = np.asarray(wq, np.float32) * np.asarray(s)
    for c in range(4):
        denom = np.abs(w[..., c]).max()
        assert np.abs(back[..., c] - w[..., c]).max() / denom < 0.01


@pytest.mark.parametrize("kind", ["conv", "dense"])
def test_quant_layers_param_compatible(kind):
    """An int8 layer creates the same "kernel" (name, shape, initial value)
    as the float layer and as the flax.linen layer it replaced, so float
    checkpoints load unchanged."""
    nn = pytest.importorskip("flax.linen")
    from mv3d_tpu.models.layers import Module, conv, dense

    x = jnp.zeros((2, 8, 8, 6)) if kind == "conv" else jnp.zeros((4, 10))

    class Plain(Module):
        def __init__(self, quant):
            self.quant = quant

        def forward(self, s, x):
            if kind == "conv":
                return conv(s, x, 12, use_bias=False, quant=self.quant)
            return dense(s, x, 7, use_bias=False, quant=self.quant)

    class Linen(nn.Module):
        @nn.compact
        def __call__(self, x):
            if kind == "conv":
                return nn.Conv(12, (3, 3), padding="SAME", use_bias=False,
                               name="Conv_0")(x)
            return nn.Dense(7, use_bias=False, name="Dense_0")(x)

    k = jax.random.PRNGKey(0)
    vq = Plain("int8").init(k, x)
    for other in (Plain("none").init(k, x), Linen().init(k, x)):
        assert jax.tree.structure(other) == jax.tree.structure(vq)
        for a, b in zip(jax.tree.leaves(other), jax.tree.leaves(vq)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.asarray(Plain("int8").apply(vq, x + 1.0)).dtype == jnp.bfloat16


@pytest.fixture(scope="module")
def tiny_cfgs():
    from tests.test_model import tiny_config
    cfg = tiny_config()
    import dataclasses
    qcfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, quant="int8"))
    return cfg, qcfg


def test_model_quant_same_variable_tree(tiny_cfgs):
    """model.quant='int8' must not change the param/batch-stat tree: float
    checkpoints serve quantized with zero conversion."""
    from mv3d_tpu.models.mv3d_net import MV3DNet
    cfg, qcfg = tiny_cfgs
    vf = MV3DNet(cfg).init_variables(jax.random.PRNGKey(0))
    vq = MV3DNet(qcfg).init_variables(jax.random.PRNGKey(0))
    assert jax.tree.structure(vf) == jax.tree.structure(vq)
    for a, b in zip(jax.tree.leaves(vf), jax.tree.leaves(vq)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_model_quant_inference_runs_and_tracks_float(tiny_cfgs):
    """Quantized full-pipeline inference executes and stays near the float
    pipeline's RPN feature statistics (random weights: loose tolerance)."""
    from mv3d_tpu.models.mv3d_net import MV3DNet
    cfg, qcfg = tiny_cfgs
    model_f = MV3DNet(cfg)
    model_q = MV3DNet(qcfg)
    variables = model_f.init_variables(jax.random.PRNGKey(0))

    xn, yn, tc = cfg.top_shape
    rng = np.random.RandomState(3)
    top = jnp.asarray(rng.rand(1, xn, yn, tc).astype(np.float32))

    out_f = model_f.top_rpn.apply(variables["top_view_rpn"], top, False)
    out_q = model_q.top_rpn.apply(variables["top_view_rpn"], top, False)
    sf, sq = out_f["scores"], out_q["scores"]
    assert np.isfinite(np.asarray(sq)).all()
    # scores correlate strongly between float and int8 forwards
    a = np.asarray(sf, np.float64).ravel()
    b = np.asarray(sq, np.float64).ravel()
    if a.std() > 1e-6:
        corr = np.corrcoef(a, b)[0, 1]
        assert corr > 0.98, corr


def test_model_quant_training_uses_float_path(tiny_cfgs):
    """train=True ignores quant: identical apply outputs vs the float model
    (bit-exact — it IS the float program)."""
    from mv3d_tpu.models.mv3d_net import MV3DNet
    cfg, qcfg = tiny_cfgs
    model_f = MV3DNet(cfg)
    model_q = MV3DNet(qcfg)
    variables = model_f.init_variables(jax.random.PRNGKey(0))

    xn, yn, tc = cfg.top_shape
    rng = np.random.RandomState(4)
    top = jnp.asarray(rng.rand(2, xn, yn, tc).astype(np.float32))
    of, _ = model_f.top_rpn.apply(variables["top_view_rpn"], top, True,
                                  mutable=["batch_stats"])
    oq, _ = model_q.top_rpn.apply(variables["top_view_rpn"], top, True,
                                  mutable=["batch_stats"])
    np.testing.assert_array_equal(np.asarray(of["scores"]),
                                  np.asarray(oq["scores"]))
