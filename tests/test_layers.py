"""The plain-JAX layers (models/layers.py) and every subnet built on them
against their flax.linen twins (tests/flax_reference.py): the same variable
tree (names, shapes, initial values from the same key), the same outputs in
inference and training mode, the same updated batch statistics, and
checkpoints written with the old tree restore into the new model."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mv3d_tpu.models import layers as L
from mv3d_tpu.models import nets as N
from tests.test_model import tiny_config

KEY = jax.random.PRNGKey(7)


@pytest.fixture(scope="module")
def linen():
    return pytest.importorskip("flax.linen")


@pytest.fixture(scope="module")
def ref():
    pytest.importorskip("flax")
    from tests import flax_reference
    return flax_reference


def assert_same_tree(a, b):
    assert jax.tree.structure(a) == jax.tree.structure(b)
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


class _One(L.Module):
    """A module holding one layer, for the layer-level cases."""

    def __init__(self, fn):
        self.fn = fn

    def forward(self, s, x, train=False):
        return self.fn(s, x, train)


def _layer_cases(nn):
    bf16 = jnp.bfloat16
    return {
        "conv_bf16_strided": (
            lambda s, x, t: L.conv(s, x, 16, (3, 3), (2, 2), dtype=bf16),
            lambda: nn.Conv(16, (3, 3), (2, 2), padding="SAME", dtype=bf16,
                            name="Conv_0"),
            (2, 9, 11, 5)),
        "conv_f32_nobias": (
            lambda s, x, t: L.conv(s, x, 8, (1, 1), use_bias=False,
                                   dtype=jnp.float32),
            lambda: nn.Conv(8, (1, 1), padding="SAME", use_bias=False,
                            dtype=jnp.float32, name="Conv_0"),
            (2, 6, 6, 4)),
        "dense": (
            lambda s, x, t: L.dense(s, x, 12, dtype=bf16),
            lambda: nn.Dense(12, dtype=bf16, name="Dense_0"),
            (5, 20)),
        "batch_norm_train": (
            lambda s, x, t: L.batch_norm(s, x, True),
            lambda: nn.BatchNorm(use_running_average=False, momentum=0.9,
                                 dtype=jnp.float32, name="BatchNorm_0"),
            (3, 4, 4, 6)),
        "batch_norm_eval": (
            lambda s, x, t: L.batch_norm(s, x, False),
            lambda: nn.BatchNorm(use_running_average=True, momentum=0.9,
                                 dtype=jnp.float32, name="BatchNorm_0"),
            (3, 4, 4, 6)),
        "conv_transpose": (
            lambda s, x, t: L.conv_transpose(
                s, x, 6, (4, 4), (2, 2), kernel_init=L.lecun_normal,
                dtype=bf16),
            lambda: nn.ConvTranspose(6, (4, 4), strides=(2, 2),
                                     padding="SAME", dtype=bf16,
                                     name="ConvTranspose_0"),
            (2, 5, 7, 3)),
    }


@pytest.mark.parametrize("case", ["conv_bf16_strided", "conv_f32_nobias",
                                  "dense", "batch_norm_train",
                                  "batch_norm_eval", "conv_transpose"])
def test_layer_matches_linen(linen, case):
    mine, theirs, shape = _layer_cases(linen)[case]
    x = jnp.asarray(np.random.RandomState(0).randn(*shape), jnp.float32)

    class Linen(linen.Module):
        @linen.compact
        def __call__(self, x):
            return theirs()(x)

    v_ref = Linen().init(KEY, x)
    v = _One(mine).init(KEY, x)
    assert_same_tree(v, v_ref)
    # non-trivial statistics so the eval-mode case normalises for real
    if "batch_stats" in v:
        stats = {"BatchNorm_0": {"mean": jnp.full((shape[-1],), 0.3),
                                 "var": jnp.full((shape[-1],), 2.0)}}
        v = v_ref = {**v, "batch_stats": stats}
    mutable = ["batch_stats"] if case == "batch_norm_train" else []
    out = _One(mine).apply(v, x, mutable=mutable)
    out_ref = Linen().apply(v_ref, x, mutable=mutable or False)
    assert_same_tree(out, out_ref)


@pytest.mark.parametrize("pool", ["max", "avg"])
def test_pool_matches_linen(linen, pool):
    x = jnp.asarray(np.random.RandomState(1).randn(2, 7, 9, 3), jnp.float32)
    if pool == "max":
        got = L.max_pool(x, (3, 3), (2, 2))
        want = linen.max_pool(x, (3, 3), strides=(2, 2), padding="SAME")
    else:
        got = L.avg_pool(x, (2, 2), (2, 2))
        want = linen.avg_pool(x, (2, 2), strides=(2, 2), padding="SAME")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


CFG = tiny_config()


def _subnet_cases():
    fusion_cfg = dataclasses.replace(CFG, model=dataclasses.replace(
        CFG.model, use_siamese_fusion=True, use_learnable_fusion=True))
    top = (1, 16, 24, CFG.top.channels)
    rgb = (1, 32, 48, 3)
    return {
        "top_rpn_s2d2": (lambda m: m.TopRPN(4, s2d_factor=2), top),
        "top_rpn_upsample": (lambda m: m.TopRPN(4, upsample=True), top),
        "rgb_resnet_s2d4": (lambda m: m.RgbFeatureNet(s2d_factor=4), rgb),
        "rgb_vgg": (lambda m: m.RgbFeatureNet(basenet="vgg"), rgb),
        "front_basic_block": (
            lambda m: m.FrontFeatureNet(block="basic", repetitions=(2, 2)),
            (1, 24, 16, 3)),
        "fusion_default": (lambda m: m.FusionHead(CFG), None),
        "fusion_siamese_learnable": (lambda m: m.FusionHead(fusion_cfg),
                                     "siamese"),
    }


def _subnet_input(shape, seed):
    rng = np.random.RandomState(seed)
    if shape is None or shape == "siamese":
        views = ("top", "rgb")
        feats = {v: jnp.asarray(rng.rand(3, 6, 6, 128), jnp.float32)
                 for v in views}
        if shape == "siamese":
            feats.update({v + "_ctx": feats[v] * 0.5 for v in views})
        return feats
    return jnp.asarray(rng.rand(*shape), jnp.float32)


@pytest.mark.parametrize("case", list(_subnet_cases()))
def test_subnet_matches_linen(ref, case):
    build, shape = _subnet_cases()[case]
    x = _subnet_input(shape, 2)
    mine, theirs = build(N), build(ref)

    def same_outputs(out, out_ref):
        # the twin returns a subset of the fusion head's output keys
        if isinstance(out, dict):
            out = {k: out[k] for k in out_ref}
        assert_same_tree(out, out_ref)

    v = mine.init(KEY, x)
    assert_same_tree(v, theirs.init(KEY, x))
    same_outputs(mine.apply(v, x, False), theirs.apply(v, x, False))
    out, upd = mine.apply(v, x, True, mutable=["batch_stats"])
    out_ref, upd_ref = theirs.apply(v, x, True, mutable=["batch_stats"])
    same_outputs(out, out_ref)
    assert_same_tree(upd, upd_ref)


def test_gru_tracker_matches_linen(ref):
    from mv3d_tpu.tracking.seq_model import MotionGRU

    x = jnp.asarray(np.random.RandomState(3).randn(2, 6, 3), jnp.float32)
    v = MotionGRU(16).init(KEY, x)
    v_ref = ref.MotionGRU(16).init(KEY, x)
    assert_same_tree(v, v_ref)
    np.testing.assert_allclose(np.asarray(MotionGRU(16).apply(v, x)),
                               np.asarray(ref.MotionGRU(16).apply(v, x)),
                               rtol=1e-6, atol=1e-6)


def test_old_npz_checkpoint_restores(ref, tmp_path):
    """A subnet checkpoint saved from the flax.linen variables loads into
    the model through train/checkpoint.py and gives the same outputs."""
    from mv3d_tpu.models.mv3d_net import MV3DNet
    from mv3d_tpu.models.nets import TOP_VIEW_RPN
    from mv3d_tpu.train.checkpoint import SubnetCheckpointer

    model = MV3DNet(CFG)
    m = CFG.model
    old = ref.TopRPN(num_bases=len(m.bases), s2d_factor=2)
    top = _subnet_input((1, *CFG.top_shape), 4)
    v_old = old.init(jax.random.PRNGKey(11), top)
    ck = SubnetCheckpointer(TOP_VIEW_RPN, str(tmp_path))
    ck.save(v_old, step=3)

    fresh = model.init_variables(jax.random.PRNGKey(0))[TOP_VIEW_RPN]
    restored = ck.load(step=3)
    assert jax.tree.structure(restored) == jax.tree.structure(fresh)
    assert_same_tree(model.top_rpn.apply(restored, top, False),
                     old.apply(v_old, top, False))
