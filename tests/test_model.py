"""End-to-end model tests on a scaled-down config: init, inference pipeline,
training forward + gradients, staged loss mix. This is the jit'd equivalent of
the reference's 1-iteration smoke harness (src/task.py -t / manager.py check)."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from mv3d_tpu.config import kitti_config
from mv3d_tpu.models import (MV3DNet, SUBNET_NAMES, TOP_VIEW_RPN, total_loss)
from mv3d_tpu.ops import boxes3d as box3d_ops


def tiny_config():
    cfg = kitti_config()
    top = dataclasses.replace(cfg.top, x_max=16.0, y_min=-6.0, y_max=6.0,
                              x_div=0.2, y_div=0.2)        # (80, 60, 27)
    front = dataclasses.replace(cfg.front, width=64, height=32)
    rpn = dataclasses.replace(cfg.rpn, nms_pre_topn=200, nms_post_topn=16)
    rcnn = dataclasses.replace(cfg.rcnn, batch_size=32)
    pipe = dataclasses.replace(cfg.pipeline, max_points=2048, max_gt=8)
    return dataclasses.replace(cfg, top=top, front=front, rpn=rpn, rcnn=rcnn,
                               pipeline=pipe, image_width=96, image_height=64)


CFG = tiny_config()


@pytest.fixture(scope="module")
def model_and_vars():
    model = MV3DNet(CFG)
    variables = model.init_variables(jax.random.PRNGKey(0))
    return model, variables


def make_batch(rng, b=1):
    g = CFG.pipeline.max_gt
    top = rng.rand(b, *CFG.top_shape).astype(np.float32) * 0.1
    rgb = rng.rand(b, *CFG.rgb_shape).astype(np.float32)
    front = rng.rand(b, *CFG.front_shape).astype(np.float32)
    gt3d = np.zeros((b, g, 8, 3), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_mask = np.zeros((b, g), bool)
    for i in range(b):
        for j in range(2):
            gt3d[i, j] = np.asarray(box3d_ops.box3d_compose(
                [6.0 + 4 * j, -2.0 + 2 * j, -1.5], [1.5, 1.6, 4.0],
                [0, 0, 0.2 * j], CFG))
            gt_labels[i, j] = 1
            gt_mask[i, j] = True
    return {
        "top": jnp.asarray(top), "rgb": jnp.asarray(rgb),
        "front": jnp.asarray(front), "gt_boxes3d": jnp.asarray(gt3d),
        "gt_labels": jnp.asarray(gt_labels), "gt_mask": jnp.asarray(gt_mask),
    }


def test_init_structure(model_and_vars):
    model, variables = model_and_vars
    assert set(variables.keys()) == set(SUBNET_NAMES)
    for name in SUBNET_NAMES:
        assert "params" in variables[name]
        assert "batch_stats" in variables[name]


def test_inference_shapes(model_and_vars, rng):
    model, variables = model_and_vars
    batch = make_batch(rng)
    dets, props = model.forward_inference(
        variables, batch["top"], batch["rgb"], batch["front"],
        score_threshold=0.0)
    r = CFG.rcnn.batch_size
    p = CFG.rpn.nms_post_topn
    assert np.asarray(props.rois).shape == (1, p, 5)
    assert np.asarray(dets.boxes3d).shape == (1, p, 8, 3)
    assert np.asarray(dets.probs).shape == (1, p)
    assert np.isfinite(np.asarray(dets.boxes3d)).all()


@pytest.mark.slow   # >50s: quick tier targets <5 min on one core
def test_train_forward_and_grads(model_and_vars, rng):
    model, variables = model_and_vars
    batch = make_batch(rng)
    key = jax.random.PRNGKey(1)

    params = {n: variables[n]["params"] for n in SUBNET_NAMES}
    stats = {n: {"batch_stats": variables[n]["batch_stats"]} for n in SUBNET_NAMES}

    def loss_fn(params):
        var = {n: {"params": params[n], **stats[n]} for n in SUBNET_NAMES}
        loss_dict, aux = model.forward_train(var, batch, key)
        return total_loss(loss_dict, SUBNET_NAMES, CFG), loss_dict

    (loss, loss_dict), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    assert np.isfinite(float(loss))
    for k, v in loss_dict.items():
        assert np.isfinite(float(v)), k
    # gradients reach every *active* subnet (front is deprecated/off by
    # default, mirroring cfg.USE_FRONT=0 — its params exist but are unused)
    active = {"top_view_rpn", "image_feature", "fusion"}
    for name in SUBNET_NAMES:
        gnorm = jax.tree_util.tree_reduce(
            lambda a, x: a + float(jnp.sum(jnp.abs(x))), grads[name], 0.0)
        if name in active:
            assert gnorm > 0, f"no gradient into {name}"
        else:
            assert gnorm == 0.0


def test_train_forward_updates_batchstats(model_and_vars, rng):
    model, variables = model_and_vars
    batch = make_batch(rng)
    _, aux = model.forward_train(variables, batch, jax.random.PRNGKey(2))
    ups = aux["updates"]
    assert ups[TOP_VIEW_RPN] is not None
    leaves = jax.tree_util.tree_leaves(ups[TOP_VIEW_RPN])
    assert len(leaves) > 0


def test_staged_loss_mix():
    ld = {"top_cls_loss": jnp.float32(1.0), "top_reg_loss": jnp.float32(2.0),
          "fuse_cls_loss": jnp.float32(3.0), "fuse_reg_loss": jnp.float32(4.0)}
    # rpn-only stage
    assert float(total_loss(ld, [TOP_VIEW_RPN], CFG)) == 3.0
    # full-net stage: 1*(1*1 + 0.05*2) + 1*3 + 0.1*4
    want = 1.0 * (1.0 * 1.0 + 0.05 * 2.0) + 1.0 * 3.0 + 0.1 * 4.0
    np.testing.assert_allclose(float(total_loss(ld, SUBNET_NAMES, CFG)), want,
                               rtol=1e-6)
    # fusion stage
    assert float(total_loss(ld, ["fusion"], CFG)) == 7.0


@pytest.mark.slow   # >50s: quick tier targets <5 min on one core
def test_batch_two_frames(model_and_vars, rng):
    model, variables = model_and_vars
    batch = make_batch(rng, b=2)
    loss_dict, aux = model.forward_train(variables, batch, jax.random.PRNGKey(3))
    assert np.isfinite(float(loss_dict["top_cls_loss"]))
    assert np.asarray(aux["fusion_targets"].rois).shape == (
        2, CFG.rcnn.batch_size, 5)


def test_siamese_fusion_mode(rng):
    """USE_SIAMESE_FUSION parity: enlarged-roi twin towers + extra fc layer."""
    import dataclasses
    cfg = dataclasses.replace(
        CFG, model=dataclasses.replace(CFG.model, use_siamese_fusion=True))
    model = MV3DNet(cfg)
    variables = model.init_variables(jax.random.PRNGKey(0))
    # ctx towers and the third fc layer exist
    fusion_params = variables["fusion"]["params"]
    assert "top_ctx_tower" in fusion_params
    assert "fc_all_3" in fusion_params
    batch = make_batch(rng)
    dets, props = model.forward_inference(
        variables, batch["top"], batch["rgb"], batch["front"],
        score_threshold=0.0)
    assert np.isfinite(np.asarray(dets.boxes3d)).all()
    # enlarge_rois geometry
    from mv3d_tpu.models.mv3d_net import enlarge_rois
    r = jnp.asarray([[10.0, 20.0, 30.0, 60.0]])
    e = np.asarray(enlarge_rois(r, 1.5))
    np.testing.assert_allclose(e, [[5.0, 10.0, 35.0, 70.0]])


def test_backbone_ablation_surface(rng):
    """The reference's backbone ablation family is constructible and runs:
    VGG rgb trunk (mv3d_net.py:214-252, cfg.RGB_BASENET) and basic-block
    resnets (resnet.py:185-258)."""
    batch = make_batch(rng)
    for mcfg in (dict(rgb_basenet="vgg"),
                 dict(backbone_block="basic")):
        cfg = dataclasses.replace(
            CFG, model=dataclasses.replace(CFG.model, **mcfg))
        model = MV3DNet(cfg)
        variables = model.init_variables(jax.random.PRNGKey(0))
        dets, props = jax.jit(partial(model.forward_inference,
                                      score_threshold=0.0))(
            variables, batch["top"], batch["rgb"], batch["front"])
        assert np.isfinite(np.asarray(dets.probs)).all(), mcfg
    # vgg trunk actually selected (param tree shape differs)
    cfg = dataclasses.replace(
        CFG, model=dataclasses.replace(CFG.model, rgb_basenet="vgg"))
    v = MV3DNet(cfg).init_variables(jax.random.PRNGKey(0))
    assert "block1_conv1" in v["image_feature"]["params"]["trunk"]
    # wrong stride for deeper repetitions is rejected
    with pytest.raises(AssertionError):
        MV3DNet(dataclasses.replace(CFG, model=dataclasses.replace(
            CFG.model, backbone_repetitions=(2, 2, 2, 2))))
