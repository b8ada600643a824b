"""Multi-chip sharding tests on the virtual 8-device CPU mesh: the full
data-parallel train step (dryrun_multichip) and sharded inference."""

import jax
import numpy as np
import pytest


def test_mesh_shapes():
    from mv3d_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(8)
    assert mesh.devices.shape == (8, 1)
    assert mesh.axis_names == ("data", "model")
    mesh2 = make_mesh(8, model_axis=2)
    assert mesh2.devices.shape == (4, 2)


@pytest.mark.slow   # >50s: quick tier targets <5 min on one core
def test_dryrun_multichip_8():
    import __graft_entry__ as ge
    ge.dryrun_multichip(8)


@pytest.mark.slow   # >50s: quick tier targets <5 min on one core
def test_dryrun_multichip_2():
    import __graft_entry__ as ge
    ge.dryrun_multichip(2)


def test_sharded_inference():
    import __graft_entry__ as ge
    from mv3d_tpu.models.mv3d_net import MV3DNet
    from mv3d_tpu.parallel.mesh import (make_mesh, make_sharded_infer_step,
                                        replicate, shard_batch)

    cfg = ge._tiny_config()
    model = MV3DNet(cfg)
    mesh = make_mesh(4)
    variables = replicate(model.init_variables(jax.random.PRNGKey(0)), mesh)

    rng = np.random.RandomState(0)
    b, n = 4, cfg.pipeline.max_points
    pts = np.stack([rng.uniform(0, 16, (b, n)), rng.uniform(-6, 6, (b, n)),
                    rng.uniform(-4, 0.8, (b, n)), rng.uniform(0, 1, (b, n))],
                   axis=-1).astype(np.float32)
    rgb = rng.rand(b, *cfg.rgb_shape).astype(np.float32)
    batch = shard_batch({"points": pts, "rgb": rgb}, mesh)

    infer = make_sharded_infer_step(model, mesh)
    dets = infer(variables, batch["points"], batch["rgb"])
    assert np.asarray(dets.boxes3d).shape[0] == b
    assert np.isfinite(np.asarray(dets.boxes3d)).all()


def test_uneven_batch_raises_clear_error():
    """batch % mesh != 0 must fail loudly BEFORE jit with an actionable
    message, not as an XLA sharding error deep inside compilation
    (VERDICT r4 next-round #5c)."""
    import __graft_entry__ as ge
    from mv3d_tpu.parallel.mesh import (batch_divisor, check_batch_divisible,
                                        make_mesh, shard_batch)

    mesh = make_mesh(4)
    assert batch_divisor(mesh) == 4
    pts = np.zeros((6, 32, 4), np.float32)   # 6 % 4 != 0
    with pytest.raises(ValueError, match="divisible"):
        shard_batch({"points": pts}, mesh)
    with pytest.raises(ValueError, match="points"):
        check_batch_divisible({"points": pts}, mesh)
    # divisible batches pass through untouched
    ok = shard_batch({"points": np.zeros((8, 32, 4), np.float32)}, mesh)
    assert ok["points"].shape == (8, 32, 4)
    # scalars / non-arrays are ignored by the check
    check_batch_divisible({"n": 3, "tag": "x"}, mesh)


def test_chip_smoke_four_device_phase():
    """chip_smoke.py --devices 4, rehearsed on 4 virtual CPU devices at the
    tiny config: sharded train step and inference fan-out against one
    device."""
    import __graft_entry__ as ge
    import chip_smoke
    from mv3d_tpu.models.mv3d_net import MV3DNet

    cfg = ge._tiny_config()
    variables = MV3DNet(cfg).init_variables(jax.random.PRNGKey(0))
    info = chip_smoke.phase_multidevice(cfg, variables, jax.devices()[:4],
                                        seed=0)
    assert info["devices"] == 4 and len(info["detections"]) == 4
