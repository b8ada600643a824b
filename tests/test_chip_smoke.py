"""chip_smoke.py's phases at the tiny test config on the CPU, its device
guard, bench.py's peak table, and the compile-cache helper. The phases run
here against the same references they use on the card; only the sizes
differ."""

import os

import jax
import pytest

import bench
import chip_smoke as cs
from __graft_entry__ import _tiny_config
from mv3d_tpu.utils import compile_cache

CFG = _tiny_config()


@pytest.fixture(scope="module")
def variables():
    from mv3d_tpu.models.mv3d_net import MV3DNet
    return MV3DNet(CFG).init_variables(jax.random.PRNGKey(0))


def test_device_guard_refuses_cpu():
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        cs.check_device(jax.devices("cpu"))


@pytest.mark.parametrize("kind,ok", [("NVIDIA H100 80GB HBM3", True),
                                     ("cpu", False),
                                     ("NVIDIA A100-SXM4-80GB", False)])
def test_peak_table_by_device_kind(kind, ok):
    if ok:
        peaks = bench.device_peaks(kind)
        assert peaks["bf16_flops"] == 989e12
        assert peaks["hbm_bytes_per_s"] == 3.35e12
    else:
        with pytest.raises(ValueError, match="no published peaks"):
            bench.device_peaks(kind)


def test_voxelizer_byte_floor():
    # points read + top view, occupancy and front view written, f32
    want = 4 * (65536 * 4 + 800 * 600 * 28 + 1500 * 100 * 3)
    from mv3d_tpu.config import kitti_config
    assert bench.voxelizer_bytes(kitti_config()) == want


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(monkeypatch, tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR wins and nothing is set in code; without
    it the cache goes to <checkout>/.jax_cache[/subdir]."""
    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.setup_compile_cache("sub") == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(compile_cache.CHECKOUT, ".jax_cache", "sub")
            assert compile_cache.setup_compile_cache("sub") == want
            assert jax.config.jax_compilation_cache_dir == want
            # a second call keeps the placement
            assert compile_cache.setup_compile_cache() == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert compile_cache.CHECKOUT == os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))


def test_phase_voxelizer():
    info = cs.phase_voxelizer(CFG, 3, seed=1)
    assert info["frames"] == 3 and info["occupied_cells"] > 0


def test_phase_nms():
    info = cs.phase_nms(1000, CFG.rpn.nms_thresh, seed=2)
    assert 0 < info["kept"] < 1000


def test_phase_inference(variables):
    info = cs.phase_inference(CFG, variables, 2, seed=3)
    assert info["mask_agreement"] == 1.0


def test_phase_serving(variables, tmp_path):
    info = cs.phase_serving(CFG, variables, str(tmp_path), seed=4)
    assert len(info["boxes"]) == 3


def test_phase_training(tmp_path):
    info = cs.phase_training(CFG, str(tmp_path), 2, 2, seed=5)
    assert set(info["losses"]) == {"top_cls_loss", "top_reg_loss",
                                   "fuse_cls_loss", "fuse_reg_loss"}
