"""Golden-parity tests of the XLA voxelizers vs the numpy oracle, and of the
numpy oracle vs an independent brute-force implementation of the reference
semantics (src/data.py:296-367, 56-111).

This mirrors the reference's validation style: its CUDA voxelizer asserts
equality against the CPU path (src/net/utility/front_top_preprocess.py:195-223).
Tolerance note: the reference gets *bitwise* equality because CPU and CUDA
execute identical IEEE ops; XLA may contract mul+add into FMA, so we allow a
few-ulp tolerance (atol 5e-5) instead.

Most tests run on a scaled-down grid (20x fewer cells) for speed; full
KITTI-shape parity is covered once in test_full_grid_smoke.
"""

import dataclasses
import math

import numpy as np
import pytest

from mv3d_tpu.config import kitti_config
from mv3d_tpu.ops import voxelize, voxelize_ref

CFG = kitti_config()
# small grid: same semantics, 80x60x25 cells
SMALL = dataclasses.replace(
    CFG, top=dataclasses.replace(CFG.top, x_max=8.0, y_min=-3.0, y_max=3.0))


def make_cloud(rng, n, cfg):
    t = cfg.top
    pts = np.stack([
        rng.uniform(t.x_min - 1, t.x_max + 1, n),
        rng.uniform(t.y_min - 1, t.y_max + 1, n),
        rng.uniform(t.z_min - 1, t.z_max + 0.5, n),
        rng.uniform(0, 1, n),
    ], axis=1).astype(np.float32)
    # inject exact slice-boundary z values to exercise the inclusive-interval rule
    k = n // 50
    slices = rng.randint(0, t.zn, k)
    pts[:k, 2] = (t.z_min + slices * t.z_div).astype(np.float32)
    return pts


def brute_force_top(points, cfg):
    """Literal per-cell implementation of the reference semantics."""
    t = cfg.top
    m = ((points[:, 0] > t.x_min) & (points[:, 0] < t.x_max) &
         (points[:, 1] > t.y_min) & (points[:, 1] < t.y_max) &
         (points[:, 2] > t.z_min) & (points[:, 2] < t.z_max))
    p = points[m]
    qx = ((p[:, 0] - t.x_min) // t.x_div).astype(int)
    qy = ((p[:, 1] - t.y_min) // t.y_div).astype(int)
    qz = ((p[:, 2] - t.z_min) / t.z_div).astype(np.float32)
    top = np.zeros((t.xn, t.yn, t.zn + 2), dtype=np.float32)
    for x in np.unique(qx):
        ix = qx == x
        for y in np.unique(qy[ix]):
            sel = ix & (qy == y)
            zs, rs = qz[sel], p[sel, 3]
            count = sel.sum()
            top[t.xn - 1 - x, t.yn - 1 - y, t.zn + 1] = min(
                1.0, np.float32(np.log(count + 1) / math.log(32)))
            top[t.xn - 1 - x, t.yn - 1 - y, t.zn] = rs[np.argmax(zs)]
            for z in range(t.zn):
                in_sl = (zs >= z) & (zs <= z + 1)
                if in_sl.any():
                    top[t.xn - 1 - x, t.yn - 1 - y, z] = max(
                        0.0, np.max(zs[in_sl]) - z)
    return top


def test_numpy_oracle_matches_brute_force(rng):
    pts = make_cloud(rng, 3000, SMALL)
    got = voxelize_ref.lidar_to_top_np(pts, SMALL)
    want = brute_force_top(pts, SMALL)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_xla_top_matches_numpy_oracle(rng):
    pts = make_cloud(rng, 4000, SMALL)
    padded, _ = voxelize.pad_points(pts, 8192)
    got = np.asarray(voxelize.lidar_to_top(padded, SMALL))
    want = voxelize_ref.lidar_to_top_np(pts, SMALL)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_xla_front_matches_numpy_oracle(rng):
    pts = make_cloud(rng, 4000, SMALL)
    padded, _ = voxelize.pad_points(pts, 8192)
    got = np.asarray(voxelize.lidar_to_front(padded, SMALL))
    want = voxelize_ref.lidar_to_front_np(pts, SMALL)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=5e-5)


def test_batched_matches_single(rng):
    pts1 = make_cloud(rng, 2000, SMALL)
    pts2 = make_cloud(rng, 2000, SMALL)
    p1, _ = voxelize.pad_points(pts1, 4096)
    p2, _ = voxelize.pad_points(pts2, 4096)
    batch = np.stack([p1, p2])
    tops = np.asarray(voxelize.lidar_to_top_batch(batch, SMALL))
    # vmap may reassociate the scatter arithmetic: allow a few ulp
    np.testing.assert_allclose(
        tops[0], np.asarray(voxelize.lidar_to_top(p1, SMALL)), atol=1e-5)
    np.testing.assert_allclose(
        tops[1], np.asarray(voxelize.lidar_to_top(p2, SMALL)), atol=1e-5)


def test_num_points_masking(rng):
    pts = make_cloud(rng, 1000, SMALL)
    padded, n = voxelize.pad_points(pts, 2048)
    # fill padding with in-bounds junk; the mask must exclude it
    padded_junk = padded.copy()
    padded_junk[n:] = make_cloud(rng, 2048 - n, SMALL)
    got = np.asarray(voxelize.lidar_to_top(
        padded_junk, SMALL, num_points=np.int32(n)))
    want = voxelize_ref.lidar_to_top_np(pts, SMALL)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_empty_cloud():
    padded, _ = voxelize.pad_points(np.zeros((0, 4), np.float32), 1024)
    top = np.asarray(voxelize.lidar_to_top(padded, SMALL))
    front = np.asarray(voxelize.lidar_to_front(padded, SMALL))
    assert top.shape == SMALL.top.shape
    assert front.shape == SMALL.front.shape
    assert np.all(top == 0) and np.all(front == 0)


def test_full_grid_smoke(rng):
    """One full-KITTI-shape run: XLA vs oracle on the real (800,600,27) grid."""
    pts = make_cloud(rng, 5000, CFG)
    padded, _ = voxelize.pad_points(pts, 8192)
    got = np.asarray(voxelize.lidar_to_top(padded, CFG))
    want = voxelize_ref.lidar_to_top_np(pts, CFG)
    assert got.shape == (800, 600, 27)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_shapes():
    # NOTE: (800, 600), not (801, 601): the reference computes
    # int((80-0)//0.1)+1 and IEEE float gives 80//0.1 == 799.0
    # (src/data.py:327-329; confirmed by the loader fallback shape
    # (800, 600, 27), batch_loading.py:620-622, and the 600*800/4/4*4 = 120000
    # anchor-count comment, src/config.py:56).
    assert CFG.top.shape == (800, 600, 27)
    assert CFG.front.shape == (1500, 100, 3)
    assert CFG.top.zn == 25


def test_aux_channel_path(rng):
    """Hybrid path: device heights + host-computed aux == full voxelization."""
    pts = make_cloud(rng, 4000, SMALL)
    padded, _ = voxelize.pad_points(pts, 8192)
    want = voxelize_ref.lidar_to_top_np(pts, SMALL)
    aux = want[:, :, SMALL.top.zn:]
    got = np.asarray(voxelize.lidar_to_top(padded, SMALL, aux=aux))
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)
    # batched
    got_b = np.asarray(voxelize.lidar_to_top_batch(
        padded[None], SMALL, aux=aux[None]))
    np.testing.assert_allclose(got_b[0], want, rtol=0, atol=5e-5)


def test_native_aux_matches_oracle(rng):
    from mv3d_tpu import native
    if not native.available():
        import pytest
        pytest.skip("no C++ toolchain")
    pts = make_cloud(rng, 4000, SMALL)
    aux = native.lidar_to_top_aux(pts, SMALL)
    want = voxelize_ref.lidar_to_top_np(pts, SMALL)[:, :, SMALL.top.zn:]
    np.testing.assert_allclose(aux, want, rtol=0, atol=2e-5)


def test_didi_center_car_filter(rng):
    """didi presets remove the capture vehicle's own returns
    (|x|<=2.35 & |y|<=1.05, src/data.py:224-227) before voxelizing."""
    didi = dataclasses.replace(
        SMALL, dataset_type="didi2",
        top=dataclasses.replace(SMALL.top, x_min=-8.0, x_max=8.0))
    pts = make_cloud(rng, 3000, didi)
    # plant points at the vehicle center: must vanish under didi, stay in kitti
    pts[:50, 0] = rng.uniform(-1.0, 1.0, 50)
    pts[:50, 1] = rng.uniform(-0.5, 0.5, 50)
    pts[:50, 2] = 0.2

    padded, _ = voxelize.pad_points(pts, 8192)
    got = np.asarray(voxelize.lidar_to_top(padded, didi))
    want = voxelize_ref.lidar_to_top_np(pts, didi)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)

    kitti_like = dataclasses.replace(didi, dataset_type="kitti")
    got_k = np.asarray(voxelize.lidar_to_top(padded, kitti_like))
    # the center cells are occupied without the filter, empty with it
    assert got_k.sum() > got.sum()

    # the *front* view never applies the filter (reference crops the front
    # path to the grid bounds alone, src/data.py:72-85): didi == kitti
    front_didi = np.asarray(voxelize.lidar_to_front(padded, didi))
    front_kitti = np.asarray(voxelize.lidar_to_front(padded, kitti_like))
    np.testing.assert_array_equal(front_didi, front_kitti)
    np.testing.assert_allclose(
        front_didi, voxelize_ref.lidar_to_front_np(pts, didi),
        rtol=0, atol=5e-5)


def test_return_occ_mask_parity(rng):
    """The voxelizer's return_occ output drives the empty-anchor filter to a
    BIT-IDENTICAL mask vs summing the assembled view (the count proxy shares
    the channel sum's zero-set at threshold 0.0 — _occ_from_cells)."""
    from mv3d_tpu.ops import anchors as anchor_ops

    pts = make_cloud(rng, 3000, SMALL)
    padded, _ = voxelize.pad_points(pts, 8192)
    top, occ = voxelize.lidar_to_top(padded, SMALL, return_occ=True)
    bases = anchor_ops.mv3d_car_bases()
    feat = SMALL.top_feature_shape()
    want = np.asarray(anchor_ops.non_empty_anchor_mask_structured(
        top, bases, 8, feat, 0.0))
    got = np.asarray(anchor_ops.non_empty_anchor_mask_structured(
        top, bases, 8, feat, 0.0, occ=occ))
    np.testing.assert_array_equal(got, want)
    # occ zero-set == view channel-sum zero-set
    view_sum = np.asarray(top).sum(-1)
    np.testing.assert_array_equal(np.asarray(occ) > 0, view_sum > 0)
