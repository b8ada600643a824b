"""Smoke test of the lidar+camera -> 3D boxes system on a CUDA GPU.

    python chip_smoke.py               # one card: phases (a)-(f)
    python chip_smoke.py --devices 4   # four cards: phase (g) only

Runs the main path once through the entry points a user calls, at the full
width of the KITTI model (``config.kitti_config()``), with random weights
made from ``--seed``, in one process:

  (a) device    the default device is a GPU (no CPU fallback); prints its
                kind, count, JAX version, XLA_FLAGS, compile-cache path and
                ``nvidia-smi`` name / power limit
  (b) voxelizer top and front views of 8 x 65,536 points against the numpy
                references (ops/voxelize_ref.py)
  (c) NMS       1,000 proposals against ``greedy_nms_np``
  (d) inference the jitted lidar -> boxes program at batch 8 on the GPU,
                frame 0 against the same program on the host CPU
  (e) serving   an exported artifact behind the HTTP server, 3 requests
  (f) training  3 ``Trainer.fit_iteration`` steps, batch 2, all subnets
  (g) 4 cards   the data-parallel train step and the serving fan-out
                (parallel/mesh.py) against the same global batch on one card

Every phase raises on a failed check, so the script exits non-zero; only
when all phases pass does it print, as its last line,
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
"""

from __future__ import annotations

import argparse
import http.client
import io
import json
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# (a) device
# ---------------------------------------------------------------------------

def check_device(devices) -> None:
    """Refuse anything but a GPU: a CPU run proves nothing about the card."""
    if not devices or devices[0].platform != "gpu":
        raise RuntimeError(
            f"chip_smoke needs a CUDA GPU; JAX found "
            f"{[d.platform for d in devices]}")


def describe_device(devices) -> str:
    import jax
    from mv3d_tpu.utils.compile_cache import setup_compile_cache

    d = devices[0]
    log(f"device_kind: {d.device_kind}  count: {len(devices)}  "
        f"jax {jax.__version__}")
    log(f"XLA_FLAGS: {os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {setup_compile_cache()}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(f"nvidia-smi name, power.limit: {card}")
    return card


# ---------------------------------------------------------------------------
# inputs made from a seed
# ---------------------------------------------------------------------------

def make_clouds(cfg, batch: int, seed: int):
    """(B, N, 4) point buffers and (B,) counts: points over the top-view
    crop plus a margin outside it, and frames of different lengths.

    Points within 1e-3 of a cell, slice or front-view pixel boundary are
    left out: the device's f32 division and atan2 may differ from the
    host's by an ulp and file such a point into the neighbouring cell,
    which says nothing about the scatters under test (the CPU tests cover
    the boundary rules)."""
    t, f = cfg.top, cfg.front
    n = cfg.pipeline.max_points
    rng = np.random.RandomState(seed)
    pts = np.full((batch, n, 4), -1e9, np.float32)
    nums = np.zeros(batch, np.int32)
    for i in range(batch):
        m = 2 * n
        p = np.stack([rng.uniform(t.x_min - 2, t.x_max + 2, m),
                      rng.uniform(t.y_min - 2, t.y_max + 2, m),
                      rng.uniform(t.z_min - 0.3, t.z_max + 0.3, m),
                      rng.uniform(0, 1, m)], axis=1).astype(np.float32)
        q = p.astype(np.float64)
        clear = np.ones(m, bool)
        for c in ((q[:, 0] - t.x_min) / t.x_div, (q[:, 1] - t.y_min) / t.y_div,
                  (q[:, 2] - t.z_min) / t.z_div,
                  np.arctan2(q[:, 1], q[:, 0]) / f.angular_res,
                  np.arctan2(q[:, 2], np.hypot(q[:, 0], q[:, 1]))
                  / f.vertical_res):
            clear &= np.abs(c - np.round(c)) > 1e-3
        p = p[clear]
        nums[i] = n - 1024 * i if i < batch // 2 else n
        pts[i, :nums[i]] = p[:nums[i]]
    return pts, nums


def make_rgb(cfg, batch: int, seed: int) -> np.ndarray:
    rng = np.random.RandomState(seed + 1)
    return (rng.rand(batch, *cfg.rgb_shape) * 255).astype(np.float32)


def make_gt(cfg, batch: int):
    """A few cars per frame at several yaws."""
    from mv3d_tpu.ops import boxes3d as box3d_ops

    g = cfg.pipeline.max_gt
    t = cfg.top
    gt3d = np.zeros((batch, g, 8, 3), np.float32)
    labels = np.zeros((batch, g), np.int32)
    mask = np.zeros((batch, g), bool)
    for i in range(batch):
        for j in range(min(4, g)):
            x = t.x_min + (t.x_max - t.x_min) * (0.2 + 0.15 * j)
            y = t.y_min + (t.y_max - t.y_min) * (0.3 + 0.1 * j)
            gt3d[i, j] = np.asarray(box3d_ops.box3d_compose(
                [x, y, -1.5], [1.5, 1.6, 4.0], [0.0, 0.0, 0.4 * j], cfg))
            labels[i, j] = 1
            mask[i, j] = True
    return gt3d, labels, mask


# ---------------------------------------------------------------------------
# (b) voxelizer
# ---------------------------------------------------------------------------

# one ulp of a height in slice units below 32 slices is 2^-19; allow two
HEIGHT_ATOL = 2.0 ** -18


def phase_voxelizer(cfg, batch: int, seed: int) -> dict:
    """Top and front views on the default device against the numpy
    references.

    Tolerances: XLA's f32 division on the GPU is one ulp off IEEE division
    for ~14% of quotients (measured on an H100), so a height, the fraction
    of a slice above its floor, may be one ulp of the height in slice units
    off: atol HEIGHT_ATOL. Intensity is the reflectance of the highest point
    in a cell, copied, so it is compared bit for bit, and per-cell counts
    are whole numbers, compared exactly. Density is log(count+1)/log 32:
    the device's logf and the host's may differ by an ulp, so rtol 1e-6.
    The front view is a mean of float sums whose scatter-add order changes
    run to run on the device: rtol 1e-5."""
    import jax
    from mv3d_tpu.ops import voxelize, voxelize_ref

    pts, nums = make_clouds(cfg, batch, seed)

    @jax.jit
    def views(p, n):
        top, occ = voxelize.lidar_to_top_batch(p, cfg, n, return_occ=True)
        return top, occ, voxelize.lidar_to_front_batch(p, cfg, n)

    top, occ, front = (np.asarray(a) for a in views(pts, nums))
    zn = cfg.top.zn
    for i in range(batch):
        want = voxelize_ref.lidar_to_top_np(pts[i, :nums[i]], cfg)
        np.testing.assert_allclose(top[i, ..., :zn], want[..., :zn], rtol=0,
                                   atol=HEIGHT_ATOL,
                                   err_msg=f"heights, frame {i}")
        np.testing.assert_array_equal(top[i, ..., zn], want[..., zn],
                                      err_msg=f"intensity, frame {i}")
        np.testing.assert_allclose(top[i, ..., zn + 1], want[..., zn + 1],
                                   rtol=1e-6, atol=0,
                                   err_msg=f"density, frame {i}")
        dens = want[..., zn + 1]
        exact = dens < 1.0          # invertible: count = 32**density - 1
        counts = np.round(np.exp2(5.0 * dens[exact].astype(np.float64)) - 1)
        np.testing.assert_array_equal(occ[i][exact], counts,
                                      err_msg=f"counts, frame {i}")
        np.testing.assert_array_equal(occ[i][~exact] >= 31, True)
        np.testing.assert_allclose(
            front[i], voxelize_ref.lidar_to_front_np(pts[i, :nums[i]], cfg),
            rtol=1e-5, atol=1e-6, err_msg=f"front, frame {i}")
    info = {"frames": batch, "points": int(nums.sum()),
            "occupied_cells": int((occ > 0).sum())}
    log(f"phase b voxelizer ok: {info}")
    return info


# ---------------------------------------------------------------------------
# (c) NMS
# ---------------------------------------------------------------------------

def phase_nms(n: int, iou_threshold: float, seed: int) -> dict:
    """Greedy NMS on the default device against ``greedy_nms_np``: the same
    keep set, in the same order.

    Box corners lie on a quarter-pixel grid and the threshold is the
    config's 0.5, so every area, product and comparison is exact in f32
    and no contraction into a fused multiply-add can move a decision."""
    import jax
    from mv3d_tpu.ops.nms import greedy_nms, greedy_nms_np

    rng = np.random.RandomState(seed)
    xy = np.round(rng.uniform(0, 600, (n, 2)) * 4) / 4
    wh = np.round(rng.uniform(4, 60, (n, 2)) * 4) / 4
    boxes = np.concatenate([xy, xy + wh], axis=1).astype(np.float32)
    scores = (rng.permutation(n) / n).astype(np.float32)   # no ties

    keep_idx, keep_mask = jax.jit(greedy_nms, static_argnums=(3, 4))(
        boxes, scores, np.ones(n, bool), iou_threshold, n)
    got = np.asarray(keep_idx)[np.asarray(keep_mask)]
    want = greedy_nms_np(boxes, scores, iou_threshold)
    np.testing.assert_array_equal(got, want)
    info = {"candidates": n, "kept": int(len(want))}
    log(f"phase c nms ok: {info}")
    return info


# ---------------------------------------------------------------------------
# (d) full inference, device against host CPU
# ---------------------------------------------------------------------------

# RPN logits come out of ~25 bf16 convs. The card and the host round every
# conv output to bf16 (2^-8 relative) after summing in different orders, so
# the logits may differ by a few bf16 steps of their own scale.
RPN_SCORE_TOL = 2.0 ** -4       # max |diff| over max |logit|
# A near-tie among ~10^5 anchor scores can swap a proposal, and after the
# 0.001-IoU final NMS that adds or drops a box or two: the masks are a
# prefix of the 30 slots, so agreement is 1 - |count difference| / 30
# (0.933 on the first H100 run). Most slots must still agree.
MASK_AGREEMENT_MIN = 0.8


def _inference_fn(model, cfg, score_threshold: float):
    from mv3d_tpu.models.nets import TOP_VIEW_RPN
    from mv3d_tpu.ops.voxelize import lidar_to_front_batch, lidar_to_top_batch

    def fn(variables, points, num_points, rgb):
        top, occ = lidar_to_top_batch(points, cfg, num_points,
                                      return_occ=True)
        front = lidar_to_front_batch(points, cfg, num_points)
        rpn = model.top_rpn.apply(variables[TOP_VIEW_RPN], top, False)
        dets, _ = model.forward_inference(
            variables, top, rgb, front, score_threshold=score_threshold,
            top_occ=occ)
        return rpn["scores"], dets.boxes3d, dets.probs, dets.mask

    return fn


def phase_inference(cfg, variables, batch: int, seed: int,
                    score_threshold: float = 0.05) -> dict:
    """lidar -> boxes at ``batch`` on the default device; frame 0 again on
    the host CPU. Checks finite boxes of the expected shape, the RPN scores
    within RPN_SCORE_TOL and the detection masks agreeing on at least
    MASK_AGREEMENT_MIN of the slots."""
    import jax
    from mv3d_tpu.models.mv3d_net import MV3DNet

    model = MV3DNet(cfg)
    fn = _inference_fn(model, cfg, score_threshold)
    pts, nums = make_clouds(cfg, batch, seed)
    rgb = make_rgb(cfg, batch, seed)

    compiled = jax.jit(fn).lower(variables, pts, nums, rgb).compile()
    log(f"inference memory_analysis (batch {batch}): "
        f"{compiled.memory_analysis()}")
    scores, boxes, probs, mask = (np.asarray(a) for a in
                                  compiled(variables, pts, nums, rgb))
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}")
    r = cfg.rpn.nms_post_topn
    assert boxes.shape == (batch, r, 8, 3), boxes.shape
    assert np.isfinite(boxes).all() and np.isfinite(scores).all()

    cpu = jax.devices("cpu")[0]
    ref = jax.jit(fn)(jax.device_put(variables, cpu),
                      *(jax.device_put(a[:1], cpu) for a in (pts, nums, rgb)))
    s_ref, _, _, m_ref = (np.asarray(a) for a in ref)
    err = float(np.abs(scores[0] - s_ref[0]).max()
                / max(np.abs(s_ref[0]).max(), 1e-6))
    agree = float((mask[0] == m_ref[0]).mean())
    info = {"batch": batch, "detections_frame0": int(mask[0].sum()),
            "rpn_score_err": err, "mask_agreement": agree}
    assert err <= RPN_SCORE_TOL, info
    assert agree >= MASK_AGREEMENT_MIN, info
    log(f"phase d inference ok: {info}")
    return info


# ---------------------------------------------------------------------------
# (e) serving
# ---------------------------------------------------------------------------

def phase_serving(cfg, variables, workdir: str, seed: int,
                  n_requests: int = 3) -> dict:
    """Export the serving program for the default backend, load it behind
    ``cli/serve.py``'s HTTP server on a free local port, and answer
    ``n_requests`` single-frame requests with finite boxes."""
    from mv3d_tpu.cli.serve import make_server
    from mv3d_tpu.serving import export_serving

    art = export_serving(variables, cfg, os.path.join(workdir, "artifact"),
                         batch_size=1, score_threshold=0.05)
    srv = make_server(art, host="127.0.0.1", port=0)
    port = srv.server_address[1]
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    pts, nums = make_clouds(cfg, n_requests, seed)
    rgb = make_rgb(cfg, n_requests, seed)
    n_boxes = []
    try:
        for i in range(n_requests):
            buf = io.BytesIO()
            np.savez(buf, points=pts[i, :nums[i]], rgb=rgb[i])
            conn = http.client.HTTPConnection("127.0.0.1", port, timeout=900)
            try:
                conn.request("POST", "/predict", body=buf.getvalue())
                resp = conn.getresponse()
                body = resp.read()
            finally:
                conn.close()
            assert resp.status == 200, (resp.status, body[:500])
            with np.load(io.BytesIO(body)) as z:
                boxes, probs = z["boxes3d"], z["probs"]
            assert boxes.ndim == 3 and boxes.shape[1:] == (8, 3), boxes.shape
            assert np.isfinite(boxes).all() and np.isfinite(probs).all()
            n_boxes.append(int(boxes.shape[0]))
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)
    info = {"requests": n_requests, "boxes": n_boxes}
    log(f"phase e serving ok: {info}")
    return info


# ---------------------------------------------------------------------------
# (f) training
# ---------------------------------------------------------------------------

def _train_batch(cfg, batch: int, seed: int) -> dict:
    pts, nums = make_clouds(cfg, batch, seed)
    gt3d, labels, mask = make_gt(cfg, batch)
    return {"points": pts, "num_points": nums,
            "rgb": make_rgb(cfg, batch, seed), "gt_boxes3d": gt3d,
            "gt_labels": labels, "gt_mask": mask}


def phase_training(cfg, workdir: str, batch: int, steps: int,
                   seed: int) -> dict:
    """``steps`` Trainer.fit_iteration steps on all four subnets; every loss
    finite."""
    from mv3d_tpu.models.nets import SUBNET_NAMES
    from mv3d_tpu.train.trainer import Trainer

    data = _train_batch(cfg, batch, seed)
    tr = Trainer(None, train_targets=list(SUBNET_NAMES), cfg=cfg,
                 log_tag="smoke", checkpoint_dir=os.path.join(workdir, "ckpt"),
                 log_dir=os.path.join(workdir, "log"), seed=seed)
    losses = [tr.fit_iteration(data) for _ in range(steps)]
    for step in losses:
        assert all(np.isfinite(v) for v in step.values()), losses
    info = {"batch": batch, "steps": steps, "losses": losses[-1]}
    log(f"phase f training ok: {info}")
    return info


# ---------------------------------------------------------------------------
# (g) data parallel over several devices
# ---------------------------------------------------------------------------

# Losses of the same global batch on 1 and on n devices. The per-device
# batch differs, so the convs may take other algorithms and batch-norm and
# loss means reduce in another order, in bf16: the RPN losses, smooth
# functions of the weights, agree within 1%. The fusion losses are means
# over ROIs sampled from the proposals; a near-tie among proposal scores
# that resolves the other way swaps sampled ROIs and moves them by steps
# (4.6% on 4 virtual CPU devices at the tiny test config, 32 ROIs a frame).
MESH_RPN_LOSS_RTOL = 1e-2
MESH_FUSION_LOSS_RTOL = 1e-1


def phase_multidevice(cfg, variables, devices, seed: int) -> dict:
    """One data-parallel train step and the inference fan-out on a mesh of
    ``devices``, against the same global batch on ``devices[0]`` alone.

    Losses agree within MESH_RPN_LOSS_RTOL / MESH_FUSION_LOSS_RTOL. The
    fan-out runs one frame per
    device, so its reference runs the same frames one at a time on one
    device, the same per-device program: detection masks must be
    identical."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from mv3d_tpu.models.mv3d_net import MV3DNet
    from mv3d_tpu.models.nets import SUBNET_NAMES
    from mv3d_tpu.ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
    from mv3d_tpu.parallel.mesh import (make_mesh, make_sharded_infer_step,
                                        make_sharded_train_step, replicate,
                                        shard_batch)

    n = len(devices)
    model = MV3DNet(cfg)
    data = _train_batch(cfg, n, seed)

    def train_losses(mesh):
        opt = optax.adam(1e-3)
        params = {k: variables[k]["params"] for k in SUBNET_NAMES}
        # the step donates its state: give it a copy of the variables
        v = replicate(jax.tree.map(jnp.array, variables), mesh)
        o = replicate(opt.init(params), mesh)
        b = shard_batch(data, mesh)
        top, front = jax.jit(
            lambda p, m: (lidar_to_top_batch(p, cfg, m),
                          lidar_to_front_batch(p, cfg, m)),
            out_shardings=(NamedSharding(mesh, P("data")),) * 2)(
                b.pop("points"), b.pop("num_points"))
        b.update(top=top, front=front)
        step = make_sharded_train_step(model, opt, SUBNET_NAMES, mesh, cfg)
        _, _, losses = step(v, o, b, jax.random.PRNGKey(seed))
        return {k: float(x) for k, x in losses.items()}

    many = train_losses(make_mesh(n, devices=devices))
    one = train_losses(make_mesh(1, devices=devices[:1]))
    for k in one:
        assert np.isfinite(many[k]) and np.isfinite(one[k]), (many, one)
        rtol = (MESH_RPN_LOSS_RTOL if k.startswith("top_")
                else MESH_FUSION_LOSS_RTOL)
        np.testing.assert_allclose(many[k], one[k], rtol=rtol, err_msg=k)

    mesh = make_mesh(n, devices=devices)
    infer = make_sharded_infer_step(model, mesh)
    b = shard_batch({"points": data["points"], "rgb": data["rgb"]}, mesh)
    dets = infer(replicate(variables, mesh), b["points"], b["rgb"])
    masks = np.asarray(dets.mask)
    solo = make_sharded_infer_step(model, make_mesh(1, devices=devices[:1]))
    v1 = jax.device_put(variables, devices[0])
    for i in range(n):
        d1 = solo(v1, data["points"][i:i + 1], data["rgb"][i:i + 1])
        np.testing.assert_array_equal(masks[i], np.asarray(d1.mask)[0],
                                      err_msg=f"frame {i}")
    assert np.isfinite(np.asarray(dets.boxes3d)).all()
    info = {"devices": n, "losses": many, "losses_1_device": one,
            "detections": masks.sum(axis=1).tolist()}
    log(f"phase g {n} devices ok: {info}")
    return info


# ---------------------------------------------------------------------------

def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=1, choices=(1, 4),
                    help="4: run only the data-parallel phase (g) on four "
                         "cards")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    check_device(devices)
    card = describe_device(devices)

    from mv3d_tpu.config import kitti_config
    from mv3d_tpu.models.mv3d_net import MV3DNet

    cfg = kitti_config()
    log(f"config: kitti top {cfg.top_shape} front {cfg.front_shape} rgb "
        f"{cfg.rgb_shape} points {cfg.pipeline.max_points} pre-NMS "
        f"{cfg.rpn.nms_pre_topn} ROIs {cfg.rcnn.batch_size}")
    variables = jax.jit(MV3DNet(cfg).init_variables)(
        jax.random.PRNGKey(args.seed))

    if args.devices > 1:
        if len(devices) < args.devices:
            raise RuntimeError(f"--devices {args.devices}: JAX sees "
                               f"{len(devices)} devices")
        phase_multidevice(cfg, variables, devices[:args.devices], args.seed)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
            phase_voxelizer(cfg, 8, args.seed)
            phase_nms(1000, cfg.rpn.nms_thresh, args.seed)
            phase_inference(cfg, variables, 8, args.seed)
            phase_serving(cfg, variables, work, args.seed)
            phase_training(cfg, work, 2, 3, args.seed)
    log(f"card: {card}")
    d = devices[0]
    print(json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind,
        "count": len(devices)}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
