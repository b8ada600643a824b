"""Test/inspection CLI (parity: reference src/test.py:21-292).

Subcommands:
  test_rpn         dump per-frame proposals (+scores) as npy
  test_mv3d        full-net inference, dump <tag>_boxes3d.npy/<tag>_probs.npy
  test_single_mv3d one-frame inference, print detections
  export_kitti     full-net inference over a split, KITTI txt output
  test_3dop        fusion head on external 3D proposals (<tag>_rois3d.npy in
                   --proposal-dir; ref test.py:21-36)
  test_rpn_target  RPN target-assignment probe: anchor counts + annotated
                   label png (non-interactive version of ref test.py:223-290)
  test_front       dump front-view arrays + pngs (ref test.py:292-350)
  probe_rpn        annotated proposal/gt images per frame (non-interactive
                   version of the stdin probes, ref test.py:58-183; with
                   --kitti-raw/--date/--drive it walks a raw drive like the
                   reference's raw-dataset probe, ref test.py:58-99)
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D test utilities")
    ap.add_argument("command", choices=["test_rpn", "test_mv3d",
                                        "test_single_mv3d", "export_kitti",
                                        "test_3dop", "test_rpn_target",
                                        "test_front", "probe_rpn"])
    ap.add_argument("--proposal-dir", default="",
                    help="test_3dop: dir of <tag>_rois3d.npy proposals")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("--kitti-object", default="",
                    help="KITTI object dataset root (default source)")
    ap.add_argument("--kitti-raw", default="",
                    help="KITTI raw root: probe a raw drive instead of the "
                         "object dataset (with --date/--drive)")
    ap.add_argument("--date", default="2011_09_26")
    ap.add_argument("--drive", default="0005")
    ap.add_argument("--split", default="")
    ap.add_argument("--out-dir", default="test_output")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--score-threshold", type=float, default=None)
    ap.add_argument("--limit", type=int, default=0, help="max frames (0=all)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    import jax.numpy as jnp

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiObjectDataset, KittiRawDataset
    from ..data.loader import frames_to_batch
    from ..train.trainer import Predictor

    if args.kitti_raw:
        ds = KittiRawDataset(args.kitti_raw, args.date, args.drive, cfg)
    else:
        if not args.kitti_object:
            raise SystemExit("one of --kitti-object / --kitti-raw is required")
        ds = KittiObjectDataset(args.kitti_object, split_file=args.split,
                                cfg=cfg)
    needs_weights = args.command in ("test_rpn", "test_mv3d",
                                     "test_single_mv3d", "export_kitti",
                                     "test_3dop", "probe_rpn")
    predictor = (Predictor(cfg, log_tag=args.tag,
                           checkpoint_dir=args.checkpoint_dir)
                 if needs_weights else None)
    os.makedirs(args.out_dir, exist_ok=True)
    n = len(ds) if not args.limit else min(args.limit, len(ds))

    if args.command == "test_rpn":
        import jax
        from ..ops.voxelize import lidar_to_top_batch
        from ..ops.proposal import rpn_proposals

        model = predictor.model

        @jax.jit
        def rpn_only(variables, points, num_points):
            top = lidar_to_top_batch(points, cfg, num_points)
            out = model.top_rpn.apply(variables["top_view_rpn"], top, False)
            inside = model.anchor_mask(top[0])
            props = rpn_proposals(out["scores"][0], out["deltas"][0],
                                  model.anchors, inside, cfg)
            return props

        for i in range(n):
            f = ds.load_frame(i)
            b = frames_to_batch([f], cfg)
            props = rpn_only(predictor.variables, jnp.asarray(b["points"]),
                             jnp.asarray(b["num_points"]))
            mask = np.asarray(props.mask)
            np.save(os.path.join(args.out_dir, f"{f.tag}_proposals.npy"),
                    np.asarray(props.rois)[mask])
            np.save(os.path.join(args.out_dir, f"{f.tag}_proposal_scores.npy"),
                    np.asarray(props.scores)[mask])
        print(f"dumped proposals for {n} frames to {args.out_dir}")

    elif args.command in ("test_mv3d", "test_single_mv3d"):
        frames = range(1) if args.command == "test_single_mv3d" else range(n)
        for i in frames:
            f = ds.load_frame(i)
            b = frames_to_batch([f], cfg)
            boxes3d, _, probs = predictor.predict_from_points(
                b["points"], b["num_points"], b["rgb"],
                score_threshold=args.score_threshold)
            np.save(os.path.join(args.out_dir, f"{f.tag}_boxes3d.npy"), boxes3d)
            np.save(os.path.join(args.out_dir, f"{f.tag}_probs.npy"), probs)
            if args.command == "test_single_mv3d":
                print(f"{f.tag}: {len(boxes3d)} detections, probs={probs}")
        print(f"dumped detections to {args.out_dir}")

    elif args.command == "export_kitti":
        from ..eval.kitti_export import export_kitti_detections
        dets = {}
        for i in range(n):
            f = ds.load_frame(i)
            b = frames_to_batch([f], cfg)
            boxes3d, _, probs = predictor.predict_from_points(
                b["points"], b["num_points"], b["rgb"],
                score_threshold=args.score_threshold)
            dets[f.tag] = (boxes3d, probs)
        export_kitti_detections(dets, args.out_dir, cfg)
        print(f"wrote KITTI txt for {len(dets)} frames to {args.out_dir}")

    elif args.command == "test_3dop":
        # external 3D proposals (e.g. 3DOP dumps): <tag>_rois3d.npy (K, 8, 3)
        import jax
        from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
        from ..train.trainer import Tester3DOP

        tester = Tester3DOP(cfg, log_tag=args.tag,
                            checkpoint_dir=args.checkpoint_dir, load=True)
        views = jax.jit(lambda p, m: (lidar_to_top_batch(p, cfg, m),
                                      lidar_to_front_batch(p, cfg, m)))
        for i in range(n):
            f = ds.load_frame(i)
            rois_path = os.path.join(args.proposal_dir, f"{f.tag}_rois3d.npy")
            if not os.path.exists(rois_path):
                print(f"{f.tag}: no proposals, skipped")
                continue
            rois3d = np.load(rois_path).astype(np.float32)
            b = frames_to_batch([f], cfg)
            top, front = views(jnp.asarray(b["points"]),
                               jnp.asarray(b["num_points"]))
            probs, boxes3d = tester(top, front, b["rgb"], rois3d,
                                    score_threshold=args.score_threshold)
            np.save(os.path.join(args.out_dir, f"{f.tag}_boxes3d.npy"), boxes3d)
            np.save(os.path.join(args.out_dir, f"{f.tag}_probs.npy"), probs)
        print(f"3dop detections -> {args.out_dir}")

    elif args.command == "test_rpn_target":
        import jax
        from ..ops.voxelize import lidar_to_top_batch
        from ..train.trainer import TesterRPNTarget

        tester = TesterRPNTarget(cfg, log_tag=args.tag,
                                 checkpoint_dir=args.checkpoint_dir,
                                 log_dir=args.out_dir)
        vox = jax.jit(lambda p, m: lidar_to_top_batch(p, cfg, m))
        for i in range(n):
            f = ds.load_frame(i)
            if not len(f.gt_boxes3d):
                print(f"{f.tag}: no gt, skipped")
                continue
            b = frames_to_batch([f], cfg)
            top = vox(jnp.asarray(b["points"]), jnp.asarray(b["num_points"]))
            n_sampled, n_pos = tester(np.asarray(top), f.gt_boxes3d,
                                      f.gt_labels, seed=i)
            tester.dump_log("rpn_target", step=i)
            print(f"{f.tag}: {tester.anchors_details().strip()}")
        print(f"rpn_target images -> {args.out_dir}/rpn_target")

    elif args.command == "test_front":
        # dump the cylindrical front view as npy + png (ref test.py:292-350)
        import jax
        from PIL import Image
        from ..ops.voxelize import lidar_to_front_batch

        vox = jax.jit(lambda p, m: lidar_to_front_batch(p, cfg, m))
        for i in range(n):
            f = ds.load_frame(i)
            b = frames_to_batch([f], cfg)
            front = np.asarray(vox(jnp.asarray(b["points"]),
                                   jnp.asarray(b["num_points"])))[0]
            np.save(os.path.join(args.out_dir, f"{f.tag}_front.npy"), front)
            lo, hi = front.min(), front.max()
            img = ((front - lo) / max(hi - lo, 1e-6) * 255).astype(np.uint8)
            Image.fromarray(img.transpose(1, 0, 2)).save(
                os.path.join(args.out_dir, f"{f.tag}_front.png"))
        print(f"front views -> {args.out_dir}")

    elif args.command == "probe_rpn":
        # annotated proposal/gt BEV images per frame — the non-interactive
        # replacement for the reference's stdin-driven probes
        import jax
        from ..ops.voxelize import lidar_to_top_batch
        from ..utils.metrics import dump_debug_images

        model = predictor.model

        @jax.jit
        def rpn_only(variables, points, num_points):
            from ..ops.proposal import rpn_proposals
            top = lidar_to_top_batch(points, cfg, num_points)
            out = model.top_rpn.apply(variables["top_view_rpn"], top, False)
            inside = model.anchor_mask(top[0])
            props = rpn_proposals(out["scores"][0], out["deltas"][0],
                                  model.anchors, inside, cfg)
            return top, props

        for i in range(n):
            f = ds.load_frame(i)
            b = frames_to_batch([f], cfg)
            top, props = rpn_only(predictor.variables,
                                  jnp.asarray(b["points"]),
                                  jnp.asarray(b["num_points"]))
            mask = np.asarray(props.mask)
            top_img = np.asarray(top[0])
            dump_debug_images(
                args.out_dir, i, top_img, rgb=f.rgb,
                gt_boxes3d=f.gt_boxes3d if len(f.gt_boxes3d) else None,
                proposals=np.asarray(props.rois)[mask][:, 1:5], cfg=cfg)
        print(f"probe images -> {args.out_dir}")


if __name__ == "__main__":
    main()
