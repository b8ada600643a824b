"""Export a trained model as a deployable AOT serving artifact.

The reference's deployment story is "re-run the model-building source and
restore per-scope checkpoints in-process" (reference mv3d.py:666-691). This
command instead freezes the complete lidar->boxes pipeline into a portable
``jax.export`` StableHLO artifact (see ``mv3d_tpu/serving/export.py``):

    python -m mv3d_tpu.cli.export -n mytag --out artifacts/mv3d \\
        --batch-size 8 --platforms cuda,cpu

The artifact directory is self-contained (program + weights + meta) and is
loaded on a serving host with ``mv3d_tpu.serving.load_serving``.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        description="Export an AOT MV3D serving artifact (jax.export)")
    ap.add_argument("-n", "--tag", default="unknown_tag")
    ap.add_argument("--checkpoint-dir", default="checkpoint")
    ap.add_argument("--out", required=True, help="artifact output directory")
    ap.add_argument("--batch-size", type=int, default=1)
    ap.add_argument("--score-threshold", type=float, default=0.05)
    ap.add_argument("--quantized", action="store_true",
                    help="freeze the uint16/uint8 quantized-transfer "
                         "signature (ops/quantize.py)")
    ap.add_argument("--platforms", default="",
                    help="comma list of lowering targets, e.g. cuda,cpu "
                         "(default: current backend)")
    ap.add_argument("--random-init", action="store_true",
                    help="skip checkpoint loading (smoke/bench artifacts)")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    from .common import resolve_config
    cfg = resolve_config(args)

    from ..serving import export_serving
    from ..train.trainer import MV3D, Predictor

    cls = MV3D if args.random_init else Predictor
    model = cls(cfg, log_tag=args.tag, checkpoint_dir=args.checkpoint_dir)
    platforms = ([p.strip() for p in args.platforms.split(",") if p.strip()]
                 or None)
    out = export_serving(model.variables, cfg, args.out,
                         batch_size=args.batch_size,
                         score_threshold=args.score_threshold,
                         quantized=args.quantized, platforms=platforms)
    print(f"exported serving artifact: {out}")
    return out


if __name__ == "__main__":
    main()
