"""Offline preprocessing CLI (parity: reference ``python data.py`` __main__,
src/data.py:839-914): voxelizes a dataset on-device and dumps the reference
directory layout."""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="MV3D offline preprocess")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--kitti-object", help="KITTI object dataset root")
    src.add_argument("--kitti-raw", help="KITTI raw root (needs --date/--drive)")
    ap.add_argument("--date", default="2011_09_26")
    ap.add_argument("--drive", default="0005")
    ap.add_argument("--split", default="")
    ap.add_argument("-o", "--out-dir", required=True)
    ap.add_argument("-b", "--batch-size", type=int, default=4)
    ap.add_argument("--cpu", action="store_true",
                    help="use the numpy oracle instead of the device")
    ap.add_argument("--no-images", action="store_true")
    from .common import add_config_args
    add_config_args(ap)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from .common import resolve_config
    cfg = resolve_config(args)
    from ..data.kitti import KittiObjectDataset, KittiRawDataset
    from ..data.preprocess import Preprocessor
    from ..utils import Timer

    if args.kitti_object:
        ds = KittiObjectDataset(args.kitti_object, split_file=args.split,
                                cfg=cfg)
    else:
        ds = KittiRawDataset(args.kitti_raw, args.date, args.drive, cfg)

    pp = Preprocessor(args.out_dir, cfg, batch_size=args.batch_size,
                      device=not args.cpu, save_images=not args.no_images)
    t = Timer()
    done = pp.run(ds)
    dt = t.total_time()
    print(f"preprocessed {done} frames in {dt:.1f}s "
          f"({done/dt:.1f} frames/sec)")


if __name__ == "__main__":
    main()
