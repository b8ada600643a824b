"""Offline preprocessing: dump per-frame views/gt in the reference layout.

Parity with the reference's offline pipeline (``python data.py`` →
``preproces``/``data_in_single_driver``, src/data.py:448-914), which writes
under ``data/preprocessing/<type>/`` per drive:

    rgb/<tag>.png            resized camera frame
    top/<tag>.npy.npz        BEV map       (npz key 'top_view', data.py:521)
    front/<tag>.npy.npz      front view    (npz key 'front_view')
    top_image/<tag>.png      BEV visualization (data.py:248-254)
    gt_boxes3d/<tag>.npy     (N, 8, 3) lidar gt corners
    gt_labels/<tag>.npy      (N,) labels

The voxelization itself runs batched on the device (ops.voxelize); the host only
does file I/O — this is where the reference's ``multiprocessing.Pool(3)`` of
pure-python triple loops (data.py:495-513) gets its >=50x speedup.
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np

from ..config import Config, cfg as _default_cfg
from ..ops import voxelize
from .loader import prepare_rgb


def draw_top_image(top: np.ndarray) -> np.ndarray:
    """Channel-summed normalized BEV image (parity: data.py:248-254)."""
    img = np.sum(top, axis=2)
    img = img - img.min()
    div = img.max() - img.min()
    img = img / div * 255 if div > 0 else img
    return np.dstack([img, img, img]).astype(np.uint8)


def draw_front_image(front: np.ndarray) -> np.ndarray:
    """Channel-summed normalized front image (parity: data.py:256-263)."""
    img = np.sum(front, axis=2)
    img = img - img.min()
    div = img.max() - img.min()
    img = img / div * 255 if div > 0 else img
    return np.dstack([img, img, img]).astype(np.uint8)


def _save_png(path: str, arr: np.ndarray):
    from PIL import Image
    Image.fromarray(arr).save(path)


class Preprocessor:
    """Batched on-device voxelization of a dataset into the dump layout."""

    def __init__(self, out_dir: str, cfg: Config = _default_cfg,
                 batch_size: int = 4, device: bool = True,
                 save_images: bool = True):
        self.out_dir = out_dir
        self.cfg = cfg
        self.batch_size = batch_size
        self.save_images = save_images
        self.device = device
        if device:
            import jax
            from functools import partial
            self._vox = jax.jit(lambda p, n: (
                voxelize.lidar_to_top_batch(p, cfg, n),
                voxelize.lidar_to_front_batch(p, cfg, n)))
        for sub in ("rgb", "top", "front", "top_image", "gt_boxes3d",
                    "gt_labels"):
            os.makedirs(os.path.join(out_dir, sub), exist_ok=True)

    def _voxelize(self, points_batch, num_batch):
        if self.device:
            top, front = self._vox(points_batch, num_batch)
            return np.asarray(top), np.asarray(front)
        from ..ops import voxelize_ref
        tops, fronts = [], []
        for p, n in zip(points_batch, num_batch):
            tops.append(voxelize_ref.lidar_to_top_np(p[:n], self.cfg))
            fronts.append(voxelize_ref.lidar_to_front_np(p[:n], self.cfg))
        return np.stack(tops), np.stack(fronts)

    def run(self, dataset, indices: Optional[Sequence[int]] = None) -> int:
        """Process frames [indices] of a dataset exposing load_frame(i)."""
        n_pts = self.cfg.pipeline.max_points
        indices = list(range(len(dataset))) if indices is None else list(indices)
        done = 0
        for start in range(0, len(indices), self.batch_size):
            chunk = indices[start:start + self.batch_size]
            frames = [dataset.load_frame(i) for i in chunk]
            pts = np.full((len(frames), n_pts, 4), -1e9, np.float32)
            nums = np.zeros(len(frames), np.int32)
            for i, f in enumerate(frames):
                k = min(len(f.points), n_pts)
                pts[i, :k] = f.points[:k]
                nums[i] = k
            tops, fronts = self._voxelize(pts, nums)
            for i, f in enumerate(frames):
                self._dump(f, tops[i], fronts[i])
                done += 1
        return done

    def _dump(self, frame, top, front):
        tag = frame.tag
        o = self.out_dir
        np.savez_compressed(os.path.join(o, "top", tag + ".npy.npz"),
                            top_view=top)
        np.savez_compressed(os.path.join(o, "front", tag + ".npy.npz"),
                            front_view=front)
        np.save(os.path.join(o, "gt_boxes3d", tag + ".npy"), frame.gt_boxes3d)
        np.save(os.path.join(o, "gt_labels", tag + ".npy"), frame.gt_labels)
        if frame.rgb is not None:
            _save_png(os.path.join(o, "rgb", tag + ".png"),
                      prepare_rgb(frame.rgb, self.cfg))
        if self.save_images:
            _save_png(os.path.join(o, "top_image", tag + ".png"),
                      draw_top_image(top))
