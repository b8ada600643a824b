"""Training metrics and debug-image observability.

Replacement for the reference's TensorBoard wiring — scalar loss
summaries (mv3d.py:833-844), periodic gt/proposal/prediction image summaries
(summary_image + log_rpn/log_fusion_net_target/predict_log, mv3d.py:579-935)
and the fixed-format text loss table (mv3d.py:1002-1003):

  * :class:`MetricsWriter` appends JSONL scalar records (loadable into
    pandas/tensorboard-like dashboards) and keeps running means;
  * :func:`dump_debug_images` renders gt vs detections on the BEV map and the
    camera image into a step-stamped directory.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class MetricsWriter:
    """Append-only JSONL scalar log with running means."""

    def __init__(self, log_dir: str, tag: str = "train"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"metrics_{tag}.jsonl")
        self._file = open(self.path, "a")
        self._sums: Dict[str, float] = defaultdict(float)
        self._counts: Dict[str, int] = defaultdict(int)

    def write(self, step: int, scalars: Dict[str, float], **extra):
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in scalars.items()}, **extra}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        for k, v in scalars.items():
            self._sums[k] += float(v)
            self._counts[k] += 1

    def means(self) -> Dict[str, float]:
        return {k: self._sums[k] / max(self._counts[k], 1)
                for k in self._sums}

    def close(self):
        self._file.close()


def dump_debug_images(out_dir: str, step: int, top_view: np.ndarray,
                      rgb: Optional[np.ndarray] = None,
                      gt_boxes3d: Optional[np.ndarray] = None,
                      det_boxes3d: Optional[np.ndarray] = None,
                      proposals: Optional[np.ndarray] = None, cfg=None):
    """Render gt (white) / detections (magenta) / proposals (yellow) onto the
    BEV image and camera frame; write pngs under <out_dir>/<step>/."""
    from PIL import Image

    from ..config import cfg as _default_cfg
    from . import viz

    cfg = cfg or _default_cfg
    d = os.path.join(out_dir, f"{step:06d}")
    os.makedirs(d, exist_ok=True)

    top_img = viz.draw_top_image(np.asarray(top_view))
    if proposals is not None and len(proposals):
        top_img = viz.draw_boxes2d(top_img, np.asarray(proposals),
                                   color=(255, 255, 0))
    if gt_boxes3d is not None and len(gt_boxes3d):
        top_img = viz.draw_box3d_on_top(top_img, gt_boxes3d,
                                        color=(255, 255, 255), cfg=cfg)
    if det_boxes3d is not None and len(det_boxes3d):
        top_img = viz.draw_box3d_on_top(top_img, det_boxes3d,
                                        color=(255, 0, 255), cfg=cfg)
    Image.fromarray(top_img).save(os.path.join(d, "top.png"))

    if rgb is not None:
        cam = np.asarray(rgb)
        if cam.dtype != np.uint8:
            cam = np.clip(cam, 0, 255).astype(np.uint8)
        if gt_boxes3d is not None and len(gt_boxes3d):
            cam = viz.draw_rgb_projections(cam, gt_boxes3d,
                                           color=(255, 255, 255), cfg=cfg)
        if det_boxes3d is not None and len(det_boxes3d):
            cam = viz.draw_rgb_projections(cam, det_boxes3d,
                                           color=(255, 0, 255), cfg=cfg)
        Image.fromarray(cam).save(os.path.join(d, "camera.png"))
    return d
