"""mv3d_tpu — a JAX multi-view 3D object detection framework.

A from-scratch JAX/XLA re-design of the capabilities of jeasinema/MV3D
(TF-1.x + CUDA, see /root/repo/SURVEY.md): BEV + front-view + RGB fusion
detection of 3D boxes from lidar point clouds, with the entire
``lidar -> voxelize -> backbone -> RPN -> NMS -> ROI fusion -> 3D boxes``
pipeline expressed as a single jitted XLA program and scaled over device meshes
with ``jax.sharding``.

Layout:
  config    — frozen-dataclass config tree with kitti/didi presets
  ops       — geometry, voxelization, NMS, IoU, anchors, ROI align (jnp)
  models    — plain-JAX layers, backbone, RPN, fusion head, full MV3DNet
  train     — in-graph target assignment, losses, Trainer/Predictor API
  data      — KITTI readers, tracklet XML I/O, prefetching loader
  parallel  — mesh / sharding helpers for multi-chip training and serving
  utils     — timers, logging, MAC counting, profiling
"""

__version__ = "0.1.0"

from . import config  # noqa: F401
from .config import Config, cfg, kitti_config, make_config  # noqa: F401
