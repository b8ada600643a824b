"""Quantized point transfer for thin host->device links (serving option).

An f32 (N, 4) cloud costs 16 bytes/point on the host->device link; on a
thin link that is the whole streaming cost. With ``pipeline.stream_quantized`` the loader ships

  * xyz as uint16 fixed-point over the top-grid crop bounds (+1 division of
    margin), 6 bytes/point;
  * reflectance as uint8/255, 1 byte/point

and the device dequantizes in-graph before ``_top_prep`` — 7/16 the bytes.

Accuracy contract (documented deviation, like the boundary-quantization note
in ops/voxelize.py:23-30): positions move by at most half a quantization
step — x: ~0.6 mm, y: ~0.5 mm, z: ~0.04 mm on the KITTI grid — so a point
within that distance of a 100 mm cell boundary (~1% of points per axis) may
land one cell over, and height fractions shift by <1e-3 slice. Bit-parity
paths keep the default f32 transfer; this is a flagged serving trade.

Padding rows quantize to the upper margin bound (outside the strict crop),
so the padding convention survives without the ``num_points`` mask.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..config import Config, cfg as _default_cfg

QMAX = 65535


def _bounds(cfg: Config) -> Tuple[np.ndarray, np.ndarray]:
    """Per-axis [lo, hi] quantization range: crop bounds + one division of
    margin, so in-crop points never clip and the sentinel QMAX maps strictly
    outside the crop."""
    t = cfg.top
    lo = np.array([t.x_min - t.x_div, t.y_min - t.y_div, t.z_min - t.z_div],
                  np.float32)
    hi = np.array([t.x_max + t.x_div, t.y_max + t.y_div, t.z_max + t.z_div],
                  np.float32)
    return lo, hi


def quantize_points(points: np.ndarray, cfg: Config = _default_cfg,
                    bounds: Tuple[np.ndarray, np.ndarray] = None
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side: (..., N, 4) f32 -> (xyz_q (..., N, 3) uint16,
    refl_q (..., N) uint8). Out-of-range points (incl. pad_points' -1e9
    rows) clip to the margin bounds, which the strict crop rejects.

    ``bounds``: explicit (lo, hi) per-axis ranges — serving hosts that only
    have an exported artifact pass the bounds from its meta.json instead of
    a cfg (the dequantization bounds are baked into the frozen program)."""
    points = np.asarray(points, np.float32)
    lo, hi = (np.asarray(bounds[0], np.float32),
              np.asarray(bounds[1], np.float32)) if bounds else _bounds(cfg)
    scale = (hi - lo) / QMAX
    q = np.clip(np.rint((points[..., :3] - lo) / scale), 0, QMAX
                ).astype(np.uint16)
    r = np.clip(np.rint(points[..., 3] * 255.0), 0, 255).astype(np.uint8)
    return q, r


def dequantize_points(xyz_q: jnp.ndarray, refl_q: jnp.ndarray,
                      cfg: Config = _default_cfg) -> jnp.ndarray:
    """In-graph: quantized pair -> (..., N, 4) f32 points."""
    lo, hi = _bounds(cfg)
    scale = (hi - lo) / QMAX
    xyz = xyz_q.astype(jnp.float32) * jnp.asarray(scale) + jnp.asarray(lo)
    refl = refl_q.astype(jnp.float32) * (1.0 / 255.0)
    return jnp.concatenate([xyz, refl[..., None]], axis=-1)
