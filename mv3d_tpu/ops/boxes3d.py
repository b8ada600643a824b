"""3D box geometry and coordinate transforms (pure jnp, vectorized, jit-safe).

In-graph equivalents of the reference per-box python loops in
``src/net/processing/boxes3d.py``. Every function here is vectorized over the
box dimension and traceable under ``jax.jit``, so the whole proposal → 3D-box
lift → projection chain stays on-device (the reference crosses to the host for
each of these, e.g. mv3d.py:297-301).

Boxes3d are (..., 8, 3) corner arrays in lidar coordinates; corners 0-3 are the
bottom face, 4-7 the top face (KITTI convention, reference box3d_compose
src/net/processing/boxes3d.py:396-435).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..config import Config, cfg as _default_cfg


# ---------------------------------------------------------------------------
# top-view <-> lidar coordinate maps
# ---------------------------------------------------------------------------

def top_to_lidar_coords(xx, yy, cfg: Config = _default_cfg):
    """Top-view pixel (xx, yy) -> lidar (x, y) [cell centers].

    Parity: reference ``top_to_lidar_coords`` (boxes3d.py:12-18).
    """
    t = cfg.top
    y = t.yn * t.y_div - (xx + 0.5) * t.y_div + t.y_min
    x = t.xn * t.x_div - (yy + 0.5) * t.x_div + t.x_min
    return x, y


def lidar_to_top_coords(x, y, cfg: Config = _default_cfg):
    """Lidar (x, y) -> top-view pixel (xx, yy).

    Parity: reference ``lidar_to_top_coords`` (boxes3d.py:21-27). Note the
    reference uses ``Yn - floor(...)`` (no ``-1``): this is intentionally
    replicated (it differs by one from the voxel-fill indexing).
    """
    t = cfg.top
    xx = t.yn - jnp.floor((y - t.y_min) / t.y_div).astype(jnp.int32)
    yy = t.xn - jnp.floor((x - t.x_min) / t.x_div).astype(jnp.int32)
    return xx, yy


# ---------------------------------------------------------------------------
# top 2D box <-> 3D box
# ---------------------------------------------------------------------------

def top_box_to_box3d(boxes: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """Lift top-view (N, 4) [x1,y1,x2,y2] boxes to (N, 8, 3) 3D boxes with the
    fixed z prior [box3d_z_min, box3d_z_max].

    Parity: reference ``top_box_to_box3d`` (boxes3d.py:40-54).
    """
    x1, y1, x2, y2 = (boxes[..., 0], boxes[..., 1], boxes[..., 2], boxes[..., 3])
    # corner order: (x1,y1), (x1,y2), (x2,y2), (x2,y1)
    xxs = jnp.stack([x1, x1, x2, x2], axis=-1)   # (N, 4)
    yys = jnp.stack([y1, y2, y2, y1], axis=-1)
    xs, ys = top_to_lidar_coords(xxs, yys, cfg)
    z_lo = jnp.full_like(xs, cfg.model.box3d_z_min)
    z_hi = jnp.full_like(xs, cfg.model.box3d_z_max)
    bottom = jnp.stack([xs, ys, z_lo], axis=-1)  # (N, 4, 3)
    top = jnp.stack([xs, ys, z_hi], axis=-1)
    return jnp.concatenate([bottom, top], axis=-2)


def box3d_to_top_box(boxes3d: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """Project (N, 8, 3) 3D boxes to enveloping top-view (N, 4) boxes.

    Parity: reference ``box3d_to_top_box`` (boxes3d.py:81-110).
    """
    xs = boxes3d[..., 0:4, 0]
    ys = boxes3d[..., 0:4, 1]
    us, vs = lidar_to_top_coords(xs, ys, cfg)
    return jnp.stack([
        jnp.min(us, axis=-1), jnp.min(vs, axis=-1),
        jnp.max(us, axis=-1), jnp.max(vs, axis=-1)], axis=-1).astype(jnp.float32)


# ---------------------------------------------------------------------------
# lidar <-> camera
# ---------------------------------------------------------------------------

def lidar_to_camera_points(points: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """(..., 3) lidar points -> camera coordinates (KITTI calibration).

    Parity: reference ``lidar_to_camera_coords`` (boxes3d.py:56-62).
    """
    T = jnp.asarray(cfg.r_rect @ cfg.velo_to_cam, dtype=points.dtype)
    ones = jnp.ones(points.shape[:-1] + (1,), dtype=points.dtype)
    hom = jnp.concatenate([points, ones], axis=-1)
    return jnp.einsum("...j,ij->...i", hom, T, precision="highest")[..., :3]


def camera_to_lidar_points(points: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """(..., 3) camera points -> lidar coordinates.

    Parity: reference ``camera_to_lidar_coords`` (boxes3d.py:64-70).
    """
    T = np.linalg.inv(cfg.velo_to_cam) @ np.linalg.inv(cfg.r_rect)
    T = jnp.asarray(T, dtype=points.dtype)
    ones = jnp.ones(points.shape[:-1] + (1,), dtype=points.dtype)
    hom = jnp.concatenate([points, ones], axis=-1)
    return jnp.einsum("...j,ij->...i", hom, T, precision="highest")[..., :3]


def box3d_to_camera_box3d(boxes3d: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """(N, 8, 3) lidar boxes -> camera-frame corners.

    Parity: reference ``box3d_to_camera_box3d`` (boxes3d.py:176-186).
    """
    return lidar_to_camera_points(boxes3d, cfg)


# ---------------------------------------------------------------------------
# rgb / front projections
# ---------------------------------------------------------------------------

def box3d_to_rgb_box(boxes3d: jnp.ndarray, cfg: Config = _default_cfg) -> jnp.ndarray:
    """Project (N, 8, 3) lidar boxes into image pixels (N, 8, 2), truncated to
    int32 like the reference.

    Parity: reference ``box3d_to_rgb_box`` KITTI branch (boxes3d.py:146-162):
    Qs = [P|1] @ Mt, qs = Qs[:, :3] @ Kt, pixel = qs[:, :2] / qs[:, 2].
    Non-kitti datasets use the reference's didi branch (boxes3d.py:164-174):
    the calibrated 3x4 projection (box3d_to_rgb_projection_cv2,
    :474-484) + crop-shift-and-clamp into the cropped image
    (convert_points_to_croped_image, :112-143), zeroing boxes that are
    behind the camera or have < 2 in-range corners — masked jnp instead of
    the reference's host loop so it stays in-graph.
    """
    if cfg.dataset_type != "kitti":
        from .projection import DIDI_PROJ_MAT
        P = jnp.asarray(DIDI_PROJ_MAT, jnp.float32)
        ones = jnp.ones(boxes3d.shape[:-1] + (1,), dtype=jnp.float32)
        Ps = jnp.concatenate([boxes3d.astype(jnp.float32), ones], axis=-1)
        X = jnp.einsum("ij,...j->...i", P, Ps, precision="highest")
        pix = (X[..., :2] / X[..., 2:3]).astype(jnp.int32)   # trunc like ref
        h, w, _ = cfg.rgb_shape
        u = pix[..., 0] - cfg.image_crop_left
        v = pix[..., 1] - cfg.image_crop_top
        in_range = (u >= 0) & (u < w) & (v >= 0) & (v < h)
        u = jnp.clip(u, 0, w - 1)
        v = jnp.clip(v, 0, h - 1)
        keep = ((jnp.sum(boxes3d[..., 0] > 0, axis=-1) > 0) &
                (jnp.sum(in_range, axis=-1) >= 2))           # (..., N)
        out = jnp.stack([u, v], axis=-1)
        return jnp.where(keep[..., None, None], out, 0).astype(jnp.int32)
    Mt = jnp.asarray(cfg.matrix_mt, dtype=jnp.float32)
    Kt = jnp.asarray(cfg.matrix_kt, dtype=jnp.float32)
    ones = jnp.ones(boxes3d.shape[:-1] + (1,), dtype=boxes3d.dtype)
    Ps = jnp.concatenate([boxes3d.astype(jnp.float32), ones], axis=-1)  # (N,8,4)
    Qs = jnp.einsum("...j,jk->...k", Ps, Mt, precision="highest")[..., :3]
    qs = jnp.einsum("...j,jk->...k", Qs, Kt, precision="highest")
    z = qs[..., 2:3]
    pix = qs[..., :2] / z
    return pix.astype(jnp.int32)   # f32->int32 cast truncates toward zero


def lidar_to_front_coords(points: jnp.ndarray, cfg: Config = _default_cfg):
    """(..., 3) lidar points -> *drawing* front-view coordinates (c, r).

    Parity: reference ``lidar_to_front_coords`` (boxes3d.py:29-38) — note the
    reference's legacy ``/2`` rescale, kept for exact parity; this is the map
    used by ``project_to_front_roi`` (mv3d.py:91-114), distinct from the
    voxelizing projection in ops/voxelize.py.
    """
    f = cfg.front
    c = jnp.trunc(jnp.arctan2(points[..., 1], points[..., 0])
                  / f.angular_res)
    r = jnp.trunc(jnp.arctan2(points[..., 2],
                              jnp.sqrt(points[..., 0] ** 2 + points[..., 1] ** 2))
                  / f.vertical_res)
    c = (c + f.c_offset) / 2.0
    r = (r + f.r_offset) / 2.0
    return c, r


# ---------------------------------------------------------------------------
# corner-delta regression transform
# ---------------------------------------------------------------------------

def _rms_scale(et_boxes3d: jnp.ndarray) -> jnp.ndarray:
    """Per-box RMS corner spread: sqrt(sum((corners - center)^2) / 8)."""
    center = jnp.mean(et_boxes3d, axis=-2, keepdims=True)
    return jnp.sqrt(jnp.sum((et_boxes3d - center) ** 2, axis=(-1, -2)) / 8.0)


def box3d_transform(et_boxes3d: jnp.ndarray, gt_boxes3d: jnp.ndarray) -> jnp.ndarray:
    """Corner-delta regression targets, normalized by the RMS corner spread.

    Parity: reference ``box3d_transform`` (boxes3d.py:302-313).
    Shapes: (N, 8, 3) x (N, 8, 3) -> (N, 8, 3).
    """
    scale = _rms_scale(et_boxes3d)[..., None, None]
    return (gt_boxes3d - et_boxes3d) / scale


def box3d_transform_inv(et_boxes3d: jnp.ndarray, deltas: jnp.ndarray) -> jnp.ndarray:
    """Invert ``box3d_transform``.

    Parity: reference ``box3d_transform_inv`` (boxes3d.py:316-328).
    """
    scale = _rms_scale(et_boxes3d)[..., None, None]
    return et_boxes3d + scale * deltas


def regularise_box3d(boxes3d: jnp.ndarray) -> jnp.ndarray:
    """Re-orthogonalize predicted corners into an upright box.

    Parity: reference ``regularise_box3d`` (boxes3d.py:332-354): average the
    vertical edge length, collapse each bottom/top corner pair to its midpoint
    and re-extrude along z.
    """
    bottom = boxes3d[..., 0:4, :]
    top = boxes3d[..., 4:8, :]
    dis = jnp.mean(jnp.sqrt(jnp.sum((bottom - top) ** 2, axis=-1)),
                   axis=-1)                       # (N,)
    corners = (bottom + top) / 2.0                # (N, 4, 3)
    ez = jnp.array([0.0, 0.0, 1.0], dtype=boxes3d.dtype)
    half = (dis / 2.0)[..., None, None] * ez
    return jnp.concatenate([corners - half, corners + half], axis=-2)


# ---------------------------------------------------------------------------
# compose / decompose
# ---------------------------------------------------------------------------

def box3d_compose(translation, size, rotation, cfg: Config = _default_cfg) -> jnp.ndarray:
    """(tx,ty,tz), (h,w,l), (rx,ry,rz=yaw) -> (8, 3) corners (KITTI convention:
    bottom face at z=0, top at z=h, then rotated/translated).

    Parity: reference ``box3d_compose`` KITTI branch (boxes3d.py:396-435).
    Vectorized: leading batch dims on all three inputs are supported.
    """
    translation = jnp.asarray(translation, dtype=jnp.float32)
    size = jnp.asarray(size, dtype=jnp.float32)
    rotation = jnp.asarray(rotation, dtype=jnp.float32)
    h, w, l = size[..., 0], size[..., 1], size[..., 2]
    zeros = jnp.zeros_like(h)
    xs = jnp.stack([-l / 2, -l / 2, l / 2, l / 2, -l / 2, -l / 2, l / 2, l / 2], axis=-1)
    ys = jnp.stack([w / 2, -w / 2, -w / 2, w / 2, w / 2, -w / 2, -w / 2, w / 2], axis=-1)
    zs = jnp.stack([zeros, zeros, zeros, zeros, h, h, h, h], axis=-1)
    yaw = rotation[..., 2]
    c, s = jnp.cos(yaw)[..., None], jnp.sin(yaw)[..., None]
    rx = c * xs - s * ys
    ry = s * xs + c * ys
    corners = jnp.stack([rx, ry, zs], axis=-1)   # (..., 8, 3)
    return corners + translation[..., None, :]


def boxes3d_decompose(boxes3d: jnp.ndarray, cfg: Config = _default_cfg
                      ) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(N, 8, 3) corners -> (translation (N,3), size (N,3)=[h,w,l], rotation (N,3)).

    Parity: reference ``boxes3d_decompose`` KITTI branch (boxes3d.py:356-393):
    translation = centroid of the *bottom* face; L/W from the two bottom edge
    lengths; yaw along the longer edge.
    """
    T = jnp.mean(boxes3d[..., 0:4, :], axis=-2)          # (N, 3)

    p0 = boxes3d[..., 0, 0:2]
    p1 = boxes3d[..., 1, 0:2]
    p2 = boxes3d[..., 2, 0:2]
    dis1 = jnp.sqrt(jnp.sum((p0 - p1) ** 2, axis=-1))
    dis2 = jnp.sqrt(jnp.sum((p1 - p2) ** 2, axis=-1))
    dis1_is_max = dis1 > dis2

    L = jnp.maximum(dis1, dis2)
    W = jnp.minimum(dis1, dis2)
    H = jnp.sqrt(jnp.sum((boxes3d[..., 0, :] - boxes3d[..., 4, :]) ** 2, axis=-1))

    yaw1 = jnp.arctan2(p1[..., 1] - p0[..., 1], p1[..., 0] - p0[..., 0])
    yaw2 = jnp.arctan2(p2[..., 1] - p1[..., 1], p2[..., 0] - p1[..., 0])
    Rz = jnp.where(dis1_is_max, yaw1, yaw2)
    zeros = jnp.zeros_like(Rz)

    size = jnp.stack([H, W, L], axis=-1)
    rotation = jnp.stack([zeros, zeros, Rz], axis=-1)
    return T, size, rotation


# ---------------------------------------------------------------------------
# yaw-aware 3D IoU (host-side numpy; used by evaluation, not the hot path)
# ---------------------------------------------------------------------------

def _polygon_clip(subject: np.ndarray, clip: np.ndarray) -> np.ndarray:
    """Sutherland–Hodgman clip of polygon ``subject`` by convex ``clip``.

    Replaces shapely.Polygon.intersection (reference boxes3d.py:488-514) with a
    dependency-free implementation; both polygons are (K, 2) CCW or CW.
    """
    def inside(p, a, b):
        return (b[0] - a[0]) * (p[1] - a[1]) - (b[1] - a[1]) * (p[0] - a[0]) >= 0

    def intersect(p1, p2, a, b):
        dc = a - b
        dp = p1 - p2
        n1 = a[0] * b[1] - a[1] * b[0]
        n2 = p1[0] * p2[1] - p1[1] * p2[0]
        denom = dc[0] * dp[1] - dc[1] * dp[0]
        return np.array([(n1 * dp[0] - n2 * dc[0]) / denom,
                         (n1 * dp[1] - n2 * dc[1]) / denom])

    # ensure clip polygon is CCW
    area2 = 0.0
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        area2 += a[0] * b[1] - b[0] * a[1]
    if area2 < 0:
        clip = clip[::-1]

    output = list(subject)
    for i in range(len(clip)):
        a, b = clip[i], clip[(i + 1) % len(clip)]
        input_list, output = output, []
        if not input_list:
            break
        s = input_list[-1]
        for p in input_list:
            if inside(p, a, b):
                if not inside(s, a, b):
                    output.append(intersect(s, p, a, b))
                output.append(p)
            elif inside(s, a, b):
                output.append(intersect(s, p, a, b))
            s = p
    return np.array(output) if output else np.zeros((0, 2))


def _polygon_area(poly: np.ndarray) -> float:
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))


def box3d_intersection(box_a: np.ndarray, box_b: np.ndarray) -> float:
    """Intersection volume of two (3, 8) corner arrays (yaw-only rotation).

    Parity: reference ``box3d_intersection`` (boxes3d.py:488-514) with the
    shapely polygon intersection replaced by Sutherland–Hodgman.
    """
    min_h_a, max_h_a = np.min(box_a[2]), np.max(box_a[2])
    min_h_b, max_h_b = np.min(box_b[2]), np.max(box_b[2])
    z_inter = max(0.0, min(max_h_a, max_h_b) - max(min_h_a, min_h_b))
    if z_inter == 0:
        return 0.0
    poly_a = box_a[0:2, 0:4].T
    poly_b = box_b[0:2, 0:4].T
    clipped = _polygon_clip(poly_a, poly_b)
    xy_inter = _polygon_area(clipped)
    if xy_inter == 0:
        return 0.0
    return float(z_inter * xy_inter)


def boxes3d_score_iou(gt_boxes3d: np.ndarray, pre_boxes3d: np.ndarray,
                      cfg: Config = _default_cfg) -> float:
    """Aggregate 3D IoU of predictions vs ground truth.

    Parity: reference ``boxes3d_score_iou`` (boxes3d.py:517-541): sum of the
    per-gt best intersections over the union of total volumes.
    """
    gt_boxes3d = np.asarray(gt_boxes3d)
    pre_boxes3d = np.asarray(pre_boxes3d)
    if pre_boxes3d.shape[0] == 0:
        return 0.0
    _, gt_size, _ = boxes3d_decompose(gt_boxes3d, cfg)
    gt_vol = float(np.sum(np.prod(np.asarray(gt_size), axis=1)))
    _, pre_size, _ = boxes3d_decompose(pre_boxes3d, cfg)
    pre_vol = float(np.sum(np.prod(np.asarray(pre_size), axis=1)))

    n_gt, n_pre = gt_boxes3d.shape[0], pre_boxes3d.shape[0]
    inters = np.zeros((n_gt, n_pre))
    for j in range(n_gt):
        for i in range(n_pre):
            inters[j, i] = box3d_intersection(gt_boxes3d[j].T, pre_boxes3d[i].T)
    inter = float(np.sum(np.max(inters, axis=1)))
    union = gt_vol + pre_vol - inter
    return inter / union if union > 0 else 0.0
