"""AOT export of the lidar->boxes serving program (``jax.export``).

The reference has no deployable serving artifact: inference hosts must
reconstruct the TF-1 graph in-process from the model-building python source
and restore per-scope checkpoints (reference mv3d.py:666-691, 117-161).
Here the whole single-XLA-program pipeline — in-graph (de)quantization +
voxelization, the three feature trunks, fusion head and NMS — is exported
once as a portable StableHLO artifact:

  * serving hosts need the artifact directory + jax, not ``mv3d_tpu``'s
    model code or config tree;
  * ``jax.export`` cross-platform lowering lets a CPU-only build box emit a
    GPU serving program (``platforms=("cuda", "cpu")``), and the runtime
    picks the branch matching its backend;
  * the signature is frozen (batch size, point bucket, image shape), so the
    serving process never recompiles or retraces.

Artifact layout (a directory):

  ``serving_fn.mlirbc`` — the exported program's StableHLO bytecode
  ``weights.npz``       — flattened model variables ("/"-joined tree paths)
  ``meta.json``         — signature + provenance (shapes, flags, jax version)
                          and the calling-convention fields of the
                          ``jax.export.Exported`` the loader rebuilds

``jax.export``'s own serializer needs the optional ``flatbuffers`` package,
which serving hosts need not have; the program is single-device and its
signature is fully described by ``meta.json``, so the loader rebuilds the
``Exported`` from these three files with nothing but jax and numpy.

``load_serving`` needs only this directory and returns a numpy-in /
numpy-out callable.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import Config

_FN_FILE = "serving_fn.mlirbc"
_WEIGHTS_FILE = "weights.npz"
_META_FILE = "meta.json"


# -- nested-dict (de)flattening for the weights npz ---------------------------

def _flatten(tree: Dict[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        assert "/" not in str(k), f"weight tree key {k!r} contains '/'"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif v is None:
            continue
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for key, arr in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return tree


# -- serving function builders -------------------------------------------------

def build_serving_fn(cfg: Config, score_threshold: float = 0.05,
                     quantized: bool = False):
    """Return ``(fn, input_specs(batch_size))`` for the serving program.

    ``fn(variables, *inputs) -> (boxes3d, probs, mask)`` runs the complete
    lidar->boxes pipeline as one XLA program (the reference crosses the
    device boundary ~6x per frame here, SURVEY.md §3.3). Inputs:

      * default: ``points (B,N,4) f32``, ``num_points (B,) i32``,
        ``rgb (B,H,W,3) f32``
      * ``quantized=True``: ``points_q (B,N,3) u16``, ``refl_q (B,N) u8``,
        ``num_points (B,) i32``, ``rgb (B,H,W,3) f32`` — the thin-link
        transfer diet of ``ops/quantize.py``, dequantized in-graph.
    """
    from ..models.mv3d_net import MV3DNet
    from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch

    model = MV3DNet(cfg)
    n = cfg.pipeline.max_points
    h, w, c = cfg.rgb_shape

    if quantized:
        from ..ops.quantize import dequantize_points

        def fn(variables, points_q, refl_q, num_points, rgb):
            pts = dequantize_points(points_q, refl_q, cfg)
            top, occ = lidar_to_top_batch(pts, cfg, num_points,
                                          return_occ=True)
            front = lidar_to_front_batch(pts, cfg, num_points)
            dets, _ = model.forward_inference(
                variables, top, rgb, front,
                score_threshold=score_threshold, top_occ=occ)
            return dets.boxes3d, dets.probs, dets.mask

        def input_specs(b: int):
            return (jax.ShapeDtypeStruct((b, n, 3), jnp.uint16),
                    jax.ShapeDtypeStruct((b, n), jnp.uint8),
                    jax.ShapeDtypeStruct((b,), jnp.int32),
                    jax.ShapeDtypeStruct((b, h, w, c), jnp.float32))
        return fn, input_specs

    def fn(variables, points, num_points, rgb):
        top, occ = lidar_to_top_batch(points, cfg, num_points,
                                      return_occ=True)
        front = lidar_to_front_batch(points, cfg, num_points)
        dets, _ = model.forward_inference(
            variables, top, rgb, front,
            score_threshold=score_threshold, top_occ=occ)
        return dets.boxes3d, dets.probs, dets.mask

    def input_specs(b: int):
        return (jax.ShapeDtypeStruct((b, n, 4), jnp.float32),
                jax.ShapeDtypeStruct((b,), jnp.int32),
                jax.ShapeDtypeStruct((b, h, w, c), jnp.float32))
    return fn, input_specs


def _avals_meta(avals) -> list:
    return [[list(a.shape), str(a.dtype)] for a in avals]


def _avals(meta_avals) -> tuple:
    return tuple(jax.core.ShapedArray(tuple(shape), jnp.dtype(dtype))
                 for shape, dtype in meta_avals)


def _exported_meta(exported) -> Dict[str, Any]:
    """The fields :func:`_rebuild_exported` needs besides the bytecode."""
    if exported.nr_devices != 1 or any(
            s is not None for s in (*exported.in_shardings_hlo,
                                    *exported.out_shardings_hlo)):
        raise ValueError("serving artifacts are single-device programs")
    if exported.ordered_effects or exported.unordered_effects:
        raise ValueError("serving programs must be free of effects")
    return {
        "fun_name": exported.fun_name,
        "in_avals": _avals_meta(exported.in_avals),
        "out_avals": _avals_meta(exported.out_avals),
        "calling_convention_version": exported.calling_convention_version,
        "module_kept_var_idx": list(exported.module_kept_var_idx),
        "uses_global_constants": exported.uses_global_constants,
    }


def _rebuild_exported(meta: Dict[str, Any], program: bytes, variables):
    """``jax.export.Exported`` of ``fn(variables, *inputs) -> (boxes3d,
    probs, mask)`` from the artifact's meta, bytecode and weights tree."""
    if meta["jax_version"] != jax.__version__:
        raise ValueError(f"artifact exported with jax {meta['jax_version']}; "
                         f"this is jax {jax.__version__}: export it again")
    ex = meta["exported"]
    n_in = len(ex["in_avals"])
    inputs = (0,) * len(meta["input_names"])
    return jax.export.Exported(
        fun_name=ex["fun_name"],
        in_tree=jax.tree.structure(((variables, *inputs), {})),
        in_avals=_avals(ex["in_avals"]),
        out_tree=jax.tree.structure((0,) * len(meta["output_names"])),
        out_avals=_avals(ex["out_avals"]),
        _has_named_shardings=False,
        _in_named_shardings=(None,) * n_in,
        _out_named_shardings=(None,) * len(ex["out_avals"]),
        in_shardings_hlo=(None,) * n_in,
        out_shardings_hlo=(None,) * len(ex["out_avals"]),
        nr_devices=1,
        platforms=tuple(meta["platforms"]),
        ordered_effects=(), unordered_effects=(), disabled_safety_checks=(),
        mlir_module_serialized=program,
        calling_convention_version=ex["calling_convention_version"],
        module_kept_var_idx=tuple(ex["module_kept_var_idx"]),
        uses_global_constants=ex["uses_global_constants"],
        _get_vjp=None)


def _var_specs(variables) -> Any:
    return jax.tree.map(
        lambda a: jax.ShapeDtypeStruct(np.shape(a), np.asarray(a).dtype),
        variables)


# -- export / load -------------------------------------------------------------

def export_serving(variables, cfg: Config, out_dir: str, batch_size: int = 1,
                   score_threshold: float = 0.05, quantized: bool = False,
                   platforms: Optional[Sequence[str]] = None) -> str:
    """Export the serving program + weights to ``out_dir`` and return it.

    ``platforms``: lowering targets (default: the current default backend).
    Pass ``("cuda", "cpu")`` to build a GPU artifact on a CPU-only host
    (cross-platform lowering; the program never runs at export time).
    """
    os.makedirs(out_dir, exist_ok=True)
    fn, input_specs = build_serving_fn(cfg, score_threshold=score_threshold,
                                       quantized=quantized)
    exported = jax.export.export(
        jax.jit(fn),
        platforms=tuple(platforms) if platforms else None,
    )(_var_specs(variables), *input_specs(batch_size))
    with open(os.path.join(out_dir, _FN_FILE), "wb") as f:
        f.write(exported.mlir_module_serialized)
    np.savez(os.path.join(out_dir, _WEIGHTS_FILE), **_flatten(variables))
    meta = {
        "batch_size": batch_size,
        "quantized": quantized,
        "score_threshold": score_threshold,
        "platforms": list(exported.platforms),
        "max_points": cfg.pipeline.max_points,
        "rgb_shape": list(cfg.rgb_shape),
        "jax_version": jax.__version__,
        "input_names": (["points_q", "refl_q", "num_points", "rgb"]
                        if quantized else ["points", "num_points", "rgb"]),
        "output_names": ["boxes3d", "probs", "mask"],
        "exported": _exported_meta(exported),
    }
    if quantized:
        # the host-side quantization grid matching the frozen in-graph
        # dequantizer — serving hosts quantize from meta alone, no cfg
        from ..ops.quantize import _bounds
        lo, hi = _bounds(cfg)
        meta["quant_bounds"] = {"lo": lo.tolist(), "hi": hi.tolist()}
    with open(os.path.join(out_dir, _META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return out_dir


class ServingModel:
    """A loaded serving artifact: numpy in, numpy out, fixed signature."""

    def __init__(self, exported, variables, meta: Dict[str, Any]):
        self.exported = exported
        self.meta = meta
        self._variables = jax.tree.map(jnp.asarray, variables)
        self._call = jax.jit(exported.call)

    def __call__(self, *inputs) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw batched call matching ``meta['input_names']`` (without the
        weights, which ride along from the artifact)."""
        out = self._call(self._variables, *(jnp.asarray(x) for x in inputs))
        return tuple(np.asarray(o) for o in out)

    def predict(self, points: np.ndarray, rgb: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Single-frame convenience: pad/truncate an (M, 4) cloud to the
        frozen point bucket and return (boxes3d (K,8,3), probs (K,)) for
        the surviving detections. Works with ANY artifact batch size: the
        frame is padded to the frozen batch with empty frames."""
        return self.predict_batch([(points, rgb)])[0]

    def predict_batch(self, frames: Sequence[Tuple[np.ndarray, np.ndarray]]
                      ) -> list:
        """Run up to ``meta['batch_size']`` frames in one program execution.

        ``frames`` is a sequence of (points (M,4), rgb (H,W,3)) pairs; the
        batch is padded to the frozen size with empty frames
        (num_points=0, which the in-graph voxelizer masks out entirely).
        Returns a list of (boxes3d (K,8,3), probs (K,)) per real frame —
        the server-side micro-batching primitive behind cli/serve.py."""
        bsz = self.meta["batch_size"]
        if not 1 <= len(frames) <= bsz:
            raise ValueError(
                f"predict_batch got {len(frames)} frames; artifact batch "
                f"size is {bsz}")
        n = self.meta["max_points"]
        h, w, c = self.meta["rgb_shape"]
        pts = np.full((bsz, n, 4), -1e9, np.float32)
        num = np.zeros(bsz, np.int32)
        rgbs = np.zeros((bsz, h, w, c), np.float32)
        for i, (p, r) in enumerate(frames):
            p = np.asarray(p, np.float32)[:n]
            pts[i, : p.shape[0]] = p
            num[i] = p.shape[0]
            rgbs[i] = np.asarray(r, np.float32)
        if self.meta["quantized"]:
            # quantize host-side with the grid from meta (the matching
            # dequantizer is baked into the frozen program) — no cfg needed
            from ..ops.quantize import quantize_points
            b = self.meta["quant_bounds"]
            q, rq = quantize_points(pts, bounds=(b["lo"], b["hi"]))
            boxes3d, probs, mask = self(q, rq, num, rgbs)
        else:
            boxes3d, probs, mask = self(pts, num, rgbs)
        out = []
        for i in range(len(frames)):
            keep = mask[i].astype(bool)
            out.append((boxes3d[i][keep], probs[i][keep]))
        return out


def load_serving(artifact_dir: str) -> ServingModel:
    """Load an artifact written by :func:`export_serving`."""
    with open(os.path.join(artifact_dir, _FN_FILE), "rb") as f:
        program = f.read()
    with np.load(os.path.join(artifact_dir, _WEIGHTS_FILE)) as z:
        variables = _unflatten({k: z[k] for k in z.files})
    with open(os.path.join(artifact_dir, _META_FILE)) as f:
        meta = json.load(f)
    return ServingModel(_rebuild_exported(meta, program, variables),
                        variables, meta)
