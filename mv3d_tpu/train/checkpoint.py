"""Per-subnet checkpointing: npz flat dicts (single-host, default) or orbax
(sharded / multi-host arrays).

Equivalent of the reference's per-scope ``tf.train.Saver`` wrapper
``Net`` (reference src/mv3d.py:117-161): each subnet
(``top_view_rpn`` / ``image_feature`` / ``front_feature`` / ``fusion``) is
saved and restored independently under ``checkpoint/<tag>/<subnet>/<step>``,
enabling mix-and-match loading of pretrained subnets for staged training
(``train.py -w``, mv3d.py:522-537). Training progress (the global step) is
stored alongside, replacing the reference's pickled
``log/train_progress/<tag>/progress.data`` (mv3d.py:963-977).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, List, Optional

import jax
import numpy as np


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _unflatten(flat: Dict[str, np.ndarray]):
    tree: Dict[str, Any] = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


class SubnetCheckpointer:
    """Saves/restores one subnet's variables (params + batch_stats).

    Two backends:
      * ``npz`` (default): compressed flat-dict files — dependency-light,
        atomic via rename, host-gathers arrays on save. Right for the
        single-host case (the reference's own scope: one GPU, one Saver).
      * ``orbax``: ``orbax.checkpoint`` directories — supports sharded/
        multi-host arrays (every process calls save/restore collectively)
        and restores with the shardings given by ``restore_target``.
    """

    def __init__(self, name: str, checkpoint_dir: str,
                 backend: str = "npz"):
        assert backend in ("npz", "orbax"), backend
        self.name = name
        self.backend = backend
        self.dir = os.path.join(checkpoint_dir, name)
        os.makedirs(self.dir, exist_ok=True)

    def _path(self, step: int) -> str:
        suffix = ".npz" if self.backend == "npz" else ".orbax"
        return os.path.join(self.dir, f"{self.name}-{step}{suffix}")

    def save(self, variables, step: int = 0):
        if self.backend == "orbax":
            import orbax.checkpoint as ocp
            with ocp.StandardCheckpointer() as ckptr:
                # Checkpointer.save is atomic (tmp dir + rename) and handles
                # sharded jax.Arrays collectively across processes
                ckptr.save(os.path.abspath(self._path(step)), variables,
                           force=True)
            return
        flat = _flatten(jax.device_get(variables))
        tmp = self._path(step) + ".tmp"
        with open(tmp, "wb") as f:   # file object: savez won't append ".npz"
            np.savez_compressed(f, **flat)
        os.replace(tmp, self._path(step))

    def save_crash(self, variables) -> str:
        """Forensic crash checkpoint at ``<name>-crash.npz``.

        The "crash" suffix is deliberately non-numeric so ``latest_step()``
        never selects it: a NaN crash usually means the post-update weights
        are themselves NaN-poisoned (loss -> grad -> apply_updates), and a
        resume must come from the last *good* cadence checkpoint, not the
        poisoned state. Orbax backend saves a sibling ``<name>-crash.orbax``
        directory the same way."""
        suffix = ".npz" if self.backend == "npz" else ".orbax"
        path = os.path.join(self.dir, f"{self.name}-crash{suffix}")
        if self.backend == "orbax":
            import orbax.checkpoint as ocp
            with ocp.StandardCheckpointer() as ckptr:
                ckptr.save(os.path.abspath(path), variables, force=True)
            return path
        flat = _flatten(jax.device_get(variables))
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **flat)
        os.replace(tmp, path)
        return path

    def latest_step(self) -> Optional[int]:
        suffix = ".npz" if self.backend == "npz" else ".orbax"
        steps = []
        for f in os.listdir(self.dir):
            if f.startswith(self.name + "-") and f.endswith(suffix):
                try:
                    steps.append(int(f[len(self.name) + 1:-len(suffix)]))
                except ValueError:
                    pass
        return max(steps) if steps else None

    def load(self, step: Optional[int] = None, restore_target=None):
        """Returns the stored variable tree, or None if no checkpoint exists
        (parity with the reference's use-default-weights fallback,
        mv3d.py:142-148).

        ``restore_target`` (orbax backend): a pytree of abstract arrays /
        jax.Arrays whose shardings the restored arrays should take — pass the
        live (possibly mesh-sharded) variables to restore distributed."""
        step = self.latest_step() if step is None else step
        if step is None or not os.path.exists(self._path(step)):
            return None
        if self.backend == "orbax":
            import orbax.checkpoint as ocp
            target = None
            if restore_target is not None:
                target = jax.tree.map(
                    lambda x: jax.ShapeDtypeStruct(
                        x.shape, x.dtype, sharding=getattr(x, "sharding",
                                                           None)),
                    restore_target)
            with ocp.StandardCheckpointer() as ckptr:
                return ckptr.restore(os.path.abspath(self._path(step)),
                                     target)
        with np.load(self._path(step)) as z:
            flat = {k: z[k] for k in z.files}
        return _unflatten(flat)

    def clean(self):
        """Remove all weights of this subnet (parity: clean_weights,
        mv3d.py:135-139)."""
        shutil.rmtree(self.dir, ignore_errors=True)
        os.makedirs(self.dir, exist_ok=True)


def save_progress(log_dir: str, tag: str, step: int):
    path = os.path.join(log_dir, "train_progress", tag)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "progress.txt"), "w") as f:
        f.write(str(step))


def load_progress(log_dir: str, tag: str) -> int:
    path = os.path.join(log_dir, "train_progress", tag, "progress.txt")
    if os.path.exists(path):
        with open(path) as f:
            return int(f.read().strip())
    return 0
