"""Device meshes and sharded train/inference steps.

The reference has *no* distribution story — single process, single GPU,
batch 1, with "mimic batch" host-side loss accumulation
(SURVEY.md §2.3; reference mv3d.py:1063-1065, 1265-1272). Here scaling is
data parallelism over a device mesh:

  * a ``jax.sharding.Mesh`` with a ``data`` axis (and a reserved ``model``
    axis — at ~10^7 params this detector needs no tensor parallelism, but the
    mesh shape keeps the extension point);
  * batch arrays sharded ``P("data")`` along their leading axis, parameters
    replicated ``P()``;
  * the train step jitted with those shardings — XLA inserts the gradient
    all-reduce (NCCL on GPUs) automatically because the loss is a global mean
    over the sharded batch. Gradient accumulation becomes *real*
    data-parallel batching.

Multi-host: call ``jax.distributed.initialize()`` before building the mesh and
feed each process its local shard via
``jax.make_array_from_process_local_data`` — nothing else changes. This recipe
is executed for real (2 OS processes, 8-device global mesh, Gloo collectives)
in ``tests/test_distributed.py``; sharded checkpointing for it is the orbax
backend of ``train/checkpoint.py``. Inference fan-out has no
cross-device communication at all.
"""

from __future__ import annotations

from functools import partial
from typing import Any, Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: Optional[int] = None, model_axis: int = 1,
              devices: Optional[Sequence] = None) -> Mesh:
    """Build a (data, model) mesh over the first n devices."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices) if n_devices is None else n_devices
    devices = devices[:n]
    assert n % model_axis == 0
    arr = np.array(devices).reshape(n // model_axis, model_axis)
    return Mesh(arr, ("data", "model"))


def replicate(tree, mesh: Mesh):
    """Replicate a pytree (parameters/optimizer state) across the mesh."""
    s = NamedSharding(mesh, P())
    return jax.device_put(tree, s)


def batch_divisor(mesh: Mesh) -> int:
    """Number of ways the leading batch axis is split on this mesh."""
    return int(mesh.shape["data"])


def check_batch_divisible(batch: Dict[str, Any], mesh: Mesh):
    """Raise a clear ValueError when a batch can't shard over the mesh.

    Without this the failure mode is an XLA sharding error deep inside jit
    ("sharding ... is not divisible") long after the user's mistake."""
    n = batch_divisor(mesh)
    for k, v in batch.items():
        if hasattr(v, "shape") and np.ndim(v) and v.shape[0] % n:
            raise ValueError(
                f"batch axis of '{k}' has size {v.shape[0]}, not divisible "
                f"by the mesh's {n}-way data sharding "
                f"(mesh {dict(mesh.shape)}); pad or rebatch so that "
                f"batch % {n} == 0")


def shard_batch(batch: Dict[str, Any], mesh: Mesh):
    """Shard every batch array along its leading (batch) axis."""
    check_batch_divisible(batch, mesh)
    s = NamedSharding(mesh, P("data"))
    return {k: (jax.device_put(v, s) if hasattr(v, "shape") else v)
            for k, v in batch.items()}


def make_sharded_train_step(model, optimizer, train_targets, mesh: Mesh,
                            cfg=None):
    """Data-parallel train step over the mesh.

    Returns step(variables, opt_state, batch, key) -> (vars, opt_state, losses)
    with variables/opt_state replicated and batch sharded P("data"). The
    global-mean losses make XLA all-reduce the gradients.
    """
    import optax

    from ..models.mv3d_net import total_loss
    from ..models.nets import SUBNET_NAMES

    cfg = cfg or model.cfg
    repl = NamedSharding(mesh, P())
    data_sharded = NamedSharding(mesh, P("data"))

    def step(variables, opt_state, batch, key):
        params = {n: variables[n]["params"] for n in SUBNET_NAMES}
        stats = {n: variables[n].get("batch_stats") for n in SUBNET_NAMES}

        def loss_fn(p):
            var = {n: {"params": p[n], "batch_stats": stats[n]}
                   for n in SUBNET_NAMES}
            loss_dict, aux = model.forward_train(var, batch, key, train=True)
            return total_loss(loss_dict, train_targets, cfg), (loss_dict, aux)

        (_, (loss_dict, aux)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        updates, new_opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        new_vars = {}
        for n in SUBNET_NAMES:
            up = aux["updates"].get(n)
            bs = (up["batch_stats"] if up is not None
                  else variables[n]["batch_stats"])
            new_vars[n] = {"params": params[n], "batch_stats": bs}
        return new_vars, new_opt_state, loss_dict

    batch_spec = {
        "points": data_sharded, "num_points": data_sharded,
        "rgb": data_sharded, "top": data_sharded, "front": data_sharded,
        "top_aux": data_sharded,
        "gt_boxes3d": data_sharded, "gt_labels": data_sharded,
        "gt_mask": data_sharded,
    }

    def jit_for(batch_keys):
        in_shard = (repl, repl, {k: batch_spec[k] for k in batch_keys}, repl)
        # donate variables/opt_state: the training loop owns them (every
        # caller rebinds to the returned state), letting XLA alias the
        # replicated param + Adam-moment buffers instead of copying them
        # on every step on every device
        return jax.jit(step, in_shardings=in_shard,
                       out_shardings=(repl, repl, repl),
                       donate_argnums=(0, 1))

    # cache compiled steps per batch-structure
    cache = {}

    def run(variables, opt_state, batch, key):
        sig = tuple(sorted(batch.keys()))
        if sig not in cache:
            cache[sig] = jit_for(sig)
        return cache[sig](variables, opt_state, batch, key)

    return run


def make_sharded_infer_step(model, mesh: Mesh, score_threshold: float = 0.05):
    """Batch-sharded inference step (throughput serving fan-out)."""
    from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch

    repl = NamedSharding(mesh, P())
    data_sharded = NamedSharding(mesh, P("data"))
    cfg = model.cfg

    def infer(variables, points, rgb):
        top, occ = lidar_to_top_batch(points, cfg, return_occ=True)
        front = lidar_to_front_batch(points, cfg)
        dets, _ = model.forward_inference(variables, top, rgb, front,
                                          score_threshold=score_threshold,
                                          top_occ=occ)
        return dets

    return jax.jit(infer,
                   in_shardings=(repl, data_sharded, data_sharded),
                   out_shardings=data_sharded)
