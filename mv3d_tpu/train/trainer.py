"""User-facing train/predict API: ``MV3D``, ``Trainer``, ``Predictor``.

API parity with the reference's ``src/mv3d.py`` classes (``MV3D`` :164,
``Trainer`` :721, ``Predictor`` :666) on a single-program JAX core:

  * one jitted train step = voxelize (optional) + trunks + RPN + in-graph
    targets + fusion + losses + adam update (the reference needs two
    ``sess.run`` calls with host numpy/PyCUDA work in between, mv3d.py:1118-1407);
  * staged training via ``optax.multi_transform`` masks over subnet subtrees
    (the equivalent of per-scope ``var_list`` s, mv3d.py:777-831);
  * per-subnet checkpointing with mix-and-match pretrained loading
    (mv3d.py:117-161, 522-537);
  * validation interleave / checkpoint cadence as in the reference loop
    (mv3d.py:980-1115).
"""

from __future__ import annotations

import os
from functools import partial
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..config import Config, cfg as _default_cfg
from ..models.mv3d_net import MV3DNet, total_loss
from ..models.nets import SUBNET_NAMES
from ..ops.voxelize import lidar_to_front_batch, lidar_to_top_batch
from ..utils import Logger, Timer
from .checkpoint import SubnetCheckpointer, load_progress, save_progress


def _batchify_view(v):
    """To-device + add a batch dim if single-frame."""
    a = jnp.asarray(v)
    return a[None] if a.ndim == 3 else a


def _prepare_views(batch: Dict[str, jnp.ndarray], cfg: Config
                   ) -> Dict[str, jnp.ndarray]:
    """Fill in top/front views from raw points if not precomputed (in-graph).

    Accepts quantized transfer batches (``points_q``/``refl_q`` from a
    ``stream_quantized`` loader): dequantization happens here, in-graph."""
    if "top" not in batch:
        batch = dict(batch)
        if "points_q" in batch:
            from ..ops.quantize import dequantize_points
            pts = dequantize_points(batch.pop("points_q"),
                                    batch.pop("refl_q"), cfg)
            batch["points"] = pts
        else:
            pts = batch["points"]
        num = batch.get("num_points")
        batch["top"], batch["top_occ"] = lidar_to_top_batch(
            pts, cfg, num, aux=batch.pop("top_aux", None), return_occ=True)
        batch["front"] = lidar_to_front_batch(pts, cfg, num)
    return batch


class MV3D:
    """Model + weights + per-subnet checkpointing + jitted predict."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", log_dir: str = "log",
                 seed: int = 0, checkpoint_backend: str = "npz",
                 debug_mode: bool = False):
        # non-interactive equivalent of the reference's tf_debug CLI session
        # wrapper (mv3d.py:1349-1353, flag :253): every jitted program checks
        # for NaN outputs and raises at the op that produced them, and
        # ``debug_dump()`` reports per-array weight statistics.
        self.debug_mode = debug_mode
        if debug_mode:
            jax.config.update("jax_debug_nans", True)
        self.cfg = cfg
        self.model = MV3DNet(cfg)
        self.tag = log_tag
        self.log_dir = log_dir
        self.ckpt_dir = os.path.join(checkpoint_dir, log_tag)
        self.checkpointers = {
            name: SubnetCheckpointer(name, self.ckpt_dir,
                                     backend=checkpoint_backend)
            for name in SUBNET_NAMES}
        self.log = Logger(os.path.join(log_dir, "log.txt"))
        from ..utils.metrics import MetricsWriter
        self.metrics = MetricsWriter(log_dir, tag=log_tag)
        self.variables = self.model.init_variables(jax.random.PRNGKey(seed))

        def _infer(variables, top, rgb, front, score_threshold):
            return self.model.forward_inference(
                variables, top, rgb, front, score_threshold=score_threshold)

        self._infer = jax.jit(_infer)

        def _infer_points(variables, points, num_points, rgb, score_threshold,
                          top_aux=None):
            top, occ = lidar_to_top_batch(points, self.cfg, num_points,
                                          aux=top_aux, return_occ=True)
            front = lidar_to_front_batch(points, self.cfg, num_points)
            return self.model.forward_inference(
                variables, top, rgb, front, score_threshold=score_threshold,
                top_occ=occ)

        self._infer_points = jax.jit(_infer_points)
        self._infer_points_aux = jax.jit(
            lambda v, p, n, r, s, a: _infer_points(v, p, n, r, s, top_aux=a))

    # -- weights --------------------------------------------------------------

    def save_weights(self, subnets: Optional[Sequence[str]] = None,
                     step: int = 0):
        for name in (subnets or SUBNET_NAMES):
            self.checkpointers[name].save(self.variables[name], step)

    def load_weights(self, subnets: Optional[Sequence[str]] = None,
                     step: Optional[int] = None):
        """Restore any stored subnets; silently keep fresh init otherwise
        (parity: Net.load_weights fallback, mv3d.py:142-148)."""
        for name in (subnets or SUBNET_NAMES):
            stored = self.checkpointers[name].load(step)
            if stored is None:
                self.log.write(
                    f"Load weights failed for {name}: no checkpoint, "
                    f"using initialized values\n")
                continue
            stored = jax.tree.map(jnp.asarray, stored)
            self.variables[name] = stored
            self.log.write(f"Load weights for {name} success!\n")

    def clean_weights(self, subnets: Optional[Sequence[str]] = None):
        for name in (subnets or SUBNET_NAMES):
            self.checkpointers[name].clean()

    def debug_dump(self, path: Optional[str] = None) -> str:
        """Write per-array statistics (shape, min/max/mean, nan/inf counts)
        of every weight to ``<log_dir>/debug/<tag>_weights.txt`` and return
        the path — the file-based stand-in for poking tensors in the
        reference's interactive debug session."""
        if path is None:
            d = os.path.join(self.log_dir, "debug")
            os.makedirs(d, exist_ok=True)
            path = os.path.join(d, f"{self.tag}_weights.txt")
        flat = jax.tree_util.tree_flatten_with_path(self.variables)[0]
        with open(path, "w") as f:
            for keypath, arr in flat:
                a = np.asarray(arr)
                f.write(
                    f"{jax.tree_util.keystr(keypath)} {a.shape} {a.dtype} "
                    f"min={a.min():.5g} max={a.max():.5g} "
                    f"mean={a.mean():.5g} nan={int(np.isnan(a).sum())} "
                    f"inf={int(np.isinf(a).sum())}\n")
        return path

    # -- inference ------------------------------------------------------------

    def predict(self, top_view, front_view, rgb_image,
                score_threshold: Optional[float] = None
                ) -> Tuple[np.ndarray, list, np.ndarray]:
        """Single-frame detection; numpy in / numpy out.

        Parity: reference ``MV3D.predict`` (mv3d.py:272-328) — returns
        (boxes3d (K, 8, 3), labels, probs (K,)).
        """
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        top = _batchify_view(top_view)
        rgb = _batchify_view(rgb_image)
        front = _batchify_view(front_view)
        dets, _ = self._infer(self.variables, top, rgb, front,
                              jnp.float32(score_threshold))
        mask = np.asarray(dets.mask[0])
        boxes3d = np.asarray(dets.boxes3d[0])[mask]
        probs = np.asarray(dets.probs[0])[mask]
        return boxes3d, [], probs

    def predict_from_points(self, points, num_points, rgb,
                            score_threshold: Optional[float] = None,
                            top_aux=None
                            ) -> Tuple[np.ndarray, list, np.ndarray]:
        """Single-frame detection from raw padded lidar points: voxelization
        and detection run as ONE XLA program (the reference crosses the
        device boundary ~6x per frame here, SURVEY.md §3.3)."""
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        points = jnp.asarray(points)
        if points.ndim == 2:
            points = points[None]
        rgb = jnp.asarray(rgb)
        if rgb.ndim == 3:
            rgb = rgb[None]
        num_points = jnp.atleast_1d(jnp.asarray(num_points, jnp.int32))
        if top_aux is not None:
            top_aux = jnp.asarray(top_aux)
            if top_aux.ndim == 3:
                top_aux = top_aux[None]
            dets, _ = self._infer_points_aux(
                self.variables, points, num_points, rgb,
                jnp.float32(score_threshold), top_aux)
        else:
            dets, _ = self._infer_points(self.variables, points, num_points,
                                         rgb, jnp.float32(score_threshold))
        mask = np.asarray(dets.mask[0])
        boxes3d = np.asarray(dets.boxes3d[0])[mask]
        probs = np.asarray(dets.probs[0])[mask]
        return boxes3d, [], probs


class Predictor(MV3D):
    """Inference-ready model: loads all subnet weights on construction
    (parity: reference ``Predictor``, mv3d.py:666-691)."""

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir, **kw)
        self.load_weights()


class Trainer(MV3D):
    """Staged trainer over any dataset exposing ``load() -> batch dict``.

    batch dict: either precomputed views (``top``/``front``/``rgb``) or raw
    ``points`` (+ optional ``num_points``) voxelized in-graph, plus
    ``gt_boxes3d`` (B,G,8,3), ``gt_labels`` (B,G), ``gt_mask`` (B,G).
    """

    def __init__(self, train_set, validation_set=None,
                 pre_trained_weights: Sequence[str] = (),
                 train_targets: Sequence[str] = SUBNET_NAMES,
                 cfg: Config = _default_cfg, log_tag: str = "default",
                 continue_train: bool = False,
                 lr: float = None, checkpoint_dir: str = "checkpoint",
                 log_dir: str = "log", seed: int = 0):
        # NOTE: real batching replaces the reference's "mimic batch size"
        # host-side loss accumulation (mv3d.py:1063-1065): the loader's
        # batch_size IS the optimization batch because the whole step is one
        # jit'd program. No separate Trainer-side knob exists.
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         log_dir=log_dir, seed=seed)
        assert train_targets, "train_targets must be non-empty"
        self.train_set = train_set
        self.validation_set = validation_set
        self.train_targets = tuple(train_targets)
        lr = cfg.train.lr if lr is None else lr

        # staged training: adam on target subnets, frozen elsewhere
        # (equivalent of the per-target var_list, mv3d.py:777-794)
        def label_params(params):
            return {n: jax.tree.map(
                lambda _: "train" if n in self.train_targets else "freeze",
                params[n]) for n in params}

        # LR schedule (reference: constant Adam, mv3d.py:757,849;
        # "cosine" adds linear warmup + cosine decay — TrainConfig)
        tc = cfg.train
        if tc.lr_schedule == "cosine":
            schedule = optax.warmup_cosine_decay_schedule(
                init_value=0.0 if tc.warmup_steps else lr,
                peak_value=lr, warmup_steps=tc.warmup_steps,
                decay_steps=max(tc.decay_steps, tc.warmup_steps + 1),
                end_value=lr * tc.lr_end_factor)
        elif tc.lr_schedule == "constant":
            schedule = lr
        else:
            raise ValueError(f"unknown lr_schedule {tc.lr_schedule!r}")
        tx = optax.adam(schedule)
        if tc.grad_clip_norm > 0:
            # clip by the global norm of the TRAINED subnets' gradients only
            # (frozen subnets are zeroed by their branch and must not dilute
            # the norm)
            tx = optax.chain(optax.clip_by_global_norm(tc.grad_clip_norm), tx)
        self.optimizer = optax.multi_transform(
            {"train": tx, "freeze": optax.set_to_zero()},
            label_params)
        params = {n: self.variables[n]["params"] for n in SUBNET_NAMES}
        self.opt_state = self.optimizer.init(params)

        self.n_global_step = 0
        # periodic gt/prediction image dumps (reference iter_debug, mv3d.py:993)
        self.debug_image_every = 0
        if not continue_train:
            self.clean_weights(self.train_targets)
        else:
            self.n_global_step = load_progress(log_dir, log_tag)
        if pre_trained_weights:
            self.load_weights(pre_trained_weights)
        if continue_train:
            self.load_weights(self.train_targets)

        model, config = self.model, self.cfg
        train_targets_t = self.train_targets
        optimizer = self.optimizer

        def step_fn(variables, opt_state, batch, key, do_optimize: bool):
            if do_optimize:
                # in-graph flip/rotate of points + gt (no-op when disabled)
                from .augment import augment_batch
                key, ak = jax.random.split(key)
                batch = augment_batch(batch, ak, config)
            batch = _prepare_views(batch, config)
            params = {n: variables[n]["params"] for n in SUBNET_NAMES}
            stats = {n: variables[n].get("batch_stats") for n in SUBNET_NAMES}

            def loss_fn(p):
                var = {n: {"params": p[n], "batch_stats": stats[n]}
                       for n in SUBNET_NAMES}
                loss_dict, aux = model.forward_train(var, batch, key,
                                                     train=do_optimize)
                return total_loss(loss_dict, train_targets_t, config), \
                    (loss_dict, aux)

            if do_optimize:
                (_, (loss_dict, aux)), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                updates, opt_state = optimizer.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                new_vars = {}
                for n in SUBNET_NAMES:
                    up = aux["updates"].get(n)
                    bs = (up["batch_stats"] if up is not None
                          else variables[n]["batch_stats"])
                    new_vars[n] = {"params": params[n], "batch_stats": bs}
                return new_vars, opt_state, loss_dict
            _, (loss_dict, aux) = loss_fn(params)
            return variables, opt_state, loss_dict

        # variables/opt_state are donated: the step owns its state buffers
        # (fit_iteration reassigns immediately), so XLA updates Adam moments
        # and params in place instead of allocating + copying ~3x the model
        # size in HBM every step. The eval step returns variables unchanged
        # and callers may keep references, so it does not donate.
        self._train_step = jax.jit(partial(step_fn, do_optimize=True),
                                   donate_argnums=(0, 1))
        self._eval_step = jax.jit(partial(step_fn, do_optimize=False))
        self._key = jax.random.PRNGKey(seed + 1)

    def _next_key(self):
        self._key, k = jax.random.split(self._key)
        return k

    def _dump_debug_images(self, batch, step: int):
        from ..utils.metrics import dump_debug_images
        boxes3d, _, _ = self.predict_from_points(
            np.asarray(batch["points"][0]),
            int(np.asarray(batch["num_points"][0])),
            np.asarray(batch["rgb"][0]), score_threshold=0.5)
        from ..ops import voxelize_ref
        pts = np.asarray(batch["points"][0])
        top = voxelize_ref.lidar_to_top_np(
            pts[: int(np.asarray(batch["num_points"][0]))], self.cfg)
        gm = np.asarray(batch["gt_mask"][0])
        dump_debug_images(
            os.path.join(self.log_dir, "debug_images", self.tag), step,
            top, rgb=np.asarray(batch["rgb"][0]),
            gt_boxes3d=np.asarray(batch["gt_boxes3d"][0])[gm],
            det_boxes3d=boxes3d, cfg=self.cfg)

    def validation_iou(self, batch: Dict[str, np.ndarray],
                       score_threshold: Optional[float] = None) -> float:
        """Online detection-quality signal: run inference on a validation
        batch and score predictions vs gt with the yaw-aware 3D IoU.

        Parity: the reference computes ``boxes3d_score_iou`` against gt on
        its validation interleave and logs it (mv3d.py:945-954 via
        boxes3d.py:517-541); like its ``log_prediction`` the score gate is a
        parameter defaulting to the config's 0.75 (mv3d.py:940). Frames
        without positive gt are skipped; returns the mean over the batch
        (0.0 if no scorable frame).
        """
        from ..ops.boxes3d import boxes3d_score_iou
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        thresh = jnp.float32(score_threshold)
        if "points" in batch and "top" not in batch:
            pts = jnp.asarray(batch["points"])
            num = batch.get("num_points")
            num = (jnp.asarray(num, jnp.int32) if num is not None
                   else jnp.full((pts.shape[0],), pts.shape[1], jnp.int32))
            dets, _ = self._infer_points(self.variables, pts, num,
                                         jnp.asarray(batch["rgb"]), thresh)
        else:
            dets, _ = self._infer(self.variables, jnp.asarray(batch["top"]),
                                  jnp.asarray(batch["rgb"]),
                                  jnp.asarray(batch["front"]), thresh)
        det_mask = np.asarray(dets.mask)
        det_boxes = np.asarray(dets.boxes3d)
        gt3d = np.asarray(batch["gt_boxes3d"])
        gm = np.asarray(batch["gt_mask"]) & (np.asarray(batch["gt_labels"]) > 0)
        ious = []
        for i in range(det_boxes.shape[0]):
            gt = gt3d[i][gm[i]]
            if len(gt) == 0:
                continue
            ious.append(boxes3d_score_iou(gt, det_boxes[i][det_mask[i]],
                                          self.cfg))
        return float(np.mean(ious)) if ious else 0.0

    def fit_iteration(self, batch: Dict[str, np.ndarray],
                      is_validation: bool = False) -> Dict[str, float]:
        """One optimization (or validation) step on a host batch dict."""
        batch = {k: jnp.asarray(v) for k, v in batch.items() if k != "tags"}
        step = self._eval_step if is_validation else self._train_step
        self.variables, self.opt_state, loss_dict = step(
            self.variables, self.opt_state, batch, self._next_key())
        return {k: float(v) for k, v in loss_dict.items()}

    def __call__(self, max_iter: int = 1000) -> Dict[str, float]:
        """Run the training loop (parity: Trainer.__call__, mv3d.py:980-1115)."""
        cfg = self.cfg
        validation_step = cfg.train.validation_every
        ckpt_save_step = cfg.train.ckpt_every
        timer = Timer()
        self.log.write(
            "iter |  top_cls_loss   reg_loss   |  fuse_cls_loss  reg_loss  |\n")
        last = {}
        init_step = self.n_global_step
        for it in range(init_step, init_step + max_iter):
            is_validation = (self.validation_set is not None and
                             it % validation_step == 0 and it > 0)
            data_set = self.validation_set if is_validation else self.train_set
            batch = data_set.load()
            if batch is None:
                continue
            # skip frames with no positive gt (mv3d.py:1050-1051)
            if not np.any(np.asarray(batch["gt_labels"]) *
                          np.asarray(batch["gt_mask"])):
                continue
            last = self.fit_iteration(batch, is_validation=is_validation)
            step_name = "validation" if is_validation else "training"
            line = "%10s: %5d  %0.5f  %0.5f  |  %0.5f  %0.5f" % (
                step_name, it,
                last["top_cls_loss"], last["top_reg_loss"],
                last["fuse_cls_loss"], last["fuse_reg_loss"])
            if is_validation:
                # online 3D-IoU of predictions vs gt (mv3d.py:945-954)
                last["iou"] = self.validation_iou(batch)
                line += "  |  iou %0.5f" % last["iou"]
            self.log.write(line + "\n")
            self.metrics.write(it, last, phase=step_name)
            if (self.debug_image_every and it > 0 and
                    it % self.debug_image_every == 0 and "points" in batch):
                self._dump_debug_images(batch, it)
            if np.any(np.isnan(list(last.values()))):
                # Forensic crash-save before dying (the reference has no
                # guard at all — a NaN propagates silently, mv3d.py:1050-
                # 1115). A NaN loss almost always means the post-update
                # weights of every trained target are themselves poisoned
                # (loss -> grad -> apply_updates), so the crash state goes
                # to <subnet>-crash.npz — a name latest_step() never selects
                # — and progress is NOT repointed: continue_train resumes
                # from the last good cadence checkpoint, not the NaN one.
                # debug_dump records which arrays went non-finite.
                try:
                    paths = [self.checkpointers[n].save_crash(
                        self.variables[n]) for n in self.train_targets]
                    dump = self.debug_dump()
                    self.log.write(f"NaN crash-save at iter {it}: forensic "
                                   f"weights at {paths}, stats at {dump}\n")
                except Exception as e:  # the original error must surface
                    self.log.write(f"NaN crash-save failed: {e}\n")
                raise FloatingPointError(
                    f"NaN loss at iter {it}: {last} "
                    f"(forensic crash checkpoint saved; resume uses the "
                    f"last good cadence checkpoint)")
            self.n_global_step = it + 1
            if it > 0 and it % ckpt_save_step == 0:
                self.save_weights(self.train_targets, it)
                save_progress(self.log_dir, self.tag, self.n_global_step)
                self.log.write(
                    "It takes %0.2f secs to train %d iterations.\n" % (
                        timer.time_diff_per_n_loops(), ckpt_save_step))
                try:  # refresh the static dashboard at checkpoint cadence
                    from ..utils.dashboard import render_dashboard
                    render_dashboard(self.log_dir)
                except Exception as e:  # observability never kills training
                    self.log.write(f"dashboard render failed: {e}\n")
        self.save_weights(self.train_targets, self.n_global_step)
        save_progress(self.log_dir, self.tag, self.n_global_step)
        return last


class PredictorForTest(MV3D):
    """Diagnostic predictor: main detections plus the twin fusion heads
    (with-RGB / without-RGB) NMS'd separately, with annotated image dumps.

    Parity: reference ``Predictor_for_test`` (mv3d.py:693-720) +
    ``predict_for_test`` (mv3d.py:332-395): after a call, ``probs_with_rgb``
    / ``boxes3d_with_rgb`` / ``probs_without_rgb`` / ``boxes3d_without_rgb``
    hold the per-head results and ``dump_log`` writes the debug images the
    reference sent to TensorBoard.
    """

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True, **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights()

        from ..ops import boxes3d as box3d_ops
        from ..ops.detect import rcnn_nms
        from ..ops.proposal import rpn_proposals
        model, config = self.model, self.cfg

        def _predict3(variables, top, rgb, front, score_threshold):
            outs, _ = model.extract_features(variables, top, rgb, front,
                                             train=False)
            rpn = outs["rpn"]
            inside = model.anchor_mask(top[0])
            props = rpn_proposals(rpn["scores"][0], rpn["deltas"][0],
                                  model.anchors, inside, config)
            rois3d = box3d_ops.top_box_to_box3d(props.rois[:, 1:5], config)
            feats = {"top": rpn["features"][0]}
            if "rgb_features" in outs:
                feats["rgb"] = outs["rgb_features"][0]
            if "front_features" in outs:
                feats["front"] = outs["front_features"][0]
            pooled = model.pool_rois(feats, rois3d, props.rois[:, 1:5])
            fuse = model.fusion.apply(variables["fusion"], pooled, False)
            dets = {}
            for head in ("", "_with_rgb", "_without_rgb"):
                if "probs" + head not in fuse:
                    continue
                deltas = fuse["deltas" + head].reshape(
                    -1, config.model.num_class, 8, 3)
                dets[head] = rcnn_nms(fuse["probs" + head], deltas, rois3d,
                                      props.mask,
                                      score_threshold=score_threshold,
                                      cfg=config)
            return dets, props

        self._predict3 = jax.jit(_predict3)
        self._last = None

    def __call__(self, top_view, front_view, rgb_image,
                 nms_threshold: Optional[float] = None, gt_boxes3d=None):
        if nms_threshold is None:
            nms_threshold = self.cfg.rcnn.score_threshold
        top = _batchify_view(top_view)
        rgb = jnp.asarray(rgb_image)
        rgb = rgb[None] if rgb.ndim == 3 else rgb
        front = jnp.asarray(front_view)
        front = front[None] if front.ndim == 3 else front
        dets, props = self._predict3(self.variables, top, rgb, front,
                                     jnp.float32(nms_threshold))

        def unpack(d):
            m = np.asarray(d.mask)
            return np.asarray(d.boxes3d)[m], np.asarray(d.probs)[m]

        boxes3d, probs = unpack(dets[""])
        for head in ("_with_rgb", "_without_rgb"):
            b, p = unpack(dets[head]) if head in dets else (boxes3d, probs)
            setattr(self, "boxes3d" + head, b)
            setattr(self, "probs" + head, p)
        pm = np.asarray(props.mask)
        self._last = {
            "top": np.asarray(top[0]), "rgb": np.asarray(rgb[0]),
            "proposals": np.asarray(props.rois)[pm][:, 1:5],
            "boxes3d": boxes3d,
            "gt_boxes3d": (np.asarray(gt_boxes3d)
                           if gt_boxes3d is not None else None),
        }
        return boxes3d, [], probs

    def dump_log(self, log_subdir: str, n_frame: int) -> str:
        """Write annotated BEV/camera pngs for the last prediction
        (non-interactive replacement for the reference's TB image summaries,
        mv3d.py:716-720)."""
        assert self._last is not None, "call the predictor first"
        from ..utils.metrics import dump_debug_images
        out = os.path.join(self.log_dir, log_subdir)
        return dump_debug_images(
            out, n_frame, self._last["top"], rgb=self._last["rgb"],
            gt_boxes3d=self._last["gt_boxes3d"],
            det_boxes3d=self._last["boxes3d"],
            proposals=self._last["proposals"], cfg=self.cfg)


class TesterRPNTarget(MV3D):
    """RPN target-assignment prober: sampled/positive anchor counts plus an
    annotated anchor-label image.

    Parity: reference ``Tester_RPN_Target`` (mv3d.py:1492-1548) — runs
    ``rpn_target`` over ALL anchors (inside_inds = arange, mv3d.py:1530) and
    reports ``anchors_details()``; the TB label/gt images become pngs.
    """

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        from ..ops import boxes3d as box3d_ops
        from ..train import targets as target_lib
        model, config = self.model, self.cfg

        def _target(gt3d, gt_labels, gt_mask, key):
            gt_top = box3d_ops.box3d_to_top_box(gt3d, config)
            inside = jnp.ones(model.anchors.shape[0], bool)   # use all
            return target_lib.rpn_target(model.anchors, inside, gt_top,
                                         gt_labels, gt_mask, key, config)

        self._target = jax.jit(_target)
        self._last = None

    def __call__(self, top_view, gt_boxes3d, gt_labels, seed: int = 0):
        g = len(gt_boxes3d)
        gt3d = jnp.asarray(gt_boxes3d, jnp.float32)
        tg = self._target(gt3d, jnp.asarray(gt_labels, jnp.int32),
                          jnp.ones(g, bool), jax.random.PRNGKey(seed))
        top = np.asarray(top_view)
        self._last = {"top": top[0] if top.ndim == 4 else top,
                      "gt_boxes3d": np.asarray(gt_boxes3d),
                      "cls_mask": np.asarray(tg.cls_mask),
                      "labels": np.asarray(tg.labels),
                      "pos_mask": np.asarray(tg.pos_mask)}
        n_sampled = int(self._last["cls_mask"].sum())
        n_pos = int(self._last["pos_mask"].sum())
        return n_sampled, n_pos

    def anchors_details(self) -> str:
        return "anchors: positive= {} total= {}\n".format(
            int(self._last["pos_mask"].sum()),
            int(self._last["cls_mask"].sum()))

    def dump_log(self, log_subdir: str, step: int = 0) -> str:
        """Sampled anchors drawn over the BEV image: negatives gray,
        positives blue, gt white (reference draw_rpn_labels/draw_rpn_gt)."""
        assert self._last is not None, "call the tester first"
        from PIL import Image

        from ..utils import viz
        anchors = np.asarray(self.model.anchors)
        img = viz.draw_top_image(self._last["top"])
        neg = self._last["cls_mask"] & ~self._last["pos_mask"]
        img = viz.draw_boxes2d(img, anchors[neg], color=(128, 128, 128))
        img = viz.draw_boxes2d(img, anchors[self._last["pos_mask"]],
                               color=(0, 64, 255))
        if len(self._last["gt_boxes3d"]):
            img = viz.draw_box3d_on_top(img, self._last["gt_boxes3d"],
                                        color=(255, 255, 255), cfg=self.cfg)
        d = os.path.join(self.log_dir, log_subdir)
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"rpn_target_{step:06d}.png")
        Image.fromarray(img).save(path)
        return path


class TesterRPN(MV3D):
    """RPN-only prober: per-frame proposals + scores + score heatmap.

    Parity: reference ``Tester_RPN`` (mv3d.py:1436-1490) — used by
    ``test.py test_rpn`` to dump proposals for external evaluation.
    """

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True, **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights(["top_view_rpn"])

        from ..ops.proposal import rpn_proposals
        model, config = self.model, self.cfg

        def _rpn(variables, top):
            out = model.top_rpn.apply(variables["top_view_rpn"], top, False)
            inside = model.anchor_mask(top[0])
            props = rpn_proposals(out["scores"][0], out["deltas"][0],
                                  model.anchors, inside, config)
            return props, out["score_map"]

        self._rpn = jax.jit(_rpn)

    def __call__(self, top_view):
        top = _batchify_view(top_view)
        props, heatmap = self._rpn(self.variables, top)
        mask = np.asarray(props.mask)
        return (np.asarray(props.rois)[mask], np.asarray(props.scores)[mask],
                np.asarray(heatmap[0]))


class Tester3DOP(MV3D):
    """Fusion head on externally supplied 3D proposals (e.g. 3DOP).

    Parity: reference ``Tester_3DOP`` (mv3d.py:1410-1434) — bypasses the RPN
    and classifies/regresses a given (K, 8, 3) proposal set.
    """

    def __init__(self, cfg: Config = _default_cfg, log_tag: str = "default",
                 checkpoint_dir: str = "checkpoint", load: bool = True, **kw):
        super().__init__(cfg, log_tag=log_tag, checkpoint_dir=checkpoint_dir,
                         **kw)
        if load:
            self.load_weights()

        from ..ops import boxes3d as box3d_ops
        from ..ops.detect import rcnn_nms
        model, config = self.model, self.cfg

        def _fuse(variables, top, rgb, front, rois3d, roi_mask,
                  score_threshold):
            outs, _ = model.extract_features(variables, top, rgb, front,
                                             train=False)
            top_rois = box3d_ops.box3d_to_top_box(rois3d, config)
            feats = {"top": outs["rpn"]["features"][0]}
            if "rgb_features" in outs:
                feats["rgb"] = outs["rgb_features"][0]
            if "front_features" in outs:
                feats["front"] = outs["front_features"][0]
            pooled = model.pool_rois(feats, rois3d, top_rois)
            fuse = model.fusion.apply(variables["fusion"], pooled, False)
            return rcnn_nms(fuse["probs"], fuse["deltas"], rois3d, roi_mask,
                            score_threshold=score_threshold, cfg=config)

        self._fuse = jax.jit(_fuse)

    def __call__(self, top_view, front_view, rgb_image, rois3d,
                 score_threshold: Optional[float] = None):
        if score_threshold is None:
            score_threshold = self.cfg.rcnn.score_threshold
        top = _batchify_view(top_view)
        rgb = jnp.asarray(rgb_image)
        if rgb.ndim == 3:
            rgb = rgb[None]
        front = jnp.asarray(front_view)
        if front.ndim == 3:
            front = front[None]
        rois3d = jnp.asarray(rois3d, jnp.float32)
        mask = jnp.ones(rois3d.shape[0], bool)
        dets = self._fuse(self.variables, top, rgb, front, rois3d, mask,
                          jnp.float32(score_threshold))
        m = np.asarray(dets.mask)
        return np.asarray(dets.probs)[m], np.asarray(dets.boxes3d)[m]
