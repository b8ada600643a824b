"""Batch loader: padding, view preparation, and background prefetch.

One class replaces the reference's four loader generations
(``batch_loading`` / ``BatchLoading2`` / ``BatchLoading3`` / ``KittiLoading``,
src/utils/batch_loading.py — threads, N processes with per-process
``pycuda.autoinit``, pickled Queue IPC). Here the host only reads files and
pads; voxelization happens *on device inside the train/predict step*
(mv3d_tpu.ops.voxelize), so a single prefetch thread keeps the device fed.

``load()`` returns the Trainer batch dict:
  points (B, N, 4), num_points (B,), rgb (B, H, W, 3) f32,
  gt_boxes3d (B, G, 8, 3), gt_labels (B, G), gt_mask (B, G), tags (list).
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..config import Config, cfg as _default_cfg
from .kitti import Frame


def _resize_rgb(rgb: np.ndarray, height: int, width: int) -> np.ndarray:
    if rgb.shape[0] == height and rgb.shape[1] == width:
        return rgb
    from PIL import Image
    img = Image.fromarray(rgb).resize((width, height), Image.BILINEAR)
    return np.asarray(img)


def prepare_rgb(rgb: np.ndarray, cfg: Config) -> np.ndarray:
    """Camera-image crop (didi sky/hood rows, reference config.py:126-140)
    then resize to cfg.rgb_shape."""
    ct, cb = cfg.image_crop_top, cfg.image_crop_bottom
    cl, cr = cfg.image_crop_left, cfg.image_crop_right
    if ct or cb or cl or cr:
        rgb = rgb[ct: rgb.shape[0] - cb if cb else rgb.shape[0],
                  cl: rgb.shape[1] - cr if cr else rgb.shape[1]]
    h, w, _ = cfg.rgb_shape
    return _resize_rgb(rgb, h, w)


def frames_to_batch(frames: Sequence[Frame], cfg: Config = _default_cfg
                    ) -> Dict[str, np.ndarray]:
    """Pad a list of frames into fixed-shape batch arrays."""
    b = len(frames)
    n = cfg.pipeline.max_points
    g = cfg.pipeline.max_gt
    h, w, _ = cfg.rgb_shape

    points = np.empty((b, n, 4), np.float32)
    num_points = np.zeros(b, np.int32)
    rgb = np.zeros((b, h, w, 3), np.float32)
    gt_boxes3d = np.zeros((b, g, 8, 3), np.float32)
    gt_labels = np.zeros((b, g), np.int32)
    gt_mask = np.zeros((b, g), bool)
    tags = []

    from .. import native
    aux = (np.zeros((b, cfg.top.xn, cfg.top.yn, 2), np.float32)
           if cfg.pipeline.host_aux_channels else None)
    for i, f in enumerate(frames):
        # crop on the host (native C++ when available): out-of-bound points
        # never reach the device, so the padded buffer holds more real points
        points[i], k = native.crop_pad(f.points, n, cfg)
        num_points[i] = k
        if aux is not None:
            # intensity/density BEV channels on the host (single C++ pass),
            # overlapped with device compute via this prefetch thread
            aux[i] = native.lidar_to_top_aux(points[i, :k], cfg)
        if f.rgb is not None:
            rgb[i] = prepare_rgb(f.rgb, cfg).astype(np.float32)
        m = min(len(f.gt_boxes3d), g)
        gt_boxes3d[i, :m] = f.gt_boxes3d[:m]
        gt_labels[i, :m] = f.gt_labels[:m]
        gt_mask[i, :m] = True
        tags.append(f.tag)

    out = {"points": points, "num_points": num_points, "rgb": rgb,
           "gt_boxes3d": gt_boxes3d, "gt_labels": gt_labels,
           "gt_mask": gt_mask, "tags": tags}
    if cfg.pipeline.stream_quantized:
        # transfer diet: ship 7 bytes/point instead of 16; the device
        # dequantizes in-graph (_prepare_views / ops.quantize)
        from ..ops.quantize import quantize_points
        out["points_q"], out["refl_q"] = quantize_points(points, cfg)
        del out["points"]
    if aux is not None:
        out["top_aux"] = aux
    return out


class BatchLoader:
    """Shuffling, prefetching batch loader over any dataset with
    ``load_frame(i) -> Frame`` and ``__len__``.

    ``workers`` threads each build WHOLE batches (file reads + crop/pad +
    assembly) in parallel and a ticket sequencer emits them in index order,
    so for a given seed the batch stream is identical to the single-worker
    stream (asserted by tests/test_data.py) while the host side scales with
    threads — numpy/PIL and the native C++ crop all release the GIL. The
    reference scales its loaders with whole OS processes and pickled Queue
    IPC (batch_loading.py:951); batches here stay in shared memory.
    """

    def __init__(self, dataset, cfg: Config = _default_cfg,
                 batch_size: int = 1, shuffle: bool = True,
                 prefetch: int = 4, seed: int = 0, loop: bool = True,
                 workers: int = 1):
        self.dataset = dataset
        self.cfg = cfg
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.loop = loop
        self._rng = np.random.RandomState(seed)
        self._queue: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._finished = False                 # all workers exited cleanly
        self._lock = threading.Lock()          # index stream + tickets
        self._index_iter = self._indices()
        self._next_ticket = 0
        self._emit_cv = threading.Condition()  # ordered emission
        self._emit_ticket = 0
        self._live = max(1, int(workers))
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(self._live)]
        for t in self._threads:
            t.start()

    def _indices(self) -> Iterator[int]:
        while True:
            order = np.arange(len(self.dataset))
            if self.shuffle:
                self._rng.shuffle(order)
            yield from order
            if not self.loop:
                return

    def _take_group(self):
        """Claim the next batch's frame indices + its emission ticket."""
        with self._lock:
            idxs = [i for _, i in zip(range(self.batch_size),
                                      self._index_iter)]
            if len(idxs) < self.batch_size:   # exhausted (non-loop): the
                return None, None             # trailing partial batch drops,
            t = self._next_ticket             # matching the 1-worker path
            self._next_ticket += 1
            return t, idxs

    def _take_replacement(self):
        with self._lock:
            return next(self._index_iter, None)

    def _skip_ticket(self, ticket):
        """Abandon a claimed ticket (stream ran dry mid-batch) so workers
        holding later tickets don't wait on it forever."""
        with self._emit_cv:
            while self._emit_ticket != ticket:
                if self._stop.is_set():
                    return
                self._emit_cv.wait(timeout=0.5)
            self._emit_ticket += 1
            self._emit_cv.notify_all()

    def _put_ordered(self, ticket, batch) -> bool:
        with self._emit_cv:
            while self._emit_ticket != ticket:
                if self._stop.is_set():
                    return False
                self._emit_cv.wait(timeout=0.5)
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue
            self._emit_ticket += 1
            self._emit_cv.notify_all()
            return not self._stop.is_set()

    def _worker(self):
        try:
            while not self._stop.is_set():
                ticket, idxs = self._take_group()
                if ticket is None:
                    return
                frames: List[Frame] = []
                for i in idxs:
                    while i is not None and not self._stop.is_set():
                        try:
                            frames.append(self.dataset.load_frame(int(i)))
                            break
                        except Exception as e:  # damaged frame: skip + pull
                            # a replacement (the reference loaders print
                            # 'GG' and reshuffle, batch_loading.py:681-688)
                            print(f"loader: skipping frame {i}: {e}")
                            i = self._take_replacement()
                if len(frames) < self.batch_size:
                    self._skip_ticket(ticket)   # stream ran dry mid-batch
                    return
                if not self._put_ordered(ticket,
                                         frames_to_batch(frames, self.cfg)):
                    return
        except BaseException as e:  # batch assembly died: surface it in
            self._error = e         # load() instead of a silent None
            with self._emit_cv:     # release peers waiting on our ticket
                self._stop.set()
                self._emit_cv.notify_all()
        finally:
            with self._lock:
                self._live -= 1
                last = self._live == 0
            if last:
                if self._error is None:
                    self._finished = True   # clean exhaustion, not a death
                self._queue.put(None)

    def load(self, timeout: Optional[float] = 60.0):
        """Next batch dict, or None when a non-looping loader is exhausted
        (every call after exhaustion keeps returning None).

        Raises RuntimeError (with the worker's exception chained, if any)
        when the prefetch threads died or produced nothing within
        ``timeout`` — a stall must be loud, not an anonymous queue.Empty
        traceback.
        """
        if self._finished and self._queue.empty():
            return None             # exhausted on a previous call
        try:
            batch = self._queue.get(timeout=timeout)
        except queue.Empty:
            if self._finished:      # all workers already exited cleanly:
                return None         # plain exhaustion, not a stall/death
            alive = any(t.is_alive() for t in self._threads)
            state = (f"stalled (no batch within {timeout}s)" if alive
                     else "died")
            raise RuntimeError(
                f"BatchLoader worker {state}: dataset len "
                f"{len(self.dataset)}, batch_size {self.batch_size}"
            ) from self._error
        if batch is None and self._error is not None:
            raise RuntimeError(
                "BatchLoader worker died while assembling a batch"
            ) from self._error
        return batch

    def get_shape(self):
        """(top_shape, front_shape, rgb_shape) — parity with the reference
        loaders' get_shape (batch_loading.py:616-622)."""
        return self.cfg.top_shape, self.cfg.front_shape, self.cfg.rgb_shape

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
