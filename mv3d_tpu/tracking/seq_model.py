"""Sequence-model motion tracker (GRU over box trajectories).

JAX counterpart of the reference's LSTM tracker prototype
(src/tracker.py, experiments/archive/exp_seq_001_top_lstm): a small recurrent
model over per-frame box translations that predicts the next-frame position,
usable as a learned alternative to the UKF for tracklet smoothing/prediction.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..models.layers import Module, Scope, dense, orthogonal, zeros


@dataclass(frozen=True)
class MotionGRU(Module):
    """GRU over (dx, dy, dz) displacement sequences -> next displacement."""
    hidden: int = 64

    def forward(self, s: Scope, deltas: jnp.ndarray) -> jnp.ndarray:
        """(B, T, 3) past displacements -> (B, T, 3) predicted next ones."""
        c = s.child(None, "GRUCell")
        f, dt = self.hidden, jnp.float32
        # input projections of every step at once (with biases) ...
        xr, xz, xn = (dense(c, deltas, f, dtype=dt, name=n)
                      for n in ("ir", "iz", "in"))
        # ... and the hidden-to-hidden kernels (only "hn" has a bias)
        hid = {n: c.child(n, "Dense") for n in ("hr", "hz", "hn")}
        w = {n: sc.param("kernel", orthogonal, (f, f))
             for n, sc in hid.items()}
        b_hn = hid["hn"].param("bias", zeros, (f,))

        def step(h, x):
            r_i, z_i, n_i = x
            r = jax.nn.sigmoid(r_i + h @ w["hr"])
            z = jax.nn.sigmoid(z_i + h @ w["hz"])
            n = jnp.tanh(n_i + r * (h @ w["hn"] + b_hn))
            h = (1.0 - z) * n + z * h
            return h, h

        h0 = jnp.zeros((deltas.shape[0], f), dt)
        xs = tuple(jnp.swapaxes(v, 0, 1) for v in (xr, xz, xn))
        _, hs = jax.lax.scan(step, h0, xs)
        return dense(s, jnp.swapaxes(hs, 0, 1), 3, dtype=dt)   # (B, T, 3)


class SeqMotionTracker:
    """Train/predict wrapper: learns object motion from trajectories and
    predicts the next position (teacher-forced next-step objective)."""

    def __init__(self, hidden: int = 64, lr: float = 1e-2, seed: int = 0):
        self.model = MotionGRU(hidden=hidden)
        self.params = self.model.init(
            jax.random.PRNGKey(seed), jnp.zeros((1, 4, 3)))
        self.opt = optax.adam(lr)
        self.opt_state = self.opt.init(self.params)

        def loss_fn(params, deltas_in, deltas_target):
            pred = self.model.apply(params, deltas_in)
            return jnp.mean((pred - deltas_target) ** 2)

        @jax.jit
        def train_step(params, opt_state, deltas_in, deltas_target):
            loss, grads = jax.value_and_grad(loss_fn)(params, deltas_in,
                                                      deltas_target)
            updates, opt_state = self.opt.update(grads, opt_state)
            return optax.apply_updates(params, updates), opt_state, loss

        self._train_step = train_step
        self._predict = jax.jit(lambda p, d: self.model.apply(p, d))

    @staticmethod
    def _to_deltas(tracks: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T, 3) positions -> (inputs (B, T-2, 3), targets (B, T-2, 3))."""
        d = np.diff(tracks, axis=1)
        return d[:, :-1], d[:, 1:]

    def fit(self, tracks: np.ndarray, steps: int = 200) -> float:
        """Train on (B, T, 3) position trajectories; returns final loss."""
        din, dtg = self._to_deltas(np.asarray(tracks, np.float32))
        loss = None
        for _ in range(steps):
            self.params, self.opt_state, loss = self._train_step(
                self.params, self.opt_state, jnp.asarray(din),
                jnp.asarray(dtg))
        return float(loss)

    def predict_next(self, history: np.ndarray) -> np.ndarray:
        """(B, T, 3) past positions -> (B, 3) predicted next positions."""
        history = np.asarray(history, np.float32)
        d = np.diff(history, axis=1)
        pred = np.asarray(self._predict(self.params, jnp.asarray(d)))
        return history[:, -1] + pred[:, -1]
