"""Distributed linear models (logistic / squared loss): each worker holds a
row shard, computes the local gradient on its device, and one
Allreduce(SUM) per step combines them.

The port's counterpart of ``rabit_tpu/models/linear.py``.  The local
gradient is one ``X.T @ residual`` product, and the combine hook is the
only communication point: ``parallel.collectives.allreduce`` over a
process group (where JAX takes ``lax.psum`` over an axis), or the engine's
host allreduce in the rabit-classic multi-process deployment.  Entry
points run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from rabit_tpu_torch.models.gbdt import _device
from rabit_tpu_torch.parallel import collectives


class LinearConfig(NamedTuple):
    n_features: int
    objective: str = "logistic"  # "logistic" | "squared"
    learning_rate: float = 0.5
    reg_lambda: float = 1e-3
    n_steps: int = 50


class LinearState(NamedTuple):
    w: torch.Tensor     # [F + 1] f32 weights, bias last
    step: torch.Tensor  # int32 scalar


def init_state(cfg: LinearConfig, device="cuda") -> LinearState:
    dev = _device(device)
    return LinearState(w=torch.zeros(cfg.n_features + 1, device=dev),
                       step=torch.zeros((), dtype=torch.int32, device=dev))


def state_from_numpy(w, step, device="cuda") -> LinearState:
    """A state from numpy parameters (a JAX ``LinearState``'s ``w`` and
    ``step``, or a checkpoint's)."""
    dev = _device(device)
    return LinearState(w=torch.tensor(np.asarray(w, np.float32), device=dev),
                       step=torch.tensor(int(step), dtype=torch.int32, device=dev))


def _margin(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X @ w[:-1] + w[-1]


def local_grad(w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
               cfg: LinearConfig) -> torch.Tensor:
    """Per-shard [F + 2] vector: gradient (bias included) ++ shard row
    count.  Summing it across workers gives the global gradient and count
    in ONE allreduce."""
    m = _margin(w, X)
    if cfg.objective == "logistic":
        r = torch.sigmoid(m) - y
    elif cfg.objective == "squared":
        r = m - y
    else:
        raise ValueError(f"unknown objective {cfg.objective}")
    n = torch.full((1,), X.shape[0], dtype=torch.float32, device=X.device)
    return torch.cat([X.T @ r, r.sum()[None], n])


def apply_grad(state: LinearState, gsum: torch.Tensor,
               cfg: LinearConfig) -> LinearState:
    g = gsum[:-1] / gsum[-1]
    # no penalty on the bias
    g = torch.cat([g[:-1] + cfg.reg_lambda * state.w[:-1], g[-1:]])
    return LinearState(w=state.w - cfg.learning_rate * g, step=state.step + 1)


def train_step(state: LinearState, X: torch.Tensor, y: torch.Tensor,
               cfg: LinearConfig,
               combine: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
               ) -> LinearState:
    """One full-batch GD step; ``combine`` is the allreduce hook."""
    return apply_grad(state, combine(local_grad(state.w, X, y, cfg)), cfg)


def train_step_dp(state: LinearState, X: torch.Tensor, y: torch.Tensor,
                  cfg: LinearConfig, group=None) -> LinearState:
    """train_step with this rank's rows, the gradient summed over
    ``group`` (None: the default group)."""
    return train_step(state, X, y, cfg,
                      combine=lambda v: collectives.allreduce(v, group))


def predict_margin(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return _margin(w, X)


class LinearModel:
    """Numpy-in trainer.  ``engine_allreduce`` (host [k] f32 -> [k] f32 sum)
    switches on the rabit-classic deployment: each process trains on its
    shard and only the [F+2] gradient vector crosses the engine."""

    def __init__(self, engine_allreduce: Callable[[np.ndarray], np.ndarray] | None = None,
                 device="cuda", **hyper):
        self._hyper = hyper
        self._engine_allreduce = engine_allreduce
        self._device = device
        self.cfg: LinearConfig | None = None
        self.w: np.ndarray | None = None

    def fit(self, X: np.ndarray, y: np.ndarray,
            start: LinearState | None = None, start_step: int = 0):
        dev = _device(self._device)
        X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        y = torch.as_tensor(np.asarray(y, np.float32), device=dev)
        self.cfg = LinearConfig(n_features=int(X.shape[1]), **self._hyper)
        state = (init_state(self.cfg, dev) if start is None
                 else LinearState(start.w.to(dev), start.step.to(dev)))
        for _ in range(start_step, self.cfg.n_steps):
            if self._engine_allreduce is None:
                state = train_step(state, X, y, self.cfg)
            else:
                g = local_grad(state.w, X, y, self.cfg).cpu().numpy()
                gsum = np.asarray(self._engine_allreduce(g), np.float32)
                state = apply_grad(state, torch.as_tensor(gsum, device=dev), self.cfg)
        self.state = state
        self.w = state.w.cpu().numpy()
        return self

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        dev = _device(self._device)
        X = torch.as_tensor(np.asarray(X, np.float32), device=dev)
        return predict_margin(torch.as_tensor(self.w, device=dev), X).cpu().numpy()

    def predict(self, X: np.ndarray) -> np.ndarray:
        m = self.predict_margin(X)
        if self.cfg.objective == "logistic":
            return (m > 0).astype(np.int32)
        return m
