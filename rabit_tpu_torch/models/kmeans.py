"""Distributed k-means (Lloyd's algorithm): each worker assigns its row
shard to the nearest centroid and one Allreduce(SUM) of the [K, F+1]
(cluster sums ++ counts) statistics matrix per iteration re-estimates the
centroids.

The port's counterpart of ``rabit_tpu/models/kmeans.py``.  Assignment is
one ``X @ C.T`` product plus a row argmin; the per-cluster sums use the
port's ``ops.hist.segment_sum`` (the f64 one-hot product on CUDA, the
row-order scatter on the CPU, as JAX's is on the CPU); the combine hook is
the only communication point (``parallel.collectives.allreduce`` over a
process group, or the engine's host allreduce in the rabit-classic
deployment).  Entry points run on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from rabit_tpu_torch.models.gbdt import _device
from rabit_tpu_torch.ops import hist
from rabit_tpu_torch.parallel import collectives


class KMeansConfig(NamedTuple):
    n_clusters: int
    n_iters: int = 20


def assign(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Nearest-centroid ids, [n] int32.  argmin ||x - c||^2 = argmin
    c.c - 2 x.c (the x.x term is constant per row): one product, no
    pairwise distance tensor; the first of equal scores wins."""
    cc = (centers * centers).sum(1)               # [K]
    scores = cc[None, :] - 2.0 * (X @ centers.T)  # [n, K]
    return scores.argmin(1).to(torch.int32)


def local_stats(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Per-shard [K, F + 1] matrix: per-cluster feature sums ++ counts."""
    a = assign(X, centers)
    vals = torch.cat([X, X.new_ones((X.shape[0], 1))], 1)  # [n, F+1]
    return hist.segment_sum(vals, a, centers.shape[0])


def update(centers: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """New centroids from summed stats; empty clusters keep their centroid."""
    counts = stats[:, -1:]
    return torch.where(counts > 0, stats[:, :-1] / counts.clamp_min(1.0), centers)


def train_iter(centers: torch.Tensor, X: torch.Tensor,
               combine: Callable[[torch.Tensor], torch.Tensor] = lambda x: x
               ) -> torch.Tensor:
    return update(centers, combine(local_stats(X, centers)))


def train_iter_dp(centers: torch.Tensor, X: torch.Tensor, group=None) -> torch.Tensor:
    """train_iter with this rank's rows, the stats summed over ``group``
    (None: the default group)."""
    return train_iter(centers, X, combine=lambda v: collectives.allreduce(v, group))


def inertia(X: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    d = X - centers[assign(X, centers).long()]
    return (d * d).sum()


class KMeans:
    """Numpy-in trainer; ``engine_allreduce`` switches on the rabit-classic
    multi-process deployment (only the [K, F+1] stats matrix crosses the
    engine each iteration)."""

    def __init__(self, n_clusters: int, n_iters: int = 20,
                 engine_allreduce: Callable[[np.ndarray], np.ndarray] | None = None,
                 seed: int = 0, device="cuda"):
        self.cfg = KMeansConfig(n_clusters=n_clusters, n_iters=n_iters)
        self._engine_allreduce = engine_allreduce
        self._seed = seed
        self._device = device
        self.centers: np.ndarray | None = None

    def fit(self, X: np.ndarray, init_centers: np.ndarray | None = None,
            start_iter: int = 0):
        dev = _device(self._device)
        X = np.asarray(X, np.float32)
        if init_centers is None:
            if self._engine_allreduce is not None:
                # Workers hold different shards: seeding from the local shard
                # would give every worker different centers and the summed
                # stats would be incoherent.  Agree on an init first
                # (e.g. rabit_tpu_torch.api.broadcast rank 0's choice).
                raise ValueError(
                    "distributed KMeans needs an agreed init_centers "
                    "(broadcast one from rank 0)"
                )
            rng = np.random.RandomState(self._seed)
            init_centers = X[rng.choice(X.shape[0], self.cfg.n_clusters, replace=False)]
        centers = torch.as_tensor(np.asarray(init_centers, np.float32), device=dev)
        X = torch.as_tensor(X, device=dev)
        for _ in range(start_iter, self.cfg.n_iters):
            if self._engine_allreduce is None:
                centers = train_iter(centers, X)
            else:
                s = np.asarray(self._engine_allreduce(local_stats(X, centers).cpu().numpy()),
                               np.float32)
                centers = update(centers, torch.as_tensor(s, device=dev))
        self.centers = centers.cpu().numpy()
        return self

    def _on_device(self, X: np.ndarray):
        dev = _device(self._device)
        return (torch.as_tensor(np.asarray(X, np.float32), device=dev),
                torch.as_tensor(self.centers, device=dev))

    def predict(self, X: np.ndarray) -> np.ndarray:
        return assign(*self._on_device(X)).cpu().numpy()

    def inertia(self, X: np.ndarray) -> float:
        return float(inertia(*self._on_device(X)))
