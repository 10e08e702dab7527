"""One rank of the port's linear and k-means models over a gloo group.

    python torch_models_worker.py RANK WORLD STORE_FILE OUT_NPZ

Joins a gloo group of WORLD processes through a FileStore and trains on
this rank's rows of the seeded data of :func:`make_classif` and
:func:`make_blobs`:

* ``linear_dp/<objective>``: ``linear.train_step_dp`` over the group,
  rows split in contiguous blocks (as ``shard_map`` splits them);
* ``kmeans_dp``: ``kmeans.train_iter_dp`` over the group, likewise;
* ``linear_hook``, ``kmeans_hook``: ``LinearModel`` / ``KMeans`` with
  ``engine_allreduce`` = ``api.allreduce(SUM)`` through ``TorchEngine``
  (which adopts the group), rows split by stride as the rabit-classic
  deployment of tests/test_models.py splits them.

Writes this rank's results to OUT_NPZ.  tests/test_torch_models.py builds
the same inputs and runs the JAX package on them.  :func:`assign_flips`
(the near-tie rule for k-means assignments computed in another sum order)
is shared with tests/test_torch_cuda.py and chip_smoke.py.  Imports torch,
numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api  # noqa: E402
from rabit_tpu_torch.models import kmeans, linear  # noqa: E402

OBJECTIVES = ("logistic", "squared")
DP_STEPS, HOOK_STEPS = 30, 25
DP_ITERS, HOOK_ITERS = 10, 8


def make_classif(n=1600, f=6, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    w = rng.randn(f).astype(np.float32)
    y = (X @ w + 0.3 > 0).astype(np.float32)
    return X, y


def make_blobs(n=1500, f=4, k=5, seed=1):
    rng = np.random.RandomState(seed)
    centers = rng.randn(k, f).astype(np.float32) * 6
    a = rng.randint(0, k, size=n)
    X = centers[a] + rng.randn(n, f).astype(np.float32)
    return X, centers


def assign_flips(X, centers, got, want, c: float | None = None) -> int:
    """Rows where two nearest-centroid assignments differ; raises unless
    each lies within an f32 bound of a tie.  The scores s_j = c_j.c_j -
    2 x.c_j of the two centroids are recomputed in f64.  An f32 dot product
    of F terms errs by at most F 2^-24 of the sum of its terms' magnitudes
    (<= |c.c| + 2 |x| |c| for a score), in any order of summation; two
    orders, each erring on two scores, can swap the argmin only where
    |s_a - s_b| <= c 2^-23 (|c.c| + 2 |x| |c|), with c = 2F (the default)
    and the larger of the two centroids' terms."""
    if c is None:
        c = 2 * np.shape(X)[1]
    X, C = np.asarray(X, np.float64), np.asarray(centers, np.float64)
    got, want = np.asarray(got), np.asarray(want)
    rows = np.nonzero(got != want)[0]
    if rows.size == 0:
        return 0
    x, a, b = X[rows], C[got[rows]], C[want[rows]]
    sa = (a * a).sum(1) - 2 * (x * a).sum(1)
    sb = (b * b).sum(1) - 2 * (x * b).sum(1)
    xn = np.linalg.norm(x, axis=1)
    scale = np.maximum((a * a).sum(1) + 2 * xn * np.linalg.norm(a, axis=1),
                       (b * b).sum(1) + 2 * xn * np.linalg.norm(b, axis=1))
    bound = c * 2.0 ** -23 * scale
    bad = np.abs(sa - sb) > bound
    if bad.any():
        i = int(np.nonzero(bad)[0][0])
        raise AssertionError(
            f"{int(bad.sum())} of {rows.size} differing assignments are not near "
            f"ties: row {rows[i]} scores {sa[i]!r} vs {sb[i]!r}, bound {bound[i]!r}")
    return int(rows.size)


def main(rank, world, store_file, out_npz):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store_file, world), rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    out = {}
    X, y = make_classif()
    rows = slice(rank * len(X) // world, (rank + 1) * len(X) // world)
    Xs, ys = torch.as_tensor(X[rows]), torch.as_tensor(y[rows])
    for objective in OBJECTIVES:
        cfg = linear.LinearConfig(n_features=X.shape[1], objective=objective,
                                  n_steps=DP_STEPS)
        state = linear.init_state(cfg, "cpu")
        for _ in range(cfg.n_steps):
            state = linear.train_step_dp(state, Xs, ys, cfg)
        out[f"linear_dp/{objective}"] = state.w.numpy()
        out[f"linear_dp_step/{objective}"] = state.step.numpy()

    B, _ = make_blobs(n=1600)
    Bs = torch.as_tensor(B[rank * len(B) // world:(rank + 1) * len(B) // world])
    centers = torch.as_tensor(B[:6])
    for _ in range(DP_ITERS):
        centers = kmeans.train_iter_dp(centers, Bs)
    out["kmeans_dp"] = centers.numpy()

    api.init(["rabit_engine=torch", "rabit_torch_device=cpu"])
    try:
        hook = lambda v: api.allreduce(v, api.SUM)
        Xh, yh = make_classif(n=1200)
        out["linear_hook"] = linear.LinearModel(hook, device="cpu", n_steps=HOOK_STEPS).fit(
            Xh[rank::world], yh[rank::world]).w
        Bh, _ = make_blobs(n=1200)
        out["kmeans_hook"] = kmeans.KMeans(4, HOOK_ITERS, engine_allreduce=hook,
                                           device="cpu").fit(Bh[rank::world],
                                                             init_centers=Bh[:4]).centers
    finally:
        api.finalize()
    np.savez(out_npz, **out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
