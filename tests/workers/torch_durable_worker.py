"""One rank of a linear-model job through the port's api with the durable
checkpoint spill (rabit_checkpoint_dir).

    python torch_durable_worker.py RANK WORLD STORE_FILE OUT_NPZ CKPT_DIR \\
        [niter=N] [stop_at=K] [local=1]

WORLD > 1 joins a gloo group of WORLD processes through the FileStore
STORE_FILE, which ``TorchEngine`` adopts; WORLD 1 runs on the solo engine.
:func:`job` fits ``models.linear`` on this rank's rows (``elastic``'s dense
partition) with one ``api.allreduce`` of the [F+2] gradient vector and one
``api.checkpoint`` per step, checking every resumed model: the history of
versions, the step, and (``local=1``) the rank-local model, which a rank
whose disk copy was missing rebuilds (``rebuilt``).  ``stop_at=K`` stops the
whole job cleanly right after checkpoint K.  Writes ``w`` (the final
weights), ``resumed_from``, ``version``, ``stopped`` and ``rebuilt`` to
OUT_NPZ.  chip_smoke.py runs :func:`job` on the card at the headline size.
Imports torch, numpy and the port only.
"""

import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from rabit_tpu_torch import api, elastic  # noqa: E402
from rabit_tpu_torch.models import linear  # noqa: E402


class CheckFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise CheckFailed(f"[rank {api.get_rank()}] check failed: {msg}")


def data(n: int = 400, f: int = 5, seed: int = 3):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, f).astype(np.float32)
    y = (X @ rng.randn(f).astype(np.float32) > 0).astype(np.float32)
    return X, y


def job(X, y, niter: int, stop_at: int = 0, local: bool = False,
        device="cpu") -> dict:
    """The job on the engine ``api.init`` started; returns its results."""
    rank, world = api.get_rank(), api.get_world_size()
    rows = elastic.shard_slice(len(X), world, rank)
    Xs = torch.as_tensor(X[rows], device=device)
    ys = torch.as_tensor(y[rows], device=device)
    cfg = linear.LinearConfig(n_features=X.shape[1], n_steps=niter)
    version, model, lmodel = api.load_checkpoint(with_local=True)
    rebuilt = 0
    if version == 0:
        state, history = linear.init_state(cfg, device), []
    else:
        history = model["history"]
        check(history == list(range(1, version + 1)), f"history {history} at v{version}")
        check(model["step"] == version, f"step {model['step']} at v{version}")
        state = linear.state_from_numpy(model["w"], model["step"], device)
        if local:
            if lmodel is None:  # its disk copy was lost: rebuild it
                rebuilt = 1
            else:
                check(lmodel == {"rank": rank, "iter": version}, f"local model {lmodel}")
    stopped = 0
    for it in range(version, niter):
        g = linear.local_grad(state.w, Xs, ys, cfg).cpu().numpy()
        state = linear.apply_grad(
            state, torch.as_tensor(api.allreduce(g, api.SUM), device=device), cfg)
        history.append(it + 1)
        api.checkpoint({"w": state.w.cpu().numpy(), "step": it + 1, "history": history},
                       {"rank": rank, "iter": it + 1} if local else None)
        check(api.version_number() == it + 1, f"version {api.version_number()} after {it + 1}")
        if stop_at == it + 1:
            stopped = 1
            break
    return {"w": state.w.cpu().numpy(), "resumed_from": version,
            "version": api.version_number(), "stopped": stopped, "rebuilt": rebuilt}


def main(rank, world, store_file, out_npz, ckpt_dir, *args):
    torch.set_num_threads(1)
    kw = dict(a.split("=", 1) for a in args)
    engine = ["rabit_engine=empty"]
    if world > 1:
        dist.init_process_group("gloo", store=dist.FileStore(store_file, world),
                                rank=rank, world_size=world,
                                timeout=timedelta(seconds=60))
        engine = ["rabit_engine=torch", "rabit_torch_device=cpu"]
    api.init(engine + [f"rabit_checkpoint_dir={ckpt_dir}"])
    try:
        X, y = data()
        out = job(X, y, int(kw.get("niter", 6)), int(kw.get("stop_at", 0)),
                  kw.get("local", "0") == "1")
    finally:
        api.finalize()
        if world > 1:
            dist.destroy_process_group()
    np.savez(out_npz, **out)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:])
