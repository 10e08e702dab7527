"""Module-level API of the port's engine layer.

The port's own copy of what it needs from ``rabit_tpu/api.py`` (the port
imports nothing of the JAX package): ``init`` / ``finalize``, rank and
world, ``allreduce`` of numpy arrays and torch tensors with the reference's
op enums, ``broadcast`` of any picklable object (length, then payload),
``allgather``, and the versioned checkpoints, pickled as the reference
binding pickles them.  The engine comes from config (``rabit_engine=torch``
for ``engine.torch_dist.TorchEngine``, ``empty`` for the solo engine); a
process that never calls ``init`` runs solo.  Compressed collectives follow
the ``rabit_compress_*`` policy that ``init`` resolves (``compress``): an
allreduce ``codec=`` (or the policy's default codec) and the broadcast
payloads' byte codec.

Not ported (ROADMAP.md Queue 1): the durable checkpoint spill
(``rabit_checkpoint_dir``), elastic ``rebootstrap``, the flight recorder and
metrics (``obs``), the quorum policy and the delivery plane.
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, Callable

import numpy as np
import torch

from rabit_tpu_torch import compress
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine import create_engine
from rabit_tpu_torch.engine.base import BITOR, DTYPE_ENUM, MAX, MIN, SUM, Engine

__all__ = ["MAX", "MIN", "SUM", "BITOR", "init", "finalize", "get_rank",
           "get_world_size", "is_distributed", "tracker_print", "allreduce",
           "broadcast", "allgather", "checkpoint", "lazy_checkpoint",
           "load_checkpoint", "version_number", "get_engine"]

_engine: Engine | None = None


def get_engine() -> Engine:
    """The active engine; a process that was never initialized gets a solo
    engine, which a later ``init`` replaces."""
    global _engine
    if _engine is None:
        from rabit_tpu_torch.engine.empty import SoloEngine

        _engine = SoloEngine(Config([]))
        _engine._provisional = True
    return _engine


def init(args: list[str] | None = None, **overrides: Any) -> None:
    """Start the engine.  ``args`` are ``"key=value"`` strings (default: the
    ones in ``sys.argv[1:]``; of a key given twice the last wins); keyword
    overrides win over them."""
    global _engine
    if _engine is not None:
        if not getattr(_engine, "_provisional", False):
            import warnings

            warnings.warn("rabit_tpu_torch.api.init ignored: already initialized",
                          stacklevel=2)
            return
        _engine = None
    if args is None:
        args = [a for a in sys.argv[1:] if "=" in a]
    config = Config(args, {k: str(v) for k, v in overrides.items()})
    compress.configure(config)  # a bad policy fails before the engine starts
    engine = create_engine(config)
    engine.init()
    _engine = engine


def finalize() -> None:
    """Shut the engine down; the process runs solo after it."""
    global _engine
    if _engine is not None:
        _engine.shutdown()
        _engine = None
    compress.reset()


def get_rank() -> int:
    return get_engine().get_rank()


def get_world_size() -> int:
    return get_engine().get_world_size()


def is_distributed() -> bool:
    return get_engine().is_distributed()


def tracker_print(msg: str) -> None:
    get_engine().tracker_print(msg if isinstance(msg, str) else str(msg))


def allreduce(data, op: int,
              prepare_fun: Callable[[np.ndarray], None] | None = None,
              codec: str | None = None):
    """Allreduce a numpy array or a torch tensor (returned as a tensor of
    its dtype on its device); ``op`` is one of MAX, MIN, SUM, BITOR.
    ``prepare_fun(data)`` (numpy only) fills ``data`` right before the
    reduction.

    ``codec`` selects a wire codec (``compress``) for this call: the
    payload crosses the engine encoded and every rank decodes and folds
    identically, trading the codec's documented error bound for wire
    bytes.  ``None`` applies the ``rabit_compress_allreduce`` policy
    (float32, non-BITOR payloads of at least ``rabit_compress_min_bytes``);
    ``"identity"`` forces the exact path.  On the compressed path
    ``prepare_fun`` runs eagerly: its output feeds the encoder."""
    if isinstance(data, torch.Tensor):
        if prepare_fun is not None:
            raise TypeError("prepare_fun takes numpy arrays only")
        out = allreduce(data.detach().cpu().numpy(), op, codec=codec)
        return torch.as_tensor(out, device=data.device)
    if not isinstance(data, np.ndarray):
        raise TypeError("allreduce takes numpy arrays and torch tensors")
    if data.dtype not in DTYPE_ENUM:
        raise TypeError(f"dtype {data.dtype} not supported")
    if op not in (MAX, MIN, SUM, BITOR):
        raise ValueError(f"unknown reduction op {op}")
    buf = data.flatten()  # a fresh 1-D copy
    prep = None
    if prepare_fun is not None:
        def prep(view: np.ndarray) -> None:
            prepare_fun(data)
            view[...] = np.ascontiguousarray(data).reshape(-1)
    c = compress.resolve(codec, buf.dtype, op, buf.nbytes)
    engine = get_engine()
    if c is None:
        out = engine.allreduce(buf, op, prepare_fun=prep)
    else:
        out = engine.allreduce_compressed(buf, op, c, prepare_fun=prep)
    return np.asarray(out).reshape(data.shape)


def broadcast(data: Any, root: int) -> Any:
    """Broadcast any picklable object from ``root``.

    With ``rabit_compress_broadcast`` configured (e.g. ``zlib``), the
    pickled payload crosses the wire compressed behind a one-byte codec
    frame; payloads under ``rabit_compress_min_bytes`` ride as identity.
    The policy comes from the shared job config, so every rank frames and
    deframes symmetrically."""
    engine = get_engine()
    pol = compress.policy()
    bcodec = compress.get_codec(pol.broadcast) if pol.broadcast else None
    payload = None
    if engine.get_rank() == root:
        if data is None:
            raise ValueError("need to pass in data when broadcasting")
        payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL)
        if bcodec is not None:
            if len(payload) >= pol.min_bytes:
                wire = bcodec.encode_bytes(payload)
                compress.observe(engine, bcodec.name, raw=len(payload), wire=len(wire))
                payload = bytes([bcodec.codec_id]) + wire
            else:
                payload = bytes([0]) + payload  # identity frame
    out = engine.broadcast(payload, root)
    if engine.get_rank() == root:
        return data
    if bcodec is not None:
        out = bytes(out)
        out = compress.get_codec_by_id(out[0]).decode_bytes(out[1:])
    return pickle.loads(out)


def allgather(data: np.ndarray) -> np.ndarray:
    """This rank's array from every rank: shape ``(world,) + data.shape``."""
    if not isinstance(data, np.ndarray):
        raise TypeError("allgather takes numpy arrays")
    engine = get_engine()
    out = engine.allgather(np.ascontiguousarray(data).reshape(-1))
    return np.asarray(out).reshape((engine.get_world_size(),) + data.shape)


def checkpoint(global_model: Any, local_model: Any = None) -> None:
    """Commit an iteration: pickle and store the models, bump the version."""
    dump = lambda m: pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)
    get_engine().checkpoint(dump(global_model),
                            None if local_model is None else dump(local_model))


def lazy_checkpoint(global_model: Any) -> None:
    """Checkpoint whose pickling waits until a load asks for it:
    ``global_model`` must stay unchanged until the next checkpoint."""
    get_engine().lazy_checkpoint(
        lambda: pickle.dumps(global_model, protocol=pickle.HIGHEST_PROTOCOL))


def load_checkpoint(with_local: bool = False):
    """``(version, global_model)`` or, ``with_local``, ``(version,
    global_model, local_model)``; version 0 means nothing checkpointed."""
    version, gblob, lblob = get_engine().load_checkpoint()
    gmodel = pickle.loads(gblob) if version > 0 and gblob is not None else None
    if not with_local:
        return version, gmodel
    return version, gmodel, (pickle.loads(lblob) if version > 0 and lblob is not None
                             else None)


def version_number() -> int:
    return get_engine().version_number()
