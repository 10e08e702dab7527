"""Module-level API of the port's engine layer.

The port's own copy of what it needs from ``rabit_tpu/api.py`` (the port
imports nothing of the JAX package): ``init`` / ``finalize``, rank, world
and processor name, ``allreduce`` of numpy arrays and torch tensors with
the reference's op enums, ``broadcast`` of any picklable object (length,
then payload), ``allgather``, and the versioned checkpoints, pickled as the
reference binding pickles them.  The engine comes from config
(``engine.create_engine``: ``rabit_engine=native|robust|base|mock`` for
rabit's fault-tolerant C++ engine under a tracker, ``torch`` for
``engine.torch_dist.TorchEngine``, ``empty`` for the solo engine; ``auto``
picks the native engine when a tracker is set); a process that never calls
``init`` runs solo.

Every user collective carries a cache key that names its call site
(``_caller_key``: file, line and function of the caller, the same on every
rank and in every life of a worker), which the robust engine uses to replay
a restarted worker's collectives from before ``load_checkpoint`` out of its
bootstrap cache (``rabit_bootstrap_cache=1``).  Compressed collectives
follow the ``rabit_compress_*`` policy that ``init`` resolves
(``compress``): an allreduce ``codec=`` (or the policy's default codec)
and the broadcast payloads' byte codec.

With ``rabit_checkpoint_dir`` set, every committed checkpoint is also
spilled to disk (``store.CheckpointStore``, after the commit barrier,
stamped with the adopted world epoch), and a fresh job, whose engine holds
version 0, resumes from the newest version every rank can serve
(``_disk_resume``).  ``rebootstrap`` re-enters the tracker after a change
of the world (``NativeEngine.rebootstrap``, ``TorchEngine.rebuild``) and
adopts the next world epoch (``world_epoch``), running the callbacks of
``register_rebalance``.

Observability (``obs``): ``init`` configures the flight recorder, the hang
watchdog, lease renewal and snapshot shipping from the same config; every
public collective runs inside ``obs.collective`` (``op_begin``/``op_end``
stamped with the cross-rank ``(version, seqno)``, timed into the metrics
registry); ``finalize`` ships the last snapshot to the tracker before the
engine's shutdown and, with ``rabit_trace_exit=1``, dumps the ring after
it.  The api's own events go through the engine's ``obs_event`` hook,
which records them tagged with the engine's class.

``init`` also resolves the quorum policy (``quorum.resolve``: a typo'd
``rabit_quorum`` fails before any engine starts) and records it as a
``quorum_policy`` event; the engines' own collectives stay exact, since
quorum rounds belong to the tracker and ``elastic.ElasticWorker``.

The delivery plane (``delivery``): with ``rabit_delivery_publish=1`` and a
tracker, rank 0 publishes every committed checkpoint (``_publish_commit``,
after the store's save) as a content-addressed snapshot, pins the
published version in the store and records ``snapshot_published``.
Publishing is best-effort: a delivery outage never fails a commit.
"""

from __future__ import annotations

import pickle
import sys
from typing import Any, Callable

import numpy as np

from rabit_tpu_torch import compress, obs, quorum
from rabit_tpu_torch.config import Config
from rabit_tpu_torch.engine import create_engine
from rabit_tpu_torch.engine.base import BITOR, DTYPE_ENUM, MAX, MIN, SUM, Engine

__all__ = ["MAX", "MIN", "SUM", "BITOR", "init", "finalize", "get_rank",
           "get_world_size", "is_distributed", "tracker_print", "get_processor_name",
           "allreduce", "broadcast", "allgather", "checkpoint", "lazy_checkpoint",
           "load_checkpoint", "version_number", "get_engine", "world_epoch",
           "register_rebalance", "unregister_rebalance", "notify_world_change",
           "rebootstrap", "collective_stats", "reset_collective_stats"]

_engine: Engine | None = None
# Durable-spill state (rabit_checkpoint_dir): the store, and the user-visible
# version base when this job resumed a previous job's disk checkpoints.  The
# base also travels inside every wrapped global blob (_wrap/_unwrap), so a
# restarted worker recovers it from the peer-served blob rather than from
# process memory.
_ckpt_store = None
_ckpt_base = 0
# The world epoch this process last adopted, and the callbacks run when it
# adopts another (register_rebalance).
_world_epoch = {"epoch": 0, "world_size": 1}
# The delivery plane's publisher (rank 0 with rabit_delivery_publish=1).
_publisher = None
_rebalance_cbs: list[Callable[[dict, dict], None]] = []

_WRAP_TAG = "__rabit_tpu_ckpt1__"


def _wrap(base: int, gblob: bytes) -> bytes:
    return pickle.dumps((_WRAP_TAG, base, gblob), protocol=pickle.HIGHEST_PROTOCOL)


def _unwrap(blob: bytes) -> tuple[int, bytes]:
    """Returns (base, inner_blob); plain blobs (store off) pass through."""
    try:
        obj = pickle.loads(blob)
    except Exception:  # noqa: BLE001 (not a pickle we wrote)
        return 0, blob
    if isinstance(obj, tuple) and len(obj) == 3 and obj[0] == _WRAP_TAG:
        return int(obj[1]), obj[2]
    return 0, blob


def _caller_key(depth: int = 2) -> str:
    """The cache key of a collective: file, line and function of the frame
    ``depth`` levels up (the user's call site)."""
    frame = sys._getframe(depth)
    return f"{frame.f_code.co_filename}::{frame.f_lineno}::{frame.f_code.co_name}"


def collective_stats():
    """This process's accumulated per-collective timing
    (``profile.GLOBAL_STATS``, over the process metrics registry)."""
    from rabit_tpu_torch.profile import GLOBAL_STATS

    return GLOBAL_STATS


def reset_collective_stats() -> None:
    collective_stats().reset()


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
    global _engine, _ckpt_store, _ckpt_base, _world_epoch, _publisher
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
    pol = compress.configure(config)  # a bad policy fails before the engine starts
    qpol = quorum.resolve(config)  # so does a typo'd rabit_quorum
    engine = create_engine(config)
    engine.init()
    _engine = engine
    obs.configure(config, rank=engine.get_rank())
    # The resolved policy is recorded so a cross-rank config skew shows in
    # the dumps.
    obs.record_event("compress_policy", allreduce=pol.allreduce or "identity",
                     min_bytes=pol.min_bytes, wire_deflate=pol.wire_deflate,
                     broadcast=pol.broadcast or "identity",
                     checkpoint=pol.checkpoint or "identity",
                     fused=compress.fused_setting(config),
                     fused_chunk_kib=config.get_int("rabit_fused_chunk_kib", 256))
    if qpol["quorum"]:
        obs.record_event("quorum_policy", quorum=qpol["quorum"], wait_sec=qpol["wait_sec"],
                         flag_after=qpol["flag_after"])
    obs.record_event("engine_ready", engine=type(engine).__name__,
                     rank=engine.get_rank(), world=engine.get_world_size())
    _ckpt_base = 0
    _world_epoch = {"epoch": 0, "world_size": engine.get_world_size()}
    ckpt_dir = config.get("rabit_checkpoint_dir", "") or ""
    if ckpt_dir and ckpt_dir != "NULL":
        from rabit_tpu_torch.store import CheckpointStore

        _ckpt_store = CheckpointStore(ckpt_dir, engine.get_rank(), codec=pol.checkpoint,
                                      keep=config.get_int("rabit_checkpoint_keep", 2),
                                      engine=engine)
    else:
        _ckpt_store = None
    # Only the committing rank 0 publishes: every rank holds the same global
    # blob, and N publishes of it would be N redundant registrations.
    _publisher = None
    uri = config.get("rabit_tracker_uri", "NULL") or "NULL"
    if config.get_bool("rabit_delivery_publish") and uri != "NULL" and engine.get_rank() == 0:
        from rabit_tpu_torch.delivery import Publisher
        from rabit_tpu_torch.tracker.protocol import parse_addrs

        _publisher = Publisher(uri, config.get_int("rabit_tracker_port", 9091),
                               job=config.get("rabit_job_key", "") or "",
                               task_id=f"pub-{config.get('rabit_task_id', '0')}",
                               addrs=parse_addrs(config.get("rabit_tracker_addrs", "") or ""))


def finalize() -> None:
    """Shut the engine down; the process runs solo after it.  The final
    metrics snapshot goes to the tracker first, while it still serves."""
    global _engine, _ckpt_store, _ckpt_base, _world_epoch, _publisher
    if _engine is not None:
        obs.ship_final_snapshot()
        obs.record_event("engine_finalize", engine=type(_engine).__name__)
        _engine.shutdown()
        _engine = None
        obs.dump_final()  # rabit_trace_exit=1: this life's ring as a -exit dump
    compress.reset()
    _ckpt_store = None
    _ckpt_base = 0
    _world_epoch = {"epoch": 0, "world_size": 1}
    _publisher = None


def world_epoch() -> dict:
    """The world epoch this process last adopted: ``{"epoch",
    "world_size"}``; epoch 0 and the engine's world until ``rebootstrap``
    or ``notify_world_change`` adopts another."""
    return dict(_world_epoch)


def register_rebalance(callback: Callable[[dict, dict], None]) -> None:
    """Run ``callback(old, new)`` (``world_epoch()``-shaped dicts) whenever
    this process adopts a new world epoch, e.g. to re-cut a data shard
    with ``models.gbdt.elastic_shard``.  Registering twice registers once;
    callbacks should be idempotent, and their exceptions reach the
    notifier."""
    if callback not in _rebalance_cbs:
        _rebalance_cbs.append(callback)


def unregister_rebalance(callback: Callable[[dict, dict], None]) -> None:
    if callback in _rebalance_cbs:
        _rebalance_cbs.remove(callback)


def notify_world_change(epoch: int, world_size: int) -> None:
    """Adopt a new world epoch: record it (the durable spill stamps its
    frames from here), report ``epoch_changed`` (and ``shard_rebalanced``
    when callbacks ran) to the engine's event hook, and run the rebalance
    callbacks.  The same epoch and world again is a no-op."""
    global _world_epoch
    old = dict(_world_epoch)
    if epoch == old["epoch"] and world_size == old["world_size"]:
        return
    _world_epoch = {"epoch": int(epoch), "world_size": int(world_size)}
    engine = get_engine()
    engine.obs_event("epoch_changed", epoch=int(epoch), world=int(world_size),
                     prev_world=old["world_size"])
    for cb in list(_rebalance_cbs):
        cb(old, dict(_world_epoch))
    if _rebalance_cbs:
        engine.obs_event("shard_rebalanced", epoch=int(epoch), callbacks=len(_rebalance_cbs))


def rebootstrap() -> dict:
    """Re-enter the tracker after a change of the world and adopt the next
    epoch: the native engine finalizes and checks in again (a fresh
    assignment, perhaps another world), ``TorchEngine`` re-reads its
    process group (``rebuild``), the solo engine only moves the epoch.
    Returns the new ``world_epoch()``."""
    engine = get_engine()
    if hasattr(engine, "rebootstrap"):
        engine.rebootstrap()
    elif hasattr(engine, "rebuild"):
        engine.rebuild()
    notify_world_change(_world_epoch["epoch"] + 1, engine.get_world_size())
    return world_epoch()


def get_rank() -> int:
    return get_engine().get_rank()


def get_world_size() -> int:
    return get_engine().get_world_size()


def is_distributed() -> bool:
    return get_engine().is_distributed()


def tracker_print(msg: str) -> None:
    get_engine().tracker_print(msg if isinstance(msg, str) else str(msg))


def get_processor_name() -> str:
    return get_engine().get_host()


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
    ``prepare_fun`` runs eagerly: its output feeds the encoder.

    The ``obs.collective`` window of a tensor is the whole call, its
    staging through the host included, and counts the tensor's bytes."""
    key = _caller_key()
    torch = sys.modules.get("torch")  # a tensor's caller has imported it
    if torch is not None and isinstance(data, torch.Tensor):
        if prepare_fun is not None:
            raise TypeError("prepare_fun takes numpy arrays only")
        nbytes = data.numel() * data.element_size()
        c = _resolve(np.dtype(str(data.dtype).removeprefix("torch.")), op, codec, nbytes)
        with _window(c, op, nbytes, key):
            out = _allreduce(data.detach().cpu().numpy(), op, None, c, key)
            return torch.as_tensor(out, device=data.device)
    if not isinstance(data, np.ndarray):
        raise TypeError("allreduce takes numpy arrays and torch tensors")
    c = _resolve(data.dtype, op, codec, data.nbytes)
    with _window(c, op, data.nbytes, key):
        return _allreduce(data, op, prepare_fun, c, key)


def _resolve(dtype: np.dtype, op: int, codec: str | None, nbytes: int):
    """Check the dtype and op; the codec of the call (None: exact)."""
    if dtype not in DTYPE_ENUM:
        raise TypeError(f"dtype {dtype} not supported")
    if op not in (MAX, MIN, SUM, BITOR):
        raise ValueError(f"unknown reduction op {op}")
    return compress.resolve(codec, dtype, op, nbytes)


def _window(c, op: int, nbytes: int, key: str):
    """The ``obs.collective`` window of one allreduce."""
    if c is None:
        return obs.collective("allreduce", nbytes, cache_key=key)
    return obs.collective("allreduce", nbytes, cache_key=key, codec=c.name,
                          fused=get_engine().fused_active(c, op))


def _allreduce(data: np.ndarray, op: int, prepare_fun, c, key: str) -> np.ndarray:
    buf = data.flatten()  # a fresh 1-D copy
    prep = None
    if prepare_fun is not None:
        def prep(view: np.ndarray) -> None:
            prepare_fun(data)
            view[...] = np.ascontiguousarray(data).reshape(-1)
    engine = get_engine()
    if c is None:
        out = engine.allreduce(buf, op, prepare_fun=prep, cache_key=key)
    else:
        out = engine.allreduce_compressed(buf, op, c, prepare_fun=prep, cache_key=key)
    return np.asarray(out).reshape(data.shape)


def broadcast(data: Any, root: int) -> Any:
    """Broadcast any picklable object from ``root``.

    With ``rabit_compress_broadcast`` configured (e.g. ``zlib``), the
    pickled payload crosses the wire compressed behind a one-byte codec
    frame; payloads under ``rabit_compress_min_bytes`` ride as identity.
    The policy comes from the shared job config, so every rank frames and
    deframes symmetrically."""
    engine = get_engine()
    key = _caller_key()
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
    # A non-root learns the payload's length from the wire, inside the window.
    with obs.collective("broadcast", len(payload) if payload is not None else 0,
                        cache_key=key,
                        codec=bcodec.name if bcodec is not None else None) as span:
        out = engine.broadcast(payload, root, cache_key=key)
        span.nbytes = len(payload) if payload is not None else len(out) if out else 0
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
    flat = np.ascontiguousarray(data).reshape(-1)
    key = _caller_key()
    with obs.collective("allgather", flat.nbytes, cache_key=key):
        out = engine.allgather(flat, cache_key=key)
    return np.asarray(out).reshape((engine.get_world_size(),) + data.shape)


def _disk_resume():
    """Fresh-job disk resume (store configured, engine version 0).

    Every rank runs this IDENTICAL deterministic collective sequence (its
    decisions depend only on collective results, which agree on all
    ranks): MAX of the newest valid version, MIN of "have it", MIN of the
    holders' ranks, then the holder's broadcast of the global blob.  A rank
    missing its file takes another branch only after the agreed MIN.

    Returns (base_version, gblob, lblob): (0, None, None) when there is
    nothing on disk anywhere."""
    engine = get_engine()
    mine = np.array([_ckpt_store.latest_valid()], np.int64)
    vmax = int(engine.allreduce(mine, MAX, cache_key="rabit_tpu.store::vmax")[0])
    if vmax <= 0:
        return 0, None, None
    have = int(_ckpt_store.has(vmax))
    all_have = int(
        engine.allreduce(np.array([have], np.int64), MIN,
                         cache_key="rabit_tpu.store::have")[0]
    )
    if all_have:
        return vmax, _ckpt_store.load_global(vmax), _ckpt_store.load_local(vmax)
    # Someone's disk copy is missing or stale: the lowest-ranked holder
    # serves the (rank-identical) global blob over a broadcast.  Rank-local
    # models cannot be served this way; a rank without its own file resumes
    # with local_model=None, and the caller must rebuild rank-local state.
    if not have:
        import warnings

        warnings.warn(
            f"rabit_tpu_torch durable resume: rank {engine.get_rank()} has no "
            f"valid disk checkpoint for v{vmax} (killed between the commit "
            "barrier and its disk save?); the global model is served by a "
            "peer but any rank-local model is LOST: load_checkpoint will "
            "return local_model=None and the caller must rebuild it",
            stacklevel=3,
        )
    world = engine.get_world_size()
    root = int(
        engine.allreduce(
            np.array([engine.get_rank() if have else world], np.int64), MIN,
            cache_key="rabit_tpu.store::root")[0]
    )
    # The blob crosses the wire zlib-compressed (both ends run this same
    # code, so no frame negotiation is needed).
    zcodec = compress.get_codec("zlib")
    wireblob = engine.broadcast(
        zcodec.encode_bytes(_ckpt_store.load_global(vmax))
        if engine.get_rank() == root else None,
        root, cache_key="rabit_tpu.store::blob",
    )
    gblob = zcodec.decode_bytes(bytes(wireblob))
    compress.observe(engine, zcodec.name, raw=len(gblob), wire=len(wireblob))
    engine.obs_event("recovery_blob_compressed", raw=len(gblob),
                     wire=len(wireblob), version=vmax)
    lblob = _ckpt_store.load_local(vmax) if have else None
    return vmax, bytes(gblob), lblob


def _note_commit(engine: Engine, nbytes: int) -> None:
    """Report one checkpoint commit (engine version bump) to the engine's
    event hook and the registry; the cross-rank collective numbering moves
    to the new version."""
    version = _ckpt_base + engine.version_number()
    obs.collective_epoch(version)
    engine.obs_event("checkpoint_commit", version=version, nbytes=nbytes)
    reg = obs.get_registry()
    reg.counter("checkpoint_commits_total").inc()
    reg.gauge("checkpoint_version").set(version)


def checkpoint(global_model: Any, local_model: Any = None) -> None:
    """Commit an iteration: pickle and store the models, bump the version.
    With ``rabit_checkpoint_dir`` configured, the committed blobs are also
    spilled to disk."""
    dump = lambda m: pickle.dumps(m, protocol=pickle.HIGHEST_PROTOCOL)
    gblob = dump(global_model)
    lblob = None if local_model is None else dump(local_model)
    engine = get_engine()
    if _ckpt_store is None:
        engine.checkpoint(gblob, lblob)
        _note_commit(engine, len(gblob))
        _publish_commit(engine, gblob)
        return
    wrapped = _wrap(_ckpt_base, gblob)
    engine.checkpoint(wrapped, lblob)
    _note_commit(engine, len(wrapped))
    # Persist AFTER the commit barrier: live ranks' disk versions can then
    # skew by at most one, which the store's keep-2 retention covers.  The
    # adopted world epoch rides in the frame (RTC3 past epoch 0).
    _ckpt_store.save(_ckpt_base + engine.version_number(), wrapped, lblob,
                     epoch=_world_epoch["epoch"])
    _publish_commit(engine, wrapped)


def _publish_commit(engine: Engine, blob: bytes) -> None:
    """Publish the committed blob (after the commit, and after the store's
    save when there is one, so that the plane names only bytes a resume
    could serve too), pin its version in the store so that no prune races
    a fetch of it, and record ``snapshot_published``.  A delivery outage is
    swallowed: it must never fail the job's commit."""
    if _publisher is None:
        return
    version = _ckpt_base + engine.version_number()
    try:
        _publisher.publish(version, blob, epoch=_world_epoch["epoch"])
        if _ckpt_store is not None:
            _ckpt_store.pin(version)
        engine.obs_event("snapshot_published", version=version, nbytes=len(blob))
    except (ConnectionError, OSError, ValueError):
        pass


def lazy_checkpoint(global_model: Any) -> None:
    """Checkpoint whose pickling waits until a load asks for it:
    ``global_model`` must stay unchanged until the next checkpoint.  With
    ``rabit_checkpoint_dir`` configured it is the eager ``checkpoint``: disk
    durability needs the bytes at commit time."""
    if _ckpt_store is not None:
        checkpoint(global_model)
        return
    engine = get_engine()
    engine.lazy_checkpoint(
        lambda: pickle.dumps(global_model, protocol=pickle.HIGHEST_PROTOCOL))
    _note_commit(engine, 0)


def load_checkpoint(with_local: bool = False):
    """``(version, global_model)`` or, ``with_local``, ``(version,
    global_model, local_model)``; version 0 means nothing checkpointed.
    With ``rabit_checkpoint_dir`` configured, a fresh job first agrees on
    and resumes from the newest disk checkpoint."""
    global _ckpt_base
    engine = get_engine()
    version, gblob, lblob = engine.load_checkpoint()
    if _ckpt_store is not None:
        if version == 0:
            vmax, dgblob, dlblob = _disk_resume()
            if vmax > 0:
                # Resuming a PREVIOUS job: the file's version is the new
                # base; the wrapper inside carries the old job's base and is
                # discarded.
                _ckpt_base = vmax
                _, gblob = _unwrap(dgblob)
                lblob = dlblob
                version = vmax
        else:
            # A blob of the CURRENT job: its wrapper carries this job's base.
            _ckpt_base, gblob = _unwrap(gblob)
            version = _ckpt_base + version
    # Landing on version V resets the per-version seqno as the survivors'
    # commit of V did, so a restarted worker resumes the shared numbering.
    obs.collective_epoch(version)
    engine.obs_event("load_checkpoint", version=version, recovered=version > 0)
    if version > 0:
        obs.get_registry().counter("load_checkpoint_recovered_total").inc()
    gmodel = pickle.loads(gblob) if version > 0 and gblob is not None else None
    if not with_local:
        return version, gmodel
    return version, gmodel, (pickle.loads(lblob) if version > 0 and lblob is not None
                             else None)


def version_number() -> int:
    """Checkpoint count; when this job resumed a previous job's disk
    checkpoints, the resumed base is included."""
    return _ckpt_base + get_engine().version_number()
