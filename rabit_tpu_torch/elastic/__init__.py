"""The elastic plane: hot spares, and recovery waves that shrink the world
and grow it back.

The port's own copy of ``rabit_tpu/elastic``:

* ``rebalance``: the dense row partition every rank re-cuts from
  ``(n_rows, world, rank)`` when the world resizes (``shard_bounds``,
  ``shard_slice``, ``rebalance_plan``), and the rank-order fold
  (``refold``) that keeps a collective's bits the same at any world size;
* ``membership``: the world-epoch line the tracker delegates its wave
  decisions to (``MembershipManager``: promote a parked spare, shrink to
  the survivors, grow back), and ``rank_map_delta``;
* ``client``: ``ElasticWorker``, the worker of an elastic job (a spare
  parked on a warm socket, epoch-stamped ring links, the rank-order fold,
  the state consensus after each wave).

``ElasticWorker``, ``ElasticResult`` and ``EpochBroken`` load lazily: the
client speaks the tracker protocol, and the tracker imports this package.
"""

from rabit_tpu_torch.elastic.membership import (  # noqa: F401 (re-exports)
    MembershipManager,
    WaveDecision,
    WorldEpoch,
    rank_map_delta,
)
from rabit_tpu_torch.elastic.rebalance import (  # noqa: F401 (re-exports)
    rebalance_plan,
    refold,
    shard_bounds,
    shard_slice,
)

_CLIENT_EXPORTS = ("ElasticWorker", "ElasticResult", "EpochBroken")


def __getattr__(name: str):
    if name in _CLIENT_EXPORTS:
        from rabit_tpu_torch.elastic import client

        return getattr(client, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def settings(cfg) -> dict:
    """The elastic config keys (``config``) as the tracker's and the
    launcher's knobs: whether this worker is a hot spare, the shrink
    deadline, the world's floor and the spare-promotion grace."""
    return {
        "spare": cfg.get_bool("rabit_spare"),
        "shrink_after_sec": float(cfg.get("rabit_shrink_after_sec", "0") or "0"),
        "min_world": cfg.get_int("rabit_min_world", 1),
        "promote_after_sec": float(cfg.get("rabit_spare_promote_sec", "0.25") or "0.25"),
    }
