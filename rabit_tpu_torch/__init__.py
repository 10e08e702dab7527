"""PyTorch/CUDA port of rabit_tpu for NVIDIA H100s.

The package itself is the rabit API, as ``rabit_tpu`` is: ``init``,
``allreduce``, ``broadcast``, ``allgather``, the versioned checkpoints and
``collective_stats`` (re-exported from ``api``).  ``api`` runs over an
engine of ``engine``: rabit's fault-tolerant C++ engine (``engine.native``,
under the port's ``tracker``), ``engine.torch_dist``'s ``TorchEngine``
(torch.distributed, NCCL or gloo, with the compressed collectives of
``compress`` and the fused ring of ``engine.fused``) or the solo engine,
configured by ``config``, with the durable checkpoint spill of ``store``
and ``fusion``'s ``LazyAllreduce``; ``obs`` is its flight recorder,
metrics registry, hang watchdog and heartbeat leases.

``models.gbdt`` holds the GBDT trainer and its rounds (fused, hook-based,
data-parallel, hybrid); ``ops.boost`` the fused row passes and ``ops.hist``
the histograms for given node ids, whose CUDA sources live in ``csrc/``
and are built at first use by ``_build``; ``models.linear`` and
``models.kmeans`` are the smaller model families; ``parallel`` holds the
collectives over process groups and sequence-parallel attention.
``elastic`` is the elastic plane: the dense row partition, the membership
epochs the tracker's hot spares and shrink and grow-back waves follow, and
``ElasticWorker``.

Importing the package loads neither torch nor any JAX: the modules that
need torch import it themselves.
"""

from rabit_tpu_torch.api import (  # noqa: F401 (re-exports)
    BITOR,
    MAX,
    MIN,
    SUM,
    allgather,
    allreduce,
    broadcast,
    checkpoint,
    collective_stats,
    finalize,
    get_processor_name,
    get_rank,
    get_world_size,
    init,
    is_distributed,
    lazy_checkpoint,
    load_checkpoint,
    reset_collective_stats,
    tracker_print,
    version_number,
)

__version__ = "0.5.0"

__all__ = [
    "MAX",
    "MIN",
    "SUM",
    "BITOR",
    "init",
    "finalize",
    "get_rank",
    "get_world_size",
    "is_distributed",
    "tracker_print",
    "get_processor_name",
    "broadcast",
    "allreduce",
    "allgather",
    "load_checkpoint",
    "checkpoint",
    "lazy_checkpoint",
    "version_number",
    "collective_stats",
    "reset_collective_stats",
]
