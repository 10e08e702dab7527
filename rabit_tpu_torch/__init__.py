"""PyTorch/CUDA port of rabit_tpu's GBDT training rounds for NVIDIA H100s.

``models.gbdt`` holds the trainer (``GBDT``, ``train_round_fused``, the
hook-based ``train_round``, the data-parallel rounds and the hybrid round
``train_round_hybrid``, whose workers cross a fault-tolerant host engine);
``ops.boost`` the fused row passes and ``ops.hist`` the histograms for given
node ids, whose CUDA sources live in ``csrc/`` and are built at first use
by ``_build``; ``elastic`` the dense row partition across ranks.  ``api``
is the module-level collective API (init, allreduce, broadcast, allgather,
checkpoints) over an engine of ``engine``: ``engine.torch_dist``'s
``TorchEngine`` (torch.distributed, NCCL or gloo) or the solo engine,
configured by ``config``, with the durable checkpoint spill of ``store``
(``rabit_checkpoint_dir``) and ``fusion``'s ``LazyAllreduce``; ``obs`` is
its flight recorder, metrics registry, hang watchdog and heartbeat leases,
and ``tracker`` the tracker and launcher of rabit's C++ engine
(``engine.native``).
``models.linear`` and ``models.kmeans`` are the smaller model families;
``parallel`` holds the collectives over process groups and, in
``parallel.ring``, sequence-parallel attention.  The package imports torch
and numpy only.
"""
