"""PyTorch/CUDA port of rabit_tpu's GBDT training rounds for NVIDIA H100s.

``models.gbdt`` holds the trainer (``GBDT``, ``train_round_fused``, the
hook-based ``train_round`` and the data-parallel rounds); ``ops.boost``
the fused row passes and ``ops.hist`` the histograms for given node ids,
whose CUDA sources live in ``csrc/`` and are built at first use by
``_build``; ``elastic`` the dense row partition across ranks.  The package
imports torch and numpy only.
"""
