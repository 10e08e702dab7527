"""PyTorch/CUDA port of rabit_tpu's GBDT training round for one NVIDIA H100.

``models.gbdt`` holds the trainer (``GBDT``, ``train_round_fused``) and
``ops.boost`` the fused row passes, whose CUDA sources live in ``csrc/``
and are built at first use by ``_build``.  The package imports torch and
numpy only.
"""
