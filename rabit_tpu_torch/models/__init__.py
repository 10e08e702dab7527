"""Model families built on the port's collectives: the exports of
``rabit_tpu/models/__init__.py`` (``init_state`` and ``predict_margin`` are
GBDT's, as there)."""

from rabit_tpu_torch.models.gbdt import (
    GBDT,
    Forest,
    GBDTConfig,
    TrainState,
    compute_bin_edges,
    init_state,
    predict_margin,
    predict_proba,
    quantize,
    train_round,
    train_round_dp,
)
from rabit_tpu_torch.models.kmeans import KMeans, KMeansConfig
from rabit_tpu_torch.models.linear import LinearConfig, LinearModel, LinearState

__all__ = [
    "KMeans",
    "KMeansConfig",
    "LinearConfig",
    "LinearModel",
    "LinearState",
    "GBDT",
    "GBDTConfig",
    "Forest",
    "TrainState",
    "compute_bin_edges",
    "quantize",
    "init_state",
    "train_round",
    "train_round_dp",
    "predict_margin",
    "predict_proba",
]
