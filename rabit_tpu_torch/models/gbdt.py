"""Histogram gradient-boosted decision trees, in PyTorch.

The counterpart of ``rabit_tpu/models/gbdt.py`` for one device.  Features
are quantized to ``n_bins`` integer bins once; every boosting round grows
one depth-``D`` tree level by level from (node, feature, bin) gradient
histograms.  Two rounds compute the same trees:

* ``train_round`` -- the reference, on the CPU: exact-f32 histograms per
  level (``ops.hist``), row routing and leaf sums in plain PyTorch.
* ``train_round_fused`` -- the main path: the fused row passes of
  ``ops.boost`` (hand-written CUDA kernels on a CUDA device, their plain
  versions on the CPU), with leaf masses read off the last histogram.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is no card raises.  A ``Forest`` and a
``TrainState`` of the JAX package carry across as numpy arrays
(``forest_from_numpy``, ``state_from_numpy``, ``forest_to_numpy``); with
the bin edges they are the model's parameters.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rabit_tpu_torch.ops import boost
from rabit_tpu_torch.ops import hist as _hist


class GBDTConfig(NamedTuple):
    """Hyperparameters; the same fields and defaults as the JAX package."""

    n_features: int
    n_trees: int = 20
    depth: int = 6
    n_bins: int = 256
    learning_rate: float = 0.3
    reg_lambda: float = 1.0
    min_child_weight: float = 1.0
    objective: str = "logistic"  # "logistic" | "squared"
    # Histogram encoding of the fused round: two-plane int8 fixed point
    # (~2^-14 of the block max) instead of hi/lo bf16 (~2^-16 relative).
    # The CPU reference (train_round) is exact f32 and ignores it.
    mxu_i8: bool = False
    # Final pass of train_round_fused: route and add the leaf weight in one
    # kernel (True), or route in a kernel and gather leaf[node] (False).
    fused_final: bool = False
    # Sub-contractions per row block in the plain histogram versions (must
    # divide the row block).  The CUDA kernels' results do not depend on it.
    r_split: int = 1


class Forest(NamedTuple):
    """Perfect binary trees in level order: ``feature``/``threshold``
    [n_trees, depth, 2**(depth-1)] int32 (go right when bin > threshold),
    ``leaf`` [n_trees, 2**depth] f32.  Untrained trees are all zero."""

    feature: torch.Tensor
    threshold: torch.Tensor
    leaf: torch.Tensor


class TrainState(NamedTuple):
    forest: Forest
    margin: torch.Tensor  # [rows] current boosting margin
    round: int            # trees built so far


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def init_forest(cfg: GBDTConfig, device="cuda") -> Forest:
    dev = _device(device)
    shape = (cfg.n_trees, cfg.depth, 2 ** (cfg.depth - 1))
    return Forest(
        feature=torch.zeros(shape, dtype=torch.int32, device=dev),
        threshold=torch.zeros(shape, dtype=torch.int32, device=dev),
        leaf=torch.zeros((cfg.n_trees, 2 ** cfg.depth), device=dev),
    )


def init_state(cfg: GBDTConfig, n_rows: int, device="cuda") -> TrainState:
    dev = _device(device)
    return TrainState(forest=init_forest(cfg, dev),
                      margin=torch.zeros(n_rows, device=dev), round=0)


# -- parameters across the two packages -----------------------------------------


def forest_from_numpy(forest, device="cuda") -> Forest:
    """A forest with numpy-convertible ``feature``/``threshold``/``leaf``
    (e.g. a JAX ``Forest``) as this package's tensors on ``device``."""
    dev = _device(device)
    t = lambda a, dt: torch.as_tensor(np.array(a), dtype=dt, device=dev)
    return Forest(feature=t(forest.feature, torch.int32),
                  threshold=t(forest.threshold, torch.int32),
                  leaf=t(forest.leaf, torch.float32))


def forest_to_numpy(forest: Forest) -> Forest:
    return Forest(*(np.asarray(a.cpu()) for a in forest))


def state_from_numpy(state, device="cuda") -> TrainState:
    """A training state with numpy-convertible fields (e.g. a JAX
    ``TrainState``) on ``device``, to continue boosting from."""
    dev = _device(device)
    return TrainState(
        forest=forest_from_numpy(state.forest, dev),
        margin=torch.as_tensor(np.array(state.margin), dtype=torch.float32,
                               device=dev),
        round=int(np.asarray(state.round)),
    )


# -- quantization ----------------------------------------------------------------


def compute_bin_edges(X: np.ndarray, n_bins: int) -> np.ndarray:
    """Per-feature quantile cut points, [n_features, n_bins - 1] (host-side,
    once per dataset -- the 'sketch' phase of hist tree_method)."""
    qs = np.linspace(0.0, 1.0, n_bins + 1)[1:-1]
    return np.quantile(np.asarray(X, np.float32), qs, axis=0).T.astype(np.float32)


def quantize(X: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Map features to integer bins in [0, n_bins): bin = #edges <= x."""
    cols = torch.searchsorted(edges.contiguous(), X.T.contiguous(), right=True)
    return cols.T.to(torch.int32).contiguous()


# -- one round ---------------------------------------------------------------------


def gradients(cfg: GBDTConfig, margin: torch.Tensor, y: torch.Tensor):
    if cfg.objective == "logistic":
        p = torch.sigmoid(margin)
        return p - y, p * (1.0 - p)
    if cfg.objective == "squared":
        return margin - y, torch.ones_like(margin)
    raise ValueError(f"unknown objective {cfg.objective}")


def split_gains(hist: torch.Tensor, cfg: GBDTConfig) -> torch.Tensor:
    """Gain of every split candidate of a [nodes, F, B, 2] histogram,
    [nodes, F*B]: XGBoost's GL^2/(HL+l) + GR^2/(HR+l) - G^2/(H+l) for
    'bin <= b goes left', -inf where a side's hessian mass is under
    min_child_weight."""
    g, h = hist[..., 0], hist[..., 1]
    GL, HL = torch.cumsum(g, -1), torch.cumsum(h, -1)
    G, H = GL[..., -1:], HL[..., -1:]
    GR, HR = G - GL, H - HL
    score = lambda a, b: a * a / (b + cfg.reg_lambda)
    gain = score(GL, HL) + score(GR, HR) - score(G, H)
    valid = (HL >= cfg.min_child_weight) & (HR >= cfg.min_child_weight)
    gain = torch.where(valid, gain, torch.full_like(gain, -torch.inf))
    return gain.reshape(gain.shape[0], -1)


def best_splits(hist: torch.Tensor, cfg: GBDTConfig):
    """Best (feature, bin, gain) per node (``split_gains``'s argmax).  Ties
    go to the first index, as with jnp.argmax."""
    flat = split_gains(hist, cfg)
    best = torch.argmax(flat, -1)
    best_gain = flat.gather(1, best[:, None])[:, 0]
    n_bins = hist.shape[2]
    return ((best // n_bins).to(torch.int32), (best % n_bins).to(torch.int32),
            best_gain)


def split_child_masses(hist: torch.Tensor, feat: torch.Tensor,
                       thr: torch.Tensor) -> torch.Tensor:
    """Leaf (g, h) masses read off the last level's histogram at the chosen
    splits (children sums = split cumsums); [2*n_nodes, 2] in leaf order
    (leaf = 2*node + went_right)."""
    g, h = hist[..., 0], hist[..., 1]
    GL, HL = torch.cumsum(g, -1), torch.cumsum(h, -1)
    G, H = GL[..., -1], HL[..., -1]
    rows = torch.arange(hist.shape[0], device=hist.device)
    f, t = feat.long(), thr.long()
    gl, hl = GL[rows, f, t], HL[rows, f, t]
    gt, ht = G[rows, f], H[rows, f]
    left = torch.stack([gl, hl], -1)
    right = torch.stack([gt - gl, ht - hl], -1)
    return torch.stack([left, right], 1).reshape(2 * hist.shape[0], 2)


def _leaf_weights(cfg: GBDTConfig, leaf_gh: torch.Tensor) -> torch.Tensor:
    return -cfg.learning_rate * leaf_gh[:, 0] / (leaf_gh[:, 1] + cfg.reg_lambda)


def _append_tree(state: TrainState, feats, thrs, leaf, margin) -> TrainState:
    t = state.round
    feature = state.forest.feature.clone()
    threshold = state.forest.threshold.clone()
    leaves = state.forest.leaf.clone()
    feature[t] = torch.stack(feats)
    threshold[t] = torch.stack(thrs)
    leaves[t] = leaf
    return TrainState(Forest(feature, threshold, leaves), margin, t + 1)


def _padded(x: torch.Tensor, size: int) -> torch.Tensor:
    out = torch.zeros(size, dtype=torch.int32, device=x.device)
    out[: x.shape[0]] = x
    return out


def train_round(state: TrainState, xb: torch.Tensor, y: torch.Tensor,
                cfg: GBDTConfig) -> TrainState:
    """Grow one tree on the CPU with exact-f32 histograms; the reference for
    train_round_fused."""
    n, F = xb.shape
    max_nodes = 2 ** (cfg.depth - 1)
    g, h = gradients(cfg, state.margin, y)
    node = torch.zeros(n, dtype=torch.int32, device=xb.device)
    feats, thrs = [], []
    for d in range(cfg.depth):
        hist = _hist.node_histograms(xb, g, h, node, 2 ** d, cfg.n_bins)
        feat, thr, _ = best_splits(hist, cfg)
        feats.append(_padded(feat, max_nodes))
        thrs.append(_padded(thr, max_nodes))
        p = node.long()
        xv = xb.gather(1, feat.long()[p][:, None])[:, 0]
        node = node * 2 + (xv > thr[p]).to(torch.int32)
    leaf_gh = _hist.segment_sum(torch.stack([g, h], -1), node, 2 ** cfg.depth)
    leaf = _leaf_weights(cfg, leaf_gh)
    return _append_tree(state, feats, thrs, leaf, state.margin + leaf[node.long()])


def train_round_fused(state: TrainState, xb3: torch.Tensor, y: torch.Tensor,
                      cfg: GBDTConfig) -> TrainState:
    """One boosting round through the fused row passes of ``ops.boost``:
    ``hist_level0``, then per level ``best_splits`` and ``hist_level``
    (route + histogram in one pass), leaf masses off the last histogram
    (``split_child_masses``), and ``route_level`` + ``margin += leaf[node]``
    or, with ``cfg.fused_final``, ``route_margin_level``.  ``xb3`` is the
    pre-blocked bin matrix from ``ops.boost.block_rows``."""
    n = y.shape[0]
    block = xb3.shape[1]
    max_nodes = 2 ** (cfg.depth - 1)
    g, h = gradients(cfg, state.margin, y)
    g3, _ = boost.block_rows(g, block)
    h3, _ = boost.block_rows(h, block)
    if g3.shape[0] != xb3.shape[0]:
        raise ValueError(
            f"train_round_fused: {n} rows block into {g3.shape[0]} blocks of "
            f"{block}, but xb3 has {xb3.shape[0]} blocks")
    hist = boost.hist_level0(xb3, g3, h3, n_bins=cfg.n_bins, mxu_i8=cfg.mxu_i8,
                             r_split=cfg.r_split)
    feat, thr, _ = best_splits(hist, cfg)
    feats, thrs = [_padded(feat, max_nodes)], [_padded(thr, max_nodes)]
    node3 = torch.zeros(g3.shape, dtype=torch.int32, device=g3.device)
    for d in range(1, cfg.depth):
        hist, node3 = boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                       n_bins=cfg.n_bins, mxu_i8=cfg.mxu_i8,
                                       r_split=cfg.r_split)
        feat, thr, _ = best_splits(hist, cfg)
        feats.append(_padded(feat, max_nodes))
        thrs.append(_padded(thr, max_nodes))
    leaf = _leaf_weights(cfg, split_child_masses(hist, feat, thr))
    if cfg.fused_final:
        margin3, _ = boost.block_rows(state.margin, block)
        margin3, _ = boost.route_margin_level(xb3, node3, margin3, feat, thr,
                                              leaf, depth=cfg.depth)
        margin = boost.unblock_rows(margin3, n)
    else:
        node3 = boost.route_level(xb3, node3, feat, thr, depth=cfg.depth)
        margin = state.margin + leaf[boost.unblock_rows(node3, n).long()]
    return _append_tree(state, feats, thrs, leaf, margin)


# -- prediction ----------------------------------------------------------------------


def predict_margin(forest: Forest, xb: torch.Tensor, cfg: GBDTConfig) -> torch.Tensor:
    """Sum of leaf values over all trees, tree by tree; [n].  Untrained
    (zero) trees add 0, so this is valid mid-training."""
    n = xb.shape[0]
    margin = torch.zeros(n, device=xb.device)
    for t in range(forest.feature.shape[0]):
        pos = torch.zeros(n, dtype=torch.long, device=xb.device)
        for d in range(cfg.depth):
            f = forest.feature[t, d][pos].long()
            thr = forest.threshold[t, d][pos]
            xv = xb.gather(1, f[:, None])[:, 0]
            pos = pos * 2 + (xv > thr).long()
        margin = margin + forest.leaf[t][pos]
    return margin


def predict_proba(forest: Forest, xb: torch.Tensor, cfg: GBDTConfig) -> torch.Tensor:
    return torch.sigmoid(predict_margin(forest, xb, cfg))


# -- host-facing wrapper ---------------------------------------------------------------


class GBDT:
    """Numpy-in, numpy-out trainer on one device: the fused kernels on CUDA,
    the exact reference round on the CPU."""

    def __init__(self, device="cuda", **hyper):
        self.device = _device(device)
        self._hyper = hyper
        self.cfg: GBDTConfig | None = None
        self.forest: Forest | None = None
        self.edges: np.ndarray | None = None

    def _bins(self, X: np.ndarray) -> torch.Tensor:
        X = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        return quantize(X, torch.as_tensor(self.edges, device=self.device))

    def fit(self, X: np.ndarray, y: np.ndarray,
            warm_state: TrainState | None = None):
        X = np.asarray(X, np.float32)
        self.cfg = GBDTConfig(n_features=X.shape[1], **self._hyper)
        self.edges = compute_bin_edges(X, self.cfg.n_bins)
        xb = self._bins(X)
        yt = torch.as_tensor(np.asarray(y, np.float32), device=self.device)
        state = warm_state or init_state(self.cfg, X.shape[0], self.device)
        if self.device.type == "cuda":
            xb3, _ = boost.block_rows(xb)
            for _ in range(self.cfg.n_trees):
                state = train_round_fused(state, xb3, yt, self.cfg)
        else:
            for _ in range(self.cfg.n_trees):
                state = train_round(state, xb, yt, self.cfg)
        self.forest = state.forest
        self._state = state
        return self

    def predict_margin(self, X: np.ndarray) -> np.ndarray:
        if self.forest is None:
            raise RuntimeError("GBDT.predict called before fit")
        return predict_margin(self.forest, self._bins(X), self.cfg).cpu().numpy()

    def predict_proba(self, X: np.ndarray) -> np.ndarray:
        return 1.0 / (1.0 + np.exp(-self.predict_margin(X)))

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.cfg.objective == "logistic":
            return (self.predict_margin(X) > 0).astype(np.int32)
        return self.predict_margin(X)
