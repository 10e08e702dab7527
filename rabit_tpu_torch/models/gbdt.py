"""Histogram gradient-boosted decision trees, in PyTorch.

The counterpart of ``rabit_tpu/models/gbdt.py``.  Features are quantized to
``n_bins`` integer bins once; every boosting round grows one depth-``D``
tree level by level from (node, feature, bin) gradient histograms.  Two
rounds compute the same trees:

* ``train_round`` -- the hook-based round: one histogram per level
  (``ops.hist.node_histograms``: the CUDA kernel on a card, the exact-f32
  scatter on the CPU) passed through the ``hist_fn`` hook, row routing by
  gathers, leaf sums (``ops.hist.segment_sum``) through ``combine_leaf``.
  The hooks are the round's only communication points.
* ``train_round_fused`` -- the fused row passes of ``ops.boost``
  (hand-written CUDA kernels on a CUDA device, their plain versions on the
  CPU), with leaf masses read off the last histogram.

Across processes (``torch.distributed``; NCCL for CUDA tensors, gloo for
CPU ones) ``train_round_dp`` and ``train_round_dp_fused`` sum each level's
histogram with one ``all_reduce``; ``GBDT(engine_allreduce=...)`` is the
rabit-classic pattern, where a host hook combines numpy histograms, and
``train_round_hybrid`` marries the two: a local ``all_reduce`` over the
processes of one worker, then one hop a worker through the host hook.

Entry points run on ``"cuda"`` unless the caller passes ``device="cpu"``;
asking for CUDA where there is no card raises.  A ``Forest`` and a
``TrainState`` of the JAX package carry across as numpy arrays
(``forest_from_numpy``, ``state_from_numpy``, ``forest_to_numpy``); with
the bin edges they are the model's parameters.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from rabit_tpu_torch import elastic
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


def node_histograms(xb: torch.Tensor, g: torch.Tensor, h: torch.Tensor,
                    node: torch.Tensor, n_nodes: int, n_bins: int,
                    mxu_i8: bool = False) -> torch.Tensor:
    """Per-(node, feature, bin) gradient and hessian sums, [n_nodes, F, B,
    2], as ``rabit_tpu.models.gbdt.node_histograms``: the CUDA kernel on the
    card (its i8 encoding with ``mxu_i8``), the exact scatter on the CPU
    (``ops.hist.node_histograms``)."""
    return _hist.node_histograms(xb, g, h, node, n_nodes, n_bins, mxu_i8=mxu_i8)


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


def _identity(a: torch.Tensor) -> torch.Tensor:
    return a


def train_round(state: TrainState, xb: torch.Tensor, y: torch.Tensor,
                cfg: GBDTConfig,
                hist_fn: Callable[..., torch.Tensor] | None = None,
                combine_leaf: Callable[[torch.Tensor], torch.Tensor] = _identity,
                ) -> TrainState:
    """Grow one tree on (this shard of) the data and append it to the
    forest.  ``xb`` is the unblocked [n, F] bin matrix.

    ``hist_fn(xb, g, h, node, n_nodes, n_bins) -> [n_nodes, F, B, 2]`` is
    the histogram-build-and-allreduce hook (default: this process's
    histogram, ``ops.hist.node_histograms`` with ``cfg.mxu_i8``);
    ``combine_leaf`` takes the [2**depth, 2] leaf (g, h) masses.  These
    hooks are the round's only communication points.  On the CPU with the
    default hook this is the exact-f32 reference of train_round_fused."""
    if hist_fn is None:
        hist_fn = lambda xb_, g_, h_, node_, nn, nb: _hist.node_histograms(
            xb_, g_, h_, node_, nn, nb, mxu_i8=cfg.mxu_i8)
    n, F = xb.shape
    max_nodes = 2 ** (cfg.depth - 1)
    g, h = gradients(cfg, state.margin, y)
    node = torch.zeros(n, dtype=torch.int32, device=xb.device)
    feats, thrs = [], []
    for d in range(cfg.depth):
        hist = hist_fn(xb, g, h, node, 2 ** d, cfg.n_bins)
        feat, thr, _ = best_splits(hist, cfg)
        feats.append(_padded(feat, max_nodes))
        thrs.append(_padded(thr, max_nodes))
        node = boost._route(xb, node, feat, thr)  # right iff bin > threshold
    leaf_gh = _hist.segment_sum(torch.stack([g, h], -1), node, 2 ** cfg.depth)
    leaf = _leaf_weights(cfg, combine_leaf(leaf_gh))
    return _append_tree(state, feats, thrs, leaf, state.margin + leaf[node.long()])


def train_round_fused(state: TrainState, xb3: torch.Tensor, y: torch.Tensor,
                      cfg: GBDTConfig,
                      combine: Callable[[torch.Tensor], torch.Tensor] = _identity,
                      ) -> TrainState:
    """One boosting round through the fused row passes of ``ops.boost``:
    ``hist_level0``, then per level ``best_splits`` and ``hist_level``
    (route + histogram in one pass), leaf masses off the last histogram
    (``split_child_masses``), and ``route_level`` + ``margin += leaf[node]``
    or, with ``cfg.fused_final``, ``route_margin_level``.  ``xb3`` is the
    pre-blocked bin matrix from ``ops.boost.block_rows``.  ``combine`` is
    the histogram allreduce hook, one call per level (the leaf masses come
    off the last combined histogram, so there is no leaf collective)."""
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
    hist = combine(boost.hist_level0(xb3, g3, h3, n_bins=cfg.n_bins,
                                     mxu_i8=cfg.mxu_i8, r_split=cfg.r_split))
    feat, thr, _ = best_splits(hist, cfg)
    feats, thrs = [_padded(feat, max_nodes)], [_padded(thr, max_nodes)]
    node3 = torch.zeros(g3.shape, dtype=torch.int32, device=g3.device)
    for d in range(1, cfg.depth):
        hist, node3 = boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                       n_bins=cfg.n_bins, mxu_i8=cfg.mxu_i8,
                                       r_split=cfg.r_split)
        hist = combine(hist)
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


# -- data-parallel rounds ------------------------------------------------------------


def _all_reduce(a: torch.Tensor, group) -> torch.Tensor:
    dist.all_reduce(a, op=dist.ReduceOp.SUM, group=group)
    return a


def train_round_dp(state: TrainState, xb: torch.Tensor, y: torch.Tensor,
                   cfg: GBDTConfig, dp_group=None, fp_group=None) -> TrainState:
    """train_round across processes: this process holds a shard of the
    rows, and each level's histogram is summed with one ``all_reduce`` over
    ``dp_group``, plus one for the leaf masses.

    JAX's mesh axes become process groups: ``dp_axis`` is ``dp_group``
    (None: the default group, every process), and ``fp_axis`` is
    ``fp_group``, whose members hold the same rows.  With ``fp_group`` each
    member histograms only its ``F // fp_size`` feature slice (the compute
    splits), then the slices are summed over ``dp_group`` and gathered
    along the feature axis over ``fp_group``; the leaf masses are summed
    over ``dp_group`` only.  ``dp_group`` must then be given: the default
    group would add the fp copies too."""
    if fp_group is None:
        hist_fn = lambda xb_, g, h, node, nn, nb: _all_reduce(
            _hist.node_histograms(xb_, g, h, node, nn, nb, mxu_i8=cfg.mxu_i8),
            dp_group)
    else:
        if dp_group is None:
            raise ValueError("train_round_dp with fp_group needs its dp_group")
        fp_size = dist.get_world_size(fp_group)
        fp_idx = dist.get_rank(fp_group)
        f_local = cfg.n_features // fp_size
        x_slice = xb[:, fp_idx * f_local:(fp_idx + 1) * f_local].contiguous()

        def hist_fn(xb_, g, h, node, nn, nb):
            sl = _all_reduce(_hist.node_histograms(x_slice, g, h, node, nn, nb,
                                                   mxu_i8=cfg.mxu_i8), dp_group)
            parts = [torch.empty_like(sl) for _ in range(fp_size)]
            dist.all_gather(parts, sl, group=fp_group)
            return torch.cat(parts, 1)

    combine_leaf = lambda gh: _all_reduce(gh, dp_group)
    return train_round(state, xb, y, cfg, hist_fn, combine_leaf)


def train_round_dp_fused(state: TrainState, xb3: torch.Tensor, y: torch.Tensor,
                         cfg: GBDTConfig, dp_group=None, wire_i8: bool = False,
                         wire_block: int = 256) -> TrainState:
    """train_round_fused across processes: this process holds a shard of
    the row blocks (``xb3``, and ``y``/margin by rows), and each level's
    histogram is summed exactly with one ``all_reduce`` over ``dp_group``
    (the leaf masses ride the last one).

    ``wire_i8=True`` sums each level's histogram over the quantized
    int8-wire ring instead (``parallel.ring_allreduce_quantized``, ~2x
    fewer wire bytes at ~2^-16 of the block max a hop): lossy, but every
    rank decodes each chunk's identical wire bytes with the same ops, so
    the histograms, and the split decisions even on exact ties, are
    bitwise identical across ranks.  Keep the exact sum where a result
    must equal a serial replay byte for byte.  The flat level histogram
    (2^d * F * n_bins * 2 floats) must be divisible by
    ``dp_size * wire_block``."""
    if wire_i8:
        from rabit_tpu_torch.parallel import ring_allreduce_quantized

        def combine(a):
            return ring_allreduce_quantized(a.reshape(-1), dp_group,
                                            block=wire_block).reshape(a.shape)
    else:
        combine = lambda a: _all_reduce(a, dp_group)
    return train_round_fused(state, xb3, y, cfg, combine=combine)


def train_round_hybrid(state: TrainState, xb: torch.Tensor, y: torch.Tensor,
                       cfg: GBDTConfig, local_group=None,
                       engine_allreduce: Callable[[np.ndarray], np.ndarray]
                       | None = None) -> TrainState:
    """One boosting round of the hybrid deployment: a worker made of the
    processes of ``local_group`` (a torch.distributed group, e.g. one
    process a card of a host; None: this process alone), whose histograms
    are summed on the devices, crossing to the other workers through a
    fault-tolerant host engine (``engine_allreduce``, ``np.ndarray ->
    np.ndarray``, e.g. ``lambda a: rabit_tpu.allreduce(a, rabit_tpu.SUM)``;
    None: solo, no hop).  Each process holds its own rows of the worker's
    shard.

    Per level, and once for the leaf masses: the process's histogram
    (``ops.hist.node_histograms``, the kernel on a card), an ``all_reduce``
    over ``local_group``, then the hop, made once a worker: the group's
    lowest rank crosses the engine and broadcasts the result over the
    group.  The leaf masses take the same path, local sum included: each
    process holds only its rows.  (JAX's counterpart, whose ``mesh`` and
    ``dp_axis`` this group replaces, sums its leaf masses under ``jit``
    already over the whole worker.)

    The hop sequence is what lets the robust engine replay a recovering
    worker byte for byte: every worker makes exactly ``depth + 1`` engine
    calls a tree, the levels in order and then the leaf masses, even where
    two levels' histograms are equal.  In eager PyTorch each hop is a plain
    call made in that order.  A round captured into a CUDA graph or by
    ``torch.compile`` must keep the hop outside the graph, one call a level
    in order (as the JAX round keeps its callbacks apart)."""
    leader = local_group is None or dist.get_rank(local_group) == 0

    def cross(a: torch.Tensor) -> torch.Tensor:
        if local_group is not None:
            _all_reduce(a, local_group)
        if engine_allreduce is None:
            return a
        if leader:
            a = torch.as_tensor(np.asarray(engine_allreduce(a.cpu().numpy()),
                                           dtype=np.float32), device=a.device)
        if local_group is not None:
            dist.broadcast(a, src=dist.get_global_rank(local_group, 0), group=local_group)
        return a

    hist_fn = lambda xb_, g, h, node, nn, nb: cross(_hist.node_histograms(
        xb_, g, h, node, nn, nb, mxu_i8=cfg.mxu_i8))
    return train_round(state, xb, y, cfg, hist_fn, cross)


def elastic_shard(X: np.ndarray, y: np.ndarray, world: int,
                  rank: int) -> tuple[np.ndarray, np.ndarray]:
    """This rank's rows of the full dataset under the dense elastic
    partition (``elastic.shard_slice``): after a world resize every rank
    re-cuts with the new ``(world, rank)``, and the shards' histogram sums
    keep covering every row."""
    sl = elastic.shard_slice(len(X), world, rank)
    return X[sl], y[sl]


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
    the exact reference round on the CPU.

    ``engine_allreduce``: optional host allreduce hook ``np.ndarray ->
    np.ndarray`` (e.g. the native TCP engine's), the rabit-classic
    deployment where each process trains on its own shard and only
    histograms cross the wire.  With it, ``fit`` runs ``train_round`` and
    each level's histogram and the leaf masses leave the device, cross the
    hook and come back: depth + 1 calls per tree."""

    def __init__(self, engine_allreduce: Callable[[np.ndarray], np.ndarray]
                 | None = None, device="cuda", **hyper):
        self.device = _device(device)
        self._engine_allreduce = engine_allreduce
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
        if self._engine_allreduce is not None:
            hook = self._cross_hook
            hist_fn = lambda xb_, g, h, node, nn, nb: hook(_hist.node_histograms(
                xb_, g, h, node, nn, nb, mxu_i8=self.cfg.mxu_i8))
            for _ in range(self.cfg.n_trees):
                state = train_round(state, xb, yt, self.cfg, hist_fn, hook)
        elif self.device.type == "cuda":
            xb3, _ = boost.block_rows(xb)
            for _ in range(self.cfg.n_trees):
                state = train_round_fused(state, xb3, yt, self.cfg)
        else:
            for _ in range(self.cfg.n_trees):
                state = train_round(state, xb, yt, self.cfg)
        self.forest = state.forest
        self._state = state
        return self

    def _cross_hook(self, a: torch.Tensor) -> torch.Tensor:
        """``a`` through the host hook, as f32 on this model's device."""
        out = np.asarray(self._engine_allreduce(a.cpu().numpy()))
        return torch.as_tensor(out, dtype=torch.float32, device=self.device)

    def fit_shard(self, X: np.ndarray, y: np.ndarray, world: int, rank: int,
                  warm_state: TrainState | None = None):
        """Elastic-deployment fit: train on this rank's dense shard of the
        full dataset (``elastic_shard``).  After a world resize, call again
        with the new ``(world, rank)`` and the recovered ``warm_state``."""
        Xs, ys = elastic_shard(X, y, world, rank)
        return self.fit(Xs, ys, warm_state=warm_state)

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
