#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (rabit_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each of which exits non-zero when it fails:

1. device  -- the card's name, count and power limit; no card is a failure.
2. build   -- compile every CUDA source (one nvcc each, in parallel),
              printing nvcc's -Xptxas -v report.
3. kernels -- each kernel against its plain PyTorch version on the same
              inputs at the headline size (1M rows x 28 features x 256
              bins, bench.py's generator, seed 0), both histogram
              encodings, hist_level at every depth of a depth-6 tree.
4. main    -- the fused boosting round (train_round_fused) at that size,
              for bf16 and i8 and both final passes: 1 warm-up and 3 timed
              rounds, launch counts per kernel, and every level held
              teacher-forced against the plain versions.  Then GBDT.fit /
              predict as a user calls them, and the fused round on a small
              input against the CPU reference round.
5. report  -- a {"kernels": [...]} line with each kernel's time, launches,
              bound, plain-version time and library-call time.

The last line is {"ok": true, "device": {...}}.  The script imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

N_FEATURES = 28
N_BINS = 256
DEPTH = 6
HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
HIST_RTOL = 1e-5            # histograms: rtol, and atol = 1e-5 * max |bin|
MARGIN_RTOL = 1e-6
GAIN_TIE = 1e-4             # a differing split must be this close in gain
REPLACES = {
    "hist_level0": "rabit_tpu/ops/boost.py:341",
    "hist_level": "rabit_tpu/ops/boost.py:374",
    "route_level": "rabit_tpu/ops/boost.py:290",
    "route_margin_level": "rabit_tpu/ops/boost.py:260",
}
SOURCE = {
    "hist_level0": "rabit_tpu_torch/csrc/hist.cu",
    "hist_level": "rabit_tpu_torch/csrc/hist.cu",
    "route_level": "rabit_tpu_torch/csrc/route.cu",
    "route_margin_level": "rabit_tpu_torch/csrc/route.cu",
}


class PhaseFailed(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


def make_data(n_rows, seed=0):
    """bench.py's Higgs-shaped generator: pre-binned features and labels."""
    rng = np.random.RandomState(seed)
    xb = rng.randint(0, N_BINS, size=(n_rows, N_FEATURES), dtype=np.int32)
    logits = (xb[:, 0] > 128).astype(np.float32) + 0.01 * xb[:, 1]
    y = (logits + rng.randn(n_rows) > 1.5).astype(np.float32)
    return xb, y


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean ms per call of ``fn`` on the card: CUDA events around ``reps``
    calls after one warm-up call."""
    fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def hist_err(got, ref) -> float:
    """Largest |got - ref| / (atol + rtol*|ref|), atol = 1e-5 * max |ref|;
    the histogram passes when this is <= 1."""
    atol = HIST_RTOL * float(ref.abs().max())
    lim = atol + HIST_RTOL * ref.abs()
    return float(((got - ref).abs() / lim.clamp_min(1e-30)).max())


class Smoke:
    def __init__(self, torch, boost, gbdt, n_rows: int, device="cuda"):
        self.torch, self.boost, self.gbdt = torch, boost, gbdt
        self.dev = torch.device(device)
        self.n_rows = n_rows
        xb, y = make_data(n_rows, seed=0)
        self.xb = torch.as_tensor(xb, device=self.dev)
        self.y = torch.as_tensor(y, device=self.dev)
        self.xb3, _ = boost.block_rows(self.xb)
        # gradients at a seeded, non-trivial margin
        rng = np.random.RandomState(1)
        margin = torch.as_tensor(rng.randn(n_rows).astype(np.float32) * 0.5,
                                 device=self.dev)
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES)
        g, h = gbdt.gradients(cfg, margin, self.y)
        self.g3, _ = boost.block_rows(g)
        self.h3, _ = boost.block_rows(h)
        self.margin3, _ = boost.block_rows(margin)
        self.err = {k: 0.0 for k in REPLACES}
        self.ms = {}
        self.plain_ms = {}
        self.library_ms = {}
        self.bound = {}
        self.launches = {k: 0 for k in REPLACES}

    def sync(self):
        if self.dev.type == "cuda":
            self.torch.cuda.synchronize()

    # -- phase 3 ------------------------------------------------------------------
    def level_inputs(self, d: int):
        """Seeded parent node ids and split tables for level d."""
        torch, n_prev = self.torch, 2 ** (d - 1)
        gen = torch.Generator(device=self.dev).manual_seed(100 + d)
        node3 = torch.randint(0, n_prev, self.g3.shape, generator=gen,
                              device=self.dev, dtype=torch.int32)
        feat = torch.randint(0, N_FEATURES, (n_prev,), generator=gen,
                             device=self.dev, dtype=torch.int32)
        thr = torch.randint(0, N_BINS, (n_prev,), generator=gen,
                            device=self.dev, dtype=torch.int32)
        return node3, feat, thr

    def check_kernels(self):
        torch, boost = self.torch, self.boost
        xb3, g3, h3 = self.xb3, self.g3, self.h3
        for i8 in (False, True):
            mode = "i8" if i8 else "bf16"
            got = boost.hist_level0(xb3, g3, h3, n_bins=N_BINS, mxu_i8=i8)
            ref = boost.hist_level0_plain(xb3, g3, h3, n_bins=N_BINS, mxu_i8=i8)
            e = hist_err(got, ref)
            print(f"  hist_level0 {mode}: max |d| {float((got - ref).abs().max()):.3e}"
                  f" (err/limit {e:.3f})")
            require(e <= 1.0, f"hist_level0 {mode} disagrees with its plain version")
            self.err["hist_level0"] = max(self.err["hist_level0"],
                                          float((got - ref).abs().max()))
            for d in range(1, DEPTH):
                node3, feat, thr = self.level_inputs(d)
                got, nk = boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                           n_bins=N_BINS, mxu_i8=i8)
                ref, npl = boost.hist_level_plain(xb3, node3, g3, h3, feat, thr,
                                                  depth=d, n_bins=N_BINS, mxu_i8=i8)
                e = hist_err(got, ref)
                same = bool(torch.equal(nk, npl))
                print(f"  hist_level d={d} {mode}: max |d| "
                      f"{float((got - ref).abs().max()):.3e} (err/limit {e:.3f}),"
                      f" node ids equal: {same}")
                require(same and e <= 1.0,
                        f"hist_level d={d} {mode} disagrees with its plain version")
                self.err["hist_level"] = max(self.err["hist_level"],
                                             float((got - ref).abs().max()))
        node3, feat, thr = self.level_inputs(DEPTH)
        gen = torch.Generator(device=self.dev).manual_seed(7)
        leaf = torch.randn(2 ** DEPTH, generator=gen, device=self.dev)
        nk = boost.route_level(xb3, node3, feat, thr, depth=DEPTH)
        npl = boost.route_level_plain(xb3, node3, feat, thr, depth=DEPTH)
        require(bool(torch.equal(nk, npl)), "route_level node ids differ")
        mk, nk2 = boost.route_margin_level(xb3, node3, self.margin3, feat, thr,
                                           leaf, depth=DEPTH)
        mp, np2 = boost.route_margin_level_plain(xb3, node3, self.margin3, feat,
                                                 thr, leaf, depth=DEPTH)
        require(bool(torch.equal(nk2, np2)), "route_margin_level node ids differ")
        merr = float((mk - mp).abs().max())
        require(bool(torch.allclose(mk, mp, rtol=MARGIN_RTOL, atol=0.0)),
                f"route_margin_level margins differ by {merr}")
        self.err["route_margin_level"] = merr
        print(f"  route_level: node ids equal; route_margin_level: node ids "
              f"equal, max |d margin| {merr:.3e}")

    # -- phase 4 ------------------------------------------------------------------
    def compare_splits(self, hk, hp, cfg, where: str):
        """Split tables from the kernel's and the plain histogram; a differing
        split must be a near tie on the plain histogram.  Returns the
        kernel's tables (the teacher-forced path goes on with them)."""
        gbdt, torch = self.gbdt, self.torch
        fk, tk, _ = gbdt.best_splits(hk, cfg)
        fp, tp, _ = gbdt.best_splits(hp, cfg)
        gains = gbdt.split_gains(hp, cfg)
        for nd in torch.nonzero((fk != fp) | (tk != tp)).flatten().tolist():
            a = float(gains[nd, int(fk[nd]) * N_BINS + int(tk[nd])])
            b = float(gains[nd, int(fp[nd]) * N_BINS + int(tp[nd])])
            gap = abs(a - b) / max(abs(a), abs(b), 1e-30)
            print(f"    {where} node {nd}: kernel split ({int(fk[nd])},{int(tk[nd])})"
                  f" vs plain ({int(fp[nd])},{int(tp[nd])}), gains {a:.7g} / {b:.7g}")
            require(gap < GAIN_TIE, f"{where}: split differs beyond a near tie")
        return fk, tk

    def teacher_forced(self, state, cfg):
        """One fused round level by level, each kernel held against its plain
        version on the kernel path's inputs; returns the kernel path's
        split tables."""
        boost, gbdt, torch = self.boost, self.gbdt, self.torch
        g, h = gbdt.gradients(cfg, state.margin, self.y)
        g3, _ = boost.block_rows(g)
        h3, _ = boost.block_rows(h)
        kw = dict(n_bins=N_BINS, mxu_i8=cfg.mxu_i8)
        hk = boost.hist_level0(self.xb3, g3, h3, **kw)
        hp = boost.hist_level0_plain(self.xb3, g3, h3, **kw)
        require(hist_err(hk, hp) <= 1.0, "level 0 histogram disagrees")
        feat, thr = self.compare_splits(hk, hp, cfg, "level 0")
        feats, thrs = [feat], [thr]
        node3 = torch.zeros(g3.shape, dtype=torch.int32, device=self.dev)
        for d in range(1, cfg.depth):
            hk, nk = boost.hist_level(self.xb3, node3, g3, h3, feat, thr,
                                      depth=d, **kw)
            hp, npl = boost.hist_level_plain(self.xb3, node3, g3, h3, feat, thr,
                                             depth=d, **kw)
            require(bool(torch.equal(nk, npl)), f"level {d} node ids differ")
            require(hist_err(hk, hp) <= 1.0, f"level {d} histogram disagrees")
            feat, thr = self.compare_splits(hk, hp, cfg, f"level {d}")
            feats.append(feat)
            thrs.append(thr)
            node3 = nk
        nk = boost.route_level(self.xb3, node3, feat, thr, depth=cfg.depth)
        npl = boost.route_level_plain(self.xb3, node3, feat, thr, depth=cfg.depth)
        require(bool(torch.equal(nk, npl)), "leaf ids differ")
        return feats, thrs

    def main_path(self, i8: bool, fused_final: bool):
        torch, boost, gbdt = self.torch, self.boost, self.gbdt
        cfg = gbdt.GBDTConfig(n_features=N_FEATURES, n_trees=4, depth=DEPTH,
                              n_bins=N_BINS, mxu_i8=i8, fused_final=fused_final)
        final = "route_margin_level" if fused_final else "route_level"
        state = gbdt.init_state(cfg, self.n_rows, self.dev)
        state = gbdt.train_round_fused(state, self.xb3, self.y, cfg)  # warm-up
        warm = state
        self.sync()
        boost.launches.clear()
        t0 = time.perf_counter()
        for _ in range(3):
            state = gbdt.train_round_fused(state, self.xb3, self.y, cfg)
        self.sync()
        ms = (time.perf_counter() - t0) * 1e3 / 3
        counts = dict(boost.launches)
        want = {"hist_level0": 3, "hist_level": 3 * (DEPTH - 1), final: 3}
        require(counts == want, f"launch counts {counts}, expected {want}")
        for k, v in counts.items():
            self.launches[k] += v
        require(bool(torch.isfinite(state.margin).all()), "non-finite margin")
        # the same round (from the warm state), level by level
        feats, thrs = self.teacher_forced(warm, cfg)
        t = warm.round
        for d in range(DEPTH):
            n = 2 ** d
            require(bool(torch.equal(state.forest.feature[t, d, :n], feats[d])) and
                    bool(torch.equal(state.forest.threshold[t, d, :n], thrs[d])),
                    f"teacher-forced tree differs from train_round_fused at level {d}")
        mode = ("i8" if i8 else "bf16") + (" fused_final" if fused_final else "")
        print(f"  main path {mode}: {ms:.3f} ms/round (3 rounds after 1 warm-up),"
              f" launches {counts}")
        return ms

    def user_entry(self):
        """GBDT.fit / predict as a user calls them, on float features."""
        gbdt, boost, torch = self.gbdt, self.boost, self.torch
        X = self.xb.cpu().numpy().astype(np.float32)
        y = self.y.cpu().numpy()
        model = gbdt.GBDT(device=self.dev, n_trees=3, depth=DEPTH, n_bins=N_BINS)
        boost.launches.clear()
        t0 = time.perf_counter()
        model.fit(X, y)
        self.sync()
        fit_s = time.perf_counter() - t0
        counts = dict(boost.launches)
        want = {"hist_level0": 3, "hist_level": 3 * (DEPTH - 1), "route_level": 3}
        require(counts == want, f"GBDT.fit launch counts {counts}, expected {want}")
        margin = model.predict_margin(X)
        require(margin.shape == (len(X),) and np.isfinite(margin).all(),
                "predict_margin: bad shape or non-finite")
        train_margin = model._state.margin.cpu().numpy()
        require(np.array_equal(margin, train_margin),
                "predict_margin differs from the training margin")
        acc = float((model.predict(X) == y).mean())
        base = float(max(y.mean(), 1 - y.mean()))
        print(f"  GBDT.fit (3 trees, incl. bin edges): {fit_s:.2f} s; "
              f"train accuracy {acc:.4f} vs majority {base:.4f}")
        require(acc > base, "the trained forest does not beat the majority class")

    def small_reference(self):
        """The fused round on the card against the CPU reference round, at
        the CPU tests' size."""
        gbdt, boost, torch = self.gbdt, self.boost, self.torch
        rng = np.random.RandomState(3)
        n, f = 600, 5
        xb = rng.randint(0, 16, size=(n, f)).astype(np.int32)
        y = rng.randint(0, 2, size=n).astype(np.float32)
        for i8 in (False, True):
            cfg = gbdt.GBDTConfig(n_features=f, n_trees=3, depth=3, n_bins=16,
                                  mxu_i8=i8)
            s_ref = gbdt.init_state(cfg, n, "cpu")
            s_k = gbdt.init_state(cfg, n, self.dev)
            xb3, _ = boost.block_rows(torch.as_tensor(xb, device=self.dev), 256)
            yc = torch.as_tensor(y, device=self.dev)
            for _ in range(cfg.n_trees):
                s_ref = gbdt.train_round(s_ref, torch.as_tensor(xb), torch.as_tensor(y), cfg)
                s_k = gbdt.train_round_fused(s_k, xb3, yc, cfg)
            fr, fk = gbdt.forest_to_numpy(s_ref.forest), gbdt.forest_to_numpy(s_k.forest)
            require(np.array_equal(fr.feature, fk.feature) and
                    np.array_equal(fr.threshold, fk.threshold),
                    f"small input ({'i8' if i8 else 'bf16'}): trees differ from the reference")
            rtol, atol = (5e-3, 5e-3) if i8 else (1e-3, 1e-5)
            require(np.allclose(fk.leaf, fr.leaf, rtol=rtol, atol=atol),
                    "small input: leaves differ from the reference")
        print("  small input: fused round on the card grows the CPU reference's trees")

    # -- phase 5 ------------------------------------------------------------------
    def measure(self):
        torch, boost = self.torch, self.boost
        xb3, g3, h3 = self.xb3, self.g3, self.h3
        rows = xb3.shape[0] * xb3.shape[1]
        hist_bytes = lambda nodes: nodes * N_FEATURES * N_BINS * 2 * 4
        flat_x = xb3.reshape(rows, N_FEATURES).long()
        feat_ids = torch.arange(N_FEATURES, device=self.dev)
        gh = torch.stack([g3.reshape(-1, 1).expand(rows, N_FEATURES),
                          h3.reshape(-1, 1).expand(rows, N_FEATURES)], -1).reshape(-1, 2)

        def library(node):  # one index_add_ builds the same histogram
            seg = ((node.reshape(-1, 1).long() * N_FEATURES + feat_ids) * N_BINS
                   + flat_x).reshape(-1)
            n_seg = int(node.max()) + 1 if node.numel() else 1
            out = torch.zeros(n_seg * N_FEATURES * N_BINS, 2, device=self.dev)
            return cuda_ms(torch, lambda: out.zero_().index_add_(0, seg, gh), 5)

        # hist_level0 (bf16, the default encoding)
        self.ms["hist_level0"] = cuda_ms(
            torch, lambda: boost.hist_level0(xb3, g3, h3, n_bins=N_BINS), 20)
        self.plain_ms["hist_level0"] = cuda_ms(
            torch, lambda: boost.hist_level0_plain(xb3, g3, h3, n_bins=N_BINS), 1)
        self.library_ms["hist_level0"] = library(torch.zeros(rows, device=self.dev,
                                                             dtype=torch.int32))
        b0 = xb3.numel() * 4 + 2 * rows * 4 + hist_bytes(1)
        self.bound["hist_level0"] = (b0, 2.0 * rows * N_FEATURES)
        # hist_level: mean over the five levels of a depth-6 tree
        ms, pms, lms, byts, ops = [], [], [], [], []
        for d in range(1, DEPTH):
            node3, feat, thr = self.level_inputs(d)
            run = lambda: boost.hist_level(xb3, node3, g3, h3, feat, thr, depth=d,
                                           n_bins=N_BINS)
            ms.append(cuda_ms(torch, run, 10))
            pms.append(cuda_ms(torch, lambda: boost.hist_level_plain(
                xb3, node3, g3, h3, feat, thr, depth=d, n_bins=N_BINS), 1))
            lms.append(library(run()[1]))
            byts.append(xb3.numel() * 4 + 4 * rows * 4 + hist_bytes(2 ** d))
            ops.append(2.0 * rows * N_FEATURES)
        i8_ms = [cuda_ms(torch, lambda: boost.hist_level0(
            xb3, g3, h3, n_bins=N_BINS, mxu_i8=True), 20)]
        for d in range(1, DEPTH):
            node3, feat, thr = self.level_inputs(d)
            i8_ms.append(cuda_ms(torch, lambda: boost.hist_level(
                xb3, node3, g3, h3, feat, thr, depth=d, n_bins=N_BINS,
                mxu_i8=True), 10))
        print("  i8 histogram ms, level 0 then d=1..5: "
              + ", ".join(f"{t:.4f}" for t in i8_ms))
        self.ms["hist_level"] = sum(ms) / len(ms)
        self.plain_ms["hist_level"] = sum(pms) / len(pms)
        self.library_ms["hist_level"] = sum(lms) / len(lms)
        self.bound["hist_level"] = (sum(byts) / len(byts), sum(ops) / len(ops))
        print("  bf16 hist_level ms by level d=1..5: "
              + ", ".join(f"{t:.4f}" for t in ms))
        # final passes at depth 6.  A row's split bin is one 32-byte sector of
        # its feature row: the least the card can read for it.
        node3, feat, thr = self.level_inputs(DEPTH)
        leaf = torch.randn(2 ** DEPTH, device=self.dev)
        self.ms["route_level"] = cuda_ms(torch, lambda: boost.route_level(
            xb3, node3, feat, thr, depth=DEPTH), 50)
        self.plain_ms["route_level"] = cuda_ms(torch, lambda: boost.route_level_plain(
            xb3, node3, feat, thr, depth=DEPTH), 5)
        self.library_ms["route_level"] = None
        self.bound["route_level"] = (rows * (32 + 4 + 4), 2.0 * rows)
        m3 = self.margin3
        self.ms["route_margin_level"] = cuda_ms(torch, lambda: boost.route_margin_level(
            xb3, node3, m3, feat, thr, leaf, depth=DEPTH), 50)
        self.plain_ms["route_margin_level"] = cuda_ms(
            torch, lambda: boost.route_margin_level_plain(
                xb3, node3, m3, feat, thr, leaf, depth=DEPTH), 5)
        self.library_ms["route_margin_level"] = None
        self.bound["route_margin_level"] = (rows * (32 + 4 + 4 + 4 + 4), 3.0 * rows)

    def kernels_line(self):
        out = []
        for k in REPLACES:
            byts, ops = self.bound[k]
            t_bytes, t_ops = byts / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
            out.append({
                "name": k, "route": "cuda", "source": SOURCE[k],
                "replaces": REPLACES[k], "launches": self.launches[k],
                "max_abs_err": self.err[k], "ms": self.ms[k],
                "plain_ms": self.plain_ms[k], "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": self.library_ms[k],
            })
        return {"kernels": out}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1_000_000,
                    help="rows of the generated data set (default: the headline 1M)")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 2
    try:
        from rabit_tpu_torch import _build
        from rabit_tpu_torch.models import gbdt
        from rabit_tpu_torch.ops import boost
    except ImportError as e:
        print(f"FAIL: run from the root of a checkout ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions' matmuls
    torch.backends.cudnn.allow_tf32 = False
    phase = "device"
    try:
        name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        smi = nvidia_smi()
        print(f"[device] {name} x{count}; nvidia-smi: {smi}", flush=True)

        phase = "build"
        t0 = time.perf_counter()
        _build.build_all()
        for src, log in _build.ptxas_log.items():
            print(f"[build] csrc/{src}.cu:\n{log.strip()}")
        print(f"[build] {time.perf_counter() - t0:.1f} s", flush=True)

        phase = "kernels"
        smoke = Smoke(torch, boost, gbdt, args.rows)
        print(f"[kernels] {args.rows} rows x {N_FEATURES} features x {N_BINS} bins")
        smoke.check_kernels()

        phase = "main"
        round_ms = {}
        for i8 in (False, True):
            for fused_final in (False, True):
                key = ("i8" if i8 else "bf16") + ("+fused_final" if fused_final else "")
                round_ms[key] = smoke.main_path(i8, fused_final)
        smoke.user_entry()
        smoke.small_reference()
        print("[main] ms/round " + json.dumps(round_ms), flush=True)

        phase = "report"
        smoke.measure()
        print(json.dumps(smoke.kernels_line()))
    except PhaseFailed as e:
        print(f"FAIL [{phase}]: {e}", file=sys.stderr)
        return 1
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
