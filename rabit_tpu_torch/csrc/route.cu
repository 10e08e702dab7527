// Final row pass of a fused GBDT boosting round: route every row from its
// level-(depth-1) node to its leaf, and optionally add the leaf's weight to
// the row's margin, or sum the rows' (g, h) per leaf.
//
// Replaces rabit_tpu/ops/boost.py route_level (_route_kernel),
// route_margin_level (_route_margin_kernel) and leaf_fit (_leaf_kernel).
//
// Bound on an H100: device memory.  Per row the pass reads its node id, one
// bin of its feature row (the split feature of its node: one 32-byte sector
// of the 4*F-byte row) and, with the margin, one float; it writes the leaf
// id (and the new margin).  No arithmetic to speak of.  The card moves 64
// bytes for that sector, not 32: a row's bin costs as much at a 64-byte
// row as at a 112-byte one and twice what it costs at a 32-byte one
// (tools/torch_route_levels.py --strides), so 1M rows x (64 + 8) bytes is
// the floor of route_level at the headline size.
//
// route_kernel (route_level, route_margin_level).  A row costs two
// device-memory round trips in series: its node id, then the bin that its
// node's split feature picks from its bin row.  The design keeps as many of
// those chains in flight as the card holds and puts nothing in front of
// them:
//
// * No staging.  The split tables (2^(depth-1) entries each) and the leaf
//   table (2^depth) are read where they lie, through the read-only path
//   (__ldg): after an SM's first reads its L1 holds them, and no barrier
//   stands before a row's first load.  The tables' size sets no limit on
//   the launch, so every depth routes.
// * A warp's loads cover 32 consecutive rows, node ids and bins alike, so
//   the bins' 64-byte fetches of neighbouring rows go out together (lanes
//   on rows 4 apart, as 16-byte node loads of four rows a thread would
//   put them, spread a warp's gathers four times wider).
// * kRows rows a thread, their loads issued before the first is used, in
//   one tile of kThreads * kRows consecutive rows a block: at the headline
//   size (1M rows) every block is resident at once (at most 32 registers a
//   thread, 8 blocks an SM), so every row's chain is in flight from the
//   start and no second wave waits.
// * Node ids and bins are read with an evict-first hint (ld.global.cs):
//   each is read once.
//
// Integer routing and one __fadd_rn a row: the result is exact and equals
// the plain version bit for bit.

#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_sort.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;                   // rows a thread stages per pass
constexpr int kRouteTile = kThreads * kRows;  // route_kernel: rows a block

template <bool MARGIN>
__global__ void __launch_bounds__(kThreads, 32 / kRows)
route_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
             const float* __restrict__ margin_in, const int* __restrict__ feat,
             const int* __restrict__ thr, const float* __restrict__ leaf,
             float* __restrict__ margin_out, int* __restrict__ node_out,
             long long n_rows, int n_feat) {
  // Row u of a thread: r0 + u * kThreads.
  const long long r0 = (long long)blockIdx.x * kRouteTile + threadIdx.x;
  int p[kRows], x[kRows], t[kRows];
  float m[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long r = r0 + u * kThreads;
    if (r < n_rows) {
      p[u] = __ldcs(node_in + r);
      if (MARGIN) m[u] = __ldcs(margin_in + r);
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long r = r0 + u * kThreads;
    if (r < n_rows) {
      t[u] = __ldg(thr + p[u]);
      x[u] = __ldcs(xb + r * n_feat + __ldg(feat + p[u]));
    }
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const long long r = r0 + u * kThreads;
    if (r < n_rows) {
      const int node = 2 * p[u] + (x[u] > t[u] ? 1 : 0);
      node_out[r] = node;
      if (MARGIN) margin_out[r] = __fadd_rn(m[u], __ldg(leaf + node));
    }
  }
}

// leaf_fit: route each row to its leaf, write the leaf id, and sum (g, h)
// per leaf as the TPU kernel does: g and h split into hi/lo bfloat16
// planes, each plane summed in f32 over a row block of R rows, hi + lo per
// block, and the row blocks' sums added per leaf in a fixed order.
//
// Bound on an H100: device memory (per row its node id, one 32-byte sector
// of its feature row, g and h in; the leaf id out; the per-block sums are
// at most a fraction of that).  The TPU kernel sums with a matmul against
// a (leaves x rows) one-hot on the MXU, its accumulator resident in VMEM
// whatever the depth; a CUDA block has 227 KB of shared memory, and one
// accumulator a leaf for every warp capped the depth (at R = 1024 it
// refused depth 13).  One block per row block reduces the block's rows,
// with route_kernel's loads (several rows a thread in flight, warp-
// consecutive rows, node ids and bins evict-first, the split tables
// through L1), in one of two ways by depth:
//
// * leaf_acc_kernel, depth <= kAccDepth (8): each warp sums its rows into
//   its own accumulators (8 x 2**depth x 16 bytes, at most 32 KB): the
//   lanes of a step that share a leaf in a pairwise shuffle tree, then the
//   warps in order.  No sort and no staging: a few instructions a row
//   beyond the loads.
// * leaf_sort_kernel, deeper: the block's rows are sorted by leaf, stably
//   (csrc/block_sort.cuh: LSD passes of 8 bits, ceil(depth / 8) of them),
//   so each leaf's rows form a run.  Shared memory R x (8 + 2 x 4 + 2 x 2)
//   bytes (R rounded up to a multiple of 256) and 8 x 256 digit counters,
//   at any depth: past 11008 rows it outgrows the card, and the wrapper
//   hands the kernel the row block in equal parts that fit.  Each run is summed:
//   every thread adds its R / 256 consecutive sorted rows in order, and a
//   segmented scan over the threads (warp shuffles, then the warps in
//   order) carries a run across threads.
//
// Either way hi + lo per leaf gives the row block's (g, h) of that leaf.
// The row blocks' sums are then added per leaf in groups of kGroup
// consecutive row blocks, each group in block order, the groups in group
// order, either way:
//
// * dense (2**depth <= 2R: the sums take at most the rows' own bytes):
//   each block writes its row of a [nb, 2**depth] partial (zeros for the
//   leaves it lacks); leaf_dense_merge_kernel adds the rows.
// * compact (deeper, so leaf_sort_kernel only): each block writes one
//   record (leaf, block, g, h) per leaf it holds, at the run's last sorted
//   slot, holes in its other slots.  A stable LSD radix sort over the
//   records' leaf ids (digit_count, digit_scan, digit_scatter: a pass each
//   8 bits) lists each leaf's records in block order; leaf_heads_kernel lists where each leaf's
//   records start, and leaf_merge_kernel walks them, a thread a leaf.
//   Scratch grows with the rows, not with 2**depth.
//
// A block that lacks a leaf adds nothing in the compact path and an exact
// 0 in the dense one, so both give the same sums.  No float atomics: the
// order of every float add is fixed by the shapes and the data, and the
// result is bitwise the same on repeat.

constexpr int kGroup = 32;  // row blocks summed in order before a group's total joins

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ inline float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ inline float4 unpack_bf16(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ inline float4 shfl_up4(float4 v, int o) {
  return make_float4(__shfl_up_sync(blk::kFull, v.x, o), __shfl_up_sync(blk::kFull, v.y, o),
                     __shfl_up_sync(blk::kFull, v.z, o), __shfl_up_sync(blk::kFull, v.w, o));
}

constexpr int kAccDepth = 8;  // leaf_acc_kernel's deepest tree: 8 warps x 256 leaves x 16 B

// Shared memory of a leaf_acc_kernel block: per-warp accumulators.
__host__ __device__ inline size_t leaf_acc_smem(int depth) {
  return ((size_t)kThreads / 32) * ((size_t)16 << depth);
}

__device__ inline float4 shfl4(float4 v, int src) {
  return make_float4(__shfl_sync(blk::kFull, v.x, src), __shfl_sync(blk::kFull, v.y, src),
                     __shfl_sync(blk::kFull, v.z, src), __shfl_sync(blk::kFull, v.w, src));
}

// The sum of v over the lanes in `peers` (this lane among them), in a
// pairwise tree over their ranks (lane order): rank 0 gets ((v0 + v1) +
// (v2 + v3)) + ...; the other lanes get partial sums.  As many levels as
// the largest group of the warp needs, so a warp of many small groups
// pays little and one of a single group five levels, not 31 serial adds.
__device__ inline float4 group_sum(float4 v, unsigned int peers) {
  const int lane = threadIdx.x & 31;
  const int cnt = __popc(peers);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  const int widest = (int)__reduce_max_sync(blk::kFull, (unsigned int)cnt);
  const unsigned int above = peers & ~((2u << lane) - 1u);  // the members after this lane
  for (int step = 1; step < widest; step <<= 1) {
    unsigned int m = above;  // the member `step` ranks after this one
    for (int j = 1; j < step; ++j) m &= m - 1u;
    const float4 o = shfl4(v, m ? __ffs(m) - 1 : lane);
    if ((rank & (2 * step - 1)) == 0 && rank + step < cnt) v = add4(v, o);
  }
  return v;
}

__device__ inline float4 split_bf16(float g, float h) {
  // (g hi, g lo, h hi, h lo): hi = bf16(v), lo = bf16(v - hi), as floats.
  const float ghi = __bfloat162float(__float2bfloat16_rn(g));
  const float hhi = __bfloat162float(__float2bfloat16_rn(h));
  return make_float4(ghi, __bfloat162float(__float2bfloat16_rn(__fsub_rn(g, ghi))), hhi,
                     __bfloat162float(__float2bfloat16_rn(__fsub_rn(h, hhi))));
}

// Up to depth kAccDepth: one block per row block, warp w owning the rows
// [w * seg, (w + 1) * seg), seg = R / 8 rounded up to whole warp steps
// (where R is not a multiple of 256 the lanes past R hold no row).  Each
// step a warp routes 32 consecutive rows (route_kernel's loads, kRows
// steps in flight); the lanes that share
// a leaf (one ballot a depth bit) are summed in registers by a pairwise
// tree over their lanes (group_sum), and the lowest of them adds the sum
// to the warp's accumulator for that leaf.  Then each leaf's 8 warp sums
// are added in warp order, hi + lo: 8 x 2**depth x 16 bytes of shared
// memory (at most 32 KB) and no sort.  ROWS steps' loads are in flight at
// once: 1 up to depth 7, at 32 registers, so 8 blocks fit an SM and the
// 977 blocks of 1M rows run in one wave (that beat 2 or 4 steps in
// flight with fewer blocks); 4 at depth 8, whose 32 KB of accumulators
// leave room for 6 blocks an SM anyway.  Writes the row block's dense
// partial row (2**depth <= 256 <= 2R: never the compact records).
template <int ROWS>
__global__ void __launch_bounds__(kThreads, ROWS == 1 ? 8 : 1)
leaf_acc_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
                const float* __restrict__ g, const float* __restrict__ h,
                const int* __restrict__ feat, const int* __restrict__ thr,
                int* __restrict__ node_out, float2* __restrict__ partial, int R,
                int n_feat, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_leaves = 1 << depth;
  constexpr int kW = kThreads / 32;
  float4* acc = reinterpret_cast<float4*>(smem);   // [warp][leaf]
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int i = tid; i < kW * n_leaves; i += kThreads) acc[i] = zero;
  __syncthreads();
  const long long base = (long long)blockIdx.x * R;
  const int seg = (R / kW + 31) & ~31;  // whole warp steps
  float4* mine = acc + w * n_leaves;
  // in(u): this lane's row of step u lies in the warp's segment and the block
  auto in = [&](int s0, int u) { return s0 + u * 32 < seg && w * seg + s0 + u * 32 + lane < R; };
  for (int s0 = 0; s0 < seg; s0 += ROWS * 32) {
    int p[ROWS], x[ROWS], t[ROWS];
    float gv[ROWS], hv[ROWS];
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const long long r = base + w * seg + s0 + u * 32 + lane;
      if (in(s0, u)) p[u] = __ldcs(node_in + r);
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      const long long r = base + w * seg + s0 + u * 32 + lane;
      if (in(s0, u)) {
        t[u] = __ldg(thr + p[u]);
        x[u] = __ldcs(xb + r * n_feat + __ldg(feat + p[u]));
        gv[u] = __ldcs(g + r);
        hv[u] = __ldcs(h + r);
      }
    }
#pragma unroll
    for (int u = 0; u < ROWS; ++u) {
      if (s0 + u * 32 >= seg) continue;  // the whole warp's step
      const long long r = base + w * seg + s0 + u * 32 + lane;
      const bool ok = in(s0, u);
      const int leaf = ok ? 2 * p[u] + (x[u] > t[u] ? 1 : 0) : -1;
      if (ok) node_out[r] = leaf;
      const unsigned int peers = blk::match_digit(leaf, depth);
      const float4 sum = group_sum(ok ? split_bf16(gv[u], hv[u]) : make_float4(0.f, 0.f, 0.f, 0.f),
                                   peers);
      if (ok && lane == __ffs(peers) - 1) mine[leaf] = add4(mine[leaf], sum);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int leaf = tid; leaf < n_leaves; leaf += kThreads) {
    float4 sum = acc[leaf];
    for (int v = 1; v < kW; ++v) sum = add4(sum, acc[v * n_leaves + leaf]);
    partial[(long long)blockIdx.x * n_leaves + leaf] =
        make_float2(__fadd_rn(sum.x, sum.y), __fadd_rn(sum.z, sum.w));
  }
}

// Shared memory of a leaf_sort_kernel block (16-byte aligned pieces).
struct LeafLayout {
  size_t planes, ka, kb, ia, ib, wc, bytes;
};

// Slots the block sort ranks for R rows: R rounded up to a multiple of 256.
__host__ __device__ inline int leaf_slots(int R) { return (R + 255) & ~255; }

__host__ __device__ inline LeafLayout leaf_layout(int R, int depth) {
  LeafLayout L;
  R = leaf_slots(R);
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at = (at + bytes + 15) & ~size_t(15);
    return here;
  };
  L.planes = take((size_t)R * 8);  // uint2 [R]: a row's four bf16 planes
  L.ka = take((size_t)R * 4);      // the sort's key buffers
  L.kb = take((size_t)R * 4);
  L.ia = take((size_t)R * 2);      // ... and slot buffers
  L.ib = take(blk::sort_passes(depth) > 1 ? (size_t)R * 2 : 0);
  L.wc = take((size_t)blk::rank_counters(blk::sort_digits(depth)) * 4);
  L.bytes = at;
  return L;
}

// One block per row block: leaf ids to node_out, the row block's (g, h)
// per leaf to partial[blk, leaf] (dense) or rec[blk * R + slot] (compact).
template <bool COMPACT>
__global__ void __launch_bounds__(kThreads)
leaf_sort_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
                  const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ feat, const int* __restrict__ thr,
                  int* __restrict__ node_out, float2* __restrict__ partial,
                  int4* __restrict__ rec, int R, int n_feat, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LeafLayout L = leaf_layout(R, depth);
  const int S = leaf_slots(R);
  uint2* planes = reinterpret_cast<uint2*>(smem + L.planes);
  const blk::SortBufs sb{reinterpret_cast<int*>(smem + L.ka),
                         reinterpret_cast<int*>(smem + L.kb),
                         reinterpret_cast<unsigned short*>(smem + L.ia),
                         reinterpret_cast<unsigned short*>(smem + L.ib)};
  int* wc = reinterpret_cast<int*>(smem + L.wc);
  __shared__ int ws[32];
  __shared__ float4 wval[blk::kWarps];
  __shared__ int wflag[blk::kWarps];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long base = (long long)blockIdx.x * R;
  if (!COMPACT) {  // the dense row starts at 0: a leaf the block lacks adds 0
    const int n_leaves = 1 << depth;
    float2* row = partial + (long long)blockIdx.x * n_leaves;
    for (int i = tid; i < n_leaves; i += kThreads) row[i] = make_float2(0.0f, 0.0f);
  }
  // 1. Route (route_kernel's loads), write the leaf ids, stage keys and planes.
  for (int r = R + tid; r < S; r += kThreads) sb.kb[r] = -1;  // slots with no row
  for (int r0 = tid; r0 < R; r0 += kRows * kThreads) {
    int p[kRows], x[kRows], t[kRows];
    float gv[kRows], hv[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * kThreads;
      if (r < R) {
        p[u] = __ldcs(node_in + base + r);
        gv[u] = __ldcs(g + base + r);
        hv[u] = __ldcs(h + base + r);
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * kThreads;
      if (r < R) {
        t[u] = __ldg(thr + p[u]);
        x[u] = __ldcs(xb + (base + r) * n_feat + __ldg(feat + p[u]));
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const int r = r0 + u * kThreads;
      if (r < R) {
        const int leaf = 2 * p[u] + (x[u] > t[u] ? 1 : 0);
        node_out[base + r] = leaf;
        sb.kb[r] = leaf;
        planes[r] = make_uint2(blk::encode_bf16(gv[u]), blk::encode_bf16(hv[u]));
      }
    }
  }
  __syncthreads();
  // 2. The block's rows by leaf, stably.
  const int* keys;
  const unsigned short* slots;
  blk::sort_slots(S, depth, sb, wc, ws, keys, slots);
  // 3. Each run's sum.  Thread tid owns the sorted slots [i0, i0 + E) below
  // R (every row is kept: the sorted slots [0, R) hold the rows).
  auto emit = [=](int i, int k, float4 s) {
    const float gs = __fadd_rn(s.x, s.y), hs = __fadd_rn(s.z, s.w);
    if (COMPACT) {
      rec[base + i] = make_int4(k, (int)blockIdx.x, __float_as_int(gs), __float_as_int(hs));
    } else {
      partial[((long long)blockIdx.x << depth) + k] = make_float2(gs, hs);
    }
  };
  const int E = S / kThreads;
  const int i0 = tid * E;
  const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  float4 acc = zero, lead = zero;
  bool any_head = false;  // a run starts in this thread's slots
  int lead_end = -1;      // where the run carried in from the left ends, if here
  for (int e = 0; e < E; ++e) {
    const int i = i0 + e;
    if (i >= R) break;
    const int k = keys[i];
    const float4 v = unpack_bf16(planes[slots[i]]);
    if (i == 0 || keys[i - 1] != k) {
      acc = v;
      any_head = true;
    } else {
      acc = add4(acc, v);
    }
    if (i == R - 1 || keys[i + 1] != k) {
      if (any_head) {
        emit(i, k, acc);
      } else {
        lead = acc;
        lead_end = i;
      }
    } else if (COMPACT) {
      rec[base + i] = make_int4(-1, 0, 0, 0);  // a hole
    }
  }
  // Segmented inclusive scan of (any_head, acc) over the threads: a
  // thread's value restarts where a run starts in it.
  bool f = any_head;
  float4 v = acc;
  for (int o = 1; o < 32; o <<= 1) {
    const bool nf = __shfl_up_sync(blk::kFull, (int)f, o) != 0;
    const float4 nv = shfl_up4(v, o);
    if (lane >= o) {
      if (!f) v = add4(nv, v);
      f = f || nf;
    }
  }
  if (lane == 31) {
    wflag[w] = f;
    wval[w] = v;
  }
  __syncthreads();
  const bool pf = __shfl_up_sync(blk::kFull, (int)f, 1) != 0;
  const float4 pv = shfl_up4(v, 1);
  if (lead_end >= 0) {
    float4 carry = zero;  // the warps before this one, in order
    for (int u = 0; u < w; ++u) carry = wflag[u] ? wval[u] : add4(carry, wval[u]);
    if (lane > 0) carry = pf ? pv : add4(carry, pv);
    emit(lead_end, keys[i0], add4(carry, lead));
  }
}

// out[leaf] = sum over groups of kGroup row blocks, in group order, of the
// group's partial rows added in block order.  8 leaves a block; its 32
// thread rows take 32 groups at a time.
__global__ void __launch_bounds__(kThreads)
leaf_dense_merge_kernel(const float2* __restrict__ partial, float2* __restrict__ out,
                        int nb, int n_leaves) {
  __shared__ float2 sums[kThreads / 8][8];
  const int c = threadIdx.x & 7, j = threadIdx.x >> 3;
  const int leaf = blockIdx.x * 8 + c;
  const int n_groups = (nb + kGroup - 1) / kGroup;
  float2 total = make_float2(0.0f, 0.0f);
  for (int q0 = 0; q0 < n_groups; q0 += kThreads / 8) {
    const int q = q0 + j;
    float2 s = make_float2(0.0f, 0.0f);
    if (q < n_groups && leaf < n_leaves) {
      float2 v[kGroup];  // the group's loads all in flight before the adds
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int b = q * kGroup + u;
        if (b < nb) v[u] = partial[(long long)b * n_leaves + leaf];
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u)
        if (q * kGroup + u < nb) s = add2(s, v[u]);
    }
    sums[j][c] = s;
    __syncthreads();
    if (j == 0) {
      const int nq = min(kThreads / 8, n_groups - q0);
      for (int u = 0; u < nq; ++u) total = add2(total, sums[u][c]);
    }
    __syncthreads();
  }
  if (j == 0 && leaf < n_leaves) out[leaf] = total;
}

// The compact path's radix passes over records (leaf, block, g, h).  Tile
// t holds the slots [t * T, t * T + T) of the record list (T: the row block
// rounded up to a multiple of 256), up to *total records (total null: the
// list's n_slots slots, holes carry leaf -1).

// counts[d, t] (digit-major): tile t's records whose leaf has digit d at
// `shift`.
__global__ void __launch_bounds__(kThreads)
digit_count_kernel(const int4* __restrict__ rec, const int* __restrict__ total,
                   int* __restrict__ counts, int T, int shift, long long n_slots) {
  __shared__ int cnt[blk::kDigits];
  const int tid = threadIdx.x;
  cnt[tid] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * T;
  const long long n = total != nullptr ? *total : n_slots;
  for (int i = tid; i < T; i += kThreads) {
    if (base + i >= n) break;
    const int k = rec[base + i].x;
    if (k >= 0) atomicAdd(&cnt[(k >> shift) & (blk::kDigits - 1)], 1);
  }
  __syncthreads();
  counts[(long long)tid * gridDim.x + blockIdx.x] = cnt[tid];
}

// One block per digit d: rel[d, t] = the digit's records in tiles < t;
// tot[d] = all of them.
__global__ void __launch_bounds__(1024)
digit_scan_kernel(const int* __restrict__ counts, int* __restrict__ rel,
                  int* __restrict__ tot, int n_tiles) {
  __shared__ int ws[32];
  const int d = blockIdx.x;
  int rows = 0;
  for (int t0 = 0; t0 < n_tiles; t0 += 1024) {
    const int t = t0 + threadIdx.x;
    const int c = t < n_tiles ? counts[(long long)d * n_tiles + t] : 0;
    int s;
    const int x = rows + blk::block_scan(c, ws, s);
    rows += s;
    if (t < n_tiles) rel[(long long)d * n_tiles + t] = x;
  }
  if (threadIdx.x == 0) tot[d] = rows;
}

// Tile t's records to out, stably by their digit at `shift`: a record of
// digit d goes to (the records of lower digits) + rel[d, t] + its rank
// among the tile's records of digit d.  *total_out: the records listed.
// Dynamic shared memory: T ints (the tile's leaf ids).
__global__ void __launch_bounds__(kThreads)
digit_scatter_kernel(const int4* __restrict__ in, const int* __restrict__ total_in,
                     const int* __restrict__ rel, const int* __restrict__ tot,
                     int4* __restrict__ out, int* __restrict__ total_out, int T,
                     int shift, long long n_slots) {
  extern __shared__ int skey[];
  __shared__ int wc[blk::rank_counters(blk::kDigits)];
  __shared__ int ws[32];
  __shared__ int off[blk::kDigits];
  const int tid = threadIdx.x;
  int all;
  const int below = blk::block_scan(tot[tid], ws, all);
  off[tid] = below + rel[(long long)tid * gridDim.x + blockIdx.x];
  if (blockIdx.x == 0 && tid == 0) *total_out = all;
  const long long base = (long long)blockIdx.x * T;
  const long long n = total_in != nullptr ? *total_in : n_slots;
  for (int i = tid; i < T; i += kThreads) skey[i] = base + i < n ? in[base + i].x : -1;
  __syncthreads();
  blk::rank_pass(
      T, blk::kDigits,
      [=](int i) { return skey[i] < 0 ? -1 : (skey[i] >> shift) & (blk::kDigits - 1); },
      [=](int i, int p) { out[p] = in[base + i]; }, wc, ws, off);
}

// heads[0 .. *n_heads): the first record of each leaf in the sorted list,
// in no particular order (warp-aggregated integer atomics; each head's
// walk below is independent of where it is listed).
__global__ void __launch_bounds__(kThreads)
leaf_heads_kernel(const int4* __restrict__ rec, const int* __restrict__ total,
                  int* __restrict__ heads, int* __restrict__ n_heads) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n = *total;
  const bool head = i < n && (i == 0 || rec[i - 1].x != rec[i].x);
  const unsigned int lanes = __ballot_sync(blk::kFull, head);
  if (lanes == 0) return;
  const int lane = threadIdx.x & 31;
  int at = 0;
  if (lane == __ffs(lanes) - 1) at = atomicAdd(n_heads, __popc(lanes));
  at = __shfl_sync(blk::kFull, at, __ffs(lanes) - 1);
  if (head) heads[at + __popc(lanes & ((1u << lane) - 1u))] = (int)i;
}

// One thread per leaf head: walks the leaf's records (in block order) and
// writes out[leaf]: the sums of kGroup-block groups, each in block order,
// added in group order.  Only heads take a thread, so the walks run
// side by side.
__global__ void __launch_bounds__(kThreads)
leaf_merge_kernel(const int4* __restrict__ rec, const int* __restrict__ total,
                  const int* __restrict__ heads, const int* __restrict__ n_heads,
                  float2* __restrict__ out) {
  const long long hd = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (hd >= *n_heads) return;
  const long long n = *total;
  const long long i = heads[hd];
  const int k = rec[i].x;
  float2 sum = make_float2(0.0f, 0.0f), grp = sum;
  int q = rec[i].y / kGroup;
  constexpr int kAhead = 8;  // records loaded together: the walk's loads overlap
  bool more = true;
  for (long long j0 = i; more; j0 += kAhead) {
    int4 r[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      r[u] = j0 + u < n ? rec[j0 + u] : make_int4(-1, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      more = more && r[u].x == k;
      if (!more) continue;
      if (r[u].y / kGroup != q) {
        sum = add2(sum, grp);
        grp = make_float2(0.0f, 0.0f);
        q = r[u].y / kGroup;
      }
      grp = add2(grp, make_float2(__int_as_float(r[u].z), __int_as_float(r[u].w)));
    }
  }
  out[k] = add2(sum, grp);
}

// leaf_fit's scratch in one workspace (byte offsets, 256-byte aligned).
struct LeafWorkspace {
  size_t partial, rec_a, rec_b, counts, rel, tot, heads, totals, bytes;
};

// The row blocks' sums merge through compact records past 2R leaves (the
// dense partial would outgrow the rows' own bytes), from the shapes alone.
bool leaf_compact(int R, int depth) { return (1LL << depth) > 2LL * R; }

// Leaves the compact path can list: at most one a record slot.
long long leaf_heads_max(int nb, int R, int depth) {
  const long long slots = (long long)nb * R;
  return depth < 62 && (1LL << depth) < slots ? 1LL << depth : slots;
}

LeafWorkspace leaf_workspace(int nb, int R, int depth) {
  LeafWorkspace w{};
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at = (at + bytes + 255) & ~size_t(255);
    return here;
  };
  if (!leaf_compact(R, depth)) {
    w.partial = take((size_t)nb * ((size_t)1 << depth) * 8);
  } else {
    w.rec_a = take((size_t)nb * R * 16);
    w.rec_b = take((size_t)nb * R * 16);
    w.counts = take((size_t)nb * blk::kDigits * 4);
    w.rel = take((size_t)nb * blk::kDigits * 4);
    w.tot = take(blk::kDigits * 4);
    w.heads = take((size_t)leaf_heads_max(nb, R, depth) * 4);
    w.totals = take(3 * 4);  // the two passes' record counts, the heads
  }
  w.bytes = at;
  return w;
}

// leaf_fit's row-block pass: leaf_acc_kernel up to depth kAccDepth (dense
// partial), else leaf_sort_kernel (dense partial or compact records).
cudaError_t launch_leaf_blocks(const int* xb, const int* node_in, const float* g,
                               const float* h, const int* feat, const int* thr,
                               int* node_out, float2* partial, int4* rec, int nb, int R,
                               int n_feat, int depth, cudaStream_t s) {
  if (depth < kAccDepth) {  // at most 16 KB: under the 48 KB default
    leaf_acc_kernel<1><<<nb, kThreads, leaf_acc_smem(depth), s>>>(
        xb, node_in, g, h, feat, thr, node_out, partial, R, n_feat, depth);
    return cudaGetLastError();
  }
  if (depth == kAccDepth) {  // 32 KB
    leaf_acc_kernel<kRows><<<nb, kThreads, leaf_acc_smem(depth), s>>>(
        xb, node_in, g, h, feat, thr, node_out, partial, R, n_feat, depth);
    return cudaGetLastError();
  }
  const bool compact = rec != nullptr;
  const void* kern = compact ? (const void*)leaf_sort_kernel<true>
                             : (const void*)leaf_sort_kernel<false>;
  static blk::SmemLimit lim[2];
  const size_t smem = leaf_layout(R, depth).bytes;
  const cudaError_t e = blk::allow_smem(kern, smem, lim[compact]);
  if (e != cudaSuccess) return e;
  if (compact)
    leaf_sort_kernel<true><<<nb, kThreads, smem, s>>>(xb, node_in, g, h, feat, thr, node_out,
                                                      nullptr, rec, R, n_feat, depth);
  else
    leaf_sort_kernel<false><<<nb, kThreads, smem, s>>>(xb, node_in, g, h, feat, thr, node_out,
                                                       partial, nullptr, R, n_feat, depth);
  return cudaGetLastError();
}

template <bool MARGIN>
int launch_route(const int* xb, const int* node_in, const float* margin_in,
                 const int* feat, const int* thr, const float* leaf,
                 float* margin_out, int* node_out, long long n_rows, int n_feat,
                 cudaStream_t stream) {
  if (n_rows == 0) return 0;
  const long long blocks = (n_rows + kRouteTile - 1) / kRouteTile;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  route_kernel<MARGIN><<<(int)blocks, kThreads, 0, stream>>>(
      xb, node_in, margin_in, feat, thr, leaf, margin_out, node_out, n_rows,
      n_feat);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// node_out[r] = 2*node_in[r] + [xb[r, feat[p]] > thr[p]], p = node_in[r].
// xb [n_rows, n_feat] i32; node ids in [0, len(feat)).
int route_level(const int* xb, const int* node_in, const int* feat,
                const int* thr, int* node_out, long long n_rows, int n_feat,
                void* stream) {
  return launch_route<false>(xb, node_in, nullptr, feat, thr, nullptr, nullptr,
                             node_out, n_rows, n_feat, (cudaStream_t)stream);
}

// route_level, then margin_out[r] = margin_in[r] + leaf[node_out[r]].
int route_margin_level(const int* xb, const int* node_in,
                       const float* margin_in, const int* feat, const int* thr,
                       const float* leaf, float* margin_out, int* node_out,
                       long long n_rows, int n_feat, void* stream) {
  return launch_route<true>(xb, node_in, margin_in, feat, thr, leaf, margin_out,
                            node_out, n_rows, n_feat, (cudaStream_t)stream);
}

// Shared memory of one leaf_fit row-block kernel (bytes): at most 32 KB
// up to depth kAccDepth, then growing with R, not with the depth past 8.
long long leaf_smem_bytes(int R, int depth) {
  return (long long)(depth <= kAccDepth ? leaf_acc_smem(depth) : leaf_layout(R, depth).bytes);
}

// Bytes of leaf_fit's workspace: up to 2R leaves a [nb, 2**depth] float2
// partial; past that two lists of nb * R records and the radix passes'
// counters.
long long leaf_workspace_bytes(int nb, int R, int depth) {
  return (long long)leaf_workspace(nb, R, depth).bytes;
}

// node_out[r] = 2*node_in[r] + [xb[r, feat[p]] > thr[p]] (the leaf id) and
// out[leaf] = (sum g, sum h) over the leaf's rows in the bf16 hi/lo planes.
// xb (nb, R, n_feat) i32 (R a multiple of 128); node_in, node_out (nb, R)
// i32; g, h (nb, R) f32; feat/thr [2**(depth-1)] i32; ws
// leaf_workspace_bytes; out [2**depth, 2] f32.
int leaf_fit(const int* xb, const int* node_in, const float* g, const float* h,
             const int* feat, const int* thr, int* node_out, void* ws, float* out,
             int nb, int R, int n_feat, int depth, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (nb == 0) return 0;
  const LeafWorkspace w = leaf_workspace(nb, R, depth);
  char* base = (char*)ws;
  float2* out2 = reinterpret_cast<float2*>(out);
  cudaError_t e;
  if (!leaf_compact(R, depth)) {
    float2* partial = (float2*)(base + w.partial);
    e = launch_leaf_blocks(xb, node_in, g, h, feat, thr, node_out, partial, nullptr,
                                  nb, R, n_feat, depth, s);
    if (e != cudaSuccess) return (int)e;
    const int n_leaves = 1 << depth;
    leaf_dense_merge_kernel<<<(n_leaves + 7) / 8, kThreads, 0, s>>>(partial, out2, nb,
                                                                   n_leaves);
    return (int)cudaGetLastError();
  }
  const int T = leaf_slots(R);  // the radix passes' tile
  const long long slots = (long long)nb * R;
  const int n_tiles = (int)((slots + T - 1) / T);
  static blk::SmemLimit lim;
  e = blk::allow_smem((const void*)digit_scatter_kernel, (size_t)T * 4, lim);
  if (e != cudaSuccess) return (int)e;
  int4* in = (int4*)(base + w.rec_a);
  int4* nxt = (int4*)(base + w.rec_b);
  int* counts = (int*)(base + w.counts);
  int* rel = (int*)(base + w.rel);
  int* tot = (int*)(base + w.tot);
  int* totals = (int*)(base + w.totals);
  e = launch_leaf_blocks(xb, node_in, g, h, feat, thr, node_out, nullptr, in, nb, R,
                               n_feat, depth, s);
  if (e != cudaSuccess) return (int)e;
  const int* total_in = nullptr;  // the first pass reads every slot
  for (int p = 0; p < blk::sort_passes(depth); ++p) {
    const int shift = p * blk::kDigitBits;
    int* total_out = totals + (p & 1);
    digit_count_kernel<<<n_tiles, kThreads, 0, s>>>(in, total_in, counts, T, shift, slots);
    digit_scan_kernel<<<blk::kDigits, 1024, 0, s>>>(counts, rel, tot, n_tiles);
    digit_scatter_kernel<<<n_tiles, kThreads, (size_t)T * 4, s>>>(
        in, total_in, rel, tot, nxt, total_out, T, shift, slots);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    int4* t = in;
    in = nxt;
    nxt = t;
    total_in = total_out;
  }
  e = cudaMemsetAsync(out, 0, ((size_t)1 << depth) * 8, s);
  if (e == cudaSuccess) e = cudaMemsetAsync(totals + 2, 0, 4, s);
  if (e != cudaSuccess) return (int)e;
  int* heads = (int*)(base + w.heads);
  leaf_heads_kernel<<<(unsigned int)((slots + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      in, total_in, heads, totals + 2);
  const long long most = leaf_heads_max(nb, R, depth);
  leaf_merge_kernel<<<(unsigned int)((most + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      in, total_in, heads, totals + 2, out2);
  return (int)cudaGetLastError();
}

}  // extern "C"
