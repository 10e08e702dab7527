// Gradient histograms of a GBDT boosting round:
//   hist[m, f, b, 0/1] = sum_r [node'_r == m][xb[r, f] == b] * (g_r, h_r)
// where node' is, by mode,
//   root:  0;
//   route: one level down, 2*node + [xb[r, feat[node]] > thr[node]]
//          (written out as well);
//   nodes: the node ids given (no routing, no node output; ids outside
//          [0, n_nodes) add nothing),
// in either encoding of the gradients:
//   bf16: g and h split into hi/lo bfloat16 planes (hi = bf16(v),
//         lo = bf16(v - hi), round to nearest even), each plane summed in
//         f32, hist = hi + lo;
//   i8:   per row block of R rows, x = v * (1/scale) with scale =
//         max(|g|, |h|) over the block's counted rows (floored at the
//         smallest normal f32), planes a = rint(64x), b = rint((x - a/64) *
//         8192) summed in exact int32, decoded once per (row block, node,
//         feature, bin) as (a/64 + b/8192) * scale and added to an f32
//         total in row-block order.
//
// Replaces rabit_tpu/ops/boost.py hist_level0 (_level0_kernel) and
// hist_level (_level_kernel), which share _accum, _gradient_matrix,
// _encode_bf16, _encode_i8 and _route, and rabit_tpu/ops/hist.py
// node_histograms_pallas (_hist_kernel), which reads the node ids.
//
// Bound on an H100: device memory.  The pass must read xb (4*F bytes a
// row), g, h and the node id, and write the new node id (route mode); the
// histogram is n_nodes * F * B * 2 floats.  Every row's work is F compares
// into one bin each: far below the card's arithmetic rate.
//
// Design (the layout of XGBoost's gpu_hist, rethought for this card).  The
// TPU kernel keeps the whole (nodes x F*B) histogram resident in VMEM while
// row blocks stream through; a CUDA block has 227 KB of shared memory and
// blocks run in no order.  So the rows are routed once, partitioned by
// node, and histogrammed in feature tiles whose accumulators do not depend
// on the depth:
//
// 1. prep (one block per row block, threads over rows, coalesced): route
//    the row (route mode, node' written out), count the block's rows per
//    node, and take the block's i8 scale.  A counted row lies below n_rows
//    and has its id in [0, n_nodes); only counted rows enter the scale.
//    Up to kMaxNodes nodes the counts can gather in shared memory; on the
//    "large" path (any node count; the wrapper takes it past 256 nodes,
//    where it is the faster) warp leaders add them to device memory.
// 2. partition: scan_nodes (one block per node) scans the counts over the
//    row blocks, giving each (row block, node) run its start inside the
//    node's segment, and marks the runs that open a chunk: the first run
//    of a node and each run that holds a row whose in-node position is a
//    multiple of C.  scan_base scans the node totals and chunk counts.
//    scatter (one block per row block) ranks the block's counted rows per
//    node, stably (per-warp counts scanned in warp order, lane ranks from
//    __match_any_sync), places them in shared memory in output order and
//    writes each node's run out contiguously: the row index to perm and
//    the encoded planes beside it (4 x bf16 in 8 bytes, or 2 x 2 int8 in
//    4 bytes); it also writes the chunk table.  Its per-warp node counters
//    and a row block's slots must fit in shared memory ((8 n_nodes + 2 R)
//    ints); on the large path scatter_sort ranks the block's rows by a
//    block-local stable radix sort of their node ids (block_sort.cuh),
//    whose shared memory grows with R alone (12 B a row), and gives the
//    same partition.  Either takes row blocks of any multiple of 128 rows
//    up to 16384.  counts, rel and hid stay [nb, n_nodes] in device
//    memory: 4 bytes a (row block, node) each.  Each node's rows then lie
//    contiguous and in row order; every chunk lies inside one node, starts
//    on a row-block run and holds about C rows, so a node with 90% of the
//    rows spreads over many blocks.  There are at most ceil(n_rows / C) +
//    n_nodes chunks: grids and buffers are sized from the shapes, blocks
//    past the chunk count exit, and nothing is read back to the host.  In
//    root mode the partition is the identity: no perm is written.
// 3. tile_hist (grid: feature tile x bin window x chunk): a block of T =
//    min(F, 4) warps owns T features of one chunk, one warp each, and keeps
//    only their accumulators for one window of 256 bins (T x 256 bins x 16
//    bytes, + f32 totals in i8), whatever the depth and the bin count.  Up
//    to 256 bins there is one window; past that each window's blocks stage
//    the chunk's rows again and skip the rows whose bin lies outside their
//    window (as they skip bins out of range), so a window's sums run in the
//    same order as with one window, and the rows' bytes are read once a
//    window.  It stages the chunk's rows through a ring of
//    kStages stages of 128 rows with cp.async: per row the 16-byte slice of
//    its feature tile (4-byte copies where the slice is not 16-byte
//    aligned) and its planes, so the next stages' loads overlap this one's
//    sums; one __syncthreads a stage, none a row.  Each warp walks a stage
//    32 rows at a time in row order.  bf16: the lanes that share a bin are
//    found with a shared-memory atomicOr mask (the set __match_any_sync
//    would give, much cheaper on this card); the lowest of them adds their
//    planes in lane order, then into the warp's accumulator.  i8: the
//    int32 sums of one row block are decoded together: a block's run of
//    rows that lies within a warp step is summed by its lane groups'
//    leaders and decoded at once; a run that spans steps is added with
//    shared integer atomics (exact in any order) and decoded, for the bins
//    it touched, when it ends, at the block's scale staged with each row.
// 4. sum_chunks: each node's chunk partials added in chunk order (zeros
//    for an empty node).
//
// hist_build runs the three steps as one host call into one workspace.
//
// There are no float atomics (the integer atomics are order-free), and
// every float sum runs in an order fixed by the data and the shapes, not
// by the SM count: the result is bitwise the same on repeat.
// The TPU kernel's r_split (a Mosaic scheduling experiment) has no
// counterpart, nor do the padding of bins to 128 lanes, the 1792-lane
// feature groups or the i32-wide compare.  Rows are addressed as (block * R
// + r) * F, so a pre-blocked (nb, R, F) matrix and an unblocked [n, F] one
// are the same bytes.
//
// Floating-point steps use __fmul_rn / __fadd_rn / __fsub_rn so that nvcc
// cannot contract them into FMAs, which would round differently from the
// reference.

#include <cuda_runtime.h>

#include <type_traits>

#include "block_sort.cuh"

namespace {

constexpr int kThreads = 256;        // prep and scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kScanThreads = 1024;   // scan blocks
constexpr int kMaxTile = 4;          // features of a tile_hist block, a warp each
                                     // (wider tiles ran slower on the card)
constexpr int kStageRows = 128;      // rows a stage holds
constexpr int kStages = 3;
constexpr int kBins = 256;           // accumulator rows a warp: one window of bins
constexpr int kMaxNodes = 4096;      // prep's shared-memory counts and split tables
constexpr size_t kSmemMax = 232448;  // shared memory one H100 block may use
constexpr float kTiny = 1.1754944e-38f;  // smallest normal f32
enum Mode { kRoot = 0, kRoute = 1, kNodes = 2 };

__device__ inline float decode_i8(int hi, int lo, float scale) {
  return __fmul_rn(__fadd_rn(__fmul_rn((float)hi, 0.015625f),
                             __fmul_rn((float)lo, 1.0f / 8192.0f)),
                   scale);
}

__device__ inline unsigned int encode_i8(float v, float inv) {
  // a = rint(64 x), b = rint((x - a/64) * 8192), packed as two int8 bytes.
  const float x = __fmul_rn(v, inv);
  const float a = rintf(__fmul_rn(x, 64.0f));
  const float b = rintf(__fmul_rn(__fsub_rn(x, __fmul_rn(a, 0.015625f)), 8192.0f));
  return ((unsigned int)(int)a & 0xffu) | (((unsigned int)(int)b & 0xffu) << 8);
}

using blk::block_scan;
using blk::encode_bf16;
using blk::kFull;

// -- 1. prep --------------------------------------------------------------------

// counts[blk, m]: the block's counted rows of node m; node_out (route);
// scale[blk] (i8): max(|g|, |h|) over the block's counted rows, floored at
// the smallest normal f32.  LARGE false (at most kMaxNodes nodes): the
// counts are taken in shared memory and the split tables staged there:
// dynamic shared memory (n_nodes + 2 * n_prev) ints.  LARGE (any node
// count): the tables are read where they lie, through L1, and each warp's
// leader for a node adds to counts in device memory (zeroed first; integer
// atomics, exact in any order): no shared memory grows with the nodes.
template <bool I8, int MODE, bool LARGE>
__global__ void __launch_bounds__(kThreads)
prep_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
            const float* __restrict__ g, const float* __restrict__ h,
            const int* __restrict__ feat, const int* __restrict__ thr,
            int* __restrict__ node_out, int* __restrict__ counts,
            float* __restrict__ scale, long long n_rows, int R, int F,
            int n_nodes, int n_prev) {
  extern __shared__ int psm[];
  int* cnt = psm;
  int* ft = psm + n_nodes;
  int* tt = ft + n_prev;
  __shared__ float red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31;
  if constexpr (!LARGE) {
    for (int i = tid; i < n_nodes; i += kThreads) cnt[i] = 0;
    for (int i = tid; i < n_prev; i += kThreads) {
      ft[i] = feat[i];
      tt[i] = thr[i];
    }
    __syncthreads();
  }
  auto split_feat = [&](int p) { return LARGE ? __ldg(feat + p) : ft[p]; };
  auto split_thr = [&](int p) { return LARGE ? __ldg(thr + p) : tt[p]; };
  const long long base = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, n_rows - base);
  float m = 0.0f;
  // R is a multiple of 32 (the wrappers take multiples of 128), so the
  // lanes of a warp make the same passes and the warp-wide match below sees
  // every lane; at R = 128 the last four warps make none.
  for (int r0 = tid; r0 < R; r0 += 4 * kThreads) {
    int key[4], x[4];
    float gv[4], hv[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + u * kThreads;
      key[u] = -1, gv[u] = 0.0f, hv[u] = 0.0f;
      if (r < valid) {
        key[u] = MODE == kRoot ? 0 : node_in[base + r];
        if (I8) {
          gv[u] = g[base + r];
          hv[u] = h[base + r];
        }
      }
    }
    if (MODE == kRoute) {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (r0 + u * kThreads < valid)
          x[u] = xb[(base + r0 + u * kThreads) * F + split_feat(key[u])];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u * kThreads;
        if (r < valid) {
          key[u] = 2 * key[u] + (x[u] > split_thr(key[u]) ? 1 : 0);
          node_out[base + r] = key[u];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const bool counted = (unsigned int)key[u] < (unsigned int)n_nodes;
      const int k = counted ? key[u] : -1;
      const unsigned int peers = __match_any_sync(kFull, k);
      if (counted && lane == __ffs(peers) - 1) {
        if constexpr (LARGE) {
          atomicAdd(&counts[(long long)blockIdx.x * n_nodes + k], __popc(peers));
        } else {
          atomicAdd(&cnt[k], __popc(peers));
        }
      }
      if (I8 && counted) m = fmaxf(m, fmaxf(fabsf(gv[u]), fabsf(hv[u])));
    }
  }
  __syncthreads();
  if constexpr (!LARGE) {
    for (int i = tid; i < n_nodes; i += kThreads)
      counts[(long long)blockIdx.x * n_nodes + i] = cnt[i];
  }
  if (I8) {
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    if (lane == 0) red[tid >> 5] = m;
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
      scale[blockIdx.x] = fmaxf(m, kTiny);
    }
  }
}

// -- 2. partition ------------------------------------------------------------------

// One block per node m: rel[blk, m] = the node's rows in blocks < blk;
// hid[blk, m] = the run's chunk index inside the node if it opens a chunk,
// else -1; node_total[m], node_heads[m].
__global__ void __launch_bounds__(kScanThreads)
scan_nodes_kernel(const int* __restrict__ counts, int* __restrict__ rel,
                  int* __restrict__ hid, int* __restrict__ node_total,
                  int* __restrict__ node_heads, int nb, int n_nodes,
                  long long C) {
  __shared__ int ws[32];
  const int m = blockIdx.x;
  int rows = 0, heads = 0;
  for (int b0 = 0; b0 < nb; b0 += kScanThreads) {
    const int b = b0 + threadIdx.x;
    const int c = b < nb ? counts[(long long)b * n_nodes + m] : 0;
    int tot;
    const long long s = rows + block_scan(c, ws, tot);
    rows += tot;
    const int head = c > 0 && (s + C - 1) / C * C < s + c;
    const int hx = heads + block_scan(head, ws, tot);
    heads += tot;
    if (b < nb) {
      rel[(long long)b * n_nodes + m] = (int)s;
      hid[(long long)b * n_nodes + m] = head ? hx : -1;
    }
  }
  if (threadIdx.x == 0) {
    node_total[m] = rows;
    node_heads[m] = heads;
  }
}

// One block: node_base[m] (first position of node m's segment) and
// node_chunk0[m] (its first chunk), m <= n_nodes: the last entries hold
// the counted rows and the chunk count.
__global__ void __launch_bounds__(kScanThreads)
scan_base_kernel(const int* __restrict__ node_total,
                 const int* __restrict__ node_heads, int* __restrict__ node_base,
                 int* __restrict__ node_chunk0, int n_nodes) {
  __shared__ int ws[32];
  int rows = 0, chunks = 0;
  for (int m0 = 0; m0 < n_nodes; m0 += kScanThreads) {
    const int m = m0 + threadIdx.x;
    int tot;
    const int r = rows + block_scan(m < n_nodes ? node_total[m] : 0, ws, tot);
    rows += tot;
    const int c = chunks + block_scan(m < n_nodes ? node_heads[m] : 0, ws, tot);
    chunks += tot;
    if (m < n_nodes) {
      node_base[m] = r;
      node_chunk0[m] = c;
    }
  }
  if (threadIdx.x == 0) {
    node_base[n_nodes] = rows;
    node_chunk0[n_nodes] = chunks;
  }
}

// One block per row block: perm[pos] = row and planes[pos] = its encoded
// (g, h) for each counted row, pos = its node's base + its rank among the
// node's rows in row order; chunk_begin for the runs that open a chunk.
// key null: root (every row below n_rows is node 0, perm not written).
// The block's rows are first placed in shared memory in their output
// order (node by node), then written out in that order, so a node's run of
// rows goes out as consecutive addresses.  Dynamic shared memory:
// (kWarps + 1) * n_nodes + 2 * R ints.  Each warp walks whole warp steps of
// its segment of the rows (R / 8 rounded up to 32: at R = 128 the last four
// warps hold no row).
template <bool I8>
__global__ void __launch_bounds__(kThreads)
scatter_kernel(const int* __restrict__ key_in, const float* __restrict__ g,
               const float* __restrict__ h, const float* __restrict__ scale,
               const int* __restrict__ rel, const int* __restrict__ hid,
               const int* __restrict__ node_base,
               const int* __restrict__ node_chunk0, int* __restrict__ chunk_begin,
               int* __restrict__ perm, unsigned int* __restrict__ planes,
               long long n_rows, int R, int n_nodes) {
  extern __shared__ int wcnt[];  // [warp][node]: counts, then next positions
  int* shift = wcnt + kWarps * n_nodes;  // [node]: output position -> slot
  int* srow = shift + n_nodes;           // [slot]: the row, in output order
  int* spos = srow + R;                  // [slot]: its output position
  __shared__ int ws[32];
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const long long base = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, n_rows - base);
  const int seg = (R / kWarps + 31) & ~31;  // whole warp steps; rows past R add nothing
  int* mine = wcnt + w * n_nodes;
  for (int i = tid; i < kWarps * n_nodes; i += kThreads) wcnt[i] = 0;
  __syncthreads();
  auto key_of = [&](int r) {
    if (r >= valid) return -1;
    const int k = key_in == nullptr ? 0 : key_in[base + r];
    return (unsigned int)k < (unsigned int)n_nodes ? k : -1;
  };
  for (int r = w * seg + lane; r < (w + 1) * seg; r += 32) {
    const int k = key_of(r);
    const unsigned int peers = __match_any_sync(kFull, k);
    if (k >= 0 && lane == __ffs(peers) - 1) mine[k] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per node: each warp's first output position, and the slot shift.
  const long long blk_nodes = (long long)blockIdx.x * n_nodes;
  int slots = 0;
  for (int m0 = 0; m0 < n_nodes; m0 += kThreads) {
    const int m = m0 + tid;
    int p0 = 0, run = 0;
    if (m < n_nodes) {
      p0 = node_base[m] + rel[blk_nodes + m];
      run = p0;
      for (int v = 0; v < kWarps; ++v) {
        const int t = wcnt[v * n_nodes + m];
        wcnt[v * n_nodes + m] = run;
        run += t;
      }
      const int hd = hid[blk_nodes + m];
      if (hd >= 0) chunk_begin[node_chunk0[m] + hd] = p0;
    }
    int tot;
    const int slot0 = slots + block_scan(run - p0, ws, tot);
    slots += tot;
    if (m < n_nodes) shift[m] = slot0 - p0;
  }
  __syncthreads();
  for (int r = w * seg + lane; r < (w + 1) * seg; r += 32) {
    const int k = key_of(r);
    const unsigned int peers = __match_any_sync(kFull, k);
    if (k >= 0) {
      const int pos = mine[k] + __popc(peers & ((1u << lane) - 1u));
      srow[pos + shift[k]] = r;
      spos[pos + shift[k]] = pos;
    }
    __syncwarp();
    if (k >= 0 && lane == __ffs(peers) - 1) mine[k] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  const float inv = I8 ? __fdiv_rn(1.0f, scale[blockIdx.x]) : 0.0f;
  for (int i = tid; i < slots; i += kThreads) {
    const int r = srow[i], pos = spos[i];
    const float gv = g[base + r], hv = h[base + r];
    if (key_in != nullptr) perm[pos] = (int)(base + r);
    if (I8) {
      planes[pos] = encode_i8(gv, inv) | (encode_i8(hv, inv) << 16);
    } else {
      reinterpret_cast<uint2*>(planes)[pos] = make_uint2(encode_bf16(gv), encode_bf16(hv));
    }
  }
}

// Slots the block sort ranks for a row block of R rows: R rounded up to a
// multiple of 256 (the sort's warps walk whole warp steps; the extra slots
// hold no row).
__host__ __device__ inline int sort_slots_of(int R) { return (R + 255) & ~255; }

// Shared memory of a scatter_sort_kernel block: two key and two slot
// buffers of sort_slots_of(R) entries (csrc/block_sort.cuh) and the digit
// counters: 204 KB at R = 16384.
__host__ __device__ inline size_t scatter_sort_smem_bytes(int R) {
  return (size_t)sort_slots_of(R) * (4 + 4 + 2 + 2) +
         (size_t)blk::rank_counters(blk::kDigits) * 4;
}

// scatter_kernel's outputs for any node count, with shared memory bounded
// by the row block: the block's counted rows are sorted by node (a stable
// LSD radix sort over the node ids' `bits` bits, block_sort.cuh), so each
// node's rows form a run in row order.  A row's place is node_base[m] +
// rel[blk, m] + its rank in the run, whose start a binary search over the
// sorted ids finds; the run's first row writes the chunk_begin entry.
// Consecutive threads take consecutive sorted rows, so a node's run goes
// out as consecutive addresses, as in scatter_kernel.  Dynamic shared
// memory: scatter_sort_smem_bytes(R).
template <bool I8>
__global__ void __launch_bounds__(kThreads)
scatter_sort_kernel(const int* __restrict__ key_in, const float* __restrict__ g,
                    const float* __restrict__ h, const float* __restrict__ scale,
                    const int* __restrict__ rel, const int* __restrict__ hid,
                    const int* __restrict__ node_base,
                    const int* __restrict__ node_chunk0, int* __restrict__ chunk_begin,
                    int* __restrict__ perm, unsigned int* __restrict__ planes,
                    long long n_rows, int R, int n_nodes, int bits) {
  extern __shared__ __align__(16) unsigned char ssm[];
  const int S = sort_slots_of(R);
  const blk::SortBufs sb{reinterpret_cast<int*>(ssm),
                         reinterpret_cast<int*>(ssm + (size_t)S * 4),
                         reinterpret_cast<unsigned short*>(ssm + (size_t)S * 8),
                         reinterpret_cast<unsigned short*>(ssm + (size_t)S * 10)};
  int* wc = reinterpret_cast<int*>(ssm + (size_t)S * 12);
  __shared__ int ws[32];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, n_rows - base);
  for (int r = tid; r < S; r += kThreads) {
    int k = r < valid ? key_in[base + r] : -1;
    sb.kb[r] = (unsigned int)k < (unsigned int)n_nodes ? k : -1;
  }
  __syncthreads();
  const int* keys;
  const unsigned short* slots;
  const int kept = blk::sort_slots(S, bits, sb, wc, ws, keys, slots);
  const float inv = I8 ? __fdiv_rn(1.0f, scale[blockIdx.x]) : 0.0f;
  const long long blk_nodes = (long long)blockIdx.x * n_nodes;
  for (int j = tid; j < kept; j += kThreads) {
    const int m = keys[j], r = slots[j];
    const int start = blk::lower_bound(keys, kept, m);
    const int p0 = node_base[m] + rel[blk_nodes + m];
    if (j == start) {
      const int hd = hid[blk_nodes + m];
      if (hd >= 0) chunk_begin[node_chunk0[m] + hd] = p0;
    }
    const int pos = p0 + (j - start);
    const float gv = g[base + r], hv = h[base + r];
    perm[pos] = (int)(base + r);
    if (I8) {
      planes[pos] = encode_i8(gv, inv) | (encode_i8(hv, inv) << 16);
    } else {
      reinterpret_cast<uint2*>(planes)[pos] = make_uint2(encode_bf16(gv), encode_bf16(hv));
    }
  }
}

// -- 3. tile_hist ---------------------------------------------------------------------

__device__ inline void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned int)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ inline void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   (unsigned int)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ inline void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned int)__cvta_generic_to_shared(dst)), "l"(src));
}
__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ inline void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ inline float4 unpack_bf16(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

__device__ inline float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y), __fadd_rn(a.z, b.z),
                     __fadd_rn(a.w, b.w));
}

__device__ inline int4 unpack_i8(unsigned int v) {
  return make_int4((int)(signed char)(v & 0xff), (int)(signed char)((v >> 8) & 0xff),
                   (int)(signed char)((v >> 16) & 0xff), (int)(signed char)(v >> 24));
}

// Shared memory of a tile_hist block: T = min(F, kMaxTile) features, the
// staged slice of a row padded to T4 (a multiple of 4) ints.
struct TileLayout {
  int T, T4;
  size_t xs, pl, sblk, ssc, acc, total, lanes, touched, bytes;
};

__host__ __device__ inline TileLayout tile_layout(int F, bool i8) {
  TileLayout L;
  L.T = F < kMaxTile ? F : kMaxTile;
  L.T4 = (L.T + 3) & ~3;
  size_t at = 0;
  auto take = [&at](size_t bytes) {
    const size_t here = at;
    at = (at + bytes + 15) & ~size_t(15);
    return here;
  };
  const size_t rows = (size_t)kStages * kStageRows;
  L.xs = take(rows * L.T4 * 4);                      // bins, a row's slice
  L.pl = take(rows * (i8 ? 4 : 8));                  // encoded planes
  L.sblk = take(i8 ? rows * 4 : 0);                  // i8: each row's block
  L.ssc = take(i8 ? rows * 4 : 0);                   // ... and its scale
  L.acc = take((size_t)L.T * kBins * 16);            // float4 / int4 a bin
  L.total = take(i8 ? (size_t)L.T * kBins * 8 : 0);  // i8: f32 totals
  L.lanes = take((size_t)L.T * kBins * 4);           // peer masks
  L.touched = take(i8 ? (size_t)L.T * kBins / 8 : 0);  // i8: touched bins
  L.bytes = at;
  return L;
}

// partial[c, f, b, 0/1] for chunk c (one node's rows [chunk_begin[c],
// next chunk's begin) of the partitioned order) and the T features of
// blockIdx.x, a warp each.  Consecutive threads copy consecutive 16-byte
// pieces of a row's slice.  PERM: rows through perm (else the identity);
// VEC: the slice is 16-byte aligned (F % 4 == 0).
template <bool I8, bool PERM, bool VEC>
__global__ void __launch_bounds__(kMaxTile * 32)
tile_hist_kernel(const int* __restrict__ xb, const int* __restrict__ perm,
                 const unsigned int* __restrict__ planes,
                 const float* __restrict__ scale,
                 const int* __restrict__ chunk_begin,
                 const int* __restrict__ node_base,
                 const int* __restrict__ node_chunk0, float* __restrict__ partial,
                 int R, int F, int n_bins, int n_nodes) {
  using Plane = typename std::conditional<I8, unsigned int, uint2>::type;
  extern __shared__ __align__(16) unsigned char tsm[];
  const TileLayout L = tile_layout(F, I8);
  const int T = L.T, T4 = L.T4, cpr = T4 / 4;  // cpr: 16-byte pieces a row
  int* xs = reinterpret_cast<int*>(tsm + L.xs);          // [stage row][T4]
  Plane* pl = reinterpret_cast<Plane*>(tsm + L.pl);      // [stage row]
  int* sblk = reinterpret_cast<int*>(tsm + L.sblk);
  float* ssc = reinterpret_cast<float*>(tsm + L.ssc);

  // Block x: feature tile x % n_tiles, bin window x / n_tiles % n_win, of
  // chunk x / (n_tiles * n_win) (the blocks of one chunk launch together,
  // as a grid of (tiles, windows, chunks) would).  The window holds the
  // bins [w0, w0 + width).
  const int n_tiles = (F + T - 1) / T;
  const int n_win = (n_bins + kBins - 1) / kBins;
  const int c = blockIdx.x / (n_tiles * n_win);
  const int n_chunks = node_chunk0[n_nodes];
  if (c >= n_chunks) return;  // the grid holds the most chunks the shapes allow
  const int begin = chunk_begin[c];
  const int end = c + 1 < n_chunks ? chunk_begin[c + 1] : node_base[n_nodes];
  const int f0 = (blockIdx.x % n_tiles) * T;
  const int w0 = (int)(blockIdx.x / n_tiles % n_win) * kBins;
  const int width = min(kBins, n_bins - w0);
  const int tw = min(T, F - f0);
  const int nt = blockDim.x;
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int f = f0 + w;
  float4* accf = reinterpret_cast<float4*>(tsm + L.acc) + w * kBins;  // this warp's
  int4* acci = reinterpret_cast<int4*>(tsm + L.acc) + w * kBins;
  float2* total = reinterpret_cast<float2*>(tsm + L.total) + w * kBins;
  unsigned int* lanes = reinterpret_cast<unsigned int*>(tsm + L.lanes) + w * kBins;
  unsigned int* touched = reinterpret_cast<unsigned int*>(tsm + L.touched) + w * (kBins / 32);
  for (int i = lane; i < kBins; i += 32) {
    if constexpr (I8) {
      acci[i] = make_int4(0, 0, 0, 0);
      total[i] = make_float2(0.0f, 0.0f);
    } else {
      accf[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
    lanes[i] = 0;
  }
  if constexpr (I8) {
    if (lane < kBins / 32) touched[lane] = 0;
  }

  auto row_of = [&](int k) { return PERM ? perm[k] : k; };
  // Copy i of stage st: piece i % cpr of the stage's row i / cpr, row r.
  auto issue_one = [&](int st, int i, int r) {
    const int sr = (st % kStages) * kStageRows + i / cpr, j = i % cpr;
    const int* src = xb + (long long)r * F + f0 + 4 * j;
    if (4 * j >= tw) {
      // past the last feature of a short last tile: nothing to copy
    } else if (VEC) {
      cp_async16(&xs[sr * T4 + 4 * j], src);
    } else {
      for (int q = 0; q < 4 && 4 * j + q < tw; ++q) cp_async4(&xs[sr * T4 + 4 * j + q], src + q);
    }
    if (j == 0) {
      const int k = begin + st * kStageRows + i / cpr;
      if constexpr (I8) {
        cp_async4(&pl[sr], planes + k);
        cp_async4(&ssc[sr], scale + r / R);
        sblk[sr] = r / R;
      } else {
        cp_async8(&pl[sr], reinterpret_cast<const uint2*>(planes) + k);
      }
    }
  };
  // Stage st's copies; the row of this thread's first copy comes in r0
  // (loaded a stage ahead).
  const int copies = kStageRows * cpr;
  auto issue = [&](int st, int r0) {
    for (int i = tid; i < copies; i += nt) {
      const int k = begin + st * kStageRows + i / cpr;
      if (k >= end) break;
      issue_one(st, i, i == tid ? r0 : row_of(k));
    }
  };
  auto first_row = [&](int st) {
    const int k = begin + st * kStageRows + tid / cpr;
    return tid < copies && k < end ? row_of(k) : 0;
  };

  const int n = end - begin;
  const int n_st = (n + kStageRows - 1) / kStageRows;
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st) issue(st, first_row(st));
    cp_async_commit();
  }
  int r_next = first_row(kStages - 1);

  int cur_blk = -1;      // i8: the row block whose int sums the warp holds
  float cur_sc = 0.0f;   // ... and its scale
  auto flush = [&]() {   // i8: decode the touched bins of block cur_blk
    __syncwarp();
    const uint4 t0 = *reinterpret_cast<const uint4*>(touched);
    const uint4 t1 = *reinterpret_cast<const uint4*>(touched + 4);
    const unsigned int tw8[8] = {t0.x, t0.y, t0.z, t0.w, t1.x, t1.y, t1.z, t1.w};
#pragma unroll
    for (int j = 0; j < kBins / 32; ++j) {
      if ((tw8[j] >> lane) & 1u) {
        const int b = j * 32 + lane;
        const int4 a = acci[b];
        const float2 t = total[b];
        total[b] = make_float2(__fadd_rn(t.x, decode_i8(a.x, a.y, cur_sc)),
                               __fadd_rn(t.y, decode_i8(a.z, a.w, cur_sc)));
        acci[b] = make_int4(0, 0, 0, 0);
      }
    }
    __syncwarp();
    if (lane < kBins / 32) touched[lane] = 0;
    __syncwarp();
  };

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage st has landed; stage st - 1's buffer is free
    if (st + kStages - 1 < n_st) issue(st + kStages - 1, r_next);
    cp_async_commit();
    r_next = first_row(st + kStages);
    if (f >= F) continue;  // a warp past the last feature only stages
    const int base = (st % kStages) * kStageRows;
    const int rows = min(kStageRows, end - (begin + st * kStageRows));
#pragma unroll 1
    for (int s0 = 0; s0 < rows; s0 += 32) {
      const int s = base + s0 + lane;
      const bool in = s0 + lane < rows;
      int bin = in ? xs[s * T4 + w] - w0 : -1;  // the bin inside the window
      if ((unsigned int)bin >= (unsigned int)width) bin = -1;
      if constexpr (!I8) {
        // The lanes that share this lane's bin (what __match_any_sync
        // gives, at a fraction of its cost): the lowest of them adds their
        // planes in lane order, then into the warp's accumulator.
        if (bin >= 0) atomicOr(&lanes[bin], 1u << lane);
        __syncwarp();
        const unsigned int peers = bin >= 0 ? lanes[bin] : 0u;
        __syncwarp();
        if (bin >= 0 && lane == __ffs(peers) - 1) {
          lanes[bin] = 0;
          float4 sum = unpack_bf16(pl[s]);
          for (unsigned int p = peers & (peers - 1u); p; p &= p - 1u)
            sum = add4(sum, unpack_bf16(pl[base + s0 + __ffs(p) - 1]));
          accf[bin] = add4(accf[bin], sum);
        }
        __syncwarp();
      } else {
        // A row block's run of rows wholly inside this step is summed by
        // its lane groups' leaders and decoded at once; a run that spans
        // steps (the carried one from the last step, the open one at this
        // step's end) goes through the int accumulators and is decoded
        // when it ends.  Either way each (run, bin) decodes once, in run
        // order.
        const int blk = in ? sblk[s] : -1;
        const float sc = in ? ssc[s] : 0.0f;
        const unsigned int valid = __ballot_sync(kFull, in);
        const int last_blk = __shfl_sync(kFull, blk, 31 - __clz(valid));
        unsigned int pending = __ballot_sync(kFull, bin >= 0);
        while (pending) {  // one pass per row block in the step
          const int lead = __ffs(pending) - 1;
          const int b0 = __shfl_sync(kFull, blk, lead);
          const float sc0 = __shfl_sync(kFull, sc, lead);
          const bool act = ((pending >> lane) & 1u) && blk == b0;
          const bool carried = b0 == cur_blk;
          if (!carried && cur_blk >= 0) {
            flush();
            cur_blk = -1;
          }
          if (carried || b0 == last_blk) {
            cur_blk = b0;
            cur_sc = sc0;
            if (act) {  // integer sums: shared atomics, exact in any order
              const int4 v = unpack_i8(pl[s]);
              int* a = &acci[bin].x;
              atomicAdd(a, v.x);
              atomicAdd(a + 1, v.y);
              atomicAdd(a + 2, v.z);
              atomicAdd(a + 3, v.w);
              atomicOr(&touched[bin >> 5], 1u << (bin & 31));
            }
            if (b0 != last_blk) {  // the carried run ends in this step
              flush();
              cur_blk = -1;
            }
          } else {
            if (act) atomicOr(&lanes[bin], 1u << lane);
            __syncwarp();
            const unsigned int peers = act ? lanes[bin] : 0u;
            __syncwarp();
            if (act && lane == __ffs(peers) - 1) {
              lanes[bin] = 0;
              int4 sum = unpack_i8(pl[s]);
              for (unsigned int p = peers & (peers - 1u); p; p &= p - 1u) {
                const int4 v = unpack_i8(pl[base + s0 + __ffs(p) - 1]);
                sum = make_int4(sum.x + v.x, sum.y + v.y, sum.z + v.z, sum.w + v.w);
              }
              const float2 t = total[bin];
              total[bin] = make_float2(__fadd_rn(t.x, decode_i8(sum.x, sum.y, sc0)),
                                       __fadd_rn(t.y, decode_i8(sum.z, sum.w, sc0)));
            }
          }
          __syncwarp();
          pending &= ~__ballot_sync(kFull, act);
        }
      }
    }
  }
  cp_async_wait<0>();
  if (f >= F) return;
  if constexpr (I8) {
    if (cur_blk >= 0) flush();
  }
  __syncwarp();
  float2* out = reinterpret_cast<float2*>(partial) + ((long long)c * F + f) * n_bins + w0;
  for (int b = lane; b < width; b += 32) {
    if constexpr (I8) {
      out[b] = total[b];
    } else {
      const float4 a = accf[b];
      out[b] = make_float2(__fadd_rn(a.x, a.y), __fadd_rn(a.z, a.w));
    }
  }
}

// -- 4. sum_chunks -----------------------------------------------------------------------

// out[m, i] = partial[c0, i] + partial[c0 + 1, i] + ... over node m's
// chunks, in chunk order; 0 for a node with none.  size = F * n_bins * 2.
// Node m = blockIdx.y, + gridDim.y past the grid's 65,535 rows.
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  const int* __restrict__ node_chunk0,
                                  float* __restrict__ out, int size, int n_nodes) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  for (int m = blockIdx.y; m < n_nodes; m += gridDim.y) {
    const int c0 = node_chunk0[m], c1 = node_chunk0[m + 1];
    float s = 0.0f;
    if (c0 < c1) {
      s = partial[(long long)c0 * size + i];
#pragma unroll 8
      for (int c = c0 + 1; c < c1; ++c) s = __fadd_rn(s, partial[(long long)c * size + i]);
    }
    out[(long long)m * size + i] = s;
  }
}

template <bool I8, int MODE>
int launch_prep(const int* xb, const int* node_in, const float* g,
                const float* h, const int* feat, const int* thr, int* node_out,
                int* counts, float* scale, long long n_rows, int R, int F,
                int n_nodes, int n_prev, bool large, cudaStream_t s) {
  const int nb = (int)((n_rows + R - 1) / R);
  if (large) {
    const cudaError_t e = cudaMemsetAsync(counts, 0, (size_t)nb * n_nodes * sizeof(int), s);
    if (e != cudaSuccess) return (int)e;
    prep_kernel<I8, MODE, true><<<nb, kThreads, 0, s>>>(
        xb, node_in, g, h, feat, thr, node_out, counts, scale, n_rows, R, F, n_nodes, n_prev);
    return (int)cudaGetLastError();
  }
  if (n_nodes > kMaxNodes) return (int)cudaErrorInvalidValue;
  // At most kMaxNodes + 2 * kMaxNodes / 2 ints: under the 48 KB default.
  const size_t smem = (size_t)(n_nodes + 2 * n_prev) * sizeof(int);
  prep_kernel<I8, MODE, false><<<nb, kThreads, smem, s>>>(
      xb, node_in, g, h, feat, thr, node_out, counts, scale, n_rows, R, F, n_nodes, n_prev);
  return (int)cudaGetLastError();
}

struct TileArgs {
  const int* xb;
  const int* perm;
  const unsigned int* planes;
  const float* scale;
  const int *chunk_begin, *node_base, *node_chunk0;
  float* partial;
  int R, F, n_bins, n_nodes, max_chunks;
};

template <bool I8, bool PERM, bool VEC>
int launch_tile(const TileArgs& a, cudaStream_t s) {
  const TileLayout L = tile_layout(a.F, I8);
  static blk::SmemLimit lim;
  const cudaError_t e = blk::allow_smem((const void*)tile_hist_kernel<I8, PERM, VEC>, L.bytes, lim);
  if (e != cudaSuccess) return (int)e;
  const long long n_win = (a.n_bins + kBins - 1) / kBins;
  const long long grid = (long long)((a.F + L.T - 1) / L.T) * n_win * a.max_chunks;
  if (grid > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  tile_hist_kernel<I8, PERM, VEC><<<(unsigned int)grid, 32 * L.T, L.bytes, s>>>(
      a.xb, a.perm, a.planes, a.scale, a.chunk_begin, a.node_base,
      a.node_chunk0, a.partial, a.R, a.F, a.n_bins, a.n_nodes);
  return (int)cudaGetLastError();
}

template <bool I8>
int launch_tile_enc(const TileArgs& a, bool vec, cudaStream_t s) {
  if (a.perm != nullptr)
    return vec ? launch_tile<I8, true, true>(a, s) : launch_tile<I8, true, false>(a, s);
  return vec ? launch_tile<I8, false, true>(a, s) : launch_tile<I8, false, false>(a, s);
}

template <int MODE>
int launch_prep_enc(int i8, const int* xb, const int* node_in, const float* g,
                    const float* h, const int* feat, const int* thr,
                    int* node_out, int* counts, float* scale, long long n_rows,
                    int R, int F, int n_nodes, int n_prev, bool large,
                    cudaStream_t s) {
  return (i8 ? launch_prep<true, MODE> : launch_prep<false, MODE>)(
      xb, node_in, g, h, feat, thr, node_out, counts, scale, n_rows, R, F,
      n_nodes, n_prev, large, s);
}

}  // namespace

extern "C" {

// 1. mode 0 (root), 1 (route) or 2 (nodes).  xb [n_rows, F] i32 in row
// blocks of R rows (R a multiple of 128; the last block may be short);
// g, h [n_rows] f32; node_in [n_rows] i32 (route: the parent ids, nodes:
// the ids; root: null); route only: feat/thr [n_prev] i32 and node_out
// [n_rows] i32.  counts [nb, n_nodes] i32; scale [nb] f32 (i8, else null).
// large: the path for any node count (else at most kMaxNodes).
int hist_prep(int mode, const int* xb, const int* node_in, const float* g,
              const float* h, const int* feat, const int* thr, int* node_out,
              int* counts, float* scale, long long n_rows, int R, int F,
              int n_nodes, int n_prev, int i8, int large, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kRoute)
    return launch_prep_enc<kRoute>(i8, xb, node_in, g, h, feat, thr, node_out,
                                   counts, scale, n_rows, R, F, n_nodes, n_prev,
                                   large != 0, s);
  if (mode == kNodes)
    return launch_prep_enc<kNodes>(i8, xb, node_in, g, h, nullptr, nullptr,
                                   nullptr, counts, scale, n_rows, R, F,
                                   n_nodes, 0, large != 0, s);
  return launch_prep_enc<kRoot>(i8, xb, nullptr, g, h, nullptr, nullptr, nullptr,
                                counts, scale, n_rows, R, F, 1, 0, false, s);
}

// 2. key [n_rows] i32 (the node ids prep counted; null: root, and perm
// null too); scale (i8) and counts from prep.  rel/hid [nb, n_nodes] i32
// and node_total/node_heads [n_nodes] i32 are scratch;
// node_base/node_chunk0 [n_nodes + 1] i32; chunk_begin [ceil(n_rows / C) +
// n_nodes] i32; perm [n_rows] i32; planes [n_rows] x (8 bytes bf16, 4
// bytes i8).  large: scatter_sort_kernel, for any node count (else
// scatter_kernel, while its shared memory fits); both give the same
// partition.
int hist_partition(const int* key, const float* g, const float* h,
                   const float* scale, const int* counts, int* rel, int* hid,
                   int* node_total, int* node_heads, int* node_base,
                   int* node_chunk0, int* chunk_begin, int* perm,
                   void* planes, long long n_rows, int R, int n_nodes,
                   int chunk_rows, int i8, int large, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = (int)((n_rows + R - 1) / R);
  scan_nodes_kernel<<<n_nodes, kScanThreads, 0, s>>>(counts, rel, hid, node_total,
                                                     node_heads, nb, n_nodes,
                                                     (long long)chunk_rows);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  scan_base_kernel<<<1, kScanThreads, 0, s>>>(node_total, node_heads,
                                              node_base, node_chunk0, n_nodes);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (large && key != nullptr) {  // (the root has one node)
    const size_t smem = scatter_sort_smem_bytes(R);
    auto kern = i8 ? scatter_sort_kernel<true> : scatter_sort_kernel<false>;
    static blk::SmemLimit lim[2];
    e = blk::allow_smem((const void*)kern, smem, lim[i8 != 0]);
    if (e != cudaSuccess) return (int)e;
    const int bits = n_nodes > 1 ? 32 - __builtin_clz((unsigned int)(n_nodes - 1)) : 0;
    kern<<<nb, kThreads, smem, s>>>(key, g, h, scale, rel, hid, node_base, node_chunk0,
                                    chunk_begin, perm, (unsigned int*)planes, n_rows, R,
                                    n_nodes, bits);
    return (int)cudaGetLastError();
  }
  const size_t smem = ((size_t)(kWarps + 1) * n_nodes + 2 * (size_t)R) * sizeof(int);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  auto kern = i8 ? scatter_kernel<true> : scatter_kernel<false>;
  static blk::SmemLimit lim[2];
  e = blk::allow_smem((const void*)kern, smem, lim[i8 != 0]);
  if (e != cudaSuccess) return (int)e;
  kern<<<nb, kThreads, smem, s>>>(key, g, h, scale, rel, hid, node_base,
                                  node_chunk0, chunk_begin, perm,
                                  (unsigned int*)planes, n_rows, R, n_nodes);
  return (int)cudaGetLastError();
}

// 3 and 4.  The partition's outputs; partial [max_chunks, F, n_bins, 2] f32
// scratch; out [n_nodes, F, n_bins, 2] f32.  perm null: root.  vec: F % 4
// == 0 and xb 16-byte aligned.
int hist_accumulate(const int* xb, const int* perm, const void* planes,
                    const float* scale, const int* chunk_begin,
                    const int* node_base, const int* node_chunk0,
                    float* partial, float* out, int R, int F,
                    int n_bins, int n_nodes, int max_chunks, int vec, int i8,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const TileArgs a{xb, perm, (const unsigned int*)planes, scale, chunk_begin,
                   node_base, node_chunk0, partial, R, F, n_bins,
                   n_nodes, max_chunks};
  const int rc = i8 ? launch_tile_enc<true>(a, vec != 0, s)
                    : launch_tile_enc<false>(a, vec != 0, s);
  if (rc != 0) return rc;
  const int size = F * n_bins * 2;
  sum_chunks_kernel<<<dim3((size + 127) / 128, n_nodes < 65535 ? n_nodes : 65535), 128, 0,
                      s>>>(partial, node_chunk0, out, size, n_nodes);
  return (int)cudaGetLastError();
}

}  // extern "C"

namespace {

// The histogram path's scratch, carved from one workspace (byte offsets,
// each 256-byte aligned).
struct Workspace {
  size_t counts, rel, hid, node_total, node_heads, node_base, node_chunk0,
      chunk_begin, perm, planes, scale, partial, bytes;
};

Workspace workspace(long long n_rows, int R, int F, int n_bins, int n_nodes,
                    int chunk_rows, bool i8) {
  const long long nb = (n_rows + R - 1) / R;
  const long long max_chunks = (n_rows + chunk_rows - 1) / chunk_rows + n_nodes;
  Workspace w;
  size_t at = 0;
  auto take = [&](size_t bytes) {
    const size_t here = at;
    at = (at + bytes + 255) & ~size_t(255);
    return here;
  };
  w.counts = take(4 * nb * n_nodes);
  w.rel = take(4 * nb * n_nodes);
  w.hid = take(4 * nb * n_nodes);
  w.node_total = take(4 * (size_t)n_nodes);
  w.node_heads = take(4 * (size_t)n_nodes);
  w.node_base = take(4 * (size_t)(n_nodes + 1));
  w.node_chunk0 = take(4 * (size_t)(n_nodes + 1));
  w.chunk_begin = take(4 * max_chunks);
  w.perm = take(4 * n_rows);
  w.planes = take((i8 ? 4 : 8) * n_rows);
  w.scale = take(4 * nb);
  w.partial = take(8 * max_chunks * F * n_bins);
  w.bytes = at;
  return w;
}

}  // namespace

extern "C" {

// Bytes of hist_build's workspace.
long long hist_workspace_bytes(long long n_rows, int R, int F, int n_bins,
                               int n_nodes, int chunk_rows, int i8) {
  return (long long)workspace(n_rows, R, F, n_bins, n_nodes, chunk_rows, i8 != 0).bytes;
}

// The whole path in one call: hist_prep, hist_partition (no perm at the
// root) and hist_accumulate, their scratch in ws (hist_workspace_bytes).
// Arguments as for those three; out [n_nodes, F, n_bins, 2] f32.
int hist_build(int mode, const int* xb, const int* node_in, const float* g,
               const float* h, const int* feat, const int* thr, int* node_out,
               void* ws, float* out, long long n_rows, int R, int F, int n_bins,
               int n_nodes, int n_prev, int chunk_rows, int vec, int i8, int large,
               void* stream) {
  const Workspace w = workspace(n_rows, R, F, n_bins, n_nodes, chunk_rows, i8 != 0);
  char* base = (char*)ws;
  auto I = [&](size_t off) { return (int*)(base + off); };
  float* scale = i8 ? (float*)(base + w.scale) : nullptr;
  int rc = hist_prep(mode, xb, node_in, g, h, feat, thr, node_out, I(w.counts),
                     scale, n_rows, R, F, n_nodes, n_prev, i8, large, stream);
  if (rc != 0) return rc;
  const int* key = mode == kRoute ? node_out : mode == kNodes ? node_in : nullptr;
  int* perm = key != nullptr ? I(w.perm) : nullptr;
  rc = hist_partition(key, g, h, scale, I(w.counts), I(w.rel), I(w.hid),
                      I(w.node_total), I(w.node_heads), I(w.node_base),
                      I(w.node_chunk0), I(w.chunk_begin), perm, base + w.planes,
                      n_rows, R, n_nodes, chunk_rows, i8, large, stream);
  if (rc != 0) return rc;
  const int max_chunks = (int)((n_rows + chunk_rows - 1) / chunk_rows + n_nodes);
  return hist_accumulate(xb, perm, base + w.planes, scale, I(w.chunk_begin),
                         I(w.node_base), I(w.node_chunk0),
                         (float*)(base + w.partial), out, R, F, n_bins, n_nodes,
                         max_chunks, vec, i8, stream);
}

}  // extern "C"
