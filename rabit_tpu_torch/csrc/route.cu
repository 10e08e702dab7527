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
// block, and the block sums added into the total in block order.
//
// Bound on an H100: device memory (per row its node id, one 32-byte sector
// of its feature row, g and h in; the leaf id out).  The TPU kernel sums
// with a matmul against ones on the MXU; here a block of 256 threads takes
// a chunk of consecutive row blocks.  Per row block it stages each row's
// leaf and encoded planes in shared memory; then each warp walks its
// segment of the block 32 rows at a time, and the lowest lane of the rows
// that share a leaf (__match_any_sync) adds their planes in row order into
// the warp's own per-leaf accumulators.  The warps' accumulators are added
// in warp order, hi + lo, into the chunk's running total, row block by row
// block.  A second kernel adds the chunk totals in chunk order.  No float
// atomics: the order is fixed by the shapes alone.

struct LeafLayout {
  size_t lid, vals, acc, total, tables, bytes;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__host__ __device__ inline LeafLayout leaf_layout(int R, int n_leaves,
                                                  int acc_warps) {
  LeafLayout L;
  L.lid = 0;                                              // int [R]
  L.vals = align16((size_t)R * 4);                        // float4 [R]
  L.acc = L.vals + (size_t)R * 16;                        // float4 [acc_warps][n_leaves]
  L.total = L.acc + (size_t)acc_warps * n_leaves * 16;    // float2 [n_leaves]
  L.tables = L.total + (size_t)n_leaves * 8;              // int [2][n_leaves / 2]
  L.bytes = L.tables + (size_t)n_leaves * 4;
  return L;
}

__device__ inline float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__global__ void __launch_bounds__(kThreads)
leaf_partial_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const int* __restrict__ feat, const int* __restrict__ thr,
                    int* __restrict__ node_out, float* __restrict__ partial,
                    int nb, int R, int n_feat, int n_leaves, int acc_warps,
                    int blocks_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const LeafLayout L = leaf_layout(R, n_leaves, acc_warps);
  int* lid = reinterpret_cast<int*>(smem + L.lid);
  float4* vals = reinterpret_cast<float4*>(smem + L.vals);
  float4* acc = reinterpret_cast<float4*>(smem + L.acc);
  float2* total = reinterpret_cast<float2*>(smem + L.total);
  const int n_prev = n_leaves / 2;
  int* ft = reinterpret_cast<int*>(smem + L.tables);
  int* tt = ft + n_prev;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < n_prev; i += blockDim.x) {
    ft[i] = feat[i];
    tt[i] = thr[i];
  }
  for (int i = tid; i < acc_warps * n_leaves; i += blockDim.x)
    acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = tid; i < n_leaves; i += blockDim.x) total[i] = make_float2(0.f, 0.f);
  const int blk0 = blockIdx.x * blocks_per_chunk;
  const int blk1 = min(nb, blk0 + blocks_per_chunk);
  const int seg = R / acc_warps;  // rows of one accumulating warp (multiple of 32)

  for (int blk = blk0; blk < blk1; ++blk) {
    __syncthreads();  // tables and zeroed accumulators / the last merge
    const long long base = (long long)blk * R;
    // Stage: route each row, write its leaf, encode its planes; kRows rows
    // a thread per pass with their loads issued together.
    for (int r0 = tid; r0 < R; r0 += kRows * kThreads) {
      int p[kRows], x[kRows];
      float gv[kRows], hv[kRows];
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u * kThreads;
        if (r < R) {
          p[u] = node_in[base + r];
          gv[u] = g[base + r];
          hv[u] = h[base + r];
        }
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u * kThreads;
        if (r < R) x[u] = xb[(base + r) * n_feat + ft[p[u]]];
      }
#pragma unroll
      for (int u = 0; u < kRows; ++u) {
        const int r = r0 + u * kThreads;
        if (r >= R) continue;
        const int leaf = 2 * p[u] + (x[u] > tt[p[u]] ? 1 : 0);
        node_out[base + r] = leaf;
        lid[r] = leaf;
        const float ghi = bf16_round(gv[u]), hhi = bf16_round(hv[u]);
        vals[r] = make_float4(ghi, bf16_round(__fsub_rn(gv[u], ghi)), hhi,
                              bf16_round(__fsub_rn(hv[u], hhi)));
      }
    }
    __syncthreads();
    // Accumulate: warp w < acc_warps walks rows [w*seg, (w+1)*seg).
    if (warp < acc_warps) {
      float4* wacc = acc + (size_t)warp * n_leaves;
      for (int r1 = warp * seg; r1 < (warp + 1) * seg; r1 += 32) {
        const int leaf = lid[r1 + lane];
        const unsigned int peers = __match_any_sync(0xffffffffu, leaf);
        if (lane == __ffs(peers) - 1) {
          float4 s = vals[r1 + lane];
          for (unsigned int m = peers & (peers - 1u); m; m &= m - 1u) {
            const float4 v = vals[r1 + __ffs(m) - 1];
            s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                            __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
          }
          const float4 a = wacc[leaf];
          wacc[leaf] = make_float4(__fadd_rn(a.x, s.x), __fadd_rn(a.y, s.y),
                                   __fadd_rn(a.z, s.z), __fadd_rn(a.w, s.w));
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // Merge: the block's plane sums in warp order, hi + lo, into the total.
    for (int leaf = tid; leaf < n_leaves; leaf += blockDim.x) {
      float4 s = acc[leaf];
      acc[leaf] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int w = 1; w < acc_warps; ++w) {
        const float4 v = acc[(size_t)w * n_leaves + leaf];
        acc[(size_t)w * n_leaves + leaf] = make_float4(0.f, 0.f, 0.f, 0.f);
        s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y),
                        __fadd_rn(s.z, v.z), __fadd_rn(s.w, v.w));
      }
      const float2 t = total[leaf];
      total[leaf] = make_float2(__fadd_rn(t.x, __fadd_rn(s.x, s.y)),
                                __fadd_rn(t.y, __fadd_rn(s.z, s.w)));
    }
  }
  __syncthreads();
  for (int leaf = tid; leaf < n_leaves; leaf += blockDim.x)
    reinterpret_cast<float2*>(partial)[(size_t)blockIdx.x * n_leaves + leaf] =
        total[leaf];
}

// out[i] = partial[0][i] + partial[1][i] + ... in chunk order.
__global__ void leaf_sum_chunks_kernel(const float* __restrict__ partial,
                                       float* __restrict__ out, int size,
                                       int n_chunks) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = partial[i];
  for (int c = 1; c < n_chunks; ++c) s = __fadd_rn(s, partial[(size_t)c * size + i]);
  out[i] = s;
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

// Shared memory of one leaf_fit block (bytes).
long long leaf_smem_bytes(int R, int n_leaves, int acc_warps) {
  return (long long)leaf_layout(R, n_leaves, acc_warps).bytes;
}

// node_out[r] = 2*node_in[r] + [xb[r, feat[p]] > thr[p]] (the leaf id) and
// out[leaf] = (sum g, sum h) over the leaf's rows in the bf16 hi/lo planes.
// xb (nb, R, n_feat) i32; node_in, node_out (nb, R) i32; g, h (nb, R) f32;
// feat/thr [n_leaves / 2] i32.  Scratch: partial [n_chunks, n_leaves, 2]
// f32.  out [n_leaves, 2] f32.  acc_warps (8, 4, 2 or 1) warps accumulate.
int leaf_fit(const int* xb, const int* node_in, const float* g, const float* h,
             const int* feat, const int* thr, int* node_out, float* partial,
             float* out, int nb, int R, int n_feat, int n_leaves, int acc_warps,
             int n_chunks, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = leaf_layout(R, n_leaves, acc_warps).bytes;
  cudaError_t e = cudaFuncSetAttribute(
      leaf_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int per = (nb + n_chunks - 1) / n_chunks;
  leaf_partial_kernel<<<n_chunks, kThreads, smem, s>>>(
      xb, node_in, g, h, feat, thr, node_out, partial, nb, R, n_feat, n_leaves,
      acc_warps, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int size = 2 * n_leaves;
  leaf_sum_chunks_kernel<<<(size + 255) / 256, 256, 0, s>>>(partial, out, size,
                                                            n_chunks);
  return (int)cudaGetLastError();
}

}  // extern "C"
