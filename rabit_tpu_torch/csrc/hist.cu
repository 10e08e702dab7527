// Gradient histograms of a GBDT boosting round:
//   hist[m, f, b, 0/1] = sum_r [node'_r == m][xb[r, f] == b] * (g_r, h_r)
// where node' is, by mode,
//   root:  0;
//   route: one level down, 2*node + [xb[r, feat[node]] > thr[node]]
//          (written out as well);
//   nodes: the node ids given (no routing, no node output),
// in either encoding of the gradients:
//   bf16: g and h split into hi/lo bfloat16 planes (hi = bf16(v),
//         lo = bf16(v - hi), round to nearest even), each plane summed in
//         f32, hist = hi + lo;
//   i8:   per row block of R rows, x = v * (1/scale) with scale =
//         max(|g|, |h|) over the block's rows (floored at the smallest
//         normal f32), planes a = rint(64x), b = rint((x - a/64) * 8192)
//         summed in exact int32, decoded once per block as
//         (a/64 + b/8192) * scale and added to an f32 total in block order.
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
// Design.  The TPU kernel keeps the whole (nodes x F*B) histogram resident
// in VMEM and adds each row block into it along a sequential grid; a CUDA
// block has 227 KB of shared memory at most and blocks run in no order.
// So the grid is (feature, node group, chunk of consecutive row blocks).
// A block owns one feature, one group of consecutive nodes and one chunk;
// its 256 threads own one bin each and keep that bin's accumulators for
// every node of the group in shared memory.  The group is as large as
// shared memory allows (the wrapper picks it; at depth <= 6 and 256 bins
// one group holds every node), so any node count runs.  Per row block the
// block stages the rows' bins of its feature (bytes), their group-local
// node ids (bytes; 0xff marks a row of another group, with a foreign id or
// past the last row of a short final block) and their encoded gradients in
// shared memory, then sorts the rows by bin with a stable counting sort
// (integer counts per warp segment, a scan, and a warp-ordered scatter
// with __match_any_sync), and each thread adds the rows of its own bin in
// row order, passing over the marked ones.  (Marking instead of leaving
// rows out of the sort keeps the staging and the sort free of branches:
// at one or two blocks an SM they are latency-bound.)  A thread touches
// only its own bin's column, so there are no float atomics and the
// summation order is fixed: row order within the chunk.  Each block writes
// its chunk's partial histogram for its nodes; a second kernel adds the
// chunks in chunk order.  The result is
// deterministic and independent of the SM count (the chunk count depends
// only on the shapes).  The TPU kernel's r_split (a Mosaic scheduling
// experiment) has no counterpart: the result does not depend on it.
// Neither do the TPU-only padding of bins to 128 lanes, the 1792-lane
// feature groups or the i32-wide compare.  Rows are addressed as
// (block * R + r) * F, so a pre-blocked (nb, R, F) matrix and an unblocked
// [n, F] one are the same bytes; rows past n add nothing.
//
// Floating-point steps use __fmul_rn / __fadd_rn / __fsub_rn so that nvcc
// cannot contract them into FMAs, which would round differently from the
// reference.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // one thread per bin: n_bins <= 256
constexpr int kWarps = kThreads / 32;
constexpr int kBins = 256;     // row stride of the per-warp bin counts
constexpr float kTiny = 1.1754944e-38f;  // smallest normal f32
constexpr int kSkip = 0xff;    // staged node id of a row that adds nothing
enum Mode { kRoot = 0, kRoute = 1, kNodes = 2 };

struct Layout {
  int nb_bins;  // group_nodes * n_bins
  // Byte offsets: accumulators first (4 planes, + 2 f32 totals for i8).
  size_t xs, vals, cnt, start, list, tables, red, total;
};

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

// n_prev: entries of each staged split table (route mode; else 0).
__host__ __device__ inline Layout layout(bool i8, int group_nodes, int n_bins,
                                         int R, int n_prev) {
  Layout L;
  L.nb_bins = group_nodes * n_bins;
  L.xs = align16((size_t)(i8 ? 6 : 4) * L.nb_bins * 4);  // then ns: R bytes each
  L.vals = align16(L.xs + (size_t)R * 2);
  L.cnt = align16(L.vals + (size_t)R * (i8 ? 4 : 16));
  L.start = L.cnt + (size_t)kWarps * kBins * 4;
  L.list = align16(L.start + (size_t)(kBins + 1) * 4);
  L.tables = align16(L.list + (size_t)R * 2);
  L.red = align16(L.tables + (size_t)2 * n_prev * 4);
  L.total = L.red + 32 * 4;
  return L;
}

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

// Exclusive prefix sum of v over the block's threads (one value each).
__device__ inline int block_exclusive_scan(int v, int* warp_sums) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[w] = x;
  __syncthreads();
  int off = 0;
  for (int i = 0; i < w; ++i) off += warp_sums[i];
  return off + x - v;
}

// i8 scale of each row block: max(|g|, |h|) over its rows (those below
// n_rows, and with given node ids those whose id is in [0, n_nodes): the
// TPU kernel takes the max of its gradient matrix, where a row of a
// foreign node is all zeros), floored at the smallest normal f32.  One
// block per row block; max is order-free.
__global__ void block_scale_kernel(const float* __restrict__ g,
                                   const float* __restrict__ h,
                                   const int* __restrict__ node, int n_nodes,
                                   float* __restrict__ scale, long long n_rows,
                                   int R) {
  __shared__ float red[kWarps];
  const long long base = (long long)blockIdx.x * R;
  const int valid = (int)min((long long)R, n_rows - base);
  float m = 0.0f;
  for (int r = threadIdx.x; r < valid; r += blockDim.x) {
    if (node != nullptr && (unsigned int)node[base + r] >= (unsigned int)n_nodes)
      continue;
    m = fmaxf(m, fmaxf(fabsf(g[base + r]), fabsf(h[base + r])));
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red[w]);
    scale[blockIdx.x] = fmaxf(m, kTiny);
  }
}

template <bool I8, int MODE>
__global__ void __launch_bounds__(kThreads, 4)
hist_partial_kernel(const int* __restrict__ xb, const int* __restrict__ node_in,
                    const float* __restrict__ g, const float* __restrict__ h,
                    const float* __restrict__ scales,
                    const int* __restrict__ feat, const int* __restrict__ thr,
                    int* __restrict__ node_out, float* __restrict__ partial,
                    long long n_rows, int nb, int R, int F, int n_bins,
                    int n_nodes, int n_prev, int group_nodes,
                    int blocks_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(I8, group_nodes, n_bins, R, n_prev);
  const int NB = L.nb_bins;
  float* accf = reinterpret_cast<float*>(smem);  // bf16: 4 f32 planes
  int* acci = reinterpret_cast<int*>(smem);      // i8: 4 int32 planes ...
  float* total = accf + 4 * NB;                  // ... + 2 f32 totals
  unsigned char* xs = smem + L.xs;               // staged bins, one byte a row
  unsigned char* ns = xs + R;                    // group-local node ids
  float4* vals4 = reinterpret_cast<float4*>(smem + L.vals);  // bf16 planes
  unsigned int* vals8 = reinterpret_cast<unsigned int*>(smem + L.vals);  // i8
  int* cnt = reinterpret_cast<int*>(smem + L.cnt);      // [warp][bin] counts
  int* start = reinterpret_cast<int*>(smem + L.start);  // bin -> first slot
  unsigned short* list = reinterpret_cast<unsigned short*>(smem + L.list);
  int* ft = reinterpret_cast<int*>(smem + L.tables);
  int* tt = ft + n_prev;
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int f = blockIdx.x;
  const int g0 = blockIdx.y * group_nodes;  // first node of this block's group
  const int n_group = min(group_nodes, n_nodes - g0);
  const int tid = threadIdx.x;
  for (int i = tid; i < (I8 ? 6 : 4) * NB; i += blockDim.x) acci[i] = 0;
  for (int i = tid; i < n_prev; i += blockDim.x) {
    ft[i] = feat[i];
    tt[i] = thr[i];
  }
  const int blk0 = blockIdx.z * blocks_per_chunk;
  const int blk1 = min(nb, blk0 + blocks_per_chunk);
  const int lane = tid & 31, warp = tid >> 5;
  const int seg = R / kWarps;  // rows of one warp's segment (a multiple of 32)

  for (int blk = blk0; blk < blk1; ++blk) {
    __syncthreads();  // the previous block's scan is done with the stage
    const long long base = (long long)blk * R;
    // Rows of this block: only the nodes mode takes a short last block (the
    // fused passes are pre-blocked), and a constant R keeps their staging
    // as short as it was.
    const int valid = MODE == kNodes ? (int)min((long long)R, n_rows - base) : R;
    const float scale = I8 ? scales[blk] : 0.0f;
    const float inv = I8 ? __fdiv_rn(1.0f, scale) : 0.0f;
    // Stage the block: four rows a thread per pass, their loads issued
    // together (then the dependent load of each row's split bin).
    for (int r0 = tid; r0 < R; r0 += 4 * kThreads) {
      int xf[4], pn[4], xsp[4];
      float gv[4], hv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u * kThreads;
        xf[u] = 0, pn[u] = 0, gv[u] = 0.0f, hv[u] = 0.0f;  // rows past the last
        if (r < valid) {
          xf[u] = xb[(base + r) * F + f];
          gv[u] = g[base + r];
          hv[u] = h[base + r];
          if (MODE != kRoot) pn[u] = node_in[base + r];
        }
      }
      if (MODE == kRoute) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int r = r0 + u * kThreads;
          xsp[u] = r < valid ? xb[(base + r) * F + ft[pn[u]]] : 0;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int r = r0 + u * kThreads;
        if (r >= R) continue;
        int node = 0;
        if (MODE == kRoute) {
          node = 2 * pn[u] + (xsp[u] > tt[pn[u]] ? 1 : 0);
          if (f == 0 && blockIdx.y == 0) node_out[base + r] = node;
        } else if (MODE == kNodes) {
          node = pn[u];
        }
        // Rows past the last one, of another group or with a foreign id
        // are sorted like the others and skipped when summed.
        const int local = node - g0;
        const bool keep = r < valid && (MODE == kRoot ||
                                        (unsigned int)local < (unsigned int)n_group);
        xs[r] = (unsigned char)xf[u];
        ns[r] = keep ? (unsigned char)local : (unsigned char)kSkip;
        if (I8) {
          vals8[r] = encode_i8(gv[u], inv) | (encode_i8(hv[u], inv) << 16);
        } else {
          const float ghf = __bfloat162float(__float2bfloat16_rn(gv[u]));
          const float hhf = __bfloat162float(__float2bfloat16_rn(hv[u]));
          vals4[r] = make_float4(
              ghf, __bfloat162float(__float2bfloat16_rn(__fsub_rn(gv[u], ghf))),
              hhf, __bfloat162float(__float2bfloat16_rn(__fsub_rn(hv[u], hhf))));
        }
      }
    }
    for (int w = 0; w < kWarps; ++w) cnt[w * kBins + tid] = 0;
    __syncthreads();
    // Stable counting sort of the block's rows by bin.  1: per-warp counts.
    for (int r = warp * seg + lane; r < (warp + 1) * seg; r += 32)
      atomicAdd(&cnt[warp * kBins + xs[r]], 1);  // integer: order-free
    __syncthreads();
    // 2: slot of (bin, warp) = rows of lower bins + of this bin in lower warps.
    int total_b = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int c = cnt[w * kBins + tid];
      cnt[w * kBins + tid] = total_b;
      total_b += c;
    }
    const int first = block_exclusive_scan(total_b, reinterpret_cast<int*>(red));
    for (int w = 0; w < kWarps; ++w) cnt[w * kBins + tid] += first;
    start[tid] = first;
    if (tid == kThreads - 1) start[kBins] = first + total_b;
    __syncthreads();
    // 3: each warp scatters its segment 32 rows at a time, lanes in order.
    for (int r = warp * seg + lane; r < (warp + 1) * seg; r += 32) {
      const int bin = xs[r];
      const unsigned int peers = __match_any_sync(0xffffffffu, bin);
      const int rank = __popc(peers & ((1u << lane) - 1u));
      int* slot = &cnt[warp * kBins + bin];
      list[*slot + rank] = (unsigned short)r;
      __syncwarp();
      if (lane == 31 - __clz(peers)) *slot += __popc(peers);
      __syncwarp();
    }
    __syncthreads();
    // 4: each thread adds its bin's rows of this group, in row order.
    if (tid < n_bins) {
      const int k1 = start[tid + 1];
      for (int k = start[tid]; k < k1; ++k) {
        const int r = list[k];
        const int nd = ns[r];
        if (nd == kSkip) continue;
        const int idx = nd * n_bins + tid;
        if (I8) {
          const unsigned int v = vals8[r];
          acci[idx] += (int)(signed char)(v & 0xff);
          acci[NB + idx] += (int)(signed char)((v >> 8) & 0xff);
          acci[2 * NB + idx] += (int)(signed char)((v >> 16) & 0xff);
          acci[3 * NB + idx] += (int)(signed char)((v >> 24) & 0xff);
        } else {
          const float4 v = vals4[r];
          accf[idx] = __fadd_rn(accf[idx], v.x);
          accf[NB + idx] = __fadd_rn(accf[NB + idx], v.y);
          accf[2 * NB + idx] = __fadd_rn(accf[2 * NB + idx], v.z);
          accf[3 * NB + idx] = __fadd_rn(accf[3 * NB + idx], v.w);
        }
      }
      if (I8) {
        // Decode this block's sums once, for the nodes this bin's rows hit
        // (the first row of a node decodes and clears it; adding an
        // untouched bin's decoded 0 would change nothing).
        for (int k = start[tid]; k < k1; ++k) {
          const int nd = ns[list[k]];
          if (nd == kSkip) continue;
          const int idx = nd * n_bins + tid;
          const int ga = acci[idx], gb = acci[NB + idx];
          const int ha = acci[2 * NB + idx], hb = acci[3 * NB + idx];
          if (ga | gb) {
            total[idx] = __fadd_rn(total[idx], decode_i8(ga, gb, scale));
            acci[idx] = 0;
            acci[NB + idx] = 0;
          }
          if (ha | hb) {
            total[NB + idx] = __fadd_rn(total[NB + idx], decode_i8(ha, hb, scale));
            acci[2 * NB + idx] = 0;
            acci[3 * NB + idx] = 0;
          }
        }
      }
    }
  }
  // Partial histogram of this chunk for the group's nodes: [chunk, node,
  // f, b, 2].  The sync orders the zeroing above (strided over all
  // threads) before these reads when the chunk holds no block.
  __syncthreads();
  if (tid < n_bins) {
    for (int nd = 0; nd < n_group; ++nd) {
      const int idx = nd * n_bins + tid;
      float2 out;
      if (I8) {
        out = make_float2(total[idx], total[NB + idx]);
      } else {
        out = make_float2(__fadd_rn(accf[idx], accf[NB + idx]),
                          __fadd_rn(accf[2 * NB + idx], accf[3 * NB + idx]));
      }
      const long long o =
          ((((long long)blockIdx.z * n_nodes + g0 + nd) * F + f) * n_bins + tid);
      reinterpret_cast<float2*>(partial)[o] = out;
    }
  }
}

// out[i] = partial[0][i] + partial[1][i] + ... in chunk order.
__global__ void sum_chunks_kernel(const float* __restrict__ partial,
                                  float* __restrict__ out, long long size,
                                  int n_chunks) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < size;
       i += stride) {
    float s = partial[i];
    for (int c = 1; c < n_chunks; ++c) s = __fadd_rn(s, partial[c * size + i]);
    out[i] = s;
  }
}

template <bool I8, int MODE>
int launch(const int* xb, const int* node_in, const float* g, const float* h,
           float* scale, const int* feat, const int* thr, int* node_out,
           float* partial, float* out, long long n_rows, int R, int F,
           int n_bins, int n_nodes, int n_prev, int group_nodes,
           int n_chunks, cudaStream_t stream) {
  const Layout L = layout(I8, group_nodes, n_bins, R, n_prev);
  auto kern = hist_partial_kernel<I8, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
  if (e != cudaSuccess) return (int)e;
  const int nb = (int)((n_rows + R - 1) / R);
  if (I8) {
    block_scale_kernel<<<nb, kThreads, 0, stream>>>(
        g, h, MODE == kNodes ? node_in : nullptr, n_nodes, scale, n_rows, R);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int per = (nb + n_chunks - 1) / n_chunks;
  const int n_groups = (n_nodes + group_nodes - 1) / group_nodes;
  kern<<<dim3(F, n_groups, n_chunks), kThreads, L.total, stream>>>(
      xb, node_in, g, h, scale, feat, thr, node_out, partial, n_rows, nb, R, F,
      n_bins, n_nodes, n_prev, group_nodes, per);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long size = (long long)n_nodes * F * n_bins * 2;
  const long long blocks = (size + 255) / 256;
  sum_chunks_kernel<<<(int)(blocks < 65535 ? blocks : 65535), 256, 0, stream>>>(
      partial, out, size, n_chunks);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch_mode(int i8, const int* xb, const int* node_in, const float* g,
                const float* h, float* scale, const int* feat, const int* thr,
                int* node_out, float* partial, float* out, long long n_rows,
                int R, int F, int n_bins, int n_nodes, int n_prev,
                int group_nodes, int n_chunks, cudaStream_t stream) {
  if (i8)
    return launch<true, MODE>(xb, node_in, g, h, scale, feat, thr, node_out,
                              partial, out, n_rows, R, F, n_bins, n_nodes,
                              n_prev, group_nodes, n_chunks, stream);
  return launch<false, MODE>(xb, node_in, g, h, scale, feat, thr, node_out,
                             partial, out, n_rows, R, F, n_bins, n_nodes,
                             n_prev, group_nodes, n_chunks, stream);
}

}  // namespace

extern "C" {

// Shared memory one block of the histogram kernel needs (bytes) for a
// group of group_nodes nodes and split tables of n_prev entries.
long long hist_smem_bytes(int i8, int group_nodes, int n_bins, int R,
                          int n_prev) {
  return (long long)layout(i8 != 0, group_nodes, n_bins, R, n_prev).total;
}

// mode 0 (root), 1 (route) or 2 (nodes).  xb [n_rows, F] i32 in row blocks
// of R rows (in nodes mode the last one may be short, else n_rows % R ==
// 0); g, h [n_rows] f32; node_in [n_rows] i32 (route: the parent ids;
// nodes: the ids; root: null); route only: the level-(d-1) split tables
// feat/thr [n_prev] (else n_prev = 0) and node_out [n_rows] i32.  Scratch:
// scale [ceil(n_rows / R)] f32 (i8 only, else null) and partial [n_chunks,
// n_nodes, F, n_bins, 2] f32.  out [n_nodes, F, n_bins, 2] f32.  The grid
// holds ceil(n_nodes / group_nodes) node groups.
int hist_build(int mode, const int* xb, const int* node_in, const float* g,
               const float* h, const int* feat, const int* thr, int* node_out,
               float* scale, float* partial, float* out, long long n_rows,
               int R, int F, int n_bins, int n_nodes, int n_prev,
               int group_nodes, int n_chunks, int i8, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (mode == kRoute)
    return launch_mode<kRoute>(i8, xb, node_in, g, h, scale, feat, thr,
                               node_out, partial, out, n_rows, R, F, n_bins,
                               n_nodes, n_prev, group_nodes, n_chunks, s);
  if (mode == kNodes)
    return launch_mode<kNodes>(i8, xb, node_in, g, h, scale, nullptr, nullptr,
                               nullptr, partial, out, n_rows, R, F, n_bins,
                               n_nodes, 0, group_nodes, n_chunks, s);
  return launch_mode<kRoot>(i8, xb, nullptr, g, h, scale, nullptr, nullptr,
                            nullptr, partial, out, n_rows, R, F, n_bins,
                            n_nodes, 0, group_nodes, n_chunks, s);
}

}  // extern "C"
