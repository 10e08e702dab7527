// Final row pass of a fused GBDT boosting round: route every row from its
// level-(depth-1) node to its leaf, and optionally add the leaf's weight to
// the row's margin.
//
// Replaces rabit_tpu/ops/boost.py route_level (_route_kernel) and
// route_margin_level (_route_margin_kernel).
//
// Bound on an H100: device memory.  Per row the pass reads its node id, one
// bin of its feature row (the split feature of its node: one 32-byte sector
// of the 4*F-byte row) and, with the margin, one float; it writes the leaf
// id (and the new margin).  No arithmetic to speak of.
//
// Design: four rows a thread, consecutive threads on consecutive rows so
// the node/margin loads and stores coalesce, each row's loads issued with
// the others' so that their latencies overlap.  The split tables (2^(depth-1)
// entries each) and the leaf table (2^depth) are copied into shared memory
// once per block and read by direct lookup: the TPU kernel's lane-masked
// reductions (no gathers on the TPU) and its (8, p_pad) padded tables have
// no use here.  Integer routing and one float add: the result is exact and
// equals the plain version bit for bit.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;  // rows a thread routes per pass

template <bool MARGIN>
__global__ void route_kernel(const int* __restrict__ xb,
                             const int* __restrict__ node_in,
                             const float* __restrict__ margin_in,
                             const int* __restrict__ feat,
                             const int* __restrict__ thr,
                             const float* __restrict__ leaf,
                             float* __restrict__ margin_out,
                             int* __restrict__ node_out,
                             long long n_rows, int n_feat, int n_prev,
                             int n_leaves) {
  extern __shared__ int tables[];
  int* ft = tables;
  int* tt = tables + n_prev;
  float* lt = reinterpret_cast<float*>(tables + 2 * n_prev);
  for (int i = threadIdx.x; i < n_prev; i += blockDim.x) {
    ft[i] = feat[i];
    tt[i] = thr[i];
  }
  if (MARGIN) {
    for (int i = threadIdx.x; i < n_leaves; i += blockDim.x) lt[i] = leaf[i];
  }
  __syncthreads();
  // Four rows a thread per pass, their loads issued together.
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       r0 < n_rows; r0 += kRows * stride) {
    int p[kRows], x[kRows];
    float m[kRows];
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = r0 + u * stride;
      if (r < n_rows) {
        p[u] = node_in[r];
        if (MARGIN) m[u] = margin_in[r];
      }
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = r0 + u * stride;
      if (r < n_rows) x[u] = xb[r * n_feat + ft[p[u]]];
    }
#pragma unroll
    for (int u = 0; u < kRows; ++u) {
      const long long r = r0 + u * stride;
      if (r >= n_rows) continue;
      const int node = 2 * p[u] + (x[u] > tt[p[u]] ? 1 : 0);
      node_out[r] = node;
      if (MARGIN) margin_out[r] = __fadd_rn(m[u], lt[node]);
    }
  }
}

int grid_for(long long n_rows) {
  const long long blocks = (n_rows + kRows * kThreads - 1) / (kRows * kThreads);
  return (int)(blocks < (1 << 30) ? blocks : (1 << 30));
}

}  // namespace

extern "C" {

// node_out[r] = 2*node_in[r] + [xb[r, feat[p]] > thr[p]], p = node_in[r].
int route_level(const int* xb, const int* node_in, const int* feat,
                const int* thr, int* node_out, long long n_rows, int n_feat,
                int n_prev, void* stream) {
  if (n_rows == 0) return 0;
  size_t smem = (size_t)2 * n_prev * sizeof(int);
  route_kernel<false><<<grid_for(n_rows), kThreads, smem,
                        (cudaStream_t)stream>>>(
      xb, node_in, nullptr, feat, thr, nullptr, nullptr, node_out, n_rows,
      n_feat, n_prev, 0);
  return (int)cudaGetLastError();
}

// route_level, then margin_out[r] = margin_in[r] + leaf[node_out[r]].
int route_margin_level(const int* xb, const int* node_in,
                       const float* margin_in, const int* feat, const int* thr,
                       const float* leaf, float* margin_out, int* node_out,
                       long long n_rows, int n_feat, int n_prev, int n_leaves,
                       void* stream) {
  if (n_rows == 0) return 0;
  size_t smem = (size_t)(2 * n_prev + n_leaves) * sizeof(int);
  route_kernel<true><<<grid_for(n_rows), kThreads, smem,
                       (cudaStream_t)stream>>>(
      xb, node_in, margin_in, feat, thr, leaf, margin_out, node_out, n_rows,
      n_feat, n_prev, n_leaves);
  return (int)cudaGetLastError();
}

}  // extern "C"
