// Block-local stable ranking and sorting by integer keys, for blocks of 256
// threads, with shared memory bounded by the number of slots a block
// ranks and 256 digit counters, whatever the range of the keys.
//
// Used by csrc/hist.cu (the partition's scatter past 4096 nodes) and
// csrc/route.cu (leaf_fit's per-row-block reduction and its merge across
// row blocks), which also share the hi/lo bf16 encoding and the raising of
// a kernel's dynamic shared-memory limit below.
//
// rank_pass is one stable counting pass over an 8-bit digit: warp w owns
// the slots [w * n / 8, (w + 1) * n / 8) and walks them 32 at a time in
// slot order; the lanes that share a digit (a ballot a digit bit) are
// ranked by lane, and per-warp digit counters, scanned digit by digit in warp
// order, give each slot its place.  sort_slots runs such passes over the
// key's bits, least significant digit first (LSD radix sort), between two
// pairs of key / slot buffers.  Everything is integer: the order is exact
// and fixed by the keys and the slots alone.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace blk {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;  // the block size every caller uses
constexpr int kWarps = kThreads / 32;
constexpr int kDigitBits = 8;
constexpr int kDigits = 1 << kDigitBits;

// Exclusive prefix sum of v over the block's threads (a multiple of 32, at
// most 1024); total gets the block's sum.  ws holds 32 ints.
__device__ inline int block_scan(int v, int* ws, int& total) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[w] = x;
  __syncthreads();
  if (w == 0) {
    int s = lane < nw ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nw) ws[lane] = s;
  }
  __syncthreads();
  const int off = w ? ws[w - 1] : 0;
  total = ws[nw - 1];
  __syncthreads();  // ws is free for the next call
  return off + x - v;
}

// hi | lo << 16 as bfloat16 bits (hi = bf16(v), lo = bf16(v - hi)).
__device__ inline unsigned int encode_bf16(float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const __nv_bfloat16 lo = __float2bfloat16_rn(__fsub_rn(v, __bfloat162float(hi)));
  return (unsigned int)__bfloat16_as_ushort(hi) |
         ((unsigned int)__bfloat16_as_ushort(lo) << 16);
}

// The dynamic shared memory a kernel has been allowed so far, per device:
// the attribute lives in each device's context, so raising it on one card
// does not raise it on another.  One static instance a kernel.
struct SmemLimit {
  static constexpr int kMaxDevices = 64;
  size_t raised[kMaxDevices] = {};
};

// Lets `kernel` launch with `bytes` of dynamic shared memory on the current
// device (above the 48 KB default it must be raised; once a device, or
// every call past kMaxDevices).
inline cudaError_t allow_smem(const void* kernel, size_t bytes, SmemLimit& lim) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool cached = dev >= 0 && dev < SmemLimit::kMaxDevices;
  if (cached && bytes <= lim.raised[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess && cached) lim.raised[dev] = bytes;
  return e;
}

// The lanes of the warp whose digit equals this lane's: d in [0, 2**bits)
// or -1 (then: the lanes whose digit is -1).  One ballot a bit, as radix
// sorts on this card do it: __match_any_sync costs several times more.
__device__ inline unsigned int match_digit(int d, int bits) {
  const unsigned int valid = __ballot_sync(kFull, d >= 0);
  unsigned int peers = d >= 0 ? valid : ~valid;
  for (int b = 0; b < bits; ++b) {
    const unsigned int set = __ballot_sync(kFull, (d >> b) & 1);
    peers &= (d >> b) & 1 ? set : ~set;
  }
  return peers;
}

// Shared ints rank_pass needs for its counters: n_dig per warp.
__host__ __device__ constexpr int rank_counters(int n_dig) { return kWarps * n_dig; }

// One stable counting pass over the slots [0, n), n a multiple of 256.
// digit(i) is slot i's digit in [0, n_dig) (n_dig a power of two <= 256),
// or -1 for a slot
// that is left out.  place(i, p) is called once for every kept slot with p
// = its rank among the kept slots ordered by (digit, slot), or, given
// dig_off (n_dig ints, shared or global), p = dig_off[digit] + its rank
// among the kept slots of its digit.  wc: rank_counters(n_dig) shared ints;
// ws: 32 shared ints.  Returns the number of kept slots.  Every thread of
// the block calls it; it ends with a barrier.
template <class Digit, class Place>
__device__ int rank_pass(int n, int n_dig, Digit digit, Place place, int* wc,
                         int* ws, const int* dig_off = nullptr) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int seg = n / kWarps;  // a multiple of 32: whole warp steps
  const int bits = 31 - __clz(n_dig);
  for (int i = tid; i < kWarps * n_dig; i += kThreads) wc[i] = 0;
  __syncthreads();
  int* mine = wc + w * n_dig;
  for (int i = w * seg + lane; i < (w + 1) * seg; i += 32) {
    const int d = digit(i);
    const unsigned int peers = match_digit(d, bits);
    if (d >= 0 && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // Per digit: each warp's first place (digit-major, warp-minor).
  int kept = 0;
  for (int d0 = 0; d0 < n_dig; d0 += kThreads) {
    const int d = d0 + tid;
    int run = 0;
    if (d < n_dig) {
      for (int v = 0; v < kWarps; ++v) {
        const int t = wc[v * n_dig + d];
        wc[v * n_dig + d] = run;
        run += t;
      }
    }
    int tot;
    const int base = kept + block_scan(run, ws, tot);
    kept += tot;
    if (d < n_dig) {
      const int off = dig_off != nullptr ? dig_off[d] : base;
      for (int v = 0; v < kWarps; ++v) wc[v * n_dig + d] += off;
    }
  }
  __syncthreads();
  for (int i = w * seg + lane; i < (w + 1) * seg; i += 32) {
    const int d = digit(i);
    const unsigned int peers = match_digit(d, bits);
    if (d >= 0) place(i, mine[d] + __popc(peers & ((1u << lane) - 1u)));
    __syncwarp();
    if (d >= 0 && lane == __ffs(peers) - 1) mine[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  return kept;
}

// Buffers of sort_slots: two of n keys and two of n slot indices.
struct SortBufs {
  int *ka, *kb;
  unsigned short *ia, *ib;
};

// Digits sort_slots uses for keys of `bits` bits: its passes and the
// counters of the widest.
__host__ __device__ constexpr int sort_passes(int bits) {
  return bits <= 0 ? 1 : (bits + kDigitBits - 1) / kDigitBits;
}
__host__ __device__ constexpr int sort_digits(int bits) {
  return bits >= kDigitBits ? kDigits : 1 << (bits > 0 ? bits : 0);
}

// Stable sort of the slots [0, n) (n a multiple of 256, at most 65536) by
// b.kb[i] in [0, 2**bits), or -1 for a slot that is left out: on return
// keys[j] and slots[j], j < the returned count, hold the kept slots' keys
// and slot indices in key order, slots in order within a key.  b.kb is
// overwritten from the second pass on.
__device__ inline int sort_slots(int n, int bits, const SortBufs& b, int* wc,
                                 int* ws, const int*& keys,
                                 const unsigned short*& slots) {
  const int passes = sort_passes(bits);
  int kept = n;
  int* kin = b.kb;
  unsigned short* iin = nullptr;  // the first pass's slots are the identity
  int* kout = b.ka;
  unsigned short* iout = b.ia;
  for (int p = 0; p < passes; ++p) {
    const int shift = p * kDigitBits;
    const int rest = bits - shift;
    const int n_dig = sort_digits(rest);
    const int m = kept;
    const int* kc = kin;
    const unsigned short* ic = iin;
    kept = rank_pass(
        n, n_dig,
        [=](int i) {
          if (i >= m) return -1;
          const int k = kc[i];
          return k < 0 ? -1 : (k >> shift) & (kDigits - 1);
        },
        [=](int i, int pos) {
          kout[pos] = kc[i];
          iout[pos] = ic != nullptr ? ic[i] : (unsigned short)i;
        },
        wc, ws);
    kin = kout;
    iin = iout;
    kout = kout == b.ka ? b.kb : b.ka;
    iout = iout == b.ia ? b.ib : b.ia;
  }
  keys = kin;
  slots = iin;
  return kept;
}

// First j in [0, n) with keys[j] >= k (keys sorted ascending).
__device__ inline int lower_bound(const int* keys, int n, int k) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (keys[mid] < k) lo = mid + 1; else hi = mid;
  }
  return lo;
}

}  // namespace blk
