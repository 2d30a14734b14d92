// Fused branch-and-bound push for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tsp_mpi_reduction_tpu/ops/expand_pallas.py
// (_push_kernel / push_rows). For every popped parent p (a packed frontier
// row) and child city c with 0 <= dest[p,c] < F, it builds the child's
// packed row and stores it at row dest[p,c] of the frontier `nodes`, in
// place. The row layout (C = P + W + 4 int32 words, P = ceil(n/4) path
// words, W = ceil(n/32) mask words):
//
//   [0, P)    the parent's path words, with the byte at prefix position
//             dpos = min(depth, n-1) (word dpos/4, shift 8*(dpos%4)) set
//             to c
//   [P, P+W)  the parent's visited-mask words with bit c ORed in
//   P+W       depth + 1
//   P+W+1..3  ccost[p,c], cbound[p,c], csum[p,c]: float32 bit patterns,
//             copied as they are (NaN payloads and -0.0 survive)
//
// Rows with dest outside [0, F) are not stored, and rows no child lands on
// keep what they held. The byte and bit arithmetic is uint32: the shift of
// 24 reaches the sign bit for city ids >= 128. The result is bit-identical
// to the plain PyTorch version push_rows_reference (ops/expand_kernels.py).
//
// What bounds it on this card: bytes. It reads k parent rows and four
// [k, n] int32 planes (dest and the three float columns) and writes n_push
// rows; at eil51 with k = 1024 that is about 1 MB a step, some 0.3 us at
// 3.35 TB/s, so the launch itself (a few us) dominates. The design keeps
// the traffic at that minimum and the launch short: one warp per parent,
// the parent row read once into two registers a thread (C <= 61 at
// n = 200), the dest row read once with a ballot per 32 children, and each
// pushed row stored by the warp as one contiguous run of C words spread
// over the lanes (coalesced; C = 33 at n = 100 takes a second pass for the
// last word). Pruned children cost one ballot bit and no store. The TPU
// version's whole-buffer VMEM block, its input-copy seed at grid step 0
// and its 12 MB VMEM budget refusal are not carried over: the kernel
// writes only the pushed rows of the existing allocation.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// The launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 200;  // MAX_BNB_CITIES: C <= 50 + 7 + 4 = 61 < 64
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
push_rows_kernel(int32_t* __restrict__ nodes,
                 const int32_t* __restrict__ parents,
                 const int32_t* __restrict__ dest,
                 const int32_t* __restrict__ ccost,
                 const int32_t* __restrict__ cbound,
                 const int32_t* __restrict__ csum,
                 int f_rows, int cols, int k, int n) {
  const int tid = threadIdx.x & 31;
  const int p = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= k) return;  // whole warps leave together

  const int pw = (n + 3) >> 2;
  const int w = (n + 31) >> 5;
  // the parent row: column tid in `lo`, column tid + 32 in `hi`
  const int32_t* prow = parents + (size_t)p * cols;
  const uint32_t lo = tid < cols ? static_cast<uint32_t>(prow[tid]) : 0u;
  const uint32_t hi = tid + 32 < cols ? static_cast<uint32_t>(prow[tid + 32]) : 0u;
  const int dcol = pw + w;  // the depth column
  const uint32_t dsrc = dcol < 32 ? __shfl_sync(kFull, lo, dcol) : __shfl_sync(kFull, hi, dcol - 32);
  const int depth = static_cast<int>(dsrc);
  const int dpos = depth < n - 1 ? depth : n - 1;
  // a negative position (never a real node) matches no path word
  const int wsel = dpos >= 0 ? (dpos >> 2) : -1;
  const uint32_t shift = 8u * static_cast<uint32_t>(dpos & 3);
  const uint32_t keep = ~(0xFFu << shift);

  const int32_t* drow = dest + (size_t)p * n;
  const size_t base = (size_t)p * n;
  for (int c0 = 0; c0 < n; c0 += 32) {
    const int cl = c0 + tid;
    const int my_dst = cl < n ? drow[cl] : -1;
    unsigned todo = __ballot_sync(kFull, my_dst >= 0 && my_dst < f_rows);
    while (todo) {
      const int src_lane = __ffs(todo) - 1;
      todo &= todo - 1;
      const int c = c0 + src_lane;
      const int dst = __shfl_sync(kFull, my_dst, src_lane);
      int32_t* out = nodes + (size_t)dst * cols;
      const uint32_t cu = static_cast<uint32_t>(c);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j = tid + 32 * half;
        if (j >= cols) continue;
        uint32_t v = half ? hi : lo;
        if (j < pw) {
          if (j == wsel) v = (v & keep) | (cu << shift);
        } else if (j < pw + w) {
          if (j - pw == (c >> 5)) v |= 1u << (cu & 31u);
        } else if (j == dcol) {
          v = static_cast<uint32_t>(depth + 1);
        } else if (j == dcol + 1) {
          v = static_cast<uint32_t>(ccost[base + c]);
        } else if (j == dcol + 2) {
          v = static_cast<uint32_t>(cbound[base + c]);
        } else {
          v = static_cast<uint32_t>(csum[base + c]);
        }
        out[j] = static_cast<int32_t>(v);
      }
    }
  }
}

}  // namespace

extern "C" {

int push_rows_launch(void* nodes, const void* parents, const void* dest, const void* ccost,
                     const void* cbound, const void* csum, int f_rows, int cols, int k, int n,
                     void* stream) {
  if (n < 1 || n > kMaxN || k < 1 || f_rows < 1 || cols != (n + 3) / 4 + (n + 31) / 32 + 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  push_rows_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(nodes), static_cast<const int32_t*>(parents),
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(ccost),
      static_cast<const int32_t*>(cbound), static_cast<const int32_t*>(csum), f_rows, cols, k, n);
  return static_cast<int>(cudaGetLastError());
}

const char* push_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
