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
// What bounds it on this card: bytes. It reads k parent rows, dest [k, n]
// and the three float columns at the pushed children, and writes n_push
// rows; at eil51 with k = 1024 that is about 0.37 MB a step, some 0.1 us at
// 3.35 TB/s, so the launch and the latency of its dependent global reads
// dominate. The design keeps the traffic at that minimum and the chain of
// dependent reads at two rounds:
//
//   - kSplit = 2 warps per (parent, chunk of 32 children): k * ceil(n/32)
//     * 2 warps, 8 a block; warp s of a chunk stores the chunk's pushed
//     children of rank s mod 2, so a parent that pushes many children
//     spreads them over 2 * ceil(n/32) warps instead of lengthening one
//     warp's serial loop;
//   - round 1: the warp loads the parent row (column lane in `lo`, column
//     lane + 32 in `hi`; C <= 61 at n = 200) and lane l loads dest of
//     child chunk*32 + l, both issued together; a ballot names the pushed
//     children, and a warp with none of its own leaves;
//   - round 2: each of the warp's children's lanes loads its own three
//     float columns, all at once, so no float of a pruned child is read;
//   - the store loop then makes no global load and takes no branch on the
//     column: for each child the warp gathers its destination and floats
//     by shuffle, builds the row with selects from per-lane words fixed
//     before the loop, and stores it as one contiguous run of C words over
//     the lanes (coalesced; two stores a lane when C > 32).
//
// kSplit = 2 and the branch-free loop were chosen by timing variants on
// the recorded eil51 and kroA100 launches (tools/kernel_variants.py,
// PERF.md section 6). The TPU version's whole-buffer VMEM block, its
// input-copy seed at grid step 0 and its 12 MB VMEM budget refusal are not
// carried over: the kernel writes only the pushed rows of the existing
// allocation.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// The launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 200;  // MAX_BNB_CITIES: C <= 50 + 7 + 4 = 61 < 64
constexpr int kWarpsPerBlock = 8;
constexpr int kSplit = 2;  // warps a chunk: warp s stores the pushed children of rank s mod kSplit
constexpr unsigned kFull = 0xffffffffu;

// kSplit warps a (parent, chunk of 32 children): the launch's grid
dim3 push_grid(int k, int n) {
  const long long warps = (long long)k * ((n + 31) / 32) * kSplit;
  return dim3(static_cast<unsigned>((warps + kWarpsPerBlock - 1) / kWarpsPerBlock));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
push_rows_kernel(int32_t* __restrict__ nodes,
                 const int32_t* __restrict__ parents,
                 const int32_t* __restrict__ dest,
                 const int32_t* __restrict__ ccost,
                 const int32_t* __restrict__ cbound,
                 const int32_t* __restrict__ csum,
                 int f_rows, int cols, int k, int n) {
  const int lane = threadIdx.x & 31;
  const int chunks = (n + 31) >> 5;
  const int gw = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gw >= k * chunks * kSplit) return;  // whole warps leave together
  const int task = gw / kSplit;
  const int part = gw - task * kSplit;
  const int p = task / chunks;
  const int c0 = (task - p * chunks) << 5;

  // round 1: this lane's dest and the parent row, issued together
  const size_t at = (size_t)p * n + c0 + lane;
  const int my_dst = c0 + lane < n ? dest[at] : -1;
  const int32_t* prow = parents + (size_t)p * cols;
  const uint32_t lo = lane < cols ? static_cast<uint32_t>(prow[lane]) : 0u;
  const uint32_t hi = lane + 32 < cols ? static_cast<uint32_t>(prow[lane + 32]) : 0u;
  bool pushed = my_dst >= 0 && my_dst < f_rows;
  unsigned todo = __ballot_sync(kFull, pushed);
  if (kSplit > 1) {  // this warp's share: the pushed children of rank part mod kSplit
    pushed = pushed && __popc(todo & ((1u << lane) - 1u)) % kSplit == part;
    todo = __ballot_sync(kFull, pushed);
  }
  if (todo == 0u) return;  // uniform across the warp

  // round 2: the pushed children's float columns, one lane each
  uint32_t fc = 0u, fb = 0u, fs = 0u;
  if (pushed) {
    fc = static_cast<uint32_t>(ccost[at]);
    fb = static_cast<uint32_t>(cbound[at]);
    fs = static_cast<uint32_t>(csum[at]);
  }

  const int pw = (n + 3) >> 2;
  const int dcol = pw + ((n + 31) >> 5);  // the depth column, after the path and mask words
  const uint32_t dsrc = dcol < 32 ? __shfl_sync(kFull, lo, dcol) : __shfl_sync(kFull, hi, dcol - 32);
  const int depth = static_cast<int>(dsrc);
  const int dpos = depth < n - 1 ? depth : n - 1;
  // a negative position (never a real node) matches no path word
  const int wsel = dpos >= 0 ? (dpos >> 2) : -1;
  const uint32_t shift = 8u * static_cast<uint32_t>(dpos & 3);
  const uint32_t keep = ~(0xFFu << shift);
  // what column j = lane (+ 32) holds in every child row but its own
  // bytes and bits: the parent's word, or depth + 1 in the depth column
  const uint32_t depth1 = static_cast<uint32_t>(depth + 1);
  const uint32_t word0 = lane == dcol ? depth1 : lo;
  const uint32_t word1 = lane + 32 == dcol ? depth1 : hi;

  // the store loop: shuffles and selects only, no branch on the column
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int c = c0 + src;
    const int dst = __shfl_sync(kFull, my_dst, src);
    const uint32_t vc = __shfl_sync(kFull, fc, src);
    const uint32_t vb = __shfl_sync(kFull, fb, src);
    const uint32_t vs = __shfl_sync(kFull, fs, src);
    const uint32_t cu = static_cast<uint32_t>(c);
    const int mcol = pw + (c >> 5);  // the mask word that takes bit c
    const uint32_t bit = 1u << (cu & 31u);
    int32_t* out = nodes + (size_t)dst * cols;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = lane + 32 * half;
      uint32_t v = half ? word1 : word0;
      v = j == wsel ? ((v & keep) | (cu << shift)) : v;  // wsel < pw: a path word
      v = j == mcol ? (v | bit) : v;
      v = j == dcol + 1 ? vc : v;
      v = j == dcol + 2 ? vb : v;
      v = j == dcol + 3 ? vs : v;
      if (j < cols) out[j] = static_cast<int32_t>(v);
    }
  }
}

// The launch floor: an empty kernel on push_rows' grid and block.
__global__ void __launch_bounds__(kWarpsPerBlock * 32) push_rows_floor_kernel() {}

bool push_args_ok(int f_rows, int cols, int k, int n) {
  return n >= 1 && n <= kMaxN && k >= 1 && f_rows >= 1 && cols == (n + 3) / 4 + (n + 31) / 32 + 4;
}

}  // namespace

extern "C" {

int push_rows_launch(void* nodes, const void* parents, const void* dest, const void* ccost,
                     const void* cbound, const void* csum, int f_rows, int cols, int k, int n,
                     void* stream) {
  if (!push_args_ok(f_rows, cols, k, n)) return static_cast<int>(cudaErrorInvalidValue);
  push_rows_kernel<<<push_grid(k, n), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int32_t*>(nodes), static_cast<const int32_t*>(parents),
      static_cast<const int32_t*>(dest), static_cast<const int32_t*>(ccost),
      static_cast<const int32_t*>(cbound), static_cast<const int32_t*>(csum), f_rows, cols, k, n);
  return static_cast<int>(cudaGetLastError());
}

// For measurement only (tools/kernel_times.py): the empty kernel on the
// grid push_rows_launch would use for k parents of n cities.
int push_rows_floor_launch(int k, int n, void* stream) {
  if (n < 1 || n > kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  push_rows_floor_kernel<<<push_grid(k, n), kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

const char* push_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
