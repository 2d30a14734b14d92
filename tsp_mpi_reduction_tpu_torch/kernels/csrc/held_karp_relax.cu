// Held-Karp min-plus relaxation kernels for Hopper (sm_90a), float and double.
//
// They replace the two Pallas TPU kernels of
// tsp_mpi_reduction_tpu/ops/held_karp_pallas.py:
//
//   relax_minplus  <- _relax_kernel / relax_minplus (compact layout)
//       cost[b,j,k]   = min_{m'} g[b,j,m'] + d_t[b,k,m']
//       parent[b,j,k] = the first m' reaching that minimum
//   relax_dense    <- _relax_dense_kernel / relax_dense (dense layout)
//       for every mask of popcount c and every endpoint k outside it:
//       table[b,k,mask] = min_{i in mask} table[b,i,mask^(1<<i)] + d_sub[b,i,k]
//
// Exactness: both kernels only add and compare, so there is no multiply to
// contract into an FMA; a strict `<` over ascending indices gives the
// first-index tie-break of torch.argmin. Results are bit-identical to the
// plain PyTorch versions in ops/held_karp_kernels.py.
//
// What bounds them on the card: both are gathers over bit-indexed tables
// with 2 operations per loaded value, far below the ridge point, so they are
// bound by memory traffic. The design keeps each thread's predecessor
// values in registers (at most 17 of them) and the block's distance matrix
// in shared memory, so every table value is read from device memory once
// per thread that needs it and every output is written once. The dense
// kernel visits only the masks of the current popcount (an index list),
// not the whole 2^m table, and updates it in place: a step reads only
// popcount c-1 entries and writes only popcount c entries, so there is no
// race. Coalescing, TMA and persistent blocks are later work.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// Each launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 17;  // n - 1 for the largest block, MAX_BLOCK_CITIES = 18
constexpr int kThreads = 256;

template <typename T>
__global__ void relax_minplus_kernel(const T* __restrict__ g,
                                     const T* __restrict__ d_t,
                                     T* __restrict__ cost,
                                     int32_t* __restrict__ parent,
                                     int J, int M) {
  __shared__ T sd[kMaxM * kMaxM];
  const int b = blockIdx.y;
  const T* dtb = d_t + (size_t)b * M * M;
  for (int i = threadIdx.x; i < M * M; i += blockDim.x) sd[i] = dtb[i];
  __syncthreads();

  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= J) return;
  const size_t row = ((size_t)b * J + j) * M;
  T gv[kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
    if (i < M) gv[i] = g[row + i];
  }
  for (int k = 0; k < M; ++k) {
    const T* dk = sd + k * M;
    T best = gv[0] + dk[0];
    int arg = 0;
#pragma unroll
    for (int i = 1; i < kMaxM; ++i) {
      if (i < M) {
        const T v = gv[i] + dk[i];
        if (v < best) {
          best = v;
          arg = i;
        }
      }
    }
    cost[row + k] = best;
    parent[row + k] = arg;
  }
}

template <typename T>
__global__ void relax_dense_kernel(T* __restrict__ table,
                                   const T* __restrict__ d_sub,
                                   const int32_t* __restrict__ masks,
                                   int count, int m) {
  __shared__ T sd[kMaxM * kMaxM];
  const int b = blockIdx.y;
  const T* db = d_sub + (size_t)b * m * m;
  for (int i = threadIdx.x; i < m * m; i += blockDim.x) sd[i] = db[i];
  __syncthreads();

  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= count) return;
  const int mask = masks[t];
  const size_t S = (size_t)1 << m;
  T* tb = table + (size_t)b * m * S;
  T gv[kMaxM];
#pragma unroll
  for (int i = 0; i < kMaxM; ++i) {
    if (i < m && ((mask >> i) & 1)) gv[i] = tb[(size_t)i * S + (mask ^ (1 << i))];
  }
  for (int k = 0; k < m; ++k) {
    if ((mask >> k) & 1) continue;  // endpoint inside the mask: not a state
    bool have = false;
    T best = T(0);
#pragma unroll
    for (int i = 0; i < kMaxM; ++i) {
      if (i < m && ((mask >> i) & 1)) {
        const T v = gv[i] + sd[i * m + k];
        if (!have || v < best) {
          best = v;
          have = true;
        }
      }
    }
    tb[(size_t)k * S + mask] = best;
  }
}

}  // namespace

extern "C" {

int hk_relax_minplus(const void* g, const void* d_t, void* cost, void* parent,
                     int B, int J, int M, int is_double, void* stream) {
  const dim3 grid((J + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    relax_minplus_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double*>(g), static_cast<const double*>(d_t),
        static_cast<double*>(cost), static_cast<int32_t*>(parent), J, M);
  } else {
    relax_minplus_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(g), static_cast<const float*>(d_t),
        static_cast<float*>(cost), static_cast<int32_t*>(parent), J, M);
  }
  return static_cast<int>(cudaGetLastError());
}

int hk_relax_dense(void* table, const void* d_sub, const void* masks, int count,
                   int B, int m, int is_double, void* stream) {
  const dim3 grid((count + kThreads - 1) / kThreads, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    relax_dense_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<double*>(table), static_cast<const double*>(d_sub),
        static_cast<const int32_t*>(masks), count, m);
  } else {
    relax_dense_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<float*>(table), static_cast<const float*>(d_sub),
        static_cast<const int32_t*>(masks), count, m);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
