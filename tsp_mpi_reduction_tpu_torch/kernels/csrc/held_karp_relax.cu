// Held-Karp min-plus relaxation kernels for Hopper (sm_90a), float and double.
//
// They replace the two Pallas TPU kernels of
// tsp_mpi_reduction_tpu/ops/held_karp_pallas.py:
//
//   relax_minplus     <- _relax_kernel / relax_minplus (compact layout)
//       cost[b,j,k]   = min_{m'} g[b,j,m'] + d_t[b,k,m']
//       parent[b,j,k] = the first m' reaching that minimum
//   relax_dense_sweep <- _relax_dense_kernel / relax_dense (dense layout),
//       every cardinality c = 1 .. m-1 of the DP in one tiled sweep:
//       for every mask of popcount c and every endpoint k outside it,
//       table[b,k,mask] = min_{i in mask} table[b,i,mask^(1<<i)] + d_sub[b,i,k]
//
// Exactness: both kernels only add and compare, so there is no multiply to
// contract into an FMA (nvcc runs with --fmad=false anyway). relax_minplus
// keeps a strict `<` over ascending indices, the first-index tie-break of
// torch.argmin. The sweep computes each state as the min over one add per
// predecessor, the same adds as the plain version's g + d_sub followed by
// amin; a min does not depend on the order of its operands when none is NaN
// and no -0.0 meets a +0.0, and here none can: distances are finite and
// non-negative and the table holds +inf where no state was written. So both
// results are bit-identical to the plain PyTorch versions in
// ops/held_karp_kernels.py, in float and double, for m up to kMaxM = 17.
//
// What bounds them on the card: both are min-plus products over
// bit-indexed tables with about 2 operations per value moved, far below the
// ridge point, so their bound is memory traffic. There is no tensor-core
// form of a min-plus product.
//
// relax_minplus (design): the [J, M] slab of block b is contiguous, so a
// tile of TJ rows is one contiguous run of TJ*M elements. A block of
// NT = P*M threads (P = floor(256 / M) rows a pass) copies its tile into
// shared memory with 16-byte vector loads (scalar loads for the elements
// before the first and after the last 16-byte boundary), at the same
// address modulo 16 so the vector stores line up. Thread t then owns the
// endpoint k = t % M, keeps the distance row d_t[b, k, :] in registers,
// and computes output o = t + s*NT (row t / M + s*P, column k) for the
// passes s = 0 .. kMinplusPasses-1, reading its row of g from shared memory
// (the few rows a warp touches fall in distinct banks for every M).
// Consecutive threads own consecutive outputs, so each warp's stores of
// cost and parent are 32 consecutive elements of the contiguous [J, M]
// output slab: coalesced without staging them in shared memory. The M
// adds and strict-< compares of an output are those of the plain version.
// M is a template parameter (1 .. kMaxM), so every loop over M unrolls
// with no bound checks.
//
// The sweep (design): a mask is split into h = m - l high bits H (cities
// l .. m-1) and l low bits L (cities 0 .. l-1). A tile is the 2^l masks
// sharing H, for all m endpoints: [m, 2^l] in shared memory. l is 9 in
// float and in double (the wrapper passes it; l = m when m is smaller, one
// tile): 30 KB a tile at m = 15 in float, 68 KB at m = 17 in double; with
// 128 threads a block, six blocks share an SM in float, three in double.
// Of the variants timed on the H100 (l = 8, 9, 10; 64 to 256 threads;
// register caps), this one was the fastest in float at m = 15.
// One launch per p = popcount(H), p = 0 .. h, each on a grid of C(h, p)
// tiles x B blocks: 7 launches at m = 15, where the per-cardinality design
// took 14. Inside a tile, state (k, M), k not in M, needs
// (i, M ^ (1<<i)) for each i in M:
//
//   - i a high bit: that state lies in tile H \ {i}, row i, written by the
//     previous launch; for fixed i these are 2^l contiguous values, read
//     coalesced along L. A pre-pass takes the min over them into the tile
//     (and the H = 0 tile loads the init row table[:, :, 0]);
//   - i a low bit: that state lies in the same tile. The tile sweeps
//     popcount(L) = 1 .. l in shared memory, __syncthreads() between
//     levels, each level reading only the one below it.
//
// A thread keeps the candidate minima of all endpoints of one mask in
// registers and folds in one predecessor at a time (one add and one min
// per endpoint, the predecessor's distance row a broadcast shared read),
// looping over the mask's set bits only: the instruction count follows
// the DP's own work. Then the tile writes its valid states
// (1 <= popcount(M) <= m-1, k not in M) once, coalesced along L, and
// leaves every other entry as it was, as the plain version copies it.
// Every computed state is written once and only the states whose endpoint
// is a high bit are read back from device memory: at m = 15, l = 9,
// B = 1024, float, about 1.0 GB written and 0.40 GB read for the whole DP,
// against about 14 x 1.46 GB of sectors touched by one launch per
// cardinality over a table whose same-popcount masks are sparse. What
// bounds the sweep on the card is latency rather than bytes: l levels of
// dependent shared-memory updates a tile, each level's masks a few warps.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// Each launcher enqueues on the given stream, does not synchronise, and
// returns the CUDA error of the attribute call or of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxM = 17;  // n - 1 for the largest block, MAX_BLOCK_CITIES = 18
constexpr int kSweepThreads = 128;

// relax_minplus: at most 256 threads a block, each computing one output in
// each of kMinplusPasses passes over a tile (4080 float32 values, 16 KB, at
// M = 15); both chosen by timing variants (tools/kernel_variants.py)
constexpr int kMinplusMaxThreads = 256;
constexpr int kMinplusPasses = 16;
__host__ __device__ constexpr int minplus_rows_per_pass(int m) { return kMinplusMaxThreads / m; }
__host__ __device__ constexpr int minplus_tile_rows(int m) { return minplus_rows_per_pass(m) * kMinplusPasses; }

// The sweep: at most 9 low bits (a tile [kMaxM, 2^9] is 34 KB in float,
// 68 KB in double), and per type the blocks an SM must hold at once, which
// caps a thread's registers (six blocks of 128 threads: 80 in float;
// double keeps its registers). Both chosen by timing the variants on the
// H100 at m = 15, B = 1024.
constexpr int kMaxLow = 9;
template <typename T> struct SweepMinBlocks;
template <> struct SweepMinBlocks<float> { static constexpr int value = 6; };
template <> struct SweepMinBlocks<double> { static constexpr int value = 1; };
constexpr int kMaxHigh = kMaxM - kMaxLow;  // h = m - l, at most 8
constexpr int kSdLd = 20;            // d_sub rows padded to 16-byte multiples

// min of two values that are never NaN; a -0.0 never meets a +0.0 here
__device__ __forceinline__ float min_of(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_of(double a, double b) { return fmin(a, b); }

// One tile of relax_minplus: rows j0 .. j0 + TJ - 1 of block b = blockIdx.y,
// j0 = blockIdx.x * TJ, on NT = P * M threads (the launcher's block size).
template <typename T, int M>
__global__ void __launch_bounds__(kMinplusMaxThreads)
relax_minplus_kernel(const T* __restrict__ g, const T* __restrict__ d_t,
                     T* __restrict__ cost, int32_t* __restrict__ parent, int J) {
  constexpr int P = minplus_rows_per_pass(M);
  constexpr int NT = P * M;
  constexpr int TJ = minplus_tile_rows(M);
  constexpr int V = 16 / sizeof(T);  // elements a 16-byte vector
  __shared__ __align__(16) T gs[TJ * M + V];
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int j0 = blockIdx.x * TJ;
  const int rows = min(TJ, J - j0);
  const int count = rows * M;
  const size_t e0 = ((size_t)b * J + j0) * M;  // the tile's first element
  const T* src = g + e0;

  // the tile: element e at gs[sh + e], the same address modulo 16 as src[e]
  const int sh = static_cast<int>((reinterpret_cast<uintptr_t>(src) & 15u) / sizeof(T));
  const int head = min((V - sh) % V, count);  // elements before the first 16-byte boundary
  const int nvec = (count - head) / V;
  const int tail = head + nvec * V;  // elements from here on follow the last one
  const uint4* vsrc = reinterpret_cast<const uint4*>(src + head);
  uint4* vdst = reinterpret_cast<uint4*>(gs + sh + head);
  for (int v = t; v < nvec; v += NT) vdst[v] = __ldcs(vsrc + v);
  if (t < head) gs[sh + t] = src[t];
  if (tail + t < count) gs[sh + tail + t] = src[tail + t];  // fewer than V <= NT

  // this thread's endpoint k and its distance row, in registers
  const int k = t % M;
  const T* dtk = d_t + ((size_t)b * M + k) * M;
  T dk[M];
#pragma unroll
  for (int i = 0; i < M; ++i) dk[i] = dtk[i];
  __syncthreads();

  // output o = t + s*NT is (row t/M + s*P, column k); consecutive threads
  // own consecutive outputs of the contiguous cost and parent slabs
  const int r0 = t / M;
  T* cb = cost + e0;
  int32_t* pb = parent + e0;
#pragma unroll
  for (int s = 0; s < kMinplusPasses; ++s) {
    const int r = r0 + s * P;
    if (r < rows) {
      const T* gr = gs + sh + r * M;
      T best = gr[0] + dk[0];
      int arg = 0;
#pragma unroll
      for (int i = 1; i < M; ++i) {
        const T v = gr[i] + dk[i];
        if (v < best) {
          best = v;
          arg = i;
        }
      }
      __stcs(cb + t + s * NT, best);
      __stcs(pb + t + s * NT, arg);
    }
  }
}

template <typename T, int M>
void launch_minplus_m(const T* g, const T* d_t, T* cost, int32_t* parent, int B, int J,
                      cudaStream_t s) {
  constexpr int TJ = minplus_tile_rows(M);
  const dim3 grid((J + TJ - 1) / TJ, B);
  relax_minplus_kernel<T, M><<<grid, minplus_rows_per_pass(M) * M, 0, s>>>(g, d_t, cost, parent, J);
}

template <typename T>
cudaError_t launch_minplus(const T* g, const T* d_t, T* cost, int32_t* parent, int B, int J,
                           int M, cudaStream_t s) {
  switch (M) {
#define HK_MINPLUS_CASE(m) \
  case m:                  \
    launch_minplus_m<T, m>(g, d_t, cost, parent, B, J, s); break;
    HK_MINPLUS_CASE(1) HK_MINPLUS_CASE(2) HK_MINPLUS_CASE(3) HK_MINPLUS_CASE(4)
    HK_MINPLUS_CASE(5) HK_MINPLUS_CASE(6) HK_MINPLUS_CASE(7) HK_MINPLUS_CASE(8)
    HK_MINPLUS_CASE(9) HK_MINPLUS_CASE(10) HK_MINPLUS_CASE(11) HK_MINPLUS_CASE(12)
    HK_MINPLUS_CASE(13) HK_MINPLUS_CASE(14) HK_MINPLUS_CASE(15) HK_MINPLUS_CASE(16)
    HK_MINPLUS_CASE(17)
#undef HK_MINPLUS_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// One launch of the sweep: every tile H = highs[blockIdx.x] (popcount p)
// of block b = blockIdx.y. `lows` lists the 2^l low masks by popcount.
// Each thread keeps the kMaxM candidate minima of one mask in registers
// and folds in one predecessor at a time: one add and one min per
// endpoint, the distances of the predecessor's row read from shared
// memory, so no instruction is spent on bits outside the mask.
template <typename T>
__global__ void __launch_bounds__(kSweepThreads, SweepMinBlocks<T>::value)
relax_dense_sweep_kernel(T* __restrict__ table,
                         const T* __restrict__ d_sub,
                         const int32_t* __restrict__ highs,
                         const int32_t* __restrict__ lows,
                         int m, int l) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nl = 1 << l;
  T* sd = reinterpret_cast<T*>(smem);  // [kMaxM][kSdLd] distances, +inf past m
  T* tile = sd + kMaxM * kSdLd;        // [m][2^l]: tile[k * nl + L] = state (k, H|L)
  const int h = m - l;
  const int H = highs[blockIdx.x];
  const int b = blockIdx.y;
  const size_t S = (size_t)1 << m;
  const size_t base = (size_t)H << l;
  T* tb = table + (size_t)b * m * S;
  const T* db = d_sub + (size_t)b * m * m;
  const T inf = static_cast<T>(INFINITY);
  for (int t = threadIdx.x; t < kMaxM * kSdLd; t += blockDim.x) {
    const int i = t / kSdLd, k = t - i * kSdLd;
    sd[t] = (i < m && k < m) ? db[i * m + k] : inf;
  }
  __syncthreads();

  // pre-pass: the high-bit predecessors (tiles of the previous launch),
  // loaded coalesced along L; the H = 0 tile holds the init row at L = 0
  for (int L = threadIdx.x; L < nl; L += blockDim.x) {
    T pv[kMaxHigh];
#pragma unroll
    for (int j = 0; j < kMaxHigh; ++j) {
      if (j < h && ((H >> j) & 1)) {
        pv[j] = tb[(size_t)(l + j) * S + ((base ^ ((size_t)1 << (l + j))) | L)];
      }
    }
    T best[kMaxM];
#pragma unroll
    for (int k = 0; k < kMaxM; ++k) best[k] = inf;
#pragma unroll
    for (int j = 0; j < kMaxHigh; ++j) {
      if (j < h && ((H >> j) & 1)) {  // uniform across the block
        const T* dr = sd + (l + j) * kSdLd;
#pragma unroll
        for (int k = 0; k < kMaxM; ++k) best[k] = min_of(best[k], pv[j] + dr[k]);
      }
    }
    if (base == 0 && L == 0) {
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) {
        if (k < m) best[k] = tb[(size_t)k * S];
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxM; ++k) {
      if (k < m) tile[k * nl + L] = best[k];
    }
  }
  __syncthreads();

  // the low-bit predecessors: popcount(L) = 1 .. l inside the tile; every
  // mask of a level has q bits, so the threads of a warp loop alike.
  // Entries with k inside the mask are computed and never read.
  int off = 0, cnt = 1;  // where popcount q starts in `lows`, and C(l, q)
  for (int q = 1; q <= l; ++q) {
    off += cnt;
    cnt = cnt * (l - q + 1) / q;
    for (int t = threadIdx.x; t < cnt; t += blockDim.x) {
      const int L = lows[off + t];
      T best[kMaxM];
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) best[k] = k < m ? tile[k * nl + L] : inf;
      for (unsigned rest = L; rest != 0u; rest &= rest - 1u) {
        const int i = __ffs(rest) - 1;
        const T pv = tile[i * nl + (L ^ (1 << i))];
        const T* dr = sd + i * kSdLd;
#pragma unroll
        for (int k = 0; k < kMaxM; ++k) best[k] = min_of(best[k], pv + dr[k]);
      }
#pragma unroll
      for (int k = 0; k < kMaxM; ++k) {
        if (k < m) tile[k * nl + L] = best[k];
      }
    }
    __syncthreads();
  }

  // write the valid states once, coalesced along L: k outside M and M not
  // empty (k outside M already means popcount(M) <= m-1)
  for (int k = 0; k < m; ++k) {
    if (k >= l && ((H >> (k - l)) & 1)) continue;  // the whole row is inside
    T* row = tb + (size_t)k * S + base;
    for (int L = threadIdx.x; L < nl; L += blockDim.x) {
      const bool in_mask = k < l && ((L >> k) & 1);
      if (!in_mask && (base | L) != 0) row[L] = tile[k * nl + L];
    }
  }
}

template <typename T>
cudaError_t launch_sweep(T* table, const T* d_sub, const int32_t* highs, int count,
                         const int32_t* lows, int B, int m, int l, cudaStream_t s) {
  if (l < 1 || l > kMaxLow || l > m || m > kMaxM || m - l > kMaxHigh) return cudaErrorInvalidValue;
  // opt in once to the shared memory of the largest tile, [kMaxM, 2^kMaxLow]
  static const cudaError_t attr = cudaFuncSetAttribute(
      relax_dense_sweep_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(T) * (kMaxM * (1 << kMaxLow) + kMaxM * kSdLd)));
  if (attr != cudaSuccess) return attr;
  const size_t smem = sizeof(T) * ((size_t)m * (1 << l) + kMaxM * kSdLd);
  const dim3 grid(count, B);
  relax_dense_sweep_kernel<T><<<grid, kSweepThreads, smem, s>>>(table, d_sub, highs, lows, m, l);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int hk_relax_minplus(const void* g, const void* d_t, void* cost, void* parent,
                     int B, int J, int M, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* par = static_cast<int32_t*>(parent);
  const cudaError_t err =
      is_double ? launch_minplus<double>(static_cast<const double*>(g), static_cast<const double*>(d_t),
                                         static_cast<double*>(cost), par, B, J, M, s)
                : launch_minplus<float>(static_cast<const float*>(g), static_cast<const float*>(d_t),
                                        static_cast<float*>(cost), par, B, J, M, s);
  return static_cast<int>(err);
}

// One launch of the dense sweep: the `count` tiles listed at `highs` (all
// of one popcount p of H, the launches going p = 0 .. m-l in order).
int hk_relax_dense_sweep(void* table, const void* d_sub, const void* highs, int count,
                         const void* lows, int B, int m, int l, int is_double, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* hi = static_cast<const int32_t*>(highs);
  const int32_t* lo = static_cast<const int32_t*>(lows);
  const cudaError_t err =
      is_double ? launch_sweep<double>(static_cast<double*>(table), static_cast<const double*>(d_sub),
                                       hi, count, lo, B, m, l, s)
                : launch_sweep<float>(static_cast<float*>(table), static_cast<const float*>(d_sub),
                                      hi, count, lo, B, m, l, s);
  return static_cast<int>(err);
}

const char* hk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
