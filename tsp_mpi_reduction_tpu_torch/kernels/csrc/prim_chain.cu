// Prim MST chain of the branch-and-bound node re-bound, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tsp_mpi_reduction_tpu/ops/prim_pallas.py
// (_prim_kernel / prim_chain). For each B&B node (lane) b with unvisited set
// U = {c : unvis[b,c]} it runs the n-1 steps of Prim's MST over U on the
// reduced costs
//
//     row(u)[c] = (dbar[u,c] + lam[b,u]) + lam[b,c]     (lam optional)
//
// and returns the tree total tot[b] (float32, accumulated in step order) and
// the per-city degrees deg[b,c] (int32). The chain is, step for step, the
// fori loop of models/branch_bound._mst_conn in the JAX package:
//
//   start    = first unvisited city, 0 if there is none
//   intree   = {start}; mind = unvis ? row(start) : inf; closest = start
//   each step: u = first-index argmin of (intree ? inf : mind); wu = its value
//              tot += isfinite(wu) ? wu : 0; when wu is finite, deg[u] and
//              deg[closest[u]] gain one; intree |= {u};
//              r = unvis ? row(u) : inf; closest = r < mind ? u : closest;
//              mind = min(mind, r)
//
// Exactness: only adds and compares, in the order above (and nvcc runs with
// --fmad=false); the warp argmin orders (value, index) pairs, so ties go to
// the lower index as argmin's do. The result is bit-identical to the plain
// PyTorch version prim_chain_reference (ops/prim_kernels.py).
//
// What bounds it on this card: not bytes (a lane reads n bytes of unvis and
// n floats of lam once, writes n+1 words) and not operations (about 4n per
// step), but the n-1 dependent steps of the chain: each is a 5-level warp
// shuffle reduction plus a row read. The design gives each lane one warp,
// with the lane's mind/closest/intree/unvis/lam/deg in registers (each
// thread holds the cities c = tid + 32*e, e < NPT = ceil(n/32) <= 7), so a
// step touches no memory except one row of dbar: from shared memory up to
// n = 96 (36 KB, inside the 48 KB a block gets without opt-in), else from
// global memory, where it stays resident in L1/L2 (160 KB at n = 200). The
// TPU version's 128-lane padding, 128-row tiles, one-hot matmul row select
// and float-encoded `closest` are not carried over.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// The launcher enqueues on the given stream, does not synchronise, and
// returns cudaGetLastError() so a refused launch is reported.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 200;                // MAX_BNB_CITIES
constexpr int kWarpsPerBlock = 4;
constexpr int kSmemNpt = 3;  // n <= 96: the n x n dbar (<= 36 KB) fits the 48 KB default
constexpr unsigned kFull = 0xffffffffu;

// (value, index) argmin across the warp; every thread gets the result.
__device__ __forceinline__ void warp_argmin(float& v, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, off);
    const int oi = __shfl_xor_sync(kFull, i, off);
    if (ov < v || (ov == v && oi < i)) {
      v = ov;
      i = oi;
    }
  }
}

template <int NPT, bool kHasLam, bool kSmem>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
prim_chain_kernel(const float* __restrict__ dbar,
                  const uint8_t* __restrict__ unvis,
                  const float* __restrict__ lam,
                  float* __restrict__ tot_out,
                  int32_t* __restrict__ deg_out,
                  int k, int n) {
  extern __shared__ float sd[];  // n*n floats when kSmem, else none
  if (kSmem) {
    for (int i = threadIdx.x; i < n * n; i += blockDim.x) sd[i] = dbar[i];
    __syncthreads();
  }
  const float* D = kSmem ? sd : dbar;

  const int tid = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= k) return;  // whole warps leave together
  const float inf = __int_as_float(0x7f800000);

  bool un[NPT], in_tree[NPT];
  float lm[NPT], mind[NPT];
  int closest[NPT], deg[NPT];
  const uint8_t* ub = unvis + (size_t)lane * n;
  const float* lb = kHasLam ? lam + (size_t)lane * n : nullptr;

  // start: the first unvisited city (0 when U is empty)
  int start = -1;
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int c = tid + 32 * e;
    un[e] = c < n && ub[c] != 0;
    lm[e] = (kHasLam && c < n) ? lb[c] : 0.0f;
    const unsigned m = __ballot_sync(kFull, un[e]);
    if (start < 0 && m != 0u) start = 32 * e + __ffs(m) - 1;
  }
  if (start < 0) start = 0;

  const float lam_s = kHasLam ? lb[start] : 0.0f;
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int c = tid + 32 * e;
    float r = inf;
    if (c < n) {
      r = D[start * n + c];
      if (kHasLam) r = (r + lam_s) + lm[e];
    }
    mind[e] = un[e] ? r : inf;
    in_tree[e] = c == start;
    closest[e] = start;
    deg[e] = 0;
  }

  float tot = 0.0f;
  for (int step = 0; step < n - 1; ++step) {
    // first-index argmin over cand = intree ? inf : mind; cities past n
    // carry inf with an index above every real one, so they never win
    float bv = inf;
    int bi = 0x7fffffff;
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      const int c = tid + 32 * e;
      const float cv = (c >= n || in_tree[e]) ? inf : mind[e];
      if (c < n && (cv < bv || (cv == bv && c < bi))) {
        bv = cv;
        bi = c;
      }
    }
    warp_argmin(bv, bi);
    const int u = bi;
    const float wu = bv;
    const bool fin = isfinite(wu);
    tot = tot + (fin ? wu : 0.0f);

    // par = closest[u], held by thread u % 32 in slot u / 32
    int par_mine = 0;
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      if (e == (u >> 5)) par_mine = closest[e];
    }
    const int par = __shfl_sync(kFull, par_mine, u & 31);

    const float lam_u = kHasLam ? lb[u] : 0.0f;
    const float* du = D + u * n;
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      const int c = tid + 32 * e;
      if (fin) deg[e] += (c == u) + (c == par);
      if (c == u) in_tree[e] = true;
      if (c < n) {
        float r = du[c];
        if (kHasLam) r = (r + lam_u) + lm[e];
        if (!un[e]) r = inf;
        if (r < mind[e]) {
          closest[e] = u;
          mind[e] = r;
        }
      }
    }
  }

  if (tid == 0) tot_out[lane] = tot;
  int32_t* db = deg_out + (size_t)lane * n;
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int c = tid + 32 * e;
    if (c < n) db[c] = deg[e];
  }
}

template <int NPT, bool kHasLam>
cudaError_t launch_npt(const float* dbar, const uint8_t* unvis, const float* lam,
                       float* tot, int32_t* deg, int k, int n, cudaStream_t s) {
  // dbar in shared memory up to n = 96 (36 KB), from L1/L2 above
  constexpr bool kSmem = NPT <= kSmemNpt;
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const size_t smem = kSmem ? sizeof(float) * n * n : 0;
  prim_chain_kernel<NPT, kHasLam, kSmem><<<grid, block, smem, s>>>(dbar, unvis, lam, tot, deg, k, n);
  return cudaGetLastError();
}

template <bool kHasLam>
cudaError_t launch(const float* dbar, const uint8_t* unvis, const float* lam,
                   float* tot, int32_t* deg, int k, int n, cudaStream_t s) {
  switch ((n + 31) / 32) {
    case 1: return launch_npt<1, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 2: return launch_npt<2, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 3: return launch_npt<3, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 4: return launch_npt<4, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 5: return launch_npt<5, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 6: return launch_npt<6, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    case 7: return launch_npt<7, kHasLam>(dbar, unvis, lam, tot, deg, k, n, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int prim_chain_launch(const void* dbar, const void* unvis, const void* lam,
                      void* tot, void* deg, int k, int n, void* stream) {
  if (n < 1 || n > kMaxN || k < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dbar);
  const uint8_t* u = static_cast<const uint8_t*>(unvis);
  const float* l = static_cast<const float*>(lam);
  float* t = static_cast<float*>(tot);
  int32_t* g = static_cast<int32_t*>(deg);
  const cudaError_t err = l ? launch<true>(d, u, l, t, g, k, n, s)
                            : launch<false>(d, u, l, t, g, k, n, s);
  return static_cast<int>(err);
}

const char* prim_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
