// Prim MST chain of the branch-and-bound node re-bound, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tsp_mpi_reduction_tpu/ops/prim_pallas.py
// (_prim_kernel / prim_chain). For each B&B node (lane) b with unvisited set
// U = {c : unvis[b,c]} it runs Prim's MST over U on the reduced costs
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
// --fmad=false); ties go to the lower index as argmin's do. The result is
// bit-identical to the plain PyTorch version prim_chain_reference
// (ops/prim_kernels.py). No NaN reaches the kernel: dbar and lam are finite
// or +inf, so every row value and every mind is a number or +inf (a NaN
// would follow the strict `<` below and never win, where torch.argmin
// would pick it).
//
// What bounds it on this card: not bytes (a lane reads n bytes of unvis and
// n floats of lam once, writes n+1 words) and not operations (about 4n per
// step), but the chain of dependent steps, each an argmin across the warp
// followed by a row update. One warp per lane; each thread holds the cities
// c = tid + 32*e, e < NPT = ceil(n/32) <= 7, with the lane's mind, closest,
// lam and deg in registers and U and the tree as bit masks. The design
// shortens each step and runs fewer of them:
//
//   1. argmin by two warp reductions (redux.sync, sm_80+) instead of a
//      5-level shuffle butterfly: the min of an order-preserving uint32 key
//      of each thread's best value, then the min index among the threads
//      whose key equals it (a thread holds cities tid + 32e, so the lowest
//      lane of a ballot is not the lowest city). -0.0 is made +0.0 before
//      the key, since float `<` sees them equal; wu is read back from the
//      key, and tot never holds -0.0 (it starts at +0.0 and a sum is -0.0
//      only when both terms are), so adding +0.0 for -0.0 changes no bit;
//   2. lam[b,u] and closest[u] come by two independent shuffles from the
//      thread holding city u: no global load in the step;
//   3. dbar sits in shared memory for every n <= 200 (n*n floats, 160 KB at
//      n = 200, opt-in dynamic shared memory set once per instantiation),
//      so the step's row is a conflict-free shared read; 8 warps a block
//      put k = 1024 lanes in 128 blocks, about one per SM, so dbar is
//      copied into shared memory about 128 times;
//   4. a warp stops once every city of U is in the tree (a warp-uniform
//      ballot): after that a non-U city's mind stays +inf (its row values
//      are masked to +inf), so every later step has wu = inf and changes
//      neither tot nor deg. The fixed-length chain runs n-1 steps; this one
//      about |U|-1.
//
// There is no tensor-core form of a Prim chain. The TPU version's 128-lane
// padding, 128-row tiles, one-hot matmul row select and float-encoded
// `closest` are not carried over.
//
// Plain C interface, loaded from Python with ctypes (kernels/_build.py).
// The launcher enqueues on the given stream, does not synchronise, and
// returns the CUDA error of the attribute call or of the launch.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxN = 200;          // MAX_BNB_CITIES
constexpr int kWarpsPerBlock = 8;   // k = 1024 lanes -> 128 blocks on 132 SMs
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;

// Order-preserving key of a float that is not NaN: for a, b not NaN,
// a < b  <=>  key(a) < key(b), and a == b  <=>  key(a) == key(b).
__device__ __forceinline__ unsigned float_key(float v) {
  unsigned b = __float_as_uint(v);
  if (b == 0x80000000u) b = 0u;  // -0.0 -> +0.0
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

template <int NPT, bool kHasLam>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
prim_chain_kernel(const float* __restrict__ dbar,
                  const uint8_t* __restrict__ unvis,
                  const float* __restrict__ lam,
                  float* __restrict__ tot_out,
                  int32_t* __restrict__ deg_out,
                  int k, int n) {
  extern __shared__ float sd[];  // the n x n dbar
  const int nn = n * n;
  if ((reinterpret_cast<uintptr_t>(dbar) & 15u) == 0u) {
    const float4* src = reinterpret_cast<const float4*>(dbar);
    float4* dst = reinterpret_cast<float4*>(sd);
    for (int i = threadIdx.x; i < nn / 4; i += blockDim.x) dst[i] = src[i];
    for (int i = (nn / 4) * 4 + threadIdx.x; i < nn; i += blockDim.x) sd[i] = dbar[i];
  } else {
    for (int i = threadIdx.x; i < nn; i += blockDim.x) sd[i] = dbar[i];
  }
  __syncthreads();

  const int tid = threadIdx.x & 31;
  const int lane = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (lane >= k) return;  // whole warps leave together
  const float inf = __int_as_float(0x7f800000);

  unsigned un = 0u, tree = 0u;  // bit e: city tid + 32e is in U / in the tree
  float lm[NPT], mind[NPT];
  int closest[NPT], deg[NPT];
  const uint8_t* ub = unvis + (size_t)lane * n;
  const float* lb = kHasLam ? lam + (size_t)lane * n : nullptr;

  // start: the first unvisited city (0 when U is empty)
  int start = -1;
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int c = tid + 32 * e;
    const bool in_u = c < n && ub[c] != 0;
    un |= static_cast<unsigned>(in_u) << e;
    lm[e] = (kHasLam && c < n) ? lb[c] : 0.0f;
    const unsigned m = __ballot_sync(kFull, in_u);
    if (start < 0 && m != 0u) start = 32 * e + __ffs(m) - 1;
  }
  if (start < 0) start = 0;

  // lam[start] from the register of the thread holding city start
  float lam_s = 0.0f;
  if (kHasLam) {
    float mine = lm[0];
#pragma unroll
    for (int e = 1; e < NPT; ++e) {
      if (e == (start >> 5)) mine = lm[e];
    }
    lam_s = __shfl_sync(kFull, mine, start & 31);
  }
  const float* ds = sd + start * n;
#pragma unroll
  for (int e = 0; e < NPT; ++e) {
    const int c = tid + 32 * e;
    float r = inf;
    if (c < n) {
      r = ds[c];
      if (kHasLam) r = (r + lam_s) + lm[e];
    }
    mind[e] = ((un >> e) & 1u) ? r : inf;
    closest[e] = start;
    deg[e] = 0;
  }
  if ((start & 31) == tid) tree = 1u << (start >> 5);

  float tot = 0.0f;
  for (int step = 0; step < n - 1; ++step) {
    // every city of U in the tree: the remaining steps change nothing
    if (__ballot_sync(kFull, (un & ~tree) != 0u) == 0u) break;

    // this thread's first-index argmin over cand = intree ? inf : mind
    // (NaN never passes `<` or `==`, so bv is never NaN)
    float bv = inf;
    unsigned bi = kNoIndex;
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      const int c = tid + 32 * e;
      const float cv = ((tree >> e) & 1u) ? inf : mind[e];
      if (c < n && (cv < bv || (cv == bv && static_cast<unsigned>(c) < bi))) {
        bv = cv;
        bi = c;
      }
    }
    // across the warp: the least key, then the least city holding it
    const unsigned key = float_key(bv);
    const unsigned kmin = __reduce_min_sync(kFull, key);
    const int u = static_cast<int>(__reduce_min_sync(kFull, key == kmin ? bi : kNoIndex));
    const float wu = __uint_as_float((kmin & 0x80000000u) ? (kmin ^ 0x80000000u) : ~kmin);
    const bool fin = isfinite(wu);
    tot = tot + (fin ? wu : 0.0f);

    // closest[u] and lam[b,u] from the thread holding city u, slot u / 32
    const int slot = u >> 5;
    int par_mine = closest[0];
    float lam_mine = lm[0];
#pragma unroll
    for (int e = 1; e < NPT; ++e) {
      if (e == slot) {
        par_mine = closest[e];
        lam_mine = lm[e];
      }
    }
    const int par = __shfl_sync(kFull, par_mine, u & 31);
    const float lam_u = kHasLam ? __shfl_sync(kFull, lam_mine, u & 31) : 0.0f;
    if ((u & 31) == tid) tree |= 1u << slot;

    const float* du = sd + u * n;
#pragma unroll
    for (int e = 0; e < NPT; ++e) {
      const int c = tid + 32 * e;
      if (fin) deg[e] += (c == u) + (c == par);
      if (c < n) {
        float r = du[c];
        if (kHasLam) r = (r + lam_u) + lm[e];
        if (!((un >> e) & 1u)) r = inf;
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
  // opt in once per instantiation to the shared memory its largest n needs
  constexpr int kNmax = 32 * NPT < kMaxN ? 32 * NPT : kMaxN;
  static const cudaError_t attr = cudaFuncSetAttribute(
      prim_chain_kernel<NPT, kHasLam>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(float) * kNmax * kNmax));
  if (attr != cudaSuccess) return attr;
  const dim3 grid((k + kWarpsPerBlock - 1) / kWarpsPerBlock);
  const dim3 block(kWarpsPerBlock * 32);
  const size_t smem = sizeof(float) * n * n;
  prim_chain_kernel<NPT, kHasLam><<<grid, block, smem, s>>>(dbar, unvis, lam, tot, deg, k, n);
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
