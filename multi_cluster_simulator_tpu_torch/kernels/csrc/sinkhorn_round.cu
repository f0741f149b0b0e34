// The trader market's sinkhorn round (market/sinkhorn.py) on the card: the
// kernel matrix, the masked Sinkhorn iterations and the plan, every float
// step in the order the reference's compiled CPU program takes it.
//
//   sinkhorn_build    K[s, b] = feas ? xla_exp(fma(jitter, 0.5 eps, v[b]) /
//                     eps) : 0, and its transpose KT (the column product
//                     reads KT's rows).
//   sinkhorn_product  out[o] = the sum over M[o, :] * w in a reduction
//                     plan's order (market/sinkhorn.py ``Stage``): each
//                     stage's accumulators are chains of fused multiply-adds
//                     in index order, summed lane by lane in accumulator
//                     order, then folded across their lanes (the tiled
//                     gemv's horizontal sums, or halving). A group of
//                     threads an output, a thread a chain. Mode 0 writes
//                     1 / max(sum, 1e-30) into
//                     ``out`` (u or vc, in place); mode 1 writes the sum
//                     (a shard's partial column sums, which the caller
//                     all-sums across shards).
//   sinkhorn_finish   vc = 1 / max(allsummed, 1e-30) (the mesh's form).
//   sinkhorn_plan     plan[s, b] = (u[s] K[s, b]) vc[b].
//
// It replaces no Pallas kernel: the reference's round is XLA ops
// (multi_cluster_simulator_tpu/market/trader.py:300-321, _match_sinkhorn),
// and XLA's CPU code sums each product in an order that PyTorch's ops reach
// only as a chain of small ops a step (C / 8 steps an iteration). Here a
// thread runs one chain in the plan's order with __fmaf_rn and its group's
// first thread folds them, so the exact order costs one launch a product.
// Bound: bytes (the products read K, then KT, once an iteration; the
// arithmetic is one fused multiply-add a 4-byte value read). A first,
// simple design: the chains are as long as the plan makes them (C / 8 or
// C / 32 steps), a group's threads read neighbouring values of one row,
// and every zero of a sparse K is read.
//
// An iteration ``it`` is active while ``*iters > it`` (the traced active
// depth); an inactive one leaves u and vc as they are, so every launch of
// it returns at once. The file compiles with nvcc (sm_90a, --fmad=false) and,
// for the CPU tests, as host C++ against a shim cuda_runtime.h: the
// rounding steps are spelled out (``fma_rn``, ``add_rn``, ``mul_rn``,
// ``div_rn``), so neither compiler contracts or reorders them.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SK_DEV __device__ __forceinline__
static SK_DEV float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
static SK_DEV float add_rn(float a, float b) { return __fadd_rn(a, b); }
static SK_DEV float mul_rn(float a, float b) { return __fmul_rn(a, b); }
static SK_DEV float div_rn(float a, float b) { return __fdiv_rn(a, b); }
static SK_DEV float floor_f(float a) { return floorf(a); }
#else
#include <math.h>
#define SK_DEV static inline
SK_DEV float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
SK_DEV float add_rn(float a, float b) { return a + b; }
SK_DEV float mul_rn(float a, float b) { return a * b; }
SK_DEV float div_rn(float a, float b) { return a / b; }
SK_DEV float floor_f(float a) { return floorf(a); }
#endif

namespace sk {

constexpr float kTiny = 1e-30f;
// a stage's row of the plan table (market/sinkhorn.py ``pack_plan``)
constexpr int kLanes = 0, kAccs = 1, kSteps = 2, kSeeded = 3, kAdd = 4,
              kTreeRows = 5, kBlocks = 6, kStageWords = 7;

SK_DEV float max_rn(float a, float b) { return a > b ? a : b; }
SK_DEV float min_rn(float a, float b) { return a < b ? a : b; }

// jax.jit(jnp.exp) on XLA's CPU backend (ops/floats.py xla_exp_f32): the
// argument clamped, n = floor(x log2 e + 1/2) clamped to +-127, the
// reduction by ln 2 in two parts, a degree-5 polynomial, times 2^n; a
// result below the least normal f32 flushed to 0.
SK_DEV float xla_exp(float x) {
  x = min_rn(max_rn(x, -0x1.5f3334p+6f), 0x1.633334p+6f);
  float n = floor_f(fma_rn(x, 0x1.715476p+0f, 0.5f));
  n = min_rn(max_rn(n, -127.0f), 127.0f);
  float r = fma_rn(-n, -0x1.bd0106p-13f, fma_rn(-n, 0x1.63p-1f, x));
  float p = 0x1.a0d2cep-13f;
  p = fma_rn(p, r, 0x1.6e879cp-10f);
  p = fma_rn(p, r, 0x1.111210p-7f);
  p = fma_rn(p, r, 0x1.555382p-5f);
  p = fma_rn(p, r, 0x1.555554p-3f);
  p = fma_rn(p, r, 0.5f);
  float y = add_rn(fma_rn(p, mul_rn(r, r), r), 1.0f);
  union { int32_t i; float f; } scale;
  scale.i = ((int32_t)n + 127) << 23;
  float out = mul_rn(y, scale.f);
  return out < 0x1p-126f ? 0.0f : out;
}

SK_DEV bool active(const int32_t* iters, int it) { return *iters > it; }

SK_DEV void build_one(long e, const uint8_t* feas, const float* jitter,
                      const float* v, const float* eps, float* K, float* KT,
                      int c_loc, int c_tot) {
  int s = (int)(e / c_tot), b = (int)(e % c_tot);
  float k = 0.0f;
  if (feas[e]) {
    float ep = *eps;
    float score = fma_rn(jitter[e], mul_rn(ep, 0.5f), v[b]);
    k = xla_exp(div_rn(score, ep));
  }
  K[e] = k;
  KT[(long)b * c_loc + s] = k;
}

// chain ``k`` of a stage (accumulator k / W, lane k % W): a chain of fused
// multiply-adds from ``init`` over the accumulator's blocks in order
SK_DEV float chain(const float* row, const float* w, const int32_t* blk,
                   int W, int T, int k, float init) {
  const int32_t* b = blk + (k / W) * T;
  const int l = k % W;
  float acc = init;
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int t = 0; t < T; ++t) {
    const int i = b[t] + l;
    acc = fma_rn(row[i], w[i], acc);
  }
  return acc;
}

// a stage's value from its A W chains (c[a W + l]): the accumulators summed
// lane by lane, ((a0 + a1) + a2) + a3, then the W lanes folded: by the
// tiled gemv's AVX horizontal sums with ``tree``, else by halving
SK_DEV float fold(const float* c, int A, int W, bool tree) {
  float v[8];
  for (int l = 0; l < W; ++l) {
    float x = c[l];
    for (int a = 1; a < A; ++a) x = add_rn(x, c[a * W + l]);
    v[l] = x;
  }
  if (tree)
    return add_rn(add_rn(add_rn(v[0], v[1]), add_rn(v[2], v[3])),
                  add_rn(add_rn(v[4], v[5]), add_rn(v[6], v[7])));
  for (int h = W >> 1; h >= 1; h >>= 1)
    for (int l = 0; l < h; ++l) v[l] = add_rn(v[l], v[l + h]);
  return v[0];
}

SK_DEV float finish(float r, int mode) {
  return mode == 0 ? div_rn(1.0f, max_rn(r, kTiny)) : r;
}

}  // namespace sk

#ifdef __CUDACC__

static const int kThreads = 128;  // a multiple of 32: groups stay in a warp

__global__ void sinkhorn_build_kernel(const uint8_t* feas,
                                      const float* jitter, const float* v,
                                      const float* eps, float* K, float* KT,
                                      int c_loc, int c_tot) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (long)c_loc * c_tot)
    sk::build_one(e, feas, jitter, v, eps, K, KT, c_loc, c_tot);
}

// A group of G threads an output (G a power of 2 at least the chains a
// stage of the plan holds, at most a warp): thread k of the group runs
// chain k, the group's first thread folds the chains from shared memory in
// the plan's order, and the group carries the running value to the next
// stage.
__global__ void sinkhorn_product_kernel(const float* M, long ld, int rows,
                                        const float* w,
                                        const int32_t* stages, int n_stages,
                                        const int32_t* blocks, int G,
                                        const int32_t* iters, int it,
                                        int mode, float* out) {
  __shared__ float s_chain[kThreads];
  __shared__ float s_r[kThreads];
  if (!sk::active(iters, it)) return;  // the same for every thread
  const long gt = (long)blockIdx.x * blockDim.x + threadIdx.x;
  const int o = (int)(gt / G), k = (int)(gt % G);
  const int base = threadIdx.x - k;
  const bool live = o < rows;
  const float* row = M + (long)(live ? o : 0) * ld;
  float r = 0.0f;
  for (int si = 0; si < n_stages; ++si) {
    const int32_t* st = stages + si * sk::kStageWords;
    const int W = st[sk::kLanes], A = st[sk::kAccs];
    float c = 0.0f;
    if (live && k < A * W)
      c = sk::chain(row, w, blocks + st[sk::kBlocks], W, st[sk::kSteps], k,
                    st[sk::kSeeded] && k == 0 ? r : 0.0f);
    s_chain[threadIdx.x] = c;
    __syncwarp();
    if (k == 0) {
      const float val = sk::fold(s_chain + base, A, W,
                                 W == 8 && o < st[sk::kTreeRows]);
      s_r[base] = st[sk::kAdd] ? add_rn(r, val) : val;
    }
    __syncwarp();
    r = s_r[base];
    __syncwarp();
  }
  if (live && k == 0) out[o] = sk::finish(r, mode);
}

__global__ void sinkhorn_finish_kernel(const float* sums, float* vc, int n,
                                       const int32_t* iters, int it) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || !sk::active(iters, it)) return;
  vc[j] = div_rn(1.0f, sk::max_rn(sums[j], sk::kTiny));
}

__global__ void sinkhorn_plan_kernel(const float* u, const float* K,
                                     const float* vc, float* plan,
                                     int c_loc, int c_tot) {
  const long e = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e < (long)c_loc * c_tot)
    plan[e] = mul_rn(mul_rn(u[e / c_tot], K[e]), vc[e % c_tot]);
}

static unsigned grid_of(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

#define SK_LAUNCHED() return (int)cudaGetLastError()

extern "C" {

int sinkhorn_build(const uint8_t* feas, const float* jitter, const float* v,
                   const float* eps, float* K, float* KT, int c_loc,
                   int c_tot, cudaStream_t stream) {
  const long n = (long)c_loc * c_tot;
  if (n == 0) return 0;
  sinkhorn_build_kernel<<<grid_of(n), kThreads, 0, stream>>>(
      feas, jitter, v, eps, K, KT, c_loc, c_tot);
  SK_LAUNCHED();
}

int sinkhorn_product(const float* M, long ld, int rows, const float* w,
                     const int32_t* stages, int n_stages,
                     const int32_t* blocks, int G, const int32_t* iters,
                     int it, int mode, float* out, cudaStream_t stream) {
  if (rows == 0) return 0;
  if (G < 1 || G > 32 || (G & (G - 1))) return (int)cudaErrorInvalidValue;
  sinkhorn_product_kernel<<<grid_of((long)rows * G), kThreads, 0, stream>>>(
      M, ld, rows, w, stages, n_stages, blocks, G, iters, it, mode, out);
  SK_LAUNCHED();
}

int sinkhorn_finish(const float* sums, float* vc, int n,
                    const int32_t* iters, int it, cudaStream_t stream) {
  if (n == 0) return 0;
  sinkhorn_finish_kernel<<<grid_of(n), kThreads, 0, stream>>>(
      sums, vc, n, iters, it);
  SK_LAUNCHED();
}

int sinkhorn_plan(const float* u, const float* K, const float* vc,
                  float* plan, int c_loc, int c_tot, cudaStream_t stream) {
  const long n = (long)c_loc * c_tot;
  if (n == 0) return 0;
  sinkhorn_plan_kernel<<<grid_of(n), kThreads, 0, stream>>>(
      u, K, vc, plan, c_loc, c_tot);
  SK_LAUNCHED();
}

}  // extern "C"

#else  // a host build: each launch is a loop over its threads

extern "C" {

int sinkhorn_build(const uint8_t* feas, const float* jitter, const float* v,
                   const float* eps, float* K, float* KT, int c_loc,
                   int c_tot, cudaStream_t) {
  for (long e = 0; e < (long)c_loc * c_tot; ++e)
    sk::build_one(e, feas, jitter, v, eps, K, KT, c_loc, c_tot);
  return 0;
}

int sinkhorn_product(const float* M, long ld, int rows, const float* w,
                     const int32_t* stages, int n_stages,
                     const int32_t* blocks, int G, const int32_t* iters,
                     int it, int mode, float* out, cudaStream_t) {
  if (G < 1 || G > 32 || (G & (G - 1))) return 1;
  if (!sk::active(iters, it)) return 0;
  for (int o = 0; o < rows; ++o) {  // a group: its G threads one by one
    const float* row = M + (long)o * ld;
    float r = 0.0f;
    for (int si = 0; si < n_stages; ++si) {
      const int32_t* st = stages + si * sk::kStageWords;
      const int W = st[sk::kLanes], A = st[sk::kAccs];
      float c[32];
      for (int k = 0; k < G; ++k)
        c[k] = k < A * W ? sk::chain(row, w, blocks + st[sk::kBlocks], W,
                                     st[sk::kSteps], k,
                                     st[sk::kSeeded] && k == 0 ? r : 0.0f)
                         : 0.0f;
      const float val = sk::fold(c, A, W, W == 8 && o < st[sk::kTreeRows]);
      r = st[sk::kAdd] ? add_rn(r, val) : val;
    }
    out[o] = sk::finish(r, mode);
  }
  return 0;
}

int sinkhorn_finish(const float* sums, float* vc, int n,
                    const int32_t* iters, int it, cudaStream_t) {
  if (!sk::active(iters, it)) return 0;
  for (int j = 0; j < n; ++j)
    vc[j] = div_rn(1.0f, sk::max_rn(sums[j], sk::kTiny));
  return 0;
}

int sinkhorn_plan(const float* u, const float* K, const float* vc,
                  float* plan, int c_loc, int c_tot, cudaStream_t) {
  for (long e = 0; e < (long)c_loc * c_tot; ++e)
    plan[e] = mul_rn(mul_rn(u[e / c_tot], K[e]), vc[e % c_tot]);
  return 0;
}

}  // extern "C"

#endif
