// The trader market's sinkhorn round (market/sinkhorn.py) on the card: the
// kernel matrix, the masked Sinkhorn iterations and the plan, every float
// step in the order the reference's compiled CPU program takes it.
//
//   sinkhorn_build    K[s, b] = feas ? xla_exp(fma(jitter, 0.5 eps, v[b]) /
//                     eps) : 0, dense, and the compact forms of K's rows
//                     (the row product's) and of its columns (KT's rows,
//                     the column product's).
//   sinkhorn_iterate  the iterations on one device: one persistent
//                     cooperative launch runs both products of every
//                     iteration, a grid-wide barrier after each product.
//   sinkhorn_product  one product (the mesh's form, whose host all-sum sits
//                     between the two): mode 0 writes u = 1 / max(sum,
//                     1e-30) in place; mode 1 writes the shard's partial
//                     column sums, which the caller all-sums.
//   sinkhorn_finish   vc = 1 / max(allsummed, 1e-30) (the mesh's form).
//   sinkhorn_plan     plan[s, b] = (u[s] K[s, b]) vc[b].
//
// So a round on one device is three launches (build, iterate, plan); on a
// mesh it is the build, then each iteration's two products and finish,
// then the plan.
//
// It replaces no Pallas kernel: the reference's round is XLA ops
// (multi_cluster_simulator_tpu/market/trader.py:300-321, _match_sinkhorn),
// and XLA's CPU code sums each product in an order that PyTorch's ops reach
// only as a chain of small ops a step. Each output's sum follows its
// reduction plan (market/sinkhorn.py ``Stage``): chain k of a stage (lane
// k % W of accumulator k / W) visits the indices blk[(k / W) T + t] + k % W
// in t order as fused multiply-adds, then ``fold`` combines the chains.
//
// Bound: bytes. K is sparse (a pair is feasible for a few per cent of the
// sellers and buyers), so the products read only the feasible entries: the
// build writes, for every (output, stage, chain), that chain's feasible
// values and their indices in the chain's order (``compact_row``,
// ``compact_cols``). A chain over the compact list rounds exactly as the
// chain over the whole row does:
//   - K is xla_exp(...), finite and >= +0, or 0 where the pair is
//     infeasible; every w (u or vc) is 1 / max(s, 1e-30), finite and >= +0;
//   - every accumulator starts at +0 or at a seeded running sum >= +0, and
//     stays >= +0;
//   - so fma_rn(0, w, acc) == acc bit for bit, and dropping the zero terms
//     of a chain, the others kept in order, leaves every rounding as it
//     was. (A feasible pair whose exp underflowed to 0 stays in the list
//     and adds nothing.)
// Each chain's list sits in a slot as long as the chain (worst case, every
// pair feasible), so no count crosses chains and the build needs no scan
// and the round no host sync. The iterations stage their vector (vc or u)
// in shared memory once a block and gather from it.
//
// An iteration ``it`` is active while ``*iters > it`` (the traced active
// depth); an inactive one leaves u and vc as they are. The file compiles
// with nvcc (sm_90a, --fmad=false) and, for the CPU tests, as host C++
// against a shim cuda_runtime.h (each launch a loop over its threads): the
// rounding steps are spelled out (``fma_rn``, ``add_rn``, ``mul_rn``,
// ``div_rn``), so neither compiler contracts or reorders them.

#include <cuda_runtime.h>
#include <stdint.h>

#ifdef __CUDACC__
#define SK_DEV __device__ __forceinline__
#define SK_MEMBER __device__ __forceinline__
static SK_DEV float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
static SK_DEV float add_rn(float a, float b) { return __fadd_rn(a, b); }
static SK_DEV float mul_rn(float a, float b) { return __fmul_rn(a, b); }
static SK_DEV float div_rn(float a, float b) { return __fdiv_rn(a, b); }
static SK_DEV float floor_f(float a) { return floorf(a); }
static SK_DEV float as_float(int32_t i) { return __int_as_float(i); }
static SK_DEV int32_t as_int(float f) { return __float_as_int(f); }
#else
#include <math.h>
#include <string.h>
#define SK_DEV static inline
#define SK_MEMBER inline
struct int2 {
  int32_t x, y;
};
static inline int2 make_int2(int32_t x, int32_t y) { return int2{x, y}; }
SK_DEV float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
SK_DEV float add_rn(float a, float b) { return a + b; }
SK_DEV float mul_rn(float a, float b) { return a * b; }
SK_DEV float div_rn(float a, float b) { return a / b; }
SK_DEV float floor_f(float a) { return floorf(a); }
SK_DEV float as_float(int32_t i) { float f; memcpy(&f, &i, 4); return f; }
SK_DEV int32_t as_int(float f) { int32_t i; memcpy(&i, &f, 4); return i; }
#endif

namespace sk {

constexpr float kTiny = 1e-30f;
// a stage's row of the plan table (market/sinkhorn.py ``pack_plan``): its
// lanes, accumulators, steps, flags, tree rows, offset into the block list,
// its first chain's number among the plan's chains and its first position
// (the slot of its first chain in an output's compact row)
constexpr int kLanes = 0, kAccs = 1, kSteps = 2, kSeeded = 3, kAdd = 4,
              kTreeRows = 5, kBlocks = 6, kChain0 = 7, kPos0 = 8,
              kStageWords = 9;

// One plan as the kernels read it, and one compact form over it: output o's
// chain c lies at entries[o n + pos] on, cnt[o chains + c] of them, each an
// (f32 bits, index) pair.
struct Plan {
  const int32_t* stages;
  int n_stages;
  const int32_t* blocks;
  int chains;  // the plan's chains, all stages
  int group;   // threads an output: a power of 2 >= a stage's chains, <= 32
  const int32_t* chain_of;    // [row length]: the chain that visits index j
  const int32_t* chain_slot;  // [chains]: where a chain starts in a row
};

struct Compact {
  int2* entries;  // [outputs * n]
  int32_t* cnt;   // [outputs * chains]
};

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
  float scale = as_float(((int32_t)n + 127) << 23);
  float out = mul_rn(y, scale);
  return out < 0x1p-126f ? 0.0f : out;
}

SK_DEV bool active(const int32_t* iters, int it) { return *iters > it; }

// K's entry at element e = s c_tot + b of a feasible pair
SK_DEV float k_value(long e, int b, const float* jitter, const float* v,
                     float eps) {
  const float score = fma_rn(jitter[e], mul_rn(eps, 0.5f), v[b]);
  return xla_exp(div_rn(score, eps));
}

// the stage that chain c of a plan belongs to
SK_DEV const int32_t* stage_of(const Plan& P, int c) {
  const int32_t* st = P.stages;
  for (int s = 1; s < P.n_stages; ++s) {
    const int32_t* nx = P.stages + s * kStageWords;
    if (nx[kChain0] > c) break;
    st = nx;
  }
  return st;
}

// chain k of stage st as a walk: step t visits index blk[t] + lane
struct Walk {
  const int32_t* blk;
  int lane;
  SK_MEMBER int at(int t) const {
#ifdef __CUDACC__
    return __ldg(blk + t) + lane;
#else
    return blk[t] + lane;
#endif
  }
};

SK_DEV Walk walk(const Plan& P, const int32_t* st, int k) {
  const int W = st[kLanes];
  return Walk{P.blocks + st[kBlocks] + (k / W) * st[kSteps], k % W};
}

// where chain k of stage st starts in an output's compact row
SK_DEV long slot(const int32_t* st, int k) {
  return (long)st[kPos0] + (long)k * st[kSteps];
}

// chain k of a stage over its compact list: fused multiply-adds from
// ``init`` over (value, index) pairs in the chain's order, gathering w
SK_DEV float chain(const int2* e, int count, const float* w, float init) {
  float acc = init;
#ifdef __CUDACC__
#pragma unroll 4
#endif
  for (int i = 0; i < count; ++i) {
    const int2 x = e[i];  // global or shared memory (a generic load)
    acc = fma_rn(as_float(x.x), w[x.y], acc);
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

SK_DEV float recip(float r) { return div_rn(1.0f, max_rn(r, kTiny)); }

}  // namespace sk

#ifdef __CUDACC__

static const int kThreads = 256;  // a multiple of 32: groups stay in a warp
static const int kWarps = kThreads / 32;

// the block's exclusive prefix sum of x over its threads, and the total
static __device__ int block_scan(int x, int* s_tmp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += y;
  }
  if (lane == 31) s_tmp[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    int t = lane < nw ? s_tmp[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, t, d);
      if (lane >= d) t += y;
    }
    if (lane < nw) s_tmp[lane] = t;
  }
  __syncthreads();
  const int out = inc - x + (warp > 0 ? s_tmp[warp - 1] : 0);
  *total = s_tmp[(blockDim.x >> 5) - 1];
  __syncthreads();
  return out;
}

// A row block (one a row of K): each thread's 16 neighbouring columns'
// feasibility, a list of the row's feasible columns in column order (a
// block scan of each thread's count), zeros into K and shared memory, then
// a thread a listed column computes its value: two loads' latency a row,
// not one a column. The row plan visits each chain's columns in column
// order (market/sinkhorn.py ``index_tables``), so one warp compacts the
// list 32 entries at a time: an entry's rank in its chain is the chain's
// count so far plus the lanes before it in the same chain.
static const int kRowChains = 64;  // the row plan's chains at most

static __device__ void compact_row(int o, const uint8_t* feas,
                                   const float* jitter, const float* v,
                                   float eps, float* K, int c_tot,
                                   sk::Plan P, sk::Compact out, float* s_row,
                                   int* s_list, int* s_tmp, int* s_cnt) {
  const long base = (long)o * c_tot;
  const bool quad = (c_tot & 3) == 0;  // the row's start 16-byte aligned
  constexpr int kPer = 16;  // columns a thread: 4 runs of 4, neighbours
  for (int c = threadIdx.x; c < P.chains; c += kThreads) s_cnt[c] = 0;
  int total = 0;
  for (int b00 = 0; b00 < c_tot; b00 += kPer * kThreads) {
    uint32_t fw[4];
    int mine = 0;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b0 = b00 + kPer * threadIdx.x + 4 * r;
      fw[r] = 0;
      if (quad && b0 < c_tot) {
        fw[r] = __ldg(reinterpret_cast<const uint32_t*>(feas + base + b0));
      } else {
        for (int i = 0; i < 4 && b0 + i < c_tot; ++i)
          fw[r] |= (uint32_t)(__ldg(feas + base + b0 + i) != 0) << (8 * i);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) mine += ((fw[r] >> (8 * i)) & 0xffu) != 0;
    }
    int chunk = 0;
    int pos = total + block_scan(mine, s_tmp, &chunk);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int b0 = b00 + kPer * threadIdx.x + 4 * r;
      if (b0 >= c_tot) continue;
      if (quad) {
        *reinterpret_cast<float4*>(s_row + b0) = make_float4(0, 0, 0, 0);
        *reinterpret_cast<float4*>(K + base + b0) = make_float4(0, 0, 0, 0);
      }
      for (int i = 0; i < 4 && b0 + i < c_tot; ++i) {
        if (!quad) {
          s_row[b0 + i] = 0.0f;
          K[base + b0 + i] = 0.0f;
        }
        if ((fw[r] >> (8 * i)) & 0xffu) s_list[pos++] = b0 + i;
      }
    }
    total += chunk;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int b = s_list[i];
    const float k = sk::k_value(base + b, b, jitter, v, eps);
    s_row[b] = k;
    K[base + b] = k;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    const unsigned below = (1u << lane) - 1u;
    for (int i0 = 0; i0 < total; i0 += 32) {
      const int i = i0 + lane;
      const bool live = i < total;
      const int j = live ? s_list[i] : 0;
      const int c = live ? __ldg(P.chain_of + j) : -1;
      const unsigned same = __match_any_sync(0xffffffffu, c);
      if (live) {
        const int rank = s_cnt[c] + __popc(same & below);
        out.entries[base + __ldg(P.chain_slot + c) + rank] =
            make_int2(as_int(s_row[j]), j);
      }
      __syncwarp();
      if (live && lane == 31 - __clz(same)) s_cnt[c] += __popc(same);
      __syncwarp();
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < P.chains; c += kThreads)
    out.cnt[(long)o * P.chains + c] = s_cnt[c];
}

// A column block: kTileCols columns of K (KT's rows; lane l takes columns
// 4 l to 4 l + 3 of the tile) and one chain of the column plan, its steps
// split over the block's warps in order. Each warp reads its steps'
// feasibility 64 steps at a time into a mask a column (loads only, all in
// flight together, a warp's 128 bytes a step contiguous): pass 1 counts
// them, the counts of the warps before give each warp's first rank, pass 2
// writes the set steps' values (the first 64 steps' masks kept).
static const int kTileCols = 128;

struct Masks {
  uint64_t m[4];
};

static __device__ Masks feasible_masks(const uint8_t* col, long ld,
                                       bool quad, int live, sk::Walk w,
                                       int t0, int t_hi) {
  Masks r = {{0, 0, 0, 0}};
#pragma unroll 8
  for (int i = 0; i < 64; ++i) {
    const int t = t0 + i;
    if (t >= t_hi) break;
    const uint8_t* row = col + (long)w.at(t) * ld;
    uint32_t f = 0;
    if (quad) {
      f = __ldg(reinterpret_cast<const uint32_t*>(row));
    } else {
      for (int q = 0; q < live; ++q) f |= (uint32_t)__ldg(row + q) << (8 * q);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if ((f >> (8 * q)) & 0xffu) r.m[q] |= 1ull << i;
  }
  return r;
}

static __device__ void compact_cols(int tile, int c, const uint8_t* feas,
                                    const float* jitter, const float* v,
                                    float eps, int c_loc, int c_tot,
                                    sk::Plan P, sk::Compact out,
                                    int* s_count) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b0 = tile * kTileCols + 4 * lane;
  const int live = b0 < c_tot ? min(4, c_tot - b0) : 0;  // columns
  const bool quad = (c_tot & 3) == 0;
  const int32_t* st = sk::stage_of(P, c);
  const int k = c - st[sk::kChain0], T = st[sk::kSteps];
  const int per = (T + kWarps - 1) / kWarps;
  const int t_lo = warp * per, t_hi = min(T, t_lo + per);
  const sk::Walk w = sk::walk(P, st, k);
  const uint8_t* col = feas + (live ? b0 : 0);
  int n[4] = {0, 0, 0, 0};
  Masks m0 = {{0, 0, 0, 0}};
  if (live)
    for (int t0 = t_lo; t0 < t_hi; t0 += 64) {
      const Masks m = feasible_masks(col, c_tot, quad, live, w, t0, t_hi);
      if (t0 == t_lo) m0 = m;
#pragma unroll
      for (int q = 0; q < 4; ++q) n[q] += __popcll(m.m[q]);
    }
#pragma unroll
  for (int q = 0; q < 4; ++q) s_count[warp * kTileCols + 4 * lane + q] = n[q];
  __syncthreads();
  int rank[4] = {0, 0, 0, 0};
  for (int w = 0; w < warp; ++w)
#pragma unroll
    for (int q = 0; q < 4; ++q) rank[q] += s_count[w * kTileCols + 4 * lane + q];
  if (!live) return;
  for (int t0 = t_lo; t0 < t_hi; t0 += 64) {
    const Masks m =
        t0 == t_lo ? m0 : feasible_masks(col, c_tot, quad, live, w, t0, t_hi);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= live) break;
      const int b = b0 + q;
      int2* dst = out.entries + (long)b * c_loc + sk::slot(st, k);
      uint64_t mq = m.m[q];
      while (mq) {
        const int s = w.at(t0 + __ffsll((long long)mq) - 1);
        mq &= mq - 1;
        dst[rank[q]++] = make_int2(
            as_int(sk::k_value((long)s * c_tot + b, b, jitter, v, eps)), s);
      }
    }
  }
  if (warp == kWarps - 1)
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (q < live) out.cnt[(long)(b0 + q) * P.chains + c] = rank[q];
}

__global__ void __launch_bounds__(kThreads)
sinkhorn_build_kernel(const uint8_t* feas,
                                      const float* jitter, const float* v,
                                      const float* eps_p, float* K, int c_loc,
                                      int c_tot, sk::Plan rp, sk::Compact rc,
                                      sk::Plan cp, sk::Compact cc) {
  extern __shared__ __align__(16) float s_dyn[];
  const float eps = *eps_p;
  // the column blocks first: each walks a whole chain's steps, the longest
  // work of the launch, and the row blocks fill the card around them
  const int col_blocks = ((c_tot + kTileCols - 1) / kTileCols) * cp.chains;
  if ((int)blockIdx.x < col_blocks) {
    compact_cols(blockIdx.x / cp.chains, blockIdx.x % cp.chains, feas, jitter,
                 v, eps, c_loc, c_tot, cp, cc, (int*)s_dyn);
  } else {
    int* s_tmp = (int*)s_dyn;
    int* s_cnt = s_tmp + 32;
    float* s_row = s_dyn + 32 + kRowChains;
    compact_row(blockIdx.x - col_blocks, feas, jitter, v, eps, K, c_tot, rp,
                rc, s_row, (int*)(s_row + c_tot), s_tmp, s_cnt);
  }
}

// A thread's chains for one output of a plan, one a stage: where its
// compact list lies (global memory, or the block's copy in shared memory)
// and how long it is; none where the thread has no chain in the stage.
constexpr int kMaxStages = 4;
struct Refs {
  const int2* e[kMaxStages];
  int n[kMaxStages];
};

static __device__ Refs chain_refs(int o, bool live, const sk::Plan& P,
                                  const sk::Compact& C, long n) {
  const int k = threadIdx.x & (P.group - 1);
  Refs r;
#pragma unroll
  for (int si = 0; si < kMaxStages; ++si) {
    r.e[si] = nullptr;
    r.n[si] = 0;
    if (si < P.n_stages) {
      const int32_t* st = P.stages + si * sk::kStageWords;
      if (live && k < st[sk::kAccs] * st[sk::kLanes]) {
        r.e[si] = C.entries + (long)o * n + sk::slot(st, k);
        r.n[si] = C.cnt[(long)o * P.chains + st[sk::kChain0] + k];
      }
    }
  }
  return r;
}

// Copy the block's lists ``r`` into shared memory at ``cache`` (room for
// ``cap`` pairs) and point ``r`` there, if they all fit; else leave ``r``
// on global memory. The choice is the block's, the same for every thread.
static __device__ void cache_refs(Refs& r, int2* cache, int cap,
                                  int* s_tmp) {
  int mine = 0;
#pragma unroll
  for (int si = 0; si < kMaxStages; ++si) mine += r.n[si];
  int total = 0;
  int at = block_scan(mine, s_tmp, &total);
  if (total > cap) return;
#pragma unroll
  for (int si = 0; si < kMaxStages; ++si) {
    if (!r.e[si]) continue;
    for (int i = 0; i < r.n[si]; ++i) cache[at + i] = r.e[si][i];
    r.e[si] = cache + at;
    at += r.n[si];
  }
}

// Output o's sum over its chains ``r`` in plan P's order, by the group of
// G threads (thread k of the group runs chain k of each stage; the group's
// first thread folds them from shared memory and carries the running value
// to the next stage). Every thread of the warp calls it, live or not.
static __device__ float product_output(int o, const sk::Plan& P,
                                       const Refs& r, const float* w,
                                       float* s_chain, float* s_r) {
  const int k = threadIdx.x & (P.group - 1);
  const int base = threadIdx.x - k;
  float run = 0.0f;
#pragma unroll
  for (int si = 0; si < kMaxStages; ++si) {
    if (si >= P.n_stages) break;
    const int32_t* st = P.stages + si * sk::kStageWords;
    const int W = st[sk::kLanes], A = st[sk::kAccs];
    float c = 0.0f;
    if (r.e[si])
      c = sk::chain(r.e[si], r.n[si], w,
                    st[sk::kSeeded] && k == 0 ? run : 0.0f);
    s_chain[threadIdx.x] = c;
    __syncwarp();
    if (k == 0) {
      const float val = sk::fold(s_chain + base, A, W,
                                 W == 8 && o < st[sk::kTreeRows]);
      s_r[base] = st[sk::kAdd] ? add_rn(run, val) : val;
    }
    __syncwarp();
    run = s_r[base];
    __syncwarp();
  }
  return run;
}

// ``len`` floats of ``src`` into shared memory, read through L2 (another
// block may have written them since this block last read them)
static __device__ void stage_vec(const float* src, int len, float* dst) {
  const int quads = ((uintptr_t)src & 15) ? 0 : len / 4;
  for (int i = threadIdx.x; i < quads; i += blockDim.x)
    reinterpret_cast<float4*>(dst)[i] =
        __ldcg(reinterpret_cast<const float4*>(src) + i);
  for (int i = 4 * quads + threadIdx.x; i < len; i += blockDim.x)
    dst[i] = __ldcg(src + i);
  __syncthreads();
}

// One product over all outputs of a plan by the grid, the block's groups
// taking outputs in rounds (every thread of a warp runs every round, so the
// group's warp syncs stay whole); ``first`` holds the first round's chains.
// Mode 0 writes recip(sum), mode 1 the sum; ``trace`` (if set) gets the
// same value.
struct Pass {
  sk::Plan P;
  sk::Compact C;
  long n;       // an output's row length: the vector's
  int outputs;
};

static __device__ int pass_first(const Pass& p) {
  return blockIdx.x * (blockDim.x / p.P.group) + threadIdx.x / p.P.group;
}

static __device__ int pass_stride(const Pass& p) {
  return gridDim.x * (blockDim.x / p.P.group);
}

static __device__ void product_pass(const Pass& p, const Refs& first,
                                    const float* s_vec, float* s_chain,
                                    float* s_r, int mode, float* out,
                                    float* trace) {
  const int o0 = pass_first(p), stride = pass_stride(p);
  const int rounds = (p.outputs + stride - 1) / stride;
  for (int round = 0; round < rounds; ++round) {
    const int o = o0 + round * stride;
    const bool live = o < p.outputs;
    const float r = product_output(
        live ? o : 0, p.P,
        round == 0 ? first : chain_refs(o, live, p.P, p.C, p.n), s_vec,
        s_chain, s_r);
    if (live && (threadIdx.x & (p.P.group - 1)) == 0) {
      const float val = mode == 0 ? sk::recip(r) : r;
      out[o] = val;
      if (trace) trace[o] = val;
    }
  }
}

// A barrier across the grid of a cooperative launch (every block resident):
// ``*bar`` (0 at the launch) counts the blocks' arrivals over all barriers;
// a block's thread 0 publishes the block's writes (a fence after the block
// sync), arrives, and waits with acquiring loads until every block has
// arrived at this barrier.
static __device__ void grid_barrier(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const unsigned old = atomicAdd(bar, 1u);
    const unsigned target = (old / gridDim.x + 1) * gridDim.x;
    unsigned seen;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
                   : "=r"(seen)
                   : "l"(bar)
                   : "memory");
    } while ((int)(seen - target) < 0);
  }
  __syncthreads();
}

// shared memory of a product block: the chains' partials and the running
// values (a float a thread each), the scan's 32 ints, then the vector
static __device__ float* smem_vec(float* s_dyn) {
  return s_dyn + 2 * blockDim.x + 32;
}

// The iterations on one device, both products of each, in one launch. The
// compact lists of the block's first round of outputs are copied into
// shared memory once (``cap`` pairs a product), where they fit.
__global__ void sinkhorn_iterate_kernel(Pass rows, Pass cols, float* u,
                                        float* vc, const int32_t* iters,
                                        int n_iters, float* trace_u,
                                        float* trace_vc, unsigned* bar,
                                        int vec_len, int cap) {
  extern __shared__ __align__(16) float s_dyn[];
  float* s_chain = s_dyn;
  float* s_r = s_dyn + blockDim.x;
  int* s_tmp = (int*)(s_dyn + 2 * blockDim.x);
  float* s_vec = smem_vec(s_dyn);
  int2* cache = (int2*)(s_vec + ((vec_len + 1) & ~1));
  Refs rr = chain_refs(pass_first(rows), pass_first(rows) < rows.outputs,
                       rows.P, rows.C, rows.n);
  Refs cr = chain_refs(pass_first(cols), pass_first(cols) < cols.outputs,
                       cols.P, cols.C, cols.n);
  cache_refs(rr, cache, cap, s_tmp);
  cache_refs(cr, cache + cap, cap, s_tmp);
  const int stride = gridDim.x * blockDim.x;
  for (int it = 0; it < n_iters; ++it) {
    float* tu = trace_u ? trace_u + (long)it * rows.outputs : nullptr;
    float* tv = trace_vc ? trace_vc + (long)it * cols.outputs : nullptr;
    if (!sk::active(iters, it)) {  // the same for every block; u, vc final
      const int first = blockIdx.x * blockDim.x + threadIdx.x;
      if (tu)
        for (int i = first; i < rows.outputs; i += stride)
          tu[i] = __ldcg(u + i);
      if (tv)
        for (int i = first; i < cols.outputs; i += stride)
          tv[i] = __ldcg(vc + i);
      continue;
    }
    stage_vec(vc, (int)rows.n, s_vec);
    product_pass(rows, rr, s_vec, s_chain, s_r, 0, u, tu);
    grid_barrier(bar);
    stage_vec(u, (int)cols.n, s_vec);
    product_pass(cols, cr, s_vec, s_chain, s_r, 0, vc, tv);
    grid_barrier(bar);
  }
}

__global__ void sinkhorn_product_kernel(Pass p, const float* w,
                                        const int32_t* iters, int it,
                                        int mode, float* out) {
  extern __shared__ __align__(16) float s_dyn[];
  if (!sk::active(iters, it)) return;  // the same for every thread
  float* s_vec = smem_vec(s_dyn);
  stage_vec(w, (int)p.n, s_vec);
  const int o = pass_first(p);
  product_pass(p, chain_refs(o, o < p.outputs, p.P, p.C, p.n), s_vec, s_dyn,
               s_dyn + blockDim.x, mode, out, nullptr);
}

__global__ void sinkhorn_finish_kernel(const float* sums, float* vc, int n,
                                       const int32_t* iters, int it) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= n || !sk::active(iters, it)) return;
  vc[j] = sk::recip(sums[j]);
}

// a row of the plan a block row (blockIdx.y, striding), 4 columns a thread
__global__ void sinkhorn_plan_kernel(const float* u, const float* K,
                                     const float* vc, float* plan,
                                     int c_loc, int c_tot) {
  const int b0 = 4 * (blockIdx.x * blockDim.x + threadIdx.x);
  if (b0 >= c_tot) return;
  const bool quad = (c_tot & 3) == 0 && b0 + 4 <= c_tot;
  for (int s = blockIdx.y; s < c_loc; s += gridDim.y) {
    const long e = (long)s * c_tot + b0;
    const float us = u[s];
    if (quad) {
      const float4 k = __ldg(reinterpret_cast<const float4*>(K + e));
      const float4 w = __ldg(reinterpret_cast<const float4*>(vc + b0));
      reinterpret_cast<float4*>(plan + e)[0] = make_float4(
          mul_rn(mul_rn(us, k.x), w.x), mul_rn(mul_rn(us, k.y), w.y),
          mul_rn(mul_rn(us, k.z), w.z), mul_rn(mul_rn(us, k.w), w.w));
    } else {
      for (int b = b0; b < b0 + 4 && b < c_tot; ++b)
        plan[(long)s * c_tot + b] = mul_rn(mul_rn(us, K[(long)s * c_tot + b]),
                                           vc[b]);
    }
  }
}

static unsigned grid_of(long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

// dynamic shared memory above the default 48 KB needs the kernel's consent
static int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

static size_t product_smem(int threads, int len) {
  return (2 * (size_t)threads + 32 + (size_t)((len + 1) & ~1)) *
         sizeof(float);
}

// the pairs a product's first round may keep in shared memory, a block
static const int kCachePairs = 4096;

static bool bad_plan(const sk::Plan& P) {
  return P.group < 1 || P.group > 32 || (P.group & (P.group - 1)) ||
         P.n_stages < 1 || P.n_stages > kMaxStages;
}

#define SK_LAUNCHED() return (int)cudaGetLastError()

extern "C" {

int sinkhorn_build(const uint8_t* feas, const float* jitter, const float* v,
                   const float* eps, float* K, int c_loc, int c_tot,
                   sk::Plan rp, sk::Compact rc, sk::Plan cp, sk::Compact cc,
                   cudaStream_t stream) {
  if ((long)c_loc * c_tot == 0) return 0;
  // a row block keeps the row's values and its feasible list in shared
  // memory: 8 bytes a buyer, up to ~28,000 buyers (227 KB); a wider round
  // fails here and raises
  if (rp.chains > kRowChains || !rp.chain_of || !rp.chain_slot)
    return (int)cudaErrorInvalidValue;
  const size_t row = (32 + kRowChains) * sizeof(int) + (size_t)c_tot * 8;
  const size_t col = kWarps * kTileCols * sizeof(int);
  const size_t smem = row > col ? row : col;
  int err = allow_smem((const void*)sinkhorn_build_kernel, smem);
  if (err) return err;
  const unsigned grid =
      c_loc + ((c_tot + kTileCols - 1) / kTileCols) * cp.chains;
  sinkhorn_build_kernel<<<grid, kThreads, smem, stream>>>(
      feas, jitter, v, eps, K, c_loc, c_tot, rp, rc, cp, cc);
  SK_LAUNCHED();
}

int sinkhorn_iterate(sk::Plan rp, sk::Compact rc, sk::Plan cp,
                     sk::Compact cc, int c_loc, int c_tot, float* u,
                     float* vc, const int32_t* iters, int n_iters,
                     float* trace_u, float* trace_vc, unsigned* bar,
                     cudaStream_t stream) {
  if ((long)c_loc * c_tot == 0 || n_iters == 0) return 0;
  if (bad_plan(rp) || bad_plan(cp)) return (int)cudaErrorInvalidValue;
  const void* fn = (const void*)sinkhorn_iterate_kernel;
  int vec_len = c_loc > c_tot ? c_loc : c_tot, cap = kCachePairs;
  const size_t smem = product_smem(kThreads, vec_len) +
                      2 * (size_t)cap * sizeof(int2);
  int err = allow_smem(fn, smem);
  if (err) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = (int)cudaGetDevice(&dev))) return err;
  if ((err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                         dev)))
    return err;
  if ((err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, sinkhorn_iterate_kernel, kThreads, smem)))
    return err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const long need_r = ((long)c_loc * rp.group + kThreads - 1) /
                      kThreads;
  const long need_c = ((long)c_tot * cp.group + kThreads - 1) /
                      kThreads;
  long grid = need_r > need_c ? need_r : need_c;
  if (grid > (long)per_sm * sms) grid = (long)per_sm * sms;
  Pass rows{rp, rc, c_tot, c_loc}, cols{cp, cc, c_loc, c_tot};
  void* args[] = {&rows, &cols, &u, &vc, (void*)&iters, &n_iters,
                  &trace_u, &trace_vc, &bar, &vec_len, &cap};
  return (int)cudaLaunchCooperativeKernel(fn, dim3((unsigned)grid),
                                          dim3(kThreads), args, smem,
                                          stream);
}

int sinkhorn_product(sk::Plan P, sk::Compact C, long n, int outputs,
                     const float* w, const int32_t* iters, int it, int mode,
                     float* out, cudaStream_t stream) {
  if (outputs == 0) return 0;
  if (bad_plan(P)) return (int)cudaErrorInvalidValue;
  const size_t smem = product_smem(kThreads, (int)n);
  int err = allow_smem((const void*)sinkhorn_product_kernel, smem);
  if (err) return err;
  Pass p{P, C, n, outputs};
  sinkhorn_product_kernel<<<grid_of((long)outputs * P.group), kThreads, smem,
                            stream>>>(p, w, iters, it, mode, out);
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
  if ((long)c_loc * c_tot == 0) return 0;
  const dim3 grid((unsigned)((c_tot + 4 * kThreads - 1) / (4 * kThreads)),
                  (unsigned)(c_loc < 65535 ? c_loc : 65535));
  sinkhorn_plan_kernel<<<grid, kThreads, 0, stream>>>(u, K, vc, plan, c_loc,
                                                      c_tot);
  SK_LAUNCHED();
}

}  // extern "C"

#else  // a host build: each launch is a loop over its blocks and threads

namespace {

// a row of K: the dense values, then each chain's feasible steps in order
void compact_row(int o, const uint8_t* feas, const float* jitter,
                 const float* v, float eps, float* K, int c_tot, sk::Plan P,
                 sk::Compact out) {
  const long base = (long)o * c_tot;
  for (int b = 0; b < c_tot; ++b)
    K[base + b] = feas[base + b] ? sk::k_value(base + b, b, jitter, v, eps)
                                 : 0.0f;
  for (int c = 0; c < P.chains; ++c) {
    const int32_t* st = sk::stage_of(P, c);
    const int k = c - st[sk::kChain0];
    int2* dst = out.entries + base + sk::slot(st, k);
    const sk::Walk w = sk::walk(P, st, k);
    int n = 0;
    for (int t = 0; t < st[sk::kSteps]; ++t) {
      const int j = w.at(t);
      if (feas[base + j]) dst[n++] = make_int2(as_int(K[base + j]), j);
    }
    out.cnt[(long)o * P.chains + c] = n;
  }
}

// a column of K (a row of KT): each chain's feasible steps in order
void compact_col(int b, const uint8_t* feas, const float* jitter,
                 const float* v, float eps, int c_loc, int c_tot, sk::Plan P,
                 sk::Compact out) {
  for (int c = 0; c < P.chains; ++c) {
    const int32_t* st = sk::stage_of(P, c);
    const int k = c - st[sk::kChain0];
    int2* dst = out.entries + (long)b * c_loc + sk::slot(st, k);
    const sk::Walk w = sk::walk(P, st, k);
    int n = 0;
    for (int t = 0; t < st[sk::kSteps]; ++t) {
      const int s = w.at(t);
      const long e = (long)s * c_tot + b;
      if (feas[e])
        dst[n++] = make_int2(as_int(sk::k_value(e, b, jitter, v, eps)),
                             s);
    }
    out.cnt[(long)b * P.chains + c] = n;
  }
}

// one output's sum in the plan's order (a group: its threads one by one)
float product_output(int o, sk::Plan P, sk::Compact C, long n,
                     const float* w) {
  float r = 0.0f;
  for (int si = 0; si < P.n_stages; ++si) {
    const int32_t* st = P.stages + si * sk::kStageWords;
    const int W = st[sk::kLanes], A = st[sk::kAccs];
    float c[32];
    for (int k = 0; k < P.group; ++k) {
      c[k] = 0.0f;
      if (k < A * W)
        c[k] = sk::chain(C.entries + (long)o * n + sk::slot(st, k),
                         C.cnt[(long)o * P.chains + st[sk::kChain0] + k], w,
                         st[sk::kSeeded] && k == 0 ? r : 0.0f);
    }
    const float val = sk::fold(c, A, W, W == 8 && o < st[sk::kTreeRows]);
    r = st[sk::kAdd] ? add_rn(r, val) : val;
  }
  return r;
}

bool bad_group(const sk::Plan& P) {
  return P.group < 1 || P.group > 32 || (P.group & (P.group - 1));
}

}  // namespace

extern "C" {

int sinkhorn_build(const uint8_t* feas, const float* jitter, const float* v,
                   const float* eps, float* K, int c_loc, int c_tot,
                   sk::Plan rp, sk::Compact rc, sk::Plan cp, sk::Compact cc,
                   cudaStream_t) {
  for (int o = 0; o < c_loc; ++o)
    compact_row(o, feas, jitter, v, *eps, K, c_tot, rp, rc);
  for (int b = 0; b < c_tot; ++b)
    compact_col(b, feas, jitter, v, *eps, c_loc, c_tot, cp, cc);
  return 0;
}

int sinkhorn_iterate(sk::Plan rp, sk::Compact rc, sk::Plan cp,
                     sk::Compact cc, int c_loc, int c_tot, float* u,
                     float* vc, const int32_t* iters, int n_iters,
                     float* trace_u, float* trace_vc, unsigned*,
                     cudaStream_t) {
  if (bad_group(rp) || bad_group(cp)) return 1;
  for (int it = 0; it < n_iters; ++it) {
    if (sk::active(iters, it)) {
      for (int o = 0; o < c_loc; ++o)  // reads vc only: u in place is safe
        u[o] = sk::recip(product_output(o, rp, rc, c_tot, vc));
      for (int b = 0; b < c_tot; ++b)
        vc[b] = sk::recip(product_output(b, cp, cc, c_loc, u));
    }
    if (trace_u)
      for (int o = 0; o < c_loc; ++o) trace_u[(long)it * c_loc + o] = u[o];
    if (trace_vc)
      for (int b = 0; b < c_tot; ++b) trace_vc[(long)it * c_tot + b] = vc[b];
  }
  return 0;
}

int sinkhorn_product(sk::Plan P, sk::Compact C, long n, int outputs,
                     const float* w, const int32_t* iters, int it, int mode,
                     float* out, cudaStream_t) {
  if (bad_group(P)) return 1;
  if (!sk::active(iters, it)) return 0;
  for (int o = 0; o < outputs; ++o) {
    const float r = product_output(o, P, C, n, w);
    out[o] = mode == 0 ? sk::recip(r) : r;
  }
  return 0;
}

int sinkhorn_finish(const float* sums, float* vc, int n,
                    const int32_t* iters, int it, cudaStream_t) {
  if (!sk::active(iters, it)) return 0;
  for (int j = 0; j < n; ++j) vc[j] = sk::recip(sums[j]);
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
