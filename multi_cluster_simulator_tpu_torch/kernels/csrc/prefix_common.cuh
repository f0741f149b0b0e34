// What the per-cluster tick-prefix kernels share (fused_prefix_fifo.cu,
// fused_prefix_ffd.cu, fused_prefix_delay.cu, fused_prefix_scored.cu, each
// a warp per cluster on prefix_warp.cuh): the row schemas, the column
// views of the tables, the pointers and sizes common to every span, the
// forms' dispatch, and the steps one lane of a warp runs on its own where
// they are rare — the fault phase (Cluster::faults), the reference's waves
// replayed where a clamped store made a demand negative (fifo_drain_waves,
// sweep and wave_place), placing a job (occupy its node, insert its
// running row into the lowest free slot, count it, trace it) — and the
// per-cluster half of the metrics tap (tap_cluster). The emit form of
// every span (its kernel's template instantiated with kEmit) also packs,
// in the release step, the return messages of the finished foreign jobs,
// and writes the borrow request the cross-cluster phases after the prefix
// consume. The expire form of every span (kExpire) runs the vnode expiry
// step between release and ingest, as the reference does when the
// trader's expire_virtual_nodes is on. The faults form (kFaults) opens the
// span with the fault phase (faults/apply.py fault_phase_local): node
// failures kill and requeue the jobs on them, repairs restore the nodes,
// and the generative mode draws the next outage with jax's threefry2x32
// and XLA's CPU f32 log written out, so that every draw is the
// reference's. The tap form (kTap, a run with the metrics plane on a
// terminal prefix) closes the span with the metrics tap (obs/device.py
// tap_tick): the per-cluster accumulators against the cursor, and the
// cross-cluster half — the depth histogram and the ring slot — with
// integer atomics and the last block (prefix_warp.cuh tap_epilogue).
// Every form takes the windowed Arrivals ingest as a runtime branch of the
// shared ingest step (Common::window >= 0).
//
// The state layout is a runtime property too (core/compact.py): every
// queue and the running set reach the kernels as a column view (Col, one
// per field: a base, the bytes between rows and the value's size), which
// serves the wide rows (base = data + 4 f, stride 4 NF, size 4) and the
// compact layout's narrow leaves (base = the leaf, stride = size = 1, 2 or
// 4) alike, so no template flag doubles the forms. Loads sign-extend to
// int32 and a job or a running row is read into a local int32_t[NF] (the
// reference's JobRec.vec) that the steps compute on unchanged. A store is
// either the checked narrow store (ops/fields.py narrow_store: a value
// outside the size's range is stored as its minimum and counted into the
// table's ovf[c]) where the reference checks — arrival ingest, the fault
// phase's requeues, the push_back of a queue, a rec_wait write — or a plain
// store where it only moves stored values (compaction, the pops, the
// placements' running rows). Narrow node columns (a terminal prefix; a
// non-terminal tick hands the kernel the engine's widened ones) are
// widened into the warp's shared memory at entry and stored back checked
// at exit, and the exit's count — ONE total over every cluster, as the
// reference's batch-wide narrow gives — is added to every cluster's
// run.ovf by the last block to finish (prefix_warp.cuh
// node_exit_epilogue).
//
// Every step here works on ONE cluster, walked by one lane, in place, in
// the reference's order. Integer discipline: all arithmetic is int32 as in
// the reference; sums that could overflow (end_t = t + dur, waits t -
// enq_t) are done in uint32 and cast back, which is the reference's
// two's-complement wrap without signed overflow in C++. NEVER (2^31-1) is
// only compared. torch bool tensors arrive as uint8_t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>
#include <math.h>

#include <type_traits>

namespace prefix {

constexpr int NF = 10;  // queue row fields (ops/fields.py QUEUE_FIELDS)
constexpr int FID = 0, FCORES = 1, FMEM = 2, FGPU = 3, FDUR = 4, FENQ = 5,
              FOWNER = 6, FREC = 7, FJCLASS = 8, FRETRIES = 9;
constexpr int RF = 10;  // running-set row fields (ops/fields.py RUN_FIELDS)
constexpr int REND = 0, RNODE = 1, RCORES = 2, RMEM = 3, RGPU = 4, RID = 5,
              ROWNER = 6, RDUR = 7, RENQ = 8, RRETRIES = 9;
constexpr int32_t NEVER = 2147483647;
// trace source-queue codes (core/state.py)
constexpr int32_t SRC_L1 = 0, SRC_L0 = 1, SRC_READY = 2, SRC_WAIT = 3,
                  SRC_LENT = 4;
// The sweeps' placed-slot mask is a fixed bit array per thread
// (kernels/fused_tick.py MAX_QUEUE; the wrapper raises above it).
constexpr int kMaxQueue = 1024;
constexpr int kMaskWords = kMaxQueue / 32;

__host__ __device__ __forceinline__ int imin(int a, int b) {
  return a < b ? a : b;
}
__host__ __device__ __forceinline__ int imax(int a, int b) {
  return a > b ? a : b;
}
__host__ __device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a + (uint32_t)b);
}
__host__ __device__ __forceinline__ int32_t wrap_sub(int32_t a, int32_t b) {
  return (int32_t)((uint32_t)a - (uint32_t)b);
}

// ---------------------------------------------------------------------------
// The column view of a table (a queue or the running set) in either layout.
// ---------------------------------------------------------------------------

// One field of a [C, L] table: element (c, i) at base + (c L + i) stride,
// stored in `size` bytes. Every access is scalar and naturally aligned to
// its own size (a narrow leaf is not 4-byte aligned).
struct Col {
  char* base;
  int32_t stride;
  int32_t size;
};

// A table's W columns and its checked-narrow overflow counter ([C]; null
// on the wide layout, whose stores never narrow). `rows` is set where the
// columns are the wide layout's packed int32 rows (field f at word f of a
// W-word row): the accessors then take the rows' own pointer arithmetic,
// as the kernels did before the view, and a uniform branch picks it.
template <int W>
struct Table {
  Col f[W];
  int32_t* ovf;
  int32_t* rows;
};
using QueueTable = Table<NF>;
using RunTable = Table<RF>;

// The host array of the tables' views (kernels/fused_tick.py _layout): two
// header words (the node columns' value size, the node exit scratch), then
// per table each field's base, stride and size and the ovf pointer, in the
// order run, lent, then the kernel's own queues.
constexpr int kLayoutHead = 2;
constexpr int kTableWords = 3 * NF + 1;
constexpr int kRunTable = 0, kLentTable = 1, kOwnTable = 2;

template <int W>
inline Table<W> make_table(const int64_t* layout, int index) {
  const int64_t* w = layout + kLayoutHead + index * kTableWords;
  Table<W> t;
  for (int f = 0; f < W; ++f) {
    t.f[f] = Col{reinterpret_cast<char*>(static_cast<intptr_t>(w[3 * f])),
                 static_cast<int32_t>(w[3 * f + 1]),
                 static_cast<int32_t>(w[3 * f + 2])};
  }
  t.ovf = reinterpret_cast<int32_t*>(static_cast<intptr_t>(w[3 * W]));
  bool packed = true;
  for (int f = 0; f < W; ++f) {
    packed = packed && t.f[f].size == 4 && t.f[f].stride == 4 * W &&
             t.f[f].base == t.f[0].base + 4 * f;
  }
  t.rows = packed ? reinterpret_cast<int32_t*>(t.f[0].base) : nullptr;
  return t;
}

__host__ __device__ __forceinline__ int32_t load_as(const char* p, int size) {
  if (size == 1) return *reinterpret_cast<const int8_t*>(p);
  if (size == 2) return *reinterpret_cast<const int16_t*>(p);
  return *reinterpret_cast<const int32_t*>(p);
}

// A plain store: the low bytes, as the reference's unchecked astype.
__host__ __device__ __forceinline__ void store_as(char* p, int size,
                                                  int32_t v) {
  if (size == 1) {
    *reinterpret_cast<int8_t*>(p) = static_cast<int8_t>(v);
  } else if (size == 2) {
    *reinterpret_cast<int16_t*>(p) = static_cast<int16_t>(v);
  } else {
    *reinterpret_cast<int32_t*>(p) = v;
  }
}

// The checked narrow store (ops/fields.py narrow_store): a value outside
// the size's range is stored as its minimum, never wrapped; returns 1
// then, for the caller to count.
__host__ __device__ __forceinline__ int store_checked_as(char* p, int size,
                                                         int32_t v) {
  const int32_t lo = size == 1 ? -128 : (size == 2 ? -32768 : INT32_MIN);
  const int32_t hi = size == 1 ? 127 : (size == 2 ? 32767 : INT32_MAX);
  const bool fit = v >= lo && v <= hi;
  store_as(p, size, fit ? v : lo);
  return fit ? 0 : 1;
}

// One cluster's rows of a table: slot i is table row r0 + i. On the
// packed wide rows `rp` points at the cluster's first row and every access
// is its own pointer arithmetic (null on narrow columns).
template <int W>
struct Rows {
  const Table<W>* t;
  size_t r0;
  int32_t* rp;

  __host__ __device__ Rows(const Table<W>* table, size_t first)
      : t(table), r0(first),
        rp(table->rows != nullptr ? table->rows + first * W : nullptr) {}

  __host__ __device__ char* at(int i, int f) const {
    return t->f[f].base + (r0 + i) * (size_t)t->f[f].stride;
  }
  __host__ __device__ int32_t get(int i, int f) const {
    if (rp != nullptr) return rp[(size_t)i * W + f];
    return load_as(at(i, f), t->f[f].size);
  }
  __host__ __device__ void set(int i, int f, int32_t v) const {
    if (rp != nullptr) {
      rp[(size_t)i * W + f] = v;
    } else {
      store_as(at(i, f), t->f[f].size, v);
    }
  }
  __host__ __device__ int set_checked(int i, int f, int32_t v) const {
    if (rp != nullptr) {
      rp[(size_t)i * W + f] = v;
      return 0;
    }
    return store_checked_as(at(i, f), t->f[f].size, v);
  }
  __host__ __device__ void load(int i, int32_t* out) const {
    if (rp != nullptr) {
      const int32_t* r = rp + (size_t)i * W;
#pragma unroll
      for (int f = 0; f < W; ++f) out[f] = r[f];
      return;
    }
#pragma unroll
    for (int f = 0; f < W; ++f) out[f] = load_as(at(i, f), t->f[f].size);
  }
  __host__ __device__ void store(int i, const int32_t* in) const {
    if (rp != nullptr) {
      int32_t* r = rp + (size_t)i * W;
#pragma unroll
      for (int f = 0; f < W; ++f) r[f] = in[f];
      return;
    }
#pragma unroll
    for (int f = 0; f < W; ++f) store_as(at(i, f), t->f[f].size, in[f]);
  }
  // Returns how many of the row's values were outside their column.
  __host__ __device__ int store_checked(int i, const int32_t* in) const {
    if (rp != nullptr) {
      store(i, in);
      return 0;
    }
    int bad = 0;
#pragma unroll
    for (int f = 0; f < W; ++f) {
      bad += store_checked_as(at(i, f), t->f[f].size, in[f]);
    }
    return bad;
  }
  // Every field of rows [from, to) set to `invalid(f)`.
  template <class Invalid>
  __host__ __device__ void fill(int from, int to, Invalid invalid) const {
    if (rp != nullptr) {
      for (int i = from; i < to; ++i) {
#pragma unroll
        for (int f = 0; f < W; ++f) rp[(size_t)i * W + f] = invalid(f);
      }
      return;
    }
    for (int f = 0; f < W; ++f) {
      const int32_t v = invalid(f);
      for (int i = from; i < to; ++i) store_as(at(i, f), t->f[f].size, v);
    }
  }
  // Add `bad` checked-store overflows to cluster c's counter.
  __host__ __device__ void count(int c, int bad) const {
    if (bad != 0) t->ovf[c] = wrap_add(t->ovf[c], bad);
  }
};
using QueueRows = Rows<NF>;
using RunRows = Rows<RF>;

__host__ __device__ __forceinline__ QueueRows queue_rows(const QueueTable& t,
                                                         int c, int Q) {
  return QueueRows(&t, (size_t)c * Q);
}

// The pointers and sizes every prefix kernel takes first. Every pointer is
// a tensor the Python wrapper checked for device, dtype, shape and
// contiguity (kernels/fused_tick.py _common).
struct Common {
  void* node_free;       // [C, N, R], node_size bytes a value
  uint8_t* node_active;  // [C, N], written by the expiry and fault steps
  RunTable run;                // [C, S] rows of RF fields
  uint8_t* run_active;         // [C, S]
  int32_t* arr_ptr;            // [C]
  int32_t* drop_queue;         // [C]
  int32_t* drop_run_full;      // [C]
  int32_t* placed_total;       // [C]
  int32_t* tr_t;  // [C, E], touched only when record_trace
  int32_t* tr_job;
  int32_t* tr_node;
  int32_t* tr_src;
  int32_t* tr_n;          // [C]
  const int32_t* rows;    // [C, K, NF] this tick's arrival rows, or the
                          // whole packed stream (K = A) when windowed
  const int32_t* counts;  // [C] their counts (the stream's valid prefix)
  int32_t* drop_ingest;   // [C] drops.ingest, touched only when windowed
  int C, N, R, Q, S, K, E, QC, record_trace, t;
  int window;  // min(max_ingest_per_tick, A) when windowed, else -1
  int node_size;          // 4, or the compact node columns' 1 or 2
  int32_t* exit_scratch;  // [L, 2] the node exit's total and blocks done
  // The lane form: L batch lanes of C clusters each, every [C, ...] array
  // above [L, C, ...] (cluster c of lane bl at index bl C + c), and the
  // lanes this launch runs (null: all).
  int L;
  const uint8_t* lane_on;  // [L]
};

// Common from the leading arguments of every launch function, in the
// wrapper's order, and the layout array.
inline Common make_common(void* node_free, void* node_active,
                          void* run_active, void* arr_ptr, void* drop_queue,
                          void* drop_run_full, void* placed_total, void* tr_t,
                          void* tr_job, void* tr_node, void* tr_src,
                          void* tr_n, void* rows, void* counts,
                          void* drop_ingest, void* lane_on, int C, int L,
                          int N, int R, int Q, int S, int K, int E, int QC,
                          int record_trace, int t, int window,
                          const int64_t* layout) {
  return Common{node_free,
                static_cast<uint8_t*>(node_active),
                make_table<RF>(layout, kRunTable),
                static_cast<uint8_t*>(run_active),
                static_cast<int32_t*>(arr_ptr),
                static_cast<int32_t*>(drop_queue),
                static_cast<int32_t*>(drop_run_full),
                static_cast<int32_t*>(placed_total),
                static_cast<int32_t*>(tr_t),
                static_cast<int32_t*>(tr_job),
                static_cast<int32_t*>(tr_node),
                static_cast<int32_t*>(tr_src),
                static_cast<int32_t*>(tr_n),
                static_cast<const int32_t*>(rows),
                static_cast<const int32_t*>(counts),
                static_cast<int32_t*>(drop_ingest),
                C, N, R, Q, S, K, E, QC, record_trace, t, window,
                static_cast<int>(layout[0]),
                reinterpret_cast<int32_t*>(static_cast<intptr_t>(layout[1])),
                L, static_cast<const uint8_t*>(lane_on)};
}

// The emit form's outputs and flags, after each launch function's own
// arguments (kernels/fused_tick.py _emit); null and unread on a terminal
// launch.
struct Emit {
  int32_t* ret_rows;   // [C, M, RF] return messages, the pack's order
  uint8_t* ret_valid;  // [C, M] which slots carry a return
  int32_t* drop_msgs;  // [C] drops.msgs: returns beyond M
  uint8_t* want;       // [C] the failed wait-head attempt, with borrowing
  int32_t* bjob;       // [C, NF] the wait head before that attempt
  int M;
  int borrowing;
};

inline Emit make_emit(void* ret_rows, void* ret_valid, void* drop_msgs,
                      void* want, void* bjob, int M, int borrowing) {
  return Emit{static_cast<int32_t*>(ret_rows),
              static_cast<uint8_t*>(ret_valid),
              static_cast<int32_t*>(drop_msgs), static_cast<uint8_t*>(want),
              static_cast<int32_t*>(bjob), M, borrowing};
}

// The expire form's node columns, after the emit outputs (kernels/
// fused_tick.py _expire); null and unread without expiry.
struct Expire {
  int32_t* node_cap;     // [C, N, R]
  int32_t* node_expire;  // [C, N]
};

inline Expire make_expire(void* node_cap, void* node_expire) {
  return Expire{static_cast<int32_t*>(node_cap),
                static_cast<int32_t*>(node_expire)};
}

// The faults form's leaves and settings, after the expire arguments
// (kernels/fused_tick.py _faults); null and unread without the fault plane.
// The lent queue is here for every kernel: a killed foreign job goes back
// to it.
struct Faults {
  uint8_t* health;        // [C, N]
  uint8_t* was_active;    // [C, N]
  int32_t* next_fail;     // [C, N]
  int32_t* down_until;    // [C, N]
  int32_t* down_since;    // [C, N]
  int32_t* n_fails;       // [C, N]
  int32_t* kills;         // [C]
  int32_t* requeues;      // [C]
  int32_t* down_ms;       // [C]
  const int32_t* fail_t;    // [C, N, E] trace mode's interval starts
  const int32_t* repair_t;  // [C, N, E] and ends
  const uint32_t* key;      // [C, 2] generative mode's stream roots
  int32_t* drop_failed;     // [C] drops.failed
  const char* node_cap;     // [C, N, R], Common::node_size bytes a value
  QueueTable lent;          // [C, Q] rows
  int32_t* lent_count;      // [C]
  int E, trace, mttf, mttr, max_retries;
};

inline Faults make_faults(void* health, void* was_active, void* next_fail,
                          void* down_until, void* down_since, void* n_fails,
                          void* kills, void* requeues, void* down_ms,
                          void* fail_t, void* repair_t, void* key,
                          void* drop_failed, void* node_cap,
                          const int64_t* layout, void* lent_count, int E,
                          int trace, int mttf, int mttr, int max_retries) {
  return Faults{static_cast<uint8_t*>(health),
                static_cast<uint8_t*>(was_active),
                static_cast<int32_t*>(next_fail),
                static_cast<int32_t*>(down_until),
                static_cast<int32_t*>(down_since),
                static_cast<int32_t*>(n_fails),
                static_cast<int32_t*>(kills),
                static_cast<int32_t*>(requeues),
                static_cast<int32_t*>(down_ms),
                static_cast<const int32_t*>(fail_t),
                static_cast<const int32_t*>(repair_t),
                static_cast<const uint32_t*>(key),
                static_cast<int32_t*>(drop_failed),
                static_cast<const char*>(node_cap),
                make_table<NF>(layout, kLentTable),
                static_cast<int32_t*>(lent_count),
                E, trace, mttf, mttr, max_retries};
}

// The fault step marks the nodes that fail in a tick in a bit array; the
// wrapper refuses the faults form above this many node slots
// (kernels/fused_tick.py MAX_FAULT_NODES).
constexpr int kMaxFaultNodes = 64;

// Every span kernel is a template on <kEmit, kExpire, kFaults, kTap>; its
// launch takes the four as int flags. Calls `launch` once, with the form
// they name as four std::bool_constant tags, so that each source spells
// its launch once:
//   dispatch_forms(emit, expire, faults, tap, [&](auto e, auto x, auto f,
//                                                auto p) {
//     kernel<decltype(e)::value, decltype(x)::value, decltype(f)::value,
//            decltype(p)::value><<<...>>>(a); });
// The tap runs only on a terminal prefix and expiry only with the trader,
// which is never terminal, so no form has both: 12 instantiations. Returns
// false (launching nothing) when asked for both.
template <class Launch>
inline bool dispatch_forms(int emit, int expire, int faults, int tap,
                           Launch&& launch) {
  using T = std::true_type;
  using F = std::false_type;
  if (expire && tap) return false;
  auto with_faults = [&](auto e, auto x, auto p) {
    if (faults) {
      launch(e, x, T{}, p);
    } else {
      launch(e, x, F{}, p);
    }
  };
  auto with_expire_or_tap = [&](auto e) {
    if (expire) {
      with_faults(e, T{}, F{});
    } else if (tap) {
      with_faults(e, F{}, T{});
    } else {
      with_faults(e, F{}, F{});
    }
  };
  if (emit) {
    with_expire_or_tap(T{});
  } else {
    with_expire_or_tap(F{});
  }
  return true;
}

// ---------------------------------------------------------------------------
// The generative fault draws, bitwise the reference's compiled ones. Every
// float step is an intrinsic that no build flag contracts or reorders.
// ---------------------------------------------------------------------------

// The float steps of the draws, each rounded once to f32 as written: the
// card's intrinsics, which no build flag contracts; on a host build (a
// logic check compiled without contraction), their plain meanings.
__host__ __device__ __forceinline__ float fmul_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ __forceinline__ float fadd_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ __forceinline__ float fsub_rn(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}
__host__ __device__ __forceinline__ float fma_rn(float a, float b, float c) {
#ifdef __CUDA_ARCH__
  return __fmaf_rn(a, b, c);
#else
  return fmaf(a, b, c);
#endif
}
__host__ __device__ __forceinline__ float i2f_rn(int v) {
#ifdef __CUDA_ARCH__
  return __int2float_rn(v);
#else
  return (float)v;
#endif
}

__host__ __device__ __forceinline__ uint32_t rotl32(uint32_t v, int d) {
  return (v << d) | (v >> (32 - d));
}

// jax's threefry2x32 block (20 rounds) of key (k0, k1) over the counter
// words (x0, x1), in place.
__host__ __device__ inline void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t& x0, uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int r0 = (i & 1) ? 17 : 13, r1 = (i & 1) ? 29 : 15;
    const int r2 = (i & 1) ? 16 : 26, r3 = (i & 1) ? 24 : 6;
    x0 += x1; x1 = rotl32(x1, r0) ^ x0;
    x0 += x1; x1 = rotl32(x1, r1) ^ x0;
    x0 += x1; x1 = rotl32(x1, r2) ^ x0;
    x0 += x1; x1 = rotl32(x1, r3) ^ x0;
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (uint32_t)(i + 1);
  }
}

// jax.random.fold_in(key, data): the block over the counter (0, data).
__host__ __device__ __forceinline__ void fold_in(uint32_t& k0, uint32_t& k1,
                                                 uint32_t data) {
  uint32_t x0 = 0u, x1 = data;
  threefry2x32(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

__host__ __device__ __forceinline__ float bits_f32(uint32_t b) {
#ifdef __CUDA_ARCH__
  return __uint_as_float(b);
#else
  float f;
  memcpy(&f, &b, sizeof f);
  return f;
#endif
}

__host__ __device__ __forceinline__ uint32_t f32_bits(float f) {
#ifdef __CUDA_ARCH__
  return __float_as_uint(f);
#else
  uint32_t b;
  memcpy(&b, &f, sizeof b);
  return b;
#endif
}

// jax.random.uniform(key, (), float32, 1e-7, 1.0) under jax.jit: the 32
// bits are both words of the block over (0, 0) xor-ed; the top 23 make a
// float in [1, 2), less one; then f * (1 - 1e-7) + 1e-7 as one fused
// multiply-add (XLA fuses it) and the max with the minimum.
__host__ __device__ inline float uniform01(uint32_t k0, uint32_t k1) {
  uint32_t x0 = 0u, x1 = 0u;
  threefry2x32(k0, k1, x0, x1);
  const float f = fsub_rn(bits_f32(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
  const float kMin = 0x1.ad7f2ap-24f;   // f32(1e-7)
  const float kSpan = 0x1.fffffcp-1f;   // f32(1 - f32(1e-7))
  const float u = fma_rn(f, kSpan, kMin);
  return u > kMin ? u : kMin;
}

// XLA's CPU f32 log (its LLVM IR's polynomial, in the order and with the
// fused multiply-adds of the compiled code; faults/schedule.py
// xla_log_f32 is the plain version): x = 2^e * m, m in [sqrt(1/2),
// sqrt(2)), a degree-9 polynomial in m - 1 in three cubic parts, ln 2 in
// two. Subnormals read as zero, as there.
__host__ __device__ inline float xla_logf(float x) {
  const float kFltMin = 0x1p-126f;
  if (x > -kFltMin && x < kFltMin) x = 0.0f;
  const float xc = x > kFltMin ? x : kFltMin;
  const uint32_t xi = f32_bits(xc);
  float e = fadd_rn(i2f_rn((int)(xi >> 23) - 127), 1.0f);
  const float m = bits_f32((xi & 0x807FFFFFu) | 0x3F000000u);
  const bool small = m < 0x1.6a09e6p-1f;
  const float xx = fadd_rn(fsub_rn(m, 1.0f), small ? m : 0.0f);
  e = fsub_rn(e, small ? 1.0f : 0.0f);
  const float z = fmul_rn(xx, xx);
  const float x3 = fmul_rn(z, xx);
  const float pa = fma_rn(fma_rn(xx, 0x1.204376p-4f, -0x1.d7a37p-4f),
                             xx, 0x1.de4a34p-4f);
  const float pb = fma_rn(fma_rn(xx, -0x1.fcba9ep-4f, 0x1.23d37ep-3f),
                             xx, -0x1.555ca0p-3f);
  const float pc = fma_rn(fma_rn(xx, 0x1.999d58p-3f, -0x1.fffff8p-3f),
                             xx, 0x1.555554p-2f);
  const float q = fma_rn(x3, fma_rn(x3, pa, pb), pc);
  const float y = fma_rn(x3, q, fmul_rn(e, -0x1.bd0106p-13f));
  float r = fma_rn(0x1.63p-1f, e,
                      fadd_rn(fma_rn(-0.5f, z, xx), y));
  if (!(x > 0.0f)) r = bits_f32(0xFFFFFFFFu);
  if (x == 0.0f) r = bits_f32(0xFF800000u);
  if (x == bits_f32(0x7F800000u)) r = x;
  return r;
}

// One generative draw (faults/schedule.py _exp_draws): node n's duration
// for draw ordinal `counter` of `kind` (0 time-to-failure, 1
// time-to-repair) under the cluster's key, clip(ceil(-mean * log(u)), 1,
// 2^30) ms.
__host__ __device__ inline int32_t exp_draw(const uint32_t* key, int n,
                                            int32_t counter, int kind,
                                            int mean) {
  uint32_t k0 = key[0], k1 = key[1];
  fold_in(k0, k1, (uint32_t)n);
  fold_in(k0, k1, 2u * (uint32_t)counter + (uint32_t)kind);
  const float u = uniform01(k0, k1);
  float dt = ceilf(fmul_rn(-i2f_rn(mean), xla_logf(u)));
  dt = dt > 1.0f ? dt : 1.0f;
  dt = dt < 1073741824.0f ? dt : 1073741824.0f;
  return (int32_t)dt;
}

__host__ __device__ __forceinline__ int32_t queue_invalid(int f) {
  return (f == FID || f == FOWNER) ? -1 : 0;
}

__host__ __device__ __forceinline__ int32_t run_invalid(int f) {
  return f == REND ? NEVER : ((f == RID || f == ROWNER) ? -1 : 0);
}

struct QueueInvalid {
  __host__ __device__ int32_t operator()(int f) const {
    return queue_invalid(f);
  }
};
struct RunInvalid {
  __host__ __device__ int32_t operator()(int f) const {
    return run_invalid(f);
  }
};

__host__ __device__ __forceinline__ void set_run_invalid(const RunRows& r,
                                                        int s) {
  r.fill(s, s + 1, RunInvalid{});
}

// Whether a node's free resources `f` cover the job (ScheduleJob's >=,
// scheduler.go:131). With the gpu axis narrowed away (R == 2) a job that
// demands gpu fits nowhere.
__host__ __device__ __forceinline__ bool fits(const int32_t* f, int R,
                                              const int32_t* job) {
  bool ok = f[0] >= job[FCORES] && f[1] >= job[FMEM];
  return ok && (R > 2 ? f[2] >= job[FGPU] : job[FGPU] <= 0);
}

// Lowest active node that fits the job, or -1.
__host__ __device__ inline int first_fit(const int32_t* free,
                                         const uint8_t* active, int N, int R,
                                         const int32_t* job) {
  for (int n = 0; n < N; ++n) {
    if (active[n] && fits(free + n * R, R, job)) return n;
  }
  return -1;
}

// The node slots a cluster may have on the compact layout's narrow node
// columns: the waves' replay computes on local int32 copies of their free
// words (kernels/fused_tick.py MAX_NARROW_NODES; the wrapper raises above
// it).
constexpr int kMaxNarrowNodes = 32;

// One cluster's node vectors and running set, and what the tick has done
// to them so far, for the steps one lane runs (prefix_warp.cuh
// WarpCluster::lane_cluster): the free words are the warp's shared copy.
struct Cluster {
  const Common& a;
  int c;
  int32_t* free;  // the node free words: the warp's shared copy
  const uint8_t* nact;
  RunRows run;
  uint8_t* ract;
  int slot;      // insertion cursor: every slot below it is active
  int n_active;  // active running slots
  int placed;    // placements this tick

  // The caller holds the free words widened, where it keeps them
  // (prefix_warp.cuh: the warp's shared copy): nothing is copied, and the
  // caller sets the cursor and the counts.
  struct Words {};
  __host__ __device__ Cluster(const Common& args, int cluster, int32_t* words,
                              Words)
      : a(args), c(cluster), free(words),
        nact(args.node_active + (size_t)cluster * args.N),
        run(&args.run, (size_t)cluster * args.S),
        ract(args.run_active + (size_t)cluster * args.S),
        slot(0), n_active(0), placed(0) {}

  // The fault phase (faults/apply.py fault_phase_local), before release.
  // One pass over the N nodes: a healthy node whose next_fail <= t fails —
  // its free resources zeroed, its activation parked in was_active, its
  // outage opened (down_until from the trace table or a repair draw) —
  // and then a down node whose down_until <= t repairs, a same-tick
  // failure included: free = cap, the activation restored, down_ms closed,
  // the next failure looked up or drawn with n_fails + 1. Only where a node
  // failed, one pass over the S running slots, in slot order: a slot on a
  // failed node is killed (its row INVALID, no resources returned); a job
  // under its retry budget is requeued with enq_t = t, rec_wait = 0 and
  // retries + 1 — an own job into the ingest target `tgt` (its count at
  // *tgt_count; the requeues go into *n_ingest), a foreign one (owner >=
  // 0) into the lent queue — past capacity into *drop_queue, each row
  // through the checked store (the reference's push_many); a job at its
  // budget counts into drops.failed; a carve placeholder (owner -2) is
  // only killed.
  __host__ __device__ void faults(const Faults& f, const QueueTable& tgt_t,
                                  int32_t* tgt_count, int* drop_queue,
                                  int* n_ingest) {
    const int N = a.N, R = a.R, t = a.t;
    const size_t cn = (size_t)c * N;
    uint8_t* act = a.node_active + cn;
    const char* cap = f.node_cap + cn * R * a.node_size;
    uint32_t failed[kMaxFaultNodes / 32] = {0u, 0u};
    bool any = false;
    int32_t down_ms = 0;
    for (int n = 0; n < N; ++n) {
      const size_t i = cn + n;
      bool up = f.health[i] != 0;
      if (up && f.next_fail[i] > t) continue;  // the quiet case
      int32_t until = f.down_until[i];
      if (up) {  // fails now
        failed[n >> 5] |= 1u << (n & 31);
        any = true;
        for (int r = 0; r < R; ++r) free[n * R + r] = 0;
        f.was_active[i] = act[n];
        act[n] = 0;
        const int32_t k = f.n_fails[i];
        until = f.trace ? (k < f.E ? f.repair_t[i * f.E + imax(k, 0)] : NEVER)
                        : wrap_add(t, exp_draw(f.key + 2 * c, n, k, 1,
                                               f.mttr));
        f.next_fail[i] = NEVER;
        f.down_since[i] = t;
        f.health[i] = 0;
        up = false;
      }
      if (until <= t) {  // repairs now
        act[n] = f.was_active[i];
        for (int r = 0; r < R; ++r) {
          free[n * R + r] = load_as(cap + (n * R + r) * a.node_size,
                                    a.node_size);
        }
        down_ms = wrap_add(down_ms, wrap_sub(t, f.down_since[i]));
        const int32_t k = f.n_fails[i] + 1;
        f.n_fails[i] = k;
        f.next_fail[i] =
            f.trace ? (k < f.E ? f.fail_t[i * f.E + imax(k, 0)] : NEVER)
                    : wrap_add(t, exp_draw(f.key + 2 * c, n, k, 0, f.mttf));
        until = NEVER;
        f.health[i] = 1;
      }
      f.down_until[i] = until;
    }
    if (down_ms != 0) f.down_ms[c] = wrap_add(f.down_ms[c], down_ms);
    if (!any) return;
    const QueueRows lent = queue_rows(f.lent, c, a.Q);
    const QueueRows tgt = queue_rows(tgt_t, c, a.Q);
    int lcount = f.lent_count[c], tcount = *tgt_count;
    int kills = 0, requeues = 0, exhausted = 0, lbad = 0, tbad = 0;
    for (int s = 0; s < a.S; ++s) {
      // the active flags, 16 at a time where they lie 8-byte aligned: a
      // run of inactive slots (the slots past the lowest free one, mostly)
      // costs two loads instead of sixteen
      if ((s & 15) == 0 && s + 16 <= a.S &&
          (reinterpret_cast<uintptr_t>(ract + s) & 7) == 0) {
        const uint64_t* w = reinterpret_cast<const uint64_t*>(ract + s);
        if ((w[0] | w[1]) == 0u) {
          s += 15;
          continue;
        }
      }
      if (!ract[s]) continue;
      const int32_t node = run.get(s, RNODE);
      if (node < 0 || node >= N ||
          !(failed[node >> 5] & (1u << (node & 31)))) {
        continue;
      }
      int32_t row[RF];
      run.load(s, row);
      const int32_t owner = row[ROWNER];
      if (owner != -2) {  // a job, not a carve placeholder
        ++kills;
        if (row[RRETRIES] < f.max_retries) {
          ++requeues;
          const int32_t job[NF] = {
              row[RID], row[RCORES], row[RMEM], row[RGPU], row[RDUR], t,
              owner, 0, (row[RGPU] > 0) * 2 + (row[RCORES] > 8),
              wrap_add(row[RRETRIES], 1)};
          if (owner >= 0) {
            if (lcount < a.Q) {
              lbad += lent.store_checked(lcount++, job);
            } else {
              ++*drop_queue;
            }
          } else {
            ++*n_ingest;
            if (tcount < a.Q) {
              tbad += tgt.store_checked(tcount++, job);
            } else {
              ++*drop_queue;
            }
          }
        } else {
          ++exhausted;
        }
      }
      set_run_invalid(run, s);
      ract[s] = 0;
    }
    lent.count(c, lbad);
    tgt.count(c, tbad);
    f.lent_count[c] = lcount;
    *tgt_count = tcount;
    f.kills[c] += kills;
    f.requeues[c] += requeues;
    f.drop_failed[c] += exhausted;
  }

  // Start `job` on `node`: occupy its resources, write its running row into
  // the lowest inactive slot (a plain store, as the reference's
  // start_many), count it, and trace it.
  __host__ __device__ void place(const int32_t* job, int node, int32_t src) {
#pragma unroll
    for (int r = 0; r < 3; ++r) {  // constant indices: `job` stays in registers
      if (r < a.R) free[node * a.R + r] -= job[FCORES + r];
    }
    while (slot < a.S && ract[slot]) ++slot;  // caller checked n_active < S
    const int32_t row[RF] = {wrap_add(a.t, job[FDUR]), node, job[FCORES],
                             job[FMEM], job[FGPU], job[FID], job[FOWNER],
                             job[FDUR], job[FENQ], job[FRETRIES]};
    run.store(slot, row);
    ract[slot] = 1;
    ++n_active;
    ++placed;
    if (a.record_trace) {
      int32_t n = a.tr_n[c];
      if (n < a.E) {
        size_t i = (size_t)c * a.E + n;
        a.tr_t[i] = a.t;
        a.tr_job[i] = job[FID];
        a.tr_node[i] = node;
        a.tr_src[i] = src;
        a.tr_n[c] = n + 1;
      }
    }
  }

  // One attempt (the reference's _attempt / _attempt_deferred) with the
  // node already picked (-1: none fits): place `job` there if the running
  // set has a free slot; returns whether it did. A job that fits a node
  // but finds the running set full counts into `*run_full`.
  __host__ __device__ bool attempt_on(const int32_t* job, int node,
                                      int32_t src, int* run_full) {
    if (node < 0) return false;
    if (n_active >= a.S) {
      ++*run_full;
      return false;
    }
    place(job, node, src);
    return true;
  }
};


// ---------------------------------------------------------------------------
// The serial queue sweep (the reference's _scored_sweep_local and the
// Level1 sweep of _delay_local) as the lane-0 replay of the waves runs it:
// for each of the first n positions of an order over a queue, record the
// job's wait and attempt it on the node the pick chooses.
// ---------------------------------------------------------------------------

// Queue order: position p is slot p.
struct QueueOrder {
  int p = 0;
  __host__ __device__ int next(const QueueRows&, int) { return p++; }
};

// The reference's first-fit pick.
struct FirstFitPick {
  __host__ __device__ int operator()(const Cluster& cl,
                                     const int32_t* job) const {
    return first_fit(cl.free, cl.nact, cl.a.N, cl.a.R, job);
  }
};

// What one tick's sweep accumulates. The placed-slot mask is kept apart
// (the callers' local array), so that these scalars stay in registers.
struct SweepAcc {
  float total;             // wait_total (f32)
  long long wave_sum = 0;  // the wave form's exact sum of wait deltas
  int run_full = 0;        // attempts that fit a node but found no slot
  int placed = 0;          // placements of this sweep
  int bad = 0;             // rec_wait stores outside their column

  __host__ __device__ explicit SweepAcc(float wait_total)
      : total(wait_total) {}
};

// The JobsMap bookkeeping of one scheduling attempt (scheduler.go:309-312):
// the job's wait delta is added to `total` in f32 (the serial form) or
// summed exactly into `wave_sum` (the wave form), and its rec_wait set.
__host__ __device__ __forceinline__ void record_wait(int32_t* job, int t,
                                                     bool wave,
                                                     SweepAcc& acc) {
  const int32_t cur = wrap_sub(t, job[FENQ]);
  const int32_t delta = wrap_sub(cur, job[FREC]);
  if (wave) {
    acc.wave_sum += delta;
  } else {
    acc.total = acc.total + (float)delta;
  }
  job[FREC] = cur;
}

// ---------------------------------------------------------------------------
// The speculative waves as the reference computes them, for rows with a
// negative demand. The reference pins its wave forms equal to the serial
// ones because free only shrinks as jobs place; a demand the compact
// layout's checked store clamped to the dtype minimum (a mis-sized plan:
// ovf > 0) is negative, and then a job that fits no node against the
// wave's starting free may fit after an earlier job of the same wave
// placed, where the serial form places it and the wave does not. So the
// kernels run the serial form (its equal) unless a clamp reached the queue
// (its ovf counter; arrival demands are not negative) and a row the sweep
// may place has a negative demand, and then these, which replay the waves
// on lane 0 (for at most kMaxNarrowNodes node slots, their local arrays:
// the wrapper refuses a compact layout with more): each wave probes every unresolved
// row against the free words at the wave's start (first fit, the
// cumulative demand per target node against that node's free), and places
// rows in position order — the order the reference's placement buffer
// keeps — so the running slots and the trace come out the same.
// ---------------------------------------------------------------------------

// Has a checked store clamped a value into table t of cluster c (its
// overflow counter, cumulative over the run)? Only a clamp makes a stored
// demand negative: arrival demands are not, and a row's demand is stored
// checked where it enters the cluster's queues.
__host__ __device__ __forceinline__ bool clamped(const QueueTable& t, int c) {
  return t.ovf != nullptr && t.ovf[c] != 0;
}

// Does one of the first `n` rows of `q` demand a negative amount?
__host__ __device__ inline bool any_negative_demand(const QueueRows& q,
                                                    int n) {
  for (int i = 0; i < n; ++i) {
    if (q.get(i, FCORES) < 0 || q.get(i, FMEM) < 0 || q.get(i, FGPU) < 0) {
      return true;
    }
  }
  return false;
}

// One wave's probe of one row: its first-fit node against the wave's
// starting free words `w0` (-1: none), and whether the cumulative demand
// `cum` of the rows that target that node, this one included, exceeds its
// free words there (the reference's overflow).
__host__ __device__ inline int wave_probe(const Cluster& cl,
                                          const int32_t* w0, int32_t* cum,
                                          const int32_t* job, bool* overflow) {
  const int R = cl.a.R;
  const int tgt = first_fit(w0, cl.nact, cl.a.N, R, job);
  *overflow = false;
  if (tgt < 0) return tgt;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    if (r >= R) break;
    cum[tgt * R + r] = wrap_add(cum[tgt * R + r], job[FCORES + r]);
    *overflow = *overflow || cum[tgt * R + r] > w0[tgt * R + r];
  }
  return tgt;
}

// The reference's _fifo_drain_wave over the ready queue's first `lim`
// rows: each wave places the rows before its first breaker — a row that
// overflows its node's group (probed again in the next wave), fits no
// node or finds no running slot (both stop the drain: the failure). Sets
// the jobs taken (placed, and the failing one), whether the drain failed
// and the failing row into `job`.
__host__ __device__ inline void fifo_drain_waves(Cluster& cl,
                                                 const QueueRows& q, int lim,
                                                 int* run_full, int* n_taken,
                                                 bool* any_fail,
                                                 int32_t* job) {
  int32_t w0[kMaxNarrowNodes * 3], cum[kMaxNarrowNodes * 3];
  const int nr = cl.a.N * cl.a.R;
  int done = 0;  // rows [0, done) are resolved: the drain takes a prefix
  *any_fail = false;
  while (done < lim && !*any_fail) {
    for (int i = 0; i < nr; ++i) {
      w0[i] = cl.free[i];
      cum[i] = 0;
    }
    const int cap_left = cl.a.S - cl.n_active;
    int rank = 0;
    for (int i = done; i < lim; ++i) {
      q.load(i, job);
      bool overflow;
      const int tgt = wave_probe(cl, w0, cum, job, &overflow);
      if (overflow) break;  // probed again next wave
      if (tgt < 0 || rank >= cap_left) {  // the drain fails on this row
        if (tgt >= 0) ++*run_full;
        *any_fail = true;
        ++done;
        break;
      }
      cl.place(job, tgt, SRC_READY);
      ++rank;
      ++done;
    }
  }
  *n_taken = done;
}

// The reference's _wave_place over the first `n_sweep` positions of
// `order` (first fit): each wave resolves the rows that fit no node (never
// placed), and, before its first overflowing row, places each row that
// fits while running slots last and counts the rest into run_full; the
// overflowing row and those after it are probed again. `mask` gets the
// placed slots.
template <class Order>
__host__ __device__ void wave_place(Cluster& cl, const QueueRows& q,
                                    int count, int n_sweep,
                                    const Order& first, int32_t src,
                                    SweepAcc& acc, uint32_t* mask) {
  int32_t w0[kMaxNarrowNodes * 3], cum[kMaxNarrowNodes * 3];
  uint32_t resolved[kMaskWords];
  const int nr = cl.a.N * cl.a.R;
  for (int w = 0; w < (n_sweep + 31) / 32; ++w) resolved[w] = 0u;
  int left = n_sweep;
  while (left > 0) {
    for (int i = 0; i < nr; ++i) {
      w0[i] = cl.free[i];
      cum[i] = 0;
    }
    const int cap_left = cl.a.S - cl.n_active;
    int rank = 0;
    bool blocked = false;
    Order order = first;
    for (int p = 0; p < n_sweep; ++p) {
      const int i = order.next(q, count);
      if (resolved[p >> 5] & (1u << (p & 31))) continue;
      int32_t job[NF];
      q.load(i, job);
      bool overflow = false;
      const int tgt = blocked ? first_fit(w0, cl.nact, cl.a.N, cl.a.R, job)
                              : wave_probe(cl, w0, cum, job, &overflow);
      blocked = blocked || overflow;
      if (tgt >= 0 && blocked) continue;
      resolved[p >> 5] |= 1u << (p & 31);
      --left;
      if (tgt < 0) continue;  // fits no node: never placed
      if (rank++ < cap_left) {
        cl.place(job, tgt, src);
        mask[i >> 5] |= 1u << (i & 31);
      } else {
        ++acc.run_full;
      }
    }
  }
}

// The rows a sweep of `n_sweep` positions may place: the first `n_sweep`
// slots in queue order, the whole queue in another order.
__host__ __device__ inline int swept_rows(const QueueOrder&, int,
                                          int n_sweep) {
  return n_sweep;
}
template <class Order>
__host__ __device__ inline int swept_rows(const Order&, int count, int) {
  return count;
}

// The first `n_sweep` positions of `order` over the queue `q` holding
// `count` rows, serially: each is read into a local row, records its wait
// (the rec_wait store checked, as the reference's set_field; the count in
// acc.bad) and is attempted on the node `pick` chooses, with the has-slot
// check, and a placed slot is marked in `mask`; `skip_after_success` is
// DELAY's parity quirk (a success passes over the next position). The
// wave form's exact wait sum is added to the total once, at the end.
// Placement is serial in both forms: the reference pins its wave sweeps
// equal to the serial ones (tests/test_kernel_equiv.py).
// `may_replay` (a clamp reached the queue) lets a negative demand among
// the swept rows replay the waves in the wave form instead.
template <class Order, class Pick>
__host__ __device__ void sweep(Cluster& cl, const QueueRows& q, int count,
                               int n_sweep, Order& order, const Pick& pick,
                               int32_t src, bool wave, bool may_replay,
                               bool skip_after_success, SweepAcc& acc,
                               uint32_t* mask) {
  for (int w = 0; w < (count + 31) / 32; ++w) mask[w] = 0u;
  const int before = cl.placed;
  if (wave && may_replay && cl.a.N <= kMaxNarrowNodes &&
      any_negative_demand(q, swept_rows(order, count, n_sweep))) {
    // the waves' wait accounting, then their placements
    const Order first = order;
    for (int p = 0; p < n_sweep; ++p) {
      const int i = order.next(q, count);
      int32_t job[NF];
      q.load(i, job);
      record_wait(job, cl.a.t, true, acc);
      acc.bad += q.set_checked(i, FREC, job[FREC]);
    }
    wave_place(cl, q, count, n_sweep, first, src, acc, mask);
    acc.total = acc.total + (float)acc.wave_sum;
    acc.placed = cl.placed - before;
    return;
  }
  bool skip = false;
  for (int p = 0; p < n_sweep; ++p) {
    const int i = order.next(q, count);
    if (skip) {
      skip = false;
      continue;
    }
    int32_t job[NF];
    q.load(i, job);
    record_wait(job, cl.a.t, wave, acc);
    acc.bad += q.set_checked(i, FREC, job[FREC]);
    if (cl.attempt_on(job, pick(cl, job), src, &acc.run_full)) {
      mask[i >> 5] |= 1u << (i & 31);
      skip = skip_after_success;
    }
  }
  if (wave) acc.total = acc.total + (float)acc.wave_sum;
  acc.placed = cl.placed - before;
}

// ---------------------------------------------------------------------------
// Level0 and the counters its sweeps update (the FFD, DELAY and scored
// kernels; prefix_warp.cuh level0_prefix).
// ---------------------------------------------------------------------------

struct Level0Args {
  Common k;
  QueueTable l0;           // [C, Q] rows
  int32_t* l0_count;       // [C]
  float* wait_total;       // [C]
  int32_t* wait_jobs;      // [C]
  int32_t* jobs_in_queue;  // [C]
  int wave;                // the wave form's wait accounting (else serial)
};

// Level0Args from the arguments after Common, in the wrappers' order.
inline Level0Args make_level0(const Common& k, const int64_t* layout,
                              void* l0_count, void* wait_total,
                              void* wait_jobs, void* jobs_in_queue,
                              int wave) {
  return Level0Args{k,
                    make_table<NF>(layout, kOwnTable),
                    static_cast<int32_t*>(l0_count),
                    static_cast<float*>(wait_total),
                    static_cast<int32_t*>(wait_jobs),
                    static_cast<int32_t*>(jobs_in_queue),
                    wave};
}


// ---------------------------------------------------------------------------
// The metrics tap (obs/device.py tap_tick): its operands and the
// per-cluster half, which prefix_warp.cuh tap_epilogue runs on each warp's
// lane 0 before the cross-cluster half.
// ---------------------------------------------------------------------------

constexpr int kDepthBuckets = 16;  // obs/device.py OBS_DEPTH_BUCKETS
constexpr int kObsRing = 64;       // obs/device.py OBS_RING

// The tap form's operands, from the host array of pointers the wrapper
// builds once per run (kernels/fused_tick.py _tap_args, in this order):
// the buffer's per-cluster leaves and the cursor, updated in place; the
// per-tick outputs; the buffer's cross-cluster leaves (a set per batch
// lane: ticks [L], depth_hist [L, B], the rings [L, kObsRing]) and a
// scratch of three words a lane (zero between launches); the state
// counters the tap reads;
// the seven overflow counters of the compact layout (l0, l1, ready, wait,
// lent, borrowed, run; null on the wide layout).
constexpr int kOvfCounters = 7;

struct Tap {
  int32_t *placed, *arrived, *borrows;
  float* wait_accrued;
  int32_t *ovf, *depth_sum, *depth_max, *kills, *requeues, *fail_drops,
      *node_down_ms;
  int32_t *c_placed, *c_arrived, *c_lent;
  float* c_wait;
  int32_t *c_ovf, *c_kills, *c_requeues, *c_fail_drops, *c_down_ms;
  int32_t *placed_d, *depth;
  int32_t *ticks, *depth_hist, *ring_placed, *ring_depth, *ring_t, *scratch;
  const float* wait_total;
  const int32_t *lent_count, *l0_count, *l1_count, *ready_count,
      *wait_count, *kills_total, *requeues_total, *down_ms_total,
      *drop_failed;
  const int32_t* ovf_total[kOvfCounters];
  int slot;  // the ring slot of the post-tick clock, (t / tick_ms) % 64
};

inline Tap make_tap(const void* const* p, int slot) {
  Tap t{};
  if (p == nullptr) return t;
  int i = 0;
  auto i32 = [&]() { return static_cast<int32_t*>(const_cast<void*>(p[i++])); };
  auto f32 = [&]() { return static_cast<float*>(const_cast<void*>(p[i++])); };
  t.placed = i32(); t.arrived = i32(); t.borrows = i32();
  t.wait_accrued = f32();
  t.ovf = i32(); t.depth_sum = i32(); t.depth_max = i32(); t.kills = i32();
  t.requeues = i32(); t.fail_drops = i32(); t.node_down_ms = i32();
  t.c_placed = i32(); t.c_arrived = i32(); t.c_lent = i32();
  t.c_wait = f32();
  t.c_ovf = i32(); t.c_kills = i32(); t.c_requeues = i32();
  t.c_fail_drops = i32(); t.c_down_ms = i32();
  t.placed_d = i32(); t.depth = i32();
  t.ticks = i32(); t.depth_hist = i32(); t.ring_placed = i32();
  t.ring_depth = i32(); t.ring_t = i32(); t.scratch = i32();
  t.wait_total = f32();
  t.lent_count = i32(); t.l0_count = i32(); t.l1_count = i32();
  t.ready_count = i32(); t.wait_count = i32(); t.kills_total = i32();
  t.requeues_total = i32(); t.down_ms_total = i32(); t.drop_failed = i32();
  for (int k = 0; k < kOvfCounters; ++k) t.ovf_total[k] = i32();
  t.slot = slot;
  return t;
}

// The log2 bucket of a queue depth as the reference's compiled code
// computes it (obs/device.py _depth_buckets): 1 + floor(log(f32(depth)) *
// f32(1 / log 2)) with XLA's CPU f32 log, which puts 8192 in bucket 13;
// 0 for an empty queue; clipped to the last bucket.
__host__ __device__ inline int depth_bucket(int32_t depth) {
  if (depth <= 0) return 0;
  const float l = fmul_rn(xla_logf(i2f_rn(depth)), 0x1.715476p+0f);
  const int b = 1 + (int)floorf(l);
  return imin(imax(b, 0), kDepthBuckets - 1);
}

// The per-cluster half of the tap (obs/device.py tap_tick_local) for
// cluster c: the counters differenced against the cursor, in the
// reference's arithmetic (int32 wrapping, the f32 wait delta added as one
// subtraction and one addition), the eleven leaves accumulated, the
// cursor moved; sets the tick's placements, the queue depth and its
// bucket. Every value is loaded before the first store, so that the loads
// go out together instead of each waiting on the stores before it (the
// compiler cannot tell the leaves apart).
__device__ __forceinline__ void tap_cluster(const Tap& p, const Common& k,
                                            int c, int32_t* placed_d_out,
                                            int32_t* depth_out,
                                            int* bucket_out) {
  // the state's counters
  const int32_t placed = k.placed_total[c], arrived = k.arr_ptr[c];
  const int32_t lent = p.lent_count[c];
  const float wait = p.wait_total[c];
  const int32_t kills = p.kills_total[c], requeues = p.requeues_total[c];
  const int32_t fail = p.drop_failed[c], down = p.down_ms_total[c];
  int32_t ovf = 0;  // obs/device.py _ovf_total: 0 on the wide layout
  for (int q = 0; q < kOvfCounters; ++q) {
    if (p.ovf_total[q] != nullptr) ovf = wrap_add(ovf, p.ovf_total[q][c]);
  }
  const int32_t depth = wrap_add(
      wrap_add(wrap_add(p.l0_count[c], p.l1_count[c]), p.ready_count[c]),
      p.wait_count[c]);
  // the cursor
  const int32_t c_placed = p.c_placed[c], c_arrived = p.c_arrived[c];
  const int32_t c_lent = p.c_lent[c], c_ovf = p.c_ovf[c];
  const float c_wait = p.c_wait[c];
  const int32_t c_kills = p.c_kills[c], c_requeues = p.c_requeues[c];
  const int32_t c_fail = p.c_fail_drops[c], c_down = p.c_down_ms[c];
  // the accumulators
  const int32_t b_placed = p.placed[c], b_arrived = p.arrived[c];
  const int32_t b_borrows = p.borrows[c], b_ovf = p.ovf[c];
  const float b_wait = p.wait_accrued[c];
  const int32_t b_depth_sum = p.depth_sum[c], b_depth_max = p.depth_max[c];
  const int32_t b_kills = p.kills[c], b_requeues = p.requeues[c];
  const int32_t b_fail = p.fail_drops[c], b_down = p.node_down_ms[c];

  const int32_t placed_d = wrap_sub(placed, c_placed);
  p.placed[c] = wrap_add(b_placed, placed_d);
  p.arrived[c] = wrap_add(b_arrived, wrap_sub(arrived, c_arrived));
  p.borrows[c] = wrap_add(b_borrows, imax(wrap_sub(lent, c_lent), 0));
  p.wait_accrued[c] = fadd_rn(b_wait, fsub_rn(wait, c_wait));
  p.ovf[c] = wrap_add(b_ovf, wrap_sub(ovf, c_ovf));
  p.depth_sum[c] = wrap_add(b_depth_sum, depth);
  p.depth_max[c] = imax(b_depth_max, depth);
  p.kills[c] = wrap_add(b_kills, wrap_sub(kills, c_kills));
  p.requeues[c] = wrap_add(b_requeues, wrap_sub(requeues, c_requeues));
  p.fail_drops[c] = wrap_add(b_fail, wrap_sub(fail, c_fail));
  p.node_down_ms[c] = wrap_add(b_down, wrap_sub(down, c_down));
  p.c_placed[c] = placed;
  p.c_arrived[c] = arrived;
  p.c_lent[c] = lent;
  p.c_wait[c] = wait;
  p.c_ovf[c] = ovf;
  p.c_kills[c] = kills;
  p.c_requeues[c] = requeues;
  p.c_fail_drops[c] = fail;
  p.c_down_ms[c] = down;
  p.placed_d[c] = placed_d;
  p.depth[c] = depth;
  bucket_out[0] = depth_bucket(depth);
  placed_d_out[0] = placed_d;
  depth_out[0] = depth;
}

}  // namespace prefix
