// What every per-cluster tick-prefix kernel shares (fused_prefix_fifo.cu,
// fused_prefix_ffd.cu): the row schemas, the pointers and sizes common to
// every span, and the phases and steps the spans have in common —
// release of due running slots, the append of the tick's arrivals to a
// queue, first-fit over the nodes, and placing a job (occupy its node,
// insert its running row into the lowest free slot, count it, trace it).
//
// Every function here works on ONE cluster, walked by one thread, in
// place, in the reference's order. Integer discipline: all arithmetic is
// int32 as in the reference; sums that could overflow (end_t = t + dur,
// waits t - enq_t) are done in uint32 and cast back, which is the
// reference's two's-complement wrap without signed overflow in C++. NEVER
// (2^31-1) is only compared. torch bool tensors arrive as uint8_t.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace prefix {

constexpr int NF = 10;  // queue row fields (ops/fields.py QUEUE_FIELDS)
constexpr int FID = 0, FCORES = 1, FMEM = 2, FGPU = 3, FDUR = 4, FENQ = 5,
              FOWNER = 6, FREC = 7, FRETRIES = 9;
constexpr int RF = 10;  // running-set row fields (ops/fields.py RUN_FIELDS)
constexpr int REND = 0, RNODE = 1, RCORES = 2, RMEM = 3, RGPU = 4, RID = 5,
              ROWNER = 6, RDUR = 7, RENQ = 8, RRETRIES = 9;
constexpr int32_t NEVER = 2147483647;
// trace source-queue codes (core/state.py)
constexpr int32_t SRC_L0 = 1, SRC_READY = 2, SRC_WAIT = 3, SRC_LENT = 4;

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

// The pointers and sizes every prefix kernel takes first. Every pointer is
// a tensor the Python wrapper checked for device, dtype, shape and
// contiguity (kernels/fused_tick.py _common).
struct Common {
  int32_t* node_free;          // [C, N, R]
  const uint8_t* node_active;  // [C, N]
  int32_t* run;                // [C, S, RF]
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
  const int32_t* rows;    // [C, K, NF] this tick's arrival rows
  const int32_t* counts;  // [C]
  int C, N, R, Q, S, K, E, QC, record_trace, t;
};

// Common from the leading arguments of every launch function, in the
// wrapper's order.
inline Common make_common(void* node_free, void* node_active, void* run,
                          void* run_active, void* arr_ptr, void* drop_queue,
                          void* drop_run_full, void* placed_total, void* tr_t,
                          void* tr_job, void* tr_node, void* tr_src,
                          void* tr_n, void* rows, void* counts, int C, int N,
                          int R, int Q, int S, int K, int E, int QC,
                          int record_trace, int t) {
  return Common{static_cast<int32_t*>(node_free),
                static_cast<const uint8_t*>(node_active),
                static_cast<int32_t*>(run),
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
                C, N, R, Q, S, K, E, QC, record_trace, t};
}

__host__ __device__ __forceinline__ int32_t queue_invalid(int f) {
  return (f == FID || f == FOWNER) ? -1 : 0;
}

__host__ __device__ __forceinline__ int32_t run_invalid(int f) {
  return f == REND ? NEVER : ((f == RID || f == ROWNER) ? -1 : 0);
}

__host__ __device__ __forceinline__ void set_queue_invalid(int32_t* row) {
#pragma unroll
  for (int f = 0; f < NF; ++f) row[f] = queue_invalid(f);
}

__host__ __device__ __forceinline__ void copy_row(int32_t* dst,
                                                  const int32_t* src) {
#pragma unroll
  for (int f = 0; f < NF; ++f) dst[f] = src[f];
}

// Lowest active node whose free resources cover the job (ScheduleJob's >=,
// scheduler.go:131), or -1. With the gpu axis narrowed away (R == 2) a job
// that demands gpu fits nowhere.
__host__ __device__ inline int first_fit(const int32_t* free,
                                         const uint8_t* active, int N, int R,
                                         const int32_t* job) {
  for (int n = 0; n < N; ++n) {
    if (!active[n]) continue;
    const int32_t* f = free + n * R;
    bool ok = f[0] >= job[FCORES] && f[1] >= job[FMEM];
    ok = ok && (R > 2 ? f[2] >= job[FGPU] : job[FGPU] <= 0);
    if (ok) return n;
  }
  return -1;
}

// One cluster's node vectors and running set, and what the tick has done
// to them so far.
struct Cluster {
  const Common& a;
  int c;
  int32_t* free;
  const uint8_t* nact;
  int32_t* run;
  uint8_t* ract;
  int slot;      // insertion cursor: every slot below it is active
  int n_active;  // active running slots
  int placed;    // placements this tick

  __host__ __device__ Cluster(const Common& args, int cluster)
      : a(args), c(cluster),
        free(args.node_free + (size_t)cluster * args.N * args.R),
        nact(args.node_active + (size_t)cluster * args.N),
        run(args.run + (size_t)cluster * args.S * RF),
        ract(args.run_active + (size_t)cluster * args.S),
        slot(0), n_active(0), placed(0) {}

  // Release: every active slot with end_t <= t returns its resources to
  // its node and becomes an invalid, inactive row; counts the rest.
  __host__ __device__ void release() {
    for (int s = 0; s < a.S; ++s) {
      if (!ract[s]) continue;
      int32_t* row = run + s * RF;
      if (row[REND] <= a.t) {
        int node = imin(imax(row[RNODE], 0), a.N - 1);
        for (int r = 0; r < a.R; ++r) free[node * a.R + r] += row[RCORES + r];
#pragma unroll
        for (int f = 0; f < RF; ++f) row[f] = run_invalid(f);
        ract[s] = 0;
      } else {
        ++n_active;
      }
    }
  }

  // Ingest: append the tick's first counts[c] rows to queue `q` holding
  // `count` rows; rows past its capacity count into `*drop_queue`, and the
  // arrival cursor advances by the full count either way. Returns the new
  // count.
  __host__ __device__ int ingest(int32_t* q, int count, int* drop_queue) {
    const int cnt = a.counts[c];
    const int n_take = imin(imax(cnt, 0), a.K);
    const int room = a.Q - count;
    *drop_queue += imax(n_take - room, 0);
    const int added = imin(n_take, room);
    const int32_t* arows = a.rows + (size_t)c * a.K * NF;
    for (int k = 0; k < added; ++k) copy_row(q + (count + k) * NF,
                                             arows + k * NF);
    a.arr_ptr[c] += cnt;
    return count + added;
  }

  // Start `job` on `node`: occupy its resources, write its running row into
  // the lowest inactive slot, count it, and trace it.
  __host__ __device__ void place(const int32_t* job, int node, int32_t src) {
    for (int r = 0; r < a.R; ++r) free[node * a.R + r] -= job[FCORES + r];
    while (slot < a.S && ract[slot]) ++slot;  // caller checked n_active < S
    int32_t* row = run + slot * RF;
    row[REND] = wrap_add(a.t, job[FDUR]);
    row[RNODE] = node;
    row[RCORES] = job[FCORES];
    row[RMEM] = job[FMEM];
    row[RGPU] = job[FGPU];
    row[RID] = job[FID];
    row[ROWNER] = job[FOWNER];
    row[RDUR] = job[FDUR];
    row[RENQ] = job[FENQ];
    row[RRETRIES] = job[FRETRIES];
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

  // One attempt (the reference's _attempt / _attempt_deferred): place
  // `job` on its first-fit node if there is one and the running set has a
  // free slot; returns whether it did. A job that fits a node but finds
  // the running set full counts into `*run_full`.
  __host__ __device__ bool attempt(const int32_t* job, int32_t src,
                                   int* run_full) {
    int node = first_fit(free, nact, a.N, a.R, job);
    if (node < 0) return false;
    if (n_active >= a.S) {
      ++*run_full;
      return false;
    }
    place(job, node, src);
    return true;
  }
};

}  // namespace prefix
