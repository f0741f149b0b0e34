// One tick's per-cluster prefix, release -> ingest -> schedule:FIFO, for
// Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the span the headline engages:
//   [release, ingest (packed rows -> ReadyQueue), schedule: FIFO], terminal,
//   wide layout, no metrics tap. The TPU kernel replays the traced jaxpr of
//   Engine._span_prefix on a block of clusters; this kernel is written from
//   the semantics instead (core/engine.py _release_local and
//   _ingest_packed_local, policies/kernels.py _fifo_local of the port), and
//   is held bitwise against the port's plain PyTorch version
//   (kernels/fused_tick.py fused_prefix_reference).
//
// Bound on the H100: device-memory bytes, counting only what the tick's
//   data needs moved. Per cluster it must read the arrival count and the
//   counters it updates, the node vectors (N*R*4 + N B), the running set's
//   active flags (S B), the end_t of each active slot, the node and
//   resources of each slot it releases, the live queue rows and the valid
//   arrival rows (NF*4 B each), and it must write every element the tick
//   changes; queue slots past a count and rows that stay as they were need
//   not move. At the headline (C=4096, N=5, R=2, Q=8, S=32, NF=RF=10) the
//   queues are almost always empty and a cluster sees about a sixth of a
//   job per tick, so this is under 200 B per cluster and under 1 MB per
//   tick: a fraction of a microsecond at 3.35 TB/s, below the latency of
//   a launch itself. chip_smoke.py counts it from every headline tick's
//   data, and PERF.md records it. The whole state is about 16 MB, so
//   between ticks it can stay in the 50 MB L2.
//
// Design: one thread per cluster walks its cluster's rows in place, once,
//   in the reference's order: release every due running slot, append the
//   tick's arrivals, drain the ready queue serially until the first job
//   that fits no node or finds the running set full (the reference's
//   "serial" drain, which tests/test_kernel_equiv.py pins equal to the
//   wave form), then the wait-head and lent-head attempts. Rows are
//   touched once each and nothing is staged or allocated: the kernel
//   updates the state tensors in place. Blocks are one warp, so the 4096
//   clusters spread over 128 SMs. This is the simple form: neighbouring
//   threads read rows 1.3 KB apart, so loads do not coalesce and the tick
//   is latency-bound well above the byte bound (PERF.md has the times).
//   A warp per cluster, and a loop over a whole chunk of ticks inside one
//   launch, are the next steps.
//
// Integer discipline: all arithmetic is int32 as in the reference. The one
// sum that could overflow, end_t = t + dur, is done in uint32 and cast
// back, which is the reference's two's-complement wrap without signed
// overflow in C++. NEVER (2^31-1) is only compared. torch bool tensors
// arrive as uint8_t.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;  // one warp per block, one cluster per thread

constexpr int NF = 10;  // queue row fields (ops/fields.py QUEUE_FIELDS)
constexpr int FID = 0, FCORES = 1, FMEM = 2, FGPU = 3, FDUR = 4, FENQ = 5,
              FOWNER = 6, FRETRIES = 9;
constexpr int RF = 10;  // running-set row fields (ops/fields.py RUN_FIELDS)
constexpr int REND = 0, RNODE = 1, RCORES = 2, RMEM = 3, RGPU = 4, RID = 5,
              ROWNER = 6, RDUR = 7, RENQ = 8, RRETRIES = 9;
constexpr int32_t NEVER = 2147483647;
constexpr int32_t SRC_READY = 2, SRC_WAIT = 3, SRC_LENT = 4;  // core/state.py

struct Args {
  int32_t* node_free;          // [C, N, R]
  const uint8_t* node_active;  // [C, N]
  int32_t* ready;              // [C, Q, NF]
  int32_t* ready_count;        // [C]
  int32_t* wait;
  int32_t* wait_count;
  int32_t* lent;
  int32_t* lent_count;
  int32_t* run;          // [C, S, RF]
  uint8_t* run_active;   // [C, S]
  int32_t* arr_ptr;      // [C]
  int32_t* drop_queue;   // [C]
  int32_t* drop_run_full;
  int32_t* placed_total;
  int32_t* tr_t;  // [C, E], touched only when record_trace
  int32_t* tr_job;
  int32_t* tr_node;
  int32_t* tr_src;
  int32_t* tr_n;          // [C]
  const int32_t* rows;    // [C, K, NF] this tick's arrival rows
  const int32_t* counts;  // [C]
  int C, N, R, Q, S, K, E, QC, record_trace, t;
};

__device__ __forceinline__ int32_t queue_invalid(int f) {
  return (f == FID || f == FOWNER) ? -1 : 0;
}

__device__ __forceinline__ int32_t run_invalid(int f) {
  return f == REND ? NEVER : ((f == RID || f == ROWNER) ? -1 : 0);
}

__device__ __forceinline__ void set_queue_invalid(int32_t* row) {
#pragma unroll
  for (int f = 0; f < NF; ++f) row[f] = queue_invalid(f);
}

// Lowest active node whose free resources cover the job (ScheduleJob's >=,
// scheduler.go:131), or -1. With the gpu axis narrowed away (R == 2) a job
// that demands gpu fits nowhere.
__device__ int first_fit(const int32_t* free, const uint8_t* active, int N,
                         int R, const int32_t* job) {
  for (int n = 0; n < N; ++n) {
    if (!active[n]) continue;
    const int32_t* f = free + n * R;
    bool ok = f[0] >= job[FCORES] && f[1] >= job[FMEM];
    ok = ok && (R > 2 ? f[2] >= job[FGPU] : job[FGPU] <= 0);
    if (ok) return n;
  }
  return -1;
}

// pop_front: shift every row left by one, INVALID into the last row.
__device__ void pop_front(int32_t* q, int32_t* count, int Q) {
  for (int i = 0; i + 1 < Q; ++i) {
#pragma unroll
    for (int f = 0; f < NF; ++f) q[i * NF + f] = q[(i + 1) * NF + f];
  }
  set_queue_invalid(q + (Q - 1) * NF);
  *count = *count > 0 ? *count - 1 : 0;
}

struct Cluster {
  const Args& a;
  int c;
  int32_t* free;
  const uint8_t* nact;
  int32_t* run;
  uint8_t* ract;
  int slot;  // insertion cursor: every slot below it is active
  int n_active;
  int placed;

  // Start `job` on `node`: occupy its resources, write its running row into
  // the lowest inactive slot, count it, and trace it.
  __device__ void place(const int32_t* job, int node, int32_t src) {
    for (int r = 0; r < a.R; ++r) free[node * a.R + r] -= job[FCORES + r];
    while (slot < a.S && ract[slot]) ++slot;  // caller checked n_active < S
    int32_t* row = run + slot * RF;
    row[REND] = (int32_t)((uint32_t)a.t + (uint32_t)job[FDUR]);
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

  // One head attempt (the reference's _attempt): place the head of `q` if
  // it fits; returns whether it did. A job that fits a node but finds the
  // running set full counts into run_full.
  __device__ bool attempt(const int32_t* job, int32_t src, int* run_full) {
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

__global__ void __launch_bounds__(kThreads)
fused_prefix_fifo_kernel(Args a) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= a.C) return;
  const int Q = a.Q, S = a.S, t = a.t;
  Cluster cl{a, c,
             a.node_free + (size_t)c * a.N * a.R,
             a.node_active + (size_t)c * a.N,
             a.run + (size_t)c * S * RF,
             a.run_active + (size_t)c * S,
             0, 0, 0};
  int32_t* ready = a.ready + (size_t)c * Q * NF;
  int32_t* wait = a.wait + (size_t)c * Q * NF;
  int32_t* lent = a.lent + (size_t)c * Q * NF;

  // 1. release: every active slot with end_t <= t returns its resources
  //    to its node and becomes an invalid, inactive row.
  for (int s = 0; s < S; ++s) {
    if (!cl.ract[s]) continue;
    int32_t* row = cl.run + s * RF;
    if (row[REND] <= t) {
      int node = min(max(row[RNODE], 0), a.N - 1);
      for (int r = 0; r < a.R; ++r) cl.free[node * a.R + r] += row[RCORES + r];
#pragma unroll
      for (int f = 0; f < RF; ++f) row[f] = run_invalid(f);
      cl.ract[s] = 0;
    } else {
      ++cl.n_active;
    }
  }

  // 2. ingest: append the tick's first counts[c] rows to the ready queue;
  //    rows past its capacity count into drops.queue, and the arrival
  //    cursor advances by the full count either way.
  const int cnt = a.counts[c];
  const int n_take = min(max(cnt, 0), a.K);
  int rcount = a.ready_count[c];
  const int room = Q - rcount;
  int drop_queue = max(n_take - room, 0);
  const int added = min(n_take, room);
  const int32_t* arows = a.rows + (size_t)c * a.K * NF;
  for (int k = 0; k < added; ++k) {
#pragma unroll
    for (int f = 0; f < NF; ++f) ready[(rcount + k) * NF + f] = arows[k * NF + f];
  }
  rcount += added;
  a.arr_ptr[c] += cnt;

  // 3. FIFO (Fifo(), scheduler.go:216-296).
  int run_full = 0;
  int wcount = a.wait_count[c];
  const bool wait_active = wcount > 0;

  // 3a. ready drain, only when the wait queue is empty: place from the
  //     head until the first failure, which moves to the wait queue.
  int n_taken = 0;
  bool any_fail = false;
  int32_t fail_job[NF];
  if (!wait_active) {
    const int lim = min(rcount, a.QC);
    for (int i = 0; i < lim; ++i) {
      const int32_t* job = ready + i * NF;
      ++n_taken;  // the drain pops the failing job too
      if (!cl.attempt(job, SRC_READY, &run_full)) {
        any_fail = true;
#pragma unroll
        for (int f = 0; f < NF; ++f) fail_job[f] = job[f];
        break;
      }
    }
  }
  // pop_front_n(ready, n_taken): rows [n_taken, rcount) move to the front,
  // every row from the new count on becomes INVALID.
  {
    const int n = min(n_taken, rcount);
    const int newcount = rcount - n;
    for (int i = 0; i < newcount; ++i) {
#pragma unroll
      for (int f = 0; f < NF; ++f) ready[i * NF + f] = ready[(i + n) * NF + f];
    }
    for (int i = newcount; i < Q; ++i) set_queue_invalid(ready + i * NF);
    rcount = newcount;
  }
  // push_back(wait, fail_job, any_fail); the drop reads the old count.
  if (any_fail) {
    if (wcount < Q) {
#pragma unroll
      for (int f = 0; f < NF; ++f) wait[wcount * NF + f] = fail_job[f];
      ++wcount;
    } else {
      ++drop_queue;
    }
  }

  // 3b. wait-head attempt (scheduler.go:219-252).
  if (wcount > 0 && cl.attempt(wait, SRC_WAIT, &run_full)) {
    pop_front(wait, &wcount, Q);
  }

  // 3c. lent best-effort (scheduler.go:277-291): only in a tick where the
  //     wait queue was empty and the ready queue drained clean.
  int lcount = a.lent_count[c];
  if (!wait_active && !any_fail && rcount == 0 && lcount > 0 &&
      cl.attempt(lent, SRC_LENT, &run_full)) {
    pop_front(lent, &lcount, Q);
  }

  a.ready_count[c] = rcount;
  a.wait_count[c] = wcount;
  a.lent_count[c] = lcount;
  a.drop_queue[c] += drop_queue;
  a.drop_run_full[c] += run_full;
  a.placed_total[c] += cl.placed;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. Every pointer is a
// tensor the wrapper checked for device, dtype, shape and contiguity.
extern "C" int fused_prefix_fifo_launch(
    void* node_free, void* node_active, void* ready, void* ready_count,
    void* wait, void* wait_count, void* lent, void* lent_count, void* run,
    void* run_active, void* arr_ptr, void* drop_queue, void* drop_run_full,
    void* placed_total, void* tr_t, void* tr_job, void* tr_node, void* tr_src,
    void* tr_n, void* rows, void* counts, int C, int N, int R, int Q, int S,
    int K, int E, int QC, int record_trace, int t, void* stream) {
  Args a{static_cast<int32_t*>(node_free),
         static_cast<const uint8_t*>(node_active),
         static_cast<int32_t*>(ready), static_cast<int32_t*>(ready_count),
         static_cast<int32_t*>(wait), static_cast<int32_t*>(wait_count),
         static_cast<int32_t*>(lent), static_cast<int32_t*>(lent_count),
         static_cast<int32_t*>(run), static_cast<uint8_t*>(run_active),
         static_cast<int32_t*>(arr_ptr), static_cast<int32_t*>(drop_queue),
         static_cast<int32_t*>(drop_run_full),
         static_cast<int32_t*>(placed_total), static_cast<int32_t*>(tr_t),
         static_cast<int32_t*>(tr_job), static_cast<int32_t*>(tr_node),
         static_cast<int32_t*>(tr_src), static_cast<int32_t*>(tr_n),
         static_cast<const int32_t*>(rows), static_cast<const int32_t*>(counts),
         C, N, R, Q, S, K, E, QC, record_trace, t};
  if (C > 0) {
    const int blocks = (C + kThreads - 1) / kThreads;
    fused_prefix_fifo_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
