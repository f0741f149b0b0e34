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
// Shared with the FFD kernel (prefix_common.cuh): release, the arrival
// append, first-fit, placement and the trace, and the integer discipline
// (int32 as in the reference, wrapping sums done in uint32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include "prefix_common.cuh"

namespace {

using namespace prefix;

constexpr int kThreads = 32;  // one warp per block, one cluster per thread

struct Args {
  Common k;
  int32_t* ready;        // [C, Q, NF]
  int32_t* ready_count;  // [C]
  int32_t* wait;
  int32_t* wait_count;
  int32_t* lent;
  int32_t* lent_count;
};

// pop_front: shift every row left by one, INVALID into the last row.
__device__ void pop_front(int32_t* q, int32_t* count, int Q) {
  for (int i = 0; i + 1 < Q; ++i) copy_row(q + i * NF, q + (i + 1) * NF);
  set_queue_invalid(q + (Q - 1) * NF);
  *count = *count > 0 ? *count - 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
fused_prefix_fifo_kernel(Args a) {
  const Common& k = a.k;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k.C) return;
  const int Q = k.Q;
  Cluster cl(k, c);
  int32_t* ready = a.ready + (size_t)c * Q * NF;
  int32_t* wait = a.wait + (size_t)c * Q * NF;
  int32_t* lent = a.lent + (size_t)c * Q * NF;

  // 1. release every due running slot.
  cl.release();

  // 2. ingest: append the tick's arrivals to the ready queue.
  int drop_queue = 0;
  int rcount = cl.ingest(ready, a.ready_count[c], &drop_queue);

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
    const int lim = imin(rcount, k.QC);
    for (int i = 0; i < lim; ++i) {
      const int32_t* job = ready + i * NF;
      ++n_taken;  // the drain pops the failing job too
      if (!cl.attempt(job, SRC_READY, &run_full)) {
        any_fail = true;
        copy_row(fail_job, job);
        break;
      }
    }
  }
  // pop_front_n(ready, n_taken): rows [n_taken, rcount) move to the front,
  // every row from the new count on becomes INVALID.
  {
    const int n = imin(n_taken, rcount);
    const int newcount = rcount - n;
    for (int i = 0; i < newcount; ++i) copy_row(ready + i * NF,
                                                ready + (i + n) * NF);
    for (int i = newcount; i < Q; ++i) set_queue_invalid(ready + i * NF);
    rcount = newcount;
  }
  // push_back(wait, fail_job, any_fail); the drop reads the old count.
  if (any_fail) {
    if (wcount < Q) {
      copy_row(wait + wcount * NF, fail_job);
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
  k.drop_queue[c] += drop_queue;
  k.drop_run_full[c] += run_full;
  k.placed_total[c] += cl.placed;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then the three
// FIFO queues.
extern "C" int fused_prefix_fifo_launch(
    void* node_free, void* node_active, void* run, void* run_active,
    void* arr_ptr, void* drop_queue, void* drop_run_full, void* placed_total,
    void* tr_t, void* tr_job, void* tr_node, void* tr_src, void* tr_n,
    void* rows, void* counts, void* ready, void* ready_count, void* wait,
    void* wait_count, void* lent, void* lent_count, int C, int N, int R,
    int Q, int S, int K, int E, int QC, int record_trace, int t,
    void* stream) {
  Args a{make_common(node_free, node_active, run, run_active, arr_ptr,
                     drop_queue, drop_run_full, placed_total, tr_t, tr_job,
                     tr_node, tr_src, tr_n, rows, counts, C, N, R, Q, S, K,
                     E, QC, record_trace, t),
         static_cast<int32_t*>(ready), static_cast<int32_t*>(ready_count),
         static_cast<int32_t*>(wait), static_cast<int32_t*>(wait_count),
         static_cast<int32_t*>(lent), static_cast<int32_t*>(lent_count)};
  if (C > 0) {
    const int blocks = (C + kThreads - 1) / kThreads;
    fused_prefix_fifo_kernel<<<blocks, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
