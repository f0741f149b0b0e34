// One tick's per-cluster prefix, release -> ingest -> schedule:FIFO, for
// Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the spans FIFO engages: [release,
//   ingest (packed rows -> ReadyQueue or the windowed stream), schedule:
//   FIFO], either state layout, with or without the metrics tap; terminal
//   on the headline, and in the emit form (kEmit) with borrowing or run_io: the
//   release step's return pack (core/engine.py _pack_returns and
//   drops.msgs) and the borrow request, want and bjob_vec
//   (policies/kernels.py _fifo_local). The TPU kernel replays the traced
//   jaxpr of Engine._span_prefix on a block of clusters; this kernel is
//   written from the semantics instead (core/engine.py _release_local and
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
// Design: a warp per cluster (prefix_warp.cuh), in place, in the
//   reference's order: the lanes release the running slots (due ones by
//   ballot, their resources back to the node words in shared memory by
//   shared atomics) and append the tick's arrivals a row a lane; then the
//   ready queue drains serially until the first job that fits no node or
//   finds the running set full (the reference's "serial" drain, which
//   tests/test_kernel_equiv.py pins equal to the wave form) and the
//   wait-head and lent-head attempts follow — decisions every lane takes
//   alike from the same loads, first fit a lane a node by ballot, the
//   free running slot by ballot from the cursor, the running row a field
//   a lane. The pops move the live rows down 32 at a time (read, sync,
//   write); the slots past a count hold INVALID rows already, so the
//   1,024-deep queues of the borrowing shapes cost what they hold. Blocks
//   of up to 16 warps, fewer while that would leave SMs without a block:
//   at the headline 4,096 warps in 256 blocks, all resident at once (64
//   registers a thread at most); config 1's one cluster is one warp. The
//   node words and flags take N (4R + 1) B of shared memory a warp.
//
// The emit form adds per cluster the M return rows and flags and the
//   borrow request (M*RF*4 + M + NF*4 + 1 B written), the M rows it
//   copies, and drops.msgs (chip_smoke.py tick_cost_borrow): the pack's
//   positions are ballot prefixes, the returns first, then the other
//   slots (prefix_warp.cuh WarpCluster::release). It is a separate
//   instantiation of the same kernel, so the terminal form's code and
//   registers stay as they were.
//
// The expire form (kExpire; the trader's expire_virtual_nodes) runs the
//   vnode expiry step (core/engine.py _expire_vnodes_local) between
//   release and ingest, a lane a node slot: per cluster it reads each
//   slot's active flag and expiry (N + 4N B) and writes the slots that
//   expire (their flag, 3 capacity and 3 free words, and the expiry).
//   Another instantiation, so the forms without it keep their code and
//   registers.
//
// The faults form (kFaults; the fault plane, cfg.faults.enabled) opens the
//   span with the fault phase (faults/apply.py fault_phase_local,
//   prefix_common.cuh Cluster::faults): per cluster one pass over the N
//   node slots, reading each slot's health flag and its next_fail or
//   down_until (about 5 B a node on a quiet tick: 0.1 MB a tick at
//   bench_faults's shape tiled to 4,096 clusters); only where a node
//   fails, one pass over the S running slots, killing those on a failed
//   node and requeueing them into the ready queue (own jobs) or the lent
//   queue (a peer's); draws only where a node fails or repairs. It runs
//   on lane 0 of the cluster's warp, over the shared node words (rare
//   work: a quiet tick reads the node slots and returns). Another
//   instantiation, so the forms without it keep their code and
//   registers.
//
// The tap form (kTap; a run with the metrics plane on a terminal prefix)
//   closes the span with prefix_warp.cuh's tap_epilogue (obs/device.py
//   tap_tick): per cluster lane 0 reads the buffer's eleven per-cluster
//   leaves, the cursor's nine and the counters it differences (under
//   128 B), writes those that change and the tick's placements and depth
//   (8 B); each block sums its warps through shared memory and adds its
//   sums and bucket counts with integer atomics, and the last block to
//   finish writes the ring slot. A template flag, not a runtime branch:
//   the forms without it keep their code and registers. It is
//   instantiated without the expire flag only, since the trader is never
//   terminal: 12 forms in all.
//
// The state layout (core/compact.py) is a runtime property, as the
//   windowed ingest is: the queues and the running set arrive as column
//   views (prefix_common.cuh Col/Table/Rows) over the wide layout's
//   packed int32 rows or the compact layout's narrow leaves (int8/int16/
//   int32, one a field), so no template flag doubles the forms. A load
//   widens to int32 and the steps compute as on the wide layout; a store
//   into a narrow leaf is the checked narrow store (clamped to the dtype
//   minimum, counted into the table's ovf) where the reference checks, a
//   plain one where it moves stored values. On the packed rows every
//   access keeps the rows' own pointer arithmetic (a uniform branch). The
//   compact layout moves fewer bytes — the bound falls with them — and
//   the lanes read a narrow leaf of 32 neighbouring rows in one load. The
//   node words are widened into the warp's shared memory at entry, on
//   either layout, and stored back at exit — checked on narrow columns,
//   the cross-cluster count applied by the last block
//   (node_exit_epilogue). Where a clamp made a queued demand negative,
//   lane 0 replays the reference's wave drain (prefix_common.cuh
//   fifo_drain_waves), whose arrays cost the forms about 1.2 KB of stack
//   frame, untouched otherwise; chip_smoke.py prints nvcc's registers,
//   shared memory, stack and spills for every form.

// The windowed ingest (an Arrivals stream: BASELINE config 1, the oracle
//   parity runs) is a runtime branch of the ingest step
//   (prefix_warp.cuh WarpCluster::ingest, Common::window >= 0), not a
//   template axis, which would double the forms for a path that runs one
//   cluster: per cluster the lanes read the enq_t of 32 rows at a time
//   up to the first not due, and copy the taken rows.
//
// Shared with the FFD kernel (prefix_warp.cuh): release, the arrival
// append, first fit, placement and the trace, the row moves, and the
// integer discipline (int32 as in the reference, wrapping sums done in
// uint32).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include "prefix_warp.cuh"

namespace {

using namespace prefix;
using warp::WarpCluster;

struct Args {
  Common k;
  QueueTable ready;      // [C, Q] rows
  int32_t* ready_count;  // [C]
  QueueTable wait;
  int32_t* wait_count;
  QueueTable lent;
  int32_t* lent_count;
  int wave;              // cfg.fifo_drain == "wave"
  Emit e;
  Expire x;
  Faults f;
  Tap p;
};

// The span of cluster c, carried by the calling warp; returns the node exit
// narrow's count (in every lane).
template <bool kEmit, bool kExpire, bool kFaults>
__device__ __forceinline__ int fifo_prefix(const Args& a, int c,
                                           const warp::WarpMem& m) {
  const Common& k = a.k;
  const int Q = k.Q;
  // the queue counts, read before the entry's other loads complete
  int rcount = a.ready_count[c], wcount = a.wait_count[c];
  int lcount = a.lent_count[c];
  WarpCluster cl(k, c, m);
  const QueueRows ready = queue_rows(a.ready, c, Q);
  const QueueRows wait = queue_rows(a.wait, c, Q);
  const QueueRows lent = queue_rows(a.lent, c, Q);

  // 0. the faults form's fault phase: kills on failed nodes, requeues into
  //    the ready queue (own jobs) and the lent queue (foreign ones),
  //    repairs.
  int drop_queue = 0;
  if (kFaults) {
    int n_ingest = 0;
    cl.faults(a.f, a.ready, a.ready_count + c, &drop_queue, &n_ingest);
    rcount = a.ready_count[c];
    lcount = a.lent_count[c];
  }

  // 1. release every due running slot (the emit form packs the returns),
  //    then, in the expire form, expire the ended virtual nodes.
  cl.release<kEmit>(&a.e);
  if (kExpire) cl.expire(a.x);

  // 2. ingest: append the tick's arrivals to the ready queue.
  int arrived = 0;
  rcount = cl.ingest(a.ready, rcount, &drop_queue, &arrived);

  // 3. FIFO (Fifo(), scheduler.go:216-296).
  int run_full = 0;
  const bool wait_active = wcount > 0;

  // 3a. ready drain, only when the wait queue is empty: place from the
  //     head until the first failure, which moves to the wait queue.
  int n_taken = 0;
  bool any_fail = false;
  int32_t job[NF];  // the last job the drain attempted: the failing one
  const int lim = wait_active ? 0 : imin(rcount, k.QC);
  if (a.wave && clamped(a.ready, c) && k.N <= kMaxNarrowNodes &&
      warp::any_negative_demand(ready, lim)) {
    cl.drain_waves(ready, lim, &run_full, &n_taken, &any_fail, job);
  } else {
    for (int i = 0; i < lim; ++i) {
      ready.load(i, job);
      ++n_taken;  // the drain pops the failing job too
      if (!cl.attempt(job, SRC_READY, &run_full)) {
        any_fail = true;
        break;
      }
    }
  }
  rcount = warp::pop_front_n(ready, rcount, n_taken);
  // push_back(wait, fail_job, any_fail), checked; the drop reads the old
  // count.
  if (any_fail) {
    if (wcount < Q) {
      const int bad = warp::store_row(wait, wcount, job, true);
      warp::lane0([&] { wait.count(c, bad); });
      ++wcount;
    } else {
      ++drop_queue;
    }
  }

  // 3b. wait-head attempt (scheduler.go:219-252). The emit form writes
  //     the head it attempts (row 0: INVALID when the queue is empty) and,
  //     with borrowing, whether the attempt failed: the BorrowResources
  //     request (scheduler.go:234).
  const bool process_w = wcount > 0;
  if (process_w || kEmit) wait.load(0, job);
  if (kEmit) {
    warp::lanes([&](int l) {
      if (l < NF) a.e.bjob[(size_t)c * NF + l] = warp::field_at(job, l);
    });
  }
  const bool wsuccess = process_w && cl.attempt(job, SRC_WAIT, &run_full);
  if (wsuccess) wcount = warp::pop_front_n(wait, wcount, 1);

  // 3c. lent best-effort (scheduler.go:277-291): only in a tick where the
  //     wait queue was empty and the ready queue drained clean. A lent
  //     row's owner (the borrower's index) goes into its running row, so
  //     that its completion returns it.
  if (!wait_active && !any_fail && rcount == 0 && lcount > 0) {
    lent.load(0, job);
    if (cl.attempt(job, SRC_LENT, &run_full)) {
      lcount = warp::pop_front_n(lent, lcount, 1);
    }
  }

  const int placed = cl.placed;
  warp::lane0([&] {
    if (kEmit) a.e.want[c] = a.e.borrowing && process_w && !wsuccess;
    a.ready_count[c] = rcount;
    a.wait_count[c] = wcount;
    a.lent_count[c] = lcount;
    // counters move only by what the tick added (no read when nothing)
    if (drop_queue != 0) k.drop_queue[c] += drop_queue;
    if (run_full != 0) k.drop_run_full[c] += run_full;
    if (placed != 0) k.placed_total[c] += placed;
  });
  return cl.store_nodes();
}

// A warp per cluster runs its span; the tap form then closes it with the
// metrics tap, every thread of the block taking part. The parameters are
// __grid_constant__: the steps and the epilogues read them where they are
// instead of from a copy of them in each thread's local memory.
template <bool kEmit, bool kExpire, bool kFaults, bool kTap>
__global__ void __launch_bounds__(warp::kMaxWarps * warp::kLanes,
                                  warp::kMinBlocks)
fused_prefix_fifo_kernel(const __grid_constant__ Args a) {
  const Common& k = a.k;
  const int bl = warp::batch_lane();
  if (!warp::lane_runs(k, bl)) return;  // the whole block: another member's
  const int c = bl * k.C + warp::cluster_index();  // over the batch
  const bool active = warp::cluster_index() < k.C;  // uniform in the warp
  int bad = 0;
  if (active) {
    bad = fifo_prefix<kEmit, kExpire, kFaults>(
        a, c, warp::warp_mem(k.N, k.R, k.Q, false));
  }
  if (kTap) warp::tap_epilogue(a.p, k, bl, c, active);
  if (k.node_size != 4) warp::node_exit_epilogue(k, a.p, kTap, bl, bad);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then the three
// FIFO queues' counts, the emit outputs, the expire form's node columns,
// the emit flags (the terminal form when `emit` is 0, its pointers then
// null) and the expire flag (its pointers null when 0).
// The faults form's leaves, node capacities and lent count follow the
// expire form's columns, and its flag and settings (interval slots, trace
// mode, mttf, mttr, retry budget) the expire flag; its pointers are null
// and unread when `faults` is 0. `wave` is the drain's form (the waves
// replayed where a row demands a negative amount, prefix_common.cuh
// fifo_drain_waves). `layout` (host memory) holds the node columns' value
// size, the node exit scratch, and the column views of the running set,
// the lent, ready and wait queues (prefix_common.cuh make_table's order).
// The lane form: `lane_on` ([L] bytes, null to run every lane) follows
// drops.ingest and L follows C; every [C, ...] array is then [L, C, ...]
// (the tenants or envs of a batch, a row of blocks each), and the
// per-lane parameters are [L] device arrays.
extern "C" int fused_prefix_fifo_launch(
    void* node_free, void* node_active, void* run_active, void* arr_ptr,
    void* drop_queue, void* drop_run_full, void* placed_total, void* tr_t,
    void* tr_job, void* tr_node, void* tr_src, void* tr_n, void* rows,
    void* counts, void* drop_ingest, void* lane_on, void* ready_count, void* wait_count,
    void* lent_count, void* ret_rows, void* ret_valid, void* drop_msgs,
    void* want, void* bjob, void* node_cap, void* node_expire, void* health,
    void* was_active, void* next_fail, void* down_until, void* down_since,
    void* n_fails, void* kills, void* requeues, void* down_ms, void* fail_t,
    void* repair_t, void* key, void* drop_failed, void* fault_cap,
    void* fault_lent_count, int C, int L, int N, int R, int Q, int S, int K,
    int E,
    int QC, int record_trace, int t, int window, int wave, int M, int emit,
    int borrowing, int expire, int faults, int fault_events, int fault_trace,
    int mttf, int mttr, int max_retries, int tap, int slot,
    const int64_t* layout, const void* const* tap_ptrs, void* stream) {
  Args a{make_common(node_free, node_active, run_active, arr_ptr, drop_queue,
                     drop_run_full, placed_total, tr_t, tr_job, tr_node,
                     tr_src, tr_n, rows, counts, drop_ingest, lane_on, C, L,
                     N, R, Q, S, K, E, QC, record_trace, t, window,
                     layout),
         make_table<NF>(layout, kOwnTable),
         static_cast<int32_t*>(ready_count),
         make_table<NF>(layout, kOwnTable + 1),
         static_cast<int32_t*>(wait_count),
         make_table<NF>(layout, kLentTable),
         static_cast<int32_t*>(lent_count), wave,
         make_emit(ret_rows, ret_valid, drop_msgs, want, bjob, M, borrowing),
         make_expire(node_cap, node_expire),
         make_faults(health, was_active, next_fail, down_until, down_since,
                     n_fails, kills, requeues, down_ms, fail_t, repair_t, key,
                     drop_failed, fault_cap, layout, fault_lent_count,
                     fault_events, fault_trace, mttf, mttr, max_retries),
         make_tap(tap ? tap_ptrs : nullptr, slot)};
  if (C > 0) {
    const warp::Geometry g = warp::geometry(C, L, N, R, Q, false);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool launched = false;
    const bool ok = dispatch_forms(emit, expire, faults, tap,
                                   [&](auto e, auto x, auto f, auto p) {
      launched = warp::launch_warps(
          fused_prefix_fifo_kernel<decltype(e)::value, decltype(x)::value,
                                   decltype(f)::value, decltype(p)::value>,
          g.blocks(C), L, g.warps, g.smem(), s, a);
    });
    if (!ok || !launched) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape at (C, L, N, R, Q): warps a block and shared-memory
// bytes a warp, as fused_prefix_fifo_launch takes it.
extern "C" void fused_prefix_fifo_geometry(
    int C, int L, int N, int R, int Q, int* warps, int64_t* warp_bytes) {
  const warp::Geometry g = warp::geometry(C, L, N, R, Q, false);
  *warps = g.warps;
  *warp_bytes = static_cast<int64_t>(g.warp_bytes);
}
