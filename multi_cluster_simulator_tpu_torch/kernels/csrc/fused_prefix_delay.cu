// One tick's per-cluster prefix, release -> ingest -> schedule:DELAY, for
// Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the span the reference's live
//   scheduler engages: [release, ingest (packed rows -> Level0), schedule:
//   DELAY in its serial form (with the parity-mode remove-then-skip quirk)
//   or its wave form], terminal, either state layout, with or without the
//   metrics tap. The TPU kernel replays the traced jaxpr of Engine._span_prefix on
//   a block of clusters; this kernel is written from the semantics instead
//   (core/engine.py _release_local and _ingest_packed_local,
//   policies/kernels.py _delay_local / _delay_wave_local / _delay_l0_head
//   of the port), and is held bitwise against the port's plain PyTorch
//   version (kernels/fused_tick.py fused_prefix_reference).
//
// Per tick and cluster, in the reference's order (scheduler.go:298-369):
//   1. release every due running slot; append the tick's arrivals to
//      Level0 (wait_jobs and jobs_in_queue grow by the arrival count);
//   2. the Level1 sweep: the first min(|L1|, QC) slots in queue order,
//      each recording its wait and attempting first fit against the
//      running set as it stood before the sweep plus the sweep's own
//      placements; with `skip` (parity mode) a success passes over the
//      next slot, which keeps its rec_wait and gets no attempt;
//   3. the placed slots are compacted out of Level1, stably; the
//      placements are in the running set already, in sweep order, which
//      is where the reference's deferred start_many puts them;
//   4. the Level0 head: record its wait, one attempt; on failure, promote
//      it to Level1 once t - enq_t >= max_wait_ms (a parameter: delay,
//      delay-eager and delay-patient differ only there); pop it on success
//      or promotion. A promotion into a full Level1 counts into
//      drops.queue and the job is lost, as in the reference.
//
// wait_total (f32): the serial form adds each processed Level1 slot's
//   delta in sweep order, then the head's; the wave form (`wave`) sums
//   the processed Level1 deltas exactly in int64, adds the sum once
//   (rounded to f32), then the head's delta. That equals the reference's
//   f32 delta.sum() while its partial sums stay below 2^24 ms. Placement
//   is serial in both forms (the reference pins its wave sweep equal to
//   the serial one, tests/test_kernel_equiv.py), and the plain version
//   keeps the wave form, so every on-card comparison of the wave config
//   also checks wave == serial.
//
// Bound on the H100: device-memory bytes, counting only what the tick's
//   data needs moved (chip_smoke.py tick_cost): per cluster the counters,
//   the node vectors, the running set's active flags and the end_t of its
//   active slots, the processed Level1 rows and the Level0 head, the
//   queue elements the compactions and the pop rewrite, the valid arrival
//   rows, and every element the tick changes. The kernel is far above it
//   (PERF.md): the Level1 sweep and the head are serial, each position
//   waiting on its row's load and on the running-slot ballot.
//
// The expire form (kExpire; the trader's expire_virtual_nodes, the
//   market's expire-on run) runs the vnode expiry step (core/engine.py
//   _expire_vnodes_local) between release and ingest, a lane a node slot:
//   per cluster it reads each node slot's active flag and expiry (N + 4N
//   B) and writes the slots that expire (their flag, 3 capacity and 3
//   free words, and the expiry). Another instantiation, so the forms
//   without it keep their code, registers and stacks.
//
// The faults form (kFaults; the fault plane) opens the span with
//   prefix_common.cuh's fault step on lane 0, requeueing killed jobs into
//   Level0 (and a peer's into the lent queue) and counting them in
//   wait_jobs and jobs_in_queue; another instantiation, as the emit and
//   expire forms are.
//
// The tap form (kTap; a run with the metrics plane on a terminal prefix)
//   closes the span with prefix_warp.cuh's tap_epilogue (obs/device.py
//   tap_tick), as the FIFO and FFD kernels' tap forms do: lane 0 of each
//   warp does the per-cluster half, the block sums its warps, and the
//   last block to finish writes the ring slot. It is instantiated without
//   the expire flag only, since the trader is never terminal: 12 forms in
//   all.
//
// The state layout and the windowed ingest (an Arrivals stream: BASELINE
//   config 1, the oracle parity runs) are runtime properties, as in
//   fused_prefix_fifo.cu.
//
// Design: a warp per cluster, in place, as the FIFO and FFD kernels
//   (prefix_warp.cuh): the lanes release, ingest, compact Level1 (each
//   kept row's destination the popc prefix of the placed mask's
//   complement, 32 rows at a time) and pop the Level0 head (the live rows
//   moved 32 at a time: read, sync, write). The Level1 sweep is serial and
//   uniform in queue order — no order staged, so a warp's shared memory
//   is its node words, its scratch and the placed mask, about 384 B at
//   config 4's shape — first fit and the free running slot by ballot, the
//   running row a field a lane; the parity skip is a uniform flag of the
//   sweep. The head is read by every lane as a swept row is; its rec_wait
//   store and the promotion's push_back are checked. Where a clamp made a
//   swept demand negative, lane 0 replays the reference's waves in queue
//   order (prefix_common.cuh sweep, wave_place). Blocks of up to 16 warps,
//   fewer while that would leave SMs without a block: config 4's 4,096
//   clusters are 256 blocks of 16, config 1's one a block of one warp.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include "prefix_warp.cuh"

namespace {

using namespace prefix;
using warp::WarpCluster;

struct Args {
  Level0Args q;
  QueueTable l1;      // [C, Q] rows
  int32_t* l1_count;  // [C]
  int skip;           // parity mode's remove-then-skip quirk
  const int32_t* max_wait;  // [L] params.max_wait_ms, a lane each
  Emit e;
  Expire x;
  Faults f;
  Tap p;
};

// The span of cluster c, carried by the calling warp; returns the node exit
// narrow's count (in every lane).
template <bool kEmit, bool kExpire, bool kFaults>
__device__ __forceinline__ int delay_prefix(const Args& a, int c,
                                            const warp::WarpMem& m,
                                            int32_t max_wait) {
  const Level0Args& q = a.q;
  const Common& k = q.k;
  // the queue counts and the wait total, read before the entry's other
  // loads complete
  int n0 = q.l0_count[c], n1 = a.l1_count[c];
  SweepAcc acc(q.wait_total[c]);
  WarpCluster cl(k, c, m);
  const QueueRows l0 = queue_rows(q.l0, c, k.Q);
  const QueueRows l1 = queue_rows(a.l1, c, k.Q);

  // 0. the faults form's fault phase, requeueing into Level0 (counted as
  //    re-arrivals).
  int drop_queue = 0;
  int requeued = 0;
  if (kFaults) {
    cl.faults(a.f, q.l0, q.l0_count + c, &drop_queue, &requeued);
    n0 = q.l0_count[c];
  }

  // 1. release (the emit form packs the returns and writes no borrow
  //    request), the expire form's vnode expiry, then the arrivals into
  //    Level0.
  cl.release<kEmit>(&a.e);
  if (kEmit) warp::emit_no_borrow(a.e, c);
  if (kExpire) cl.expire(a.x);
  int arrived = 0;
  n0 = cl.ingest(q.l0, n0, &drop_queue, &arrived);

  // 2-3. the Level1 sweep in queue order, then its compaction.
  cl.sweep(l1, n1, imin(n1, k.QC), SRC_L1, false, q.wave != 0,
           clamped(q.l0, c) || clamped(a.l1, c), a.skip != 0,
           warp::FirstFit{}, acc);
  n1 = warp::compact_placed(l1, n1, acc.placed, m.mask);
  int l1_bad = acc.bad;

  // 4. the Level0 head: its rec_wait store (set_field_elem) and the
  //    promotion's push_back are checked.
  int l0_bad = 0;
  if (n0 > 0) {
    int32_t job[NF];
    l0.load(0, job);
    record_wait(job, k.t, false, acc);  // one f32 add, after the sweep's
    const int rec_size = l0.rp == nullptr ? l0.t->f[FREC].size : 4;
    l0_bad = warp::fits_size(rec_size, job[FREC]) ? 0 : 1;
    warp::lane0([&] { l0.set_checked(0, FREC, job[FREC]); });
    const bool success = cl.attempt(job, SRC_L0, &acc.run_full);
    const bool promote =
        !success && wrap_sub(k.t, job[FENQ]) >= max_wait;
    if (promote) {
      if (n1 < k.Q) {
        l1_bad += warp::store_row(l1, n1, job, true);
        ++n1;
      } else {
        ++drop_queue;
      }
    }
    if (success || promote) n0 = warp::pop_front_n(l0, n0, 1);
  }

  // 5. the counters, by lane 0; they move only by what the tick added
  const int placed = cl.placed;
  warp::lane0([&] {
    const int entered = arrived + requeued;
    if (entered != 0) q.wait_jobs[c] += entered;
    if (entered != placed) q.jobs_in_queue[c] += entered - placed;
    q.l0_count[c] = n0;
    a.l1_count[c] = n1;
    l0.count(c, l0_bad);
    l1.count(c, l1_bad);
    q.wait_total[c] = acc.total;
    if (drop_queue != 0) k.drop_queue[c] += drop_queue;
    if (acc.run_full != 0) k.drop_run_full[c] += acc.run_full;
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
fused_prefix_delay_kernel(const __grid_constant__ Args a) {
  const Common& k = a.q.k;
  const int bl = warp::batch_lane();
  if (!warp::lane_runs(k, bl)) return;  // the whole block: another member's
  const int c = bl * k.C + warp::cluster_index();  // over the batch
  const bool active = warp::cluster_index() < k.C;  // uniform in the warp
  int bad = 0;
  if (active) {
    bad = delay_prefix<kEmit, kExpire, kFaults>(
        a, c, warp::warp_mem(k.N, k.R, k.Q, false), a.max_wait[bl]);
  }
  if (kTap) warp::tap_epilogue(a.p, k, bl, c, active);
  if (k.node_size != 4) warp::node_exit_epilogue(k, a.p, kTap, bl, bad);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then Level0's
// count and counters, Level1's count, the emit outputs, the expire form's
// node columns, the flags and the promotion threshold, the emit flags (the
// terminal form when `emit` is 0) and the expire flag.
// The faults form's leaves, node capacities and lent count follow the
// expire form's columns, and its flag and settings (interval slots, trace
// mode, mttf, mttr, retry budget) the expire flag; its pointers are null
// and unread when `faults` is 0. `layout` (host memory) holds the node
// columns' value size, the node exit scratch, and the column views of the
// running set, the lent queue, Level0 and Level1.
// The lane form: `lane_on` ([L] bytes, null to run every lane) follows
// drops.ingest and L follows C; every [C, ...] array is then [L, C, ...]
// (the tenants or envs of a batch, a row of blocks each), and the
// per-lane parameters are [L] device arrays.
extern "C" int fused_prefix_delay_launch(
    void* node_free, void* node_active, void* run_active, void* arr_ptr,
    void* drop_queue, void* drop_run_full, void* placed_total, void* tr_t,
    void* tr_job, void* tr_node, void* tr_src, void* tr_n, void* rows,
    void* counts, void* drop_ingest, void* lane_on, void* l0_count, void* wait_total,
    void* wait_jobs, void* jobs_in_queue, void* l1_count, void* max_wait,
    void* ret_rows,
    void* ret_valid, void* drop_msgs, void* want, void* bjob, void* node_cap,
    void* node_expire, void* health, void* was_active, void* next_fail,
    void* down_until, void* down_since, void* n_fails, void* kills,
    void* requeues, void* down_ms, void* fail_t, void* repair_t, void* key,
    void* drop_failed, void* fault_cap, void* fault_lent_count, int C, int L,
    int N, int R, int Q, int S, int K, int E, int QC, int record_trace, int t,
    int window, int wave, int skip, int M, int emit,
    int borrowing, int expire, int faults, int fault_events, int fault_trace,
    int mttf, int mttr, int max_retries, int tap, int slot,
    const int64_t* layout, const void* const* tap_ptrs, void* stream) {
  if (Q > kMaxQueue) return static_cast<int>(cudaErrorInvalidValue);
  const Common k = make_common(node_free, node_active, run_active, arr_ptr,
                               drop_queue, drop_run_full, placed_total, tr_t,
                               tr_job, tr_node, tr_src, tr_n, rows, counts,
                               drop_ingest, lane_on, C, L, N, R, Q, S, K,
                               E, QC, record_trace, t, window, layout);
  Args a{make_level0(k, layout, l0_count, wait_total, wait_jobs,
                     jobs_in_queue, wave),
         make_table<NF>(layout, kOwnTable + 1),
         static_cast<int32_t*>(l1_count), skip,
         static_cast<const int32_t*>(max_wait),
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
          fused_prefix_delay_kernel<decltype(e)::value, decltype(x)::value,
                                    decltype(f)::value, decltype(p)::value>,
          g.blocks(C), L, g.warps, g.smem(), s, a);
    });
    if (!ok || !launched) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape at (C, L, N, R, Q): warps a block and shared-memory
// bytes a warp, as fused_prefix_delay_launch takes it.
extern "C" void fused_prefix_delay_geometry(
    int C, int L, int N, int R, int Q, int* warps, int64_t* warp_bytes) {
  const warp::Geometry g = warp::geometry(C, L, N, R, Q, false);
  *warps = g.warps;
  *warp_bytes = static_cast<int64_t>(g.warp_bytes);
}
