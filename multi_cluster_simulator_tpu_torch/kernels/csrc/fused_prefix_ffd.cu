// One tick's per-cluster prefix, release -> ingest -> schedule:FFD, for
// Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the span the first-fit-decreasing
//   bin-pack engages: [release, ingest (packed rows -> Level0), schedule:
//   FFD in its serial or its wave form], terminal, either state layout,
//   with or without the metrics tap. The TPU kernel replays the traced jaxpr of
//   Engine._span_prefix on a block of clusters; this kernel is written
//   from the semantics instead
//   (core/engine.py _release_local and _ingest_packed_local,
//   policies/kernels.py _ffd_local / _ffd_wave_local of the port), and is
//   held bitwise against the port's plain PyTorch version
//   (kernels/fused_tick.py fused_prefix_reference).
//
// Per tick and cluster: release every due running slot; append the tick's
//   arrivals to Level0 (wait_jobs and jobs_in_queue grow by the arrival
//   count, dropped rows included, as in the reference); take the first
//   QC = min(|L0|, sweep length) slots of the best-fit-decreasing order —
//   valid slots by (-key1, -key2, slot), key1 = cores and key2 = mem, or
//   swapped with ffd_mem_first — and for each, in that order, record its
//   wait and try first-fit with the has-slot check; placed jobs go into
//   the lowest free running slots in sweep order; last, Level0 is
//   compacted stably in slot order.
//
// The BFD order is computed before the sweep, which never changes the
//   keys (prefix_warp.cuh WarpCluster::bfd_order): the live rows' keys
//   (-key1, -key2) go into the warp's shared memory as one int64 each,
//   the slot the last key; then a warp bitonic sort of all the rows
//   orders them, and the sweep takes the first QC positions. Keys
//   stay full int32: a clamped demand (-128, -32,768) negates to a
//   positive key. Shared memory a warp: 10 B a slot of the power of two
//   >= Q (10 KB at Q = 768), the placed-slot mask (MAX_QUEUE bits; the
//   wrapper raises above it) and the node words.
//
// wait_total (f32): the serial form adds each processed job's delta in
//   sweep order, one f32 add per job, as _record_wait does. The wave form
//   (`wave`) sums the tick's integer deltas exactly in int64 and adds the
//   sum once, rounded to f32 — the port's plain version does the same, and
//   it equals the reference's f32 delta.sum() while its partial sums stay
//   below 2^24 ms. Placement is serial in both forms: the reference pins
//   its wave sweep equal to the serial one (tests/test_kernel_equiv.py),
//   and the plain version keeps the wave form, so every on-card
//   comparison of the wave config also checks wave == serial.
//
// The expire form (kExpire; the trader's expire_virtual_nodes) runs the
//   vnode expiry step between release and ingest, a lane a node slot; a
//   separate instantiation, as the emit form is.
//
// The faults form (kFaults; the fault plane) opens the span with
//   prefix_common.cuh's fault step on lane 0, requeueing killed jobs into
//   Level0 (and a peer's into the lent queue) and counting them in
//   wait_jobs and jobs_in_queue; another instantiation, as the emit and
//   expire forms are.
//
// Bound on the H100: device-memory bytes, counting only what the tick's
//   data needs moved: per cluster the arrival count and the counters it
//   updates, the node vectors, the running set's active flags, the end_t
//   of each active slot and the node and resources of each released slot,
//   the two sort keys of every live Level0 row, the whole row of each
//   processed job, the Level0 elements the compaction rewrites (each read
//   from its old slot), the valid arrival rows, and every element the tick
//   changes as a write (chip_smoke.py tick_bytes). At borg4k (C=4096,
//   N=5, R=2, Q=32, S=96) that is a few hundred bytes per cluster, about
//   a microsecond per tick at 3.35 TB/s; the kernel is far above it
//   (PERF.md).
//
// The tap form (kTap; a run with the metrics plane on a terminal prefix)
//   closes the span with prefix_warp.cuh's tap_epilogue, as the FIFO
//   kernel's tap form does. It is instantiated without the expire flag
//   only, since the trader is never terminal: 12 forms in all.
//
// The state layout and the windowed ingest are runtime properties, as in
//   fused_prefix_fifo.cu.
//
// Design: a warp per cluster, in place, as in the FIFO kernel
//   (prefix_warp.cuh): the lanes release, ingest, stage and order the
//   keys, and compact Level0 (each kept row's destination the popc
//   prefix of the placed mask's complement, 32 rows at a time: read, sync,
//   write); the sweep is serial and uniform, first fit and the free
//   running slot by ballot, the running row a field a lane. Where a clamp
//   made a demand negative, lane 0 replays the reference's waves over the
//   same order (prefix_common.cuh sweep, wave_place). Blocks of up to 16
//   warps, fewer while that would leave SMs without a block: ffd64's 64
//   clusters are 64 blocks of one warp, borg4k's 4,096 are 256 of 16.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include "prefix_warp.cuh"

namespace {

using namespace prefix;

struct Args {
  Level0Args q;
  const int32_t* mem_first;  // [L] params.ffd_mem_first > 0, a lane each
  Emit e;
  Expire x;
  Faults f;
  Tap p;
};

// A warp per cluster runs its span; the tap form then closes it with the
// metrics tap, every thread of the block taking part. The parameters are
// __grid_constant__: the steps and the epilogues read them where they are
// instead of from a copy of them in each thread's local memory.
template <bool kEmit, bool kExpire, bool kFaults, bool kTap>
__global__ void __launch_bounds__(warp::kMaxWarps * warp::kLanes,
                                  warp::kMinBlocks)
fused_prefix_ffd_kernel(const __grid_constant__ Args a) {
  const Common& k = a.q.k;
  const int bl = warp::batch_lane();
  if (!warp::lane_runs(k, bl)) return;  // the whole block: another member's
  const int c = bl * k.C + warp::cluster_index();  // over the batch
  const bool active = warp::cluster_index() < k.C;  // uniform in the warp
  int bad = 0;
  if (active) {
    bad = warp::level0_prefix<kEmit, kExpire, kFaults>(
        a.q, a.e, a.x, a.f, c, warp::warp_mem(k.N, k.R, k.Q, true),
        a.mem_first[bl], warp::FirstFit{});
  }
  if (kTap) warp::tap_epilogue(a.p, k, bl, c, active);
  if (k.node_size != 4) warp::node_exit_epilogue(k, a.p, kTap, bl, bad);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then Level0's
// count and the FFD counters, the emit outputs, the two flags, and the
// emit flags (the terminal form when `emit` is 0).
// The faults form's leaves, node capacities and lent count follow the
// expire form's columns, and its flag and settings (interval slots, trace
// mode, mttf, mttr, retry budget) the expire flag; its pointers are null
// and unread when `faults` is 0. `layout` (host memory) holds the node
// columns' value size, the node exit scratch, and the column views of the
// running set, the lent queue and Level0.
// The lane form: `lane_on` ([L] bytes, null to run every lane) follows
// drops.ingest and L follows C; every [C, ...] array is then [L, C, ...]
// (the tenants or envs of a batch, a row of blocks each), and the
// per-lane parameters are [L] device arrays.
extern "C" int fused_prefix_ffd_launch(
    void* node_free, void* node_active, void* run_active, void* arr_ptr,
    void* drop_queue, void* drop_run_full, void* placed_total, void* tr_t,
    void* tr_job, void* tr_node, void* tr_src, void* tr_n, void* rows,
    void* counts, void* drop_ingest, void* lane_on, void* l0_count, void* wait_total,
    void* wait_jobs, void* jobs_in_queue, void* mem_first, void* ret_rows,
    void* ret_valid,
    void* drop_msgs, void* want, void* bjob, void* node_cap,
    void* node_expire, void* health, void* was_active, void* next_fail,
    void* down_until, void* down_since, void* n_fails, void* kills,
    void* requeues, void* down_ms, void* fail_t, void* repair_t, void* key,
    void* drop_failed, void* fault_cap, void* fault_lent_count, int C, int L,
    int N, int R, int Q, int S, int K, int E, int QC, int record_trace, int t,
    int window, int wave, int M, int emit, int borrowing,
    int expire, int faults, int fault_events, int fault_trace, int mttf,
    int mttr, int max_retries, int tap, int slot, const int64_t* layout,
    const void* const* tap_ptrs, void* stream) {
  if (Q > kMaxQueue) return static_cast<int>(cudaErrorInvalidValue);
  const Common k = make_common(node_free, node_active, run_active, arr_ptr,
                               drop_queue, drop_run_full, placed_total, tr_t,
                               tr_job, tr_node, tr_src, tr_n, rows, counts,
                               drop_ingest, lane_on, C, L, N, R, Q, S, K,
                               E, QC, record_trace, t, window, layout);
  Args a{make_level0(k, layout, l0_count, wait_total, wait_jobs,
                     jobs_in_queue, wave),
         static_cast<const int32_t*>(mem_first),
         make_emit(ret_rows, ret_valid, drop_msgs, want, bjob, M, borrowing),
         make_expire(node_cap, node_expire),
         make_faults(health, was_active, next_fail, down_until, down_since,
                     n_fails, kills, requeues, down_ms, fail_t, repair_t, key,
                     drop_failed, fault_cap, layout, fault_lent_count,
                     fault_events, fault_trace, mttf, mttr, max_retries),
         make_tap(tap ? tap_ptrs : nullptr, slot)};
  if (C > 0) {
    const warp::Geometry g = warp::geometry(C, L, N, R, Q, true);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool launched = false;
    const bool ok = dispatch_forms(emit, expire, faults, tap,
                                   [&](auto e, auto x, auto f, auto p) {
      launched = warp::launch_warps(
          fused_prefix_ffd_kernel<decltype(e)::value, decltype(x)::value,
                                  decltype(f)::value, decltype(p)::value>,
          g.blocks(C), L, g.warps, g.smem(), s, a);
    });
    if (!ok || !launched) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape at (C, L, N, R, Q): warps a block and shared-memory
// bytes a warp, as fused_prefix_ffd_launch takes it.
extern "C" void fused_prefix_ffd_geometry(
    int C, int L, int N, int R, int Q, int* warps, int64_t* warp_bytes) {
  const warp::Geometry g = warp::geometry(C, L, N, R, Q, true);
  *warps = g.warps;
  *warp_bytes = static_cast<int64_t>(g.warp_bytes);
}
