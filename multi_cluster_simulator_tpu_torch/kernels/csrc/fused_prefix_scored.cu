// One tick's per-cluster prefix, release -> ingest -> schedule:{gavel,
// tesserae, rl}, for Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the spans the scored kinds of the
//   policy zoo engage: [release, ingest (packed rows -> Level0), schedule:
//   the serial Level0 sweep with a scored node pick], terminal, either
//   state layout, with or without the metrics tap. Written from the semantics
//   (policies/kernels.py _scored_sweep_local with _gavel_local,
//   _tesserae_local and _rl_local of the port) and held bitwise against
//   the port's plain PyTorch version (kernels/fused_tick.py
//   fused_prefix_reference).
//
// It is the FFD kernel's body (prefix_warp.cuh level0_prefix) with
//   another order and pick, so the FFD code path compiles without a score
//   branch:
//   - gavel and rl sweep Level0 in queue order and score node n for a job
//     as entry [clip(jclass), clip(node_type[n])] of a 4x4 f32 table
//     (params.gavel_tput or params.rl_scores; all zeros, rl's default,
//     is first fit). The table is a kernel parameter, read once per run.
//   - tesserae sweeps in the best-fit-decreasing order (always cores
//     first) and scores sum_r f32(free[n, r]) * (f32(res[r]) * w[r])
//     under the 3 f32 weights params.tess_w.
//   The pick is the first maximum of the scores with infeasible nodes at
//   -inf and in the reduction (ties go to the lowest index, so with every
//   feasible node at -inf the pick is node 0, as the reference's
//   jnp.argmax), and no node when none fits; a NaN score wins as it does
//   in torch.argmax and jnp.argmax.
//
// The float hazard: the tesserae products pass 2^24 and are not integers
//   (w[1] = 1e-3), so the bits of the score, and with them the argmax and
//   the placements, depend on the order of the operations and on whether
//   a multiply and an add are fused. The reference's XLA CPU dot rounds
//   the first product and adds each later one with a fused multiply-add;
//   this kernel does exactly that, spelled out with prefix_common.cuh's
//   fmul_rn and fma_rn (the card's __fmul_rn and __fmaf_rn, their plain
//   meanings on a host build compiled without contraction), and the file
//   is built with --fmad=false (kernels/build.py) so that nvcc contracts
//   nothing else. The plain version computes the fused multiply-add
//   exactly (policies/kernels.py fma_f32).
//
// wait_total (f32): one add per processed job, in sweep order, as FFD's
//   serial form; the scored kinds have no wave form.
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
// Bound on the H100: device-memory bytes, as FFD's (chip_smoke.py
//   tick_cost): the counters, the node vectors and types, the running
//   set's active flags and active end_t, the Level0 keys the order reads,
//   the processed rows, the compaction's rewrites, the valid arrival rows
//   and every element the tick changes; plus the score operations.
//
// The tap form (kTap; a run with the metrics plane on a terminal prefix)
//   closes the span with prefix_warp.cuh's tap_epilogue, as the FIFO and
//   FFD kernels' tap forms do. It is instantiated without the expire flag
//   only, since the trader is never terminal: 12 forms in all.
//
// The state layout and the windowed ingest are runtime properties, as in
//   fused_prefix_fifo.cu.
//
// Design: a warp per cluster, in place, as the FFD kernel (prefix_warp.cuh
//   level0_prefix): the lanes release, ingest, stage and sort tesserae's
//   keys, and compact Level0; the sweep is serial and uniform, the pick a
//   lane a node — each lane scores its node from the same loads and in the
//   same float steps as the plain version — reduced to the winner by warp
//   shuffles (WarpCluster::scored_fit), 32 nodes a round. The keys and the
//   order are staged for tesserae only: the launcher takes the pick and
//   sizes each warp's shared memory by it (fused_prefix_scored_geometry),
//   so gavel and rl warps need only the node words and the placed mask
//   (about 0.4 KB at config 4's shape, against 3 KB with the order) and
//   more of them fit a block where Q is deep. Blocks of up to 16 warps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//   --fmad=false -shared -Xcompiler -fPIC (kernels/build.py); bound to
//   PyTorch with ctypes.

#include "prefix_warp.cuh"

namespace {

using namespace prefix;
using warp::WarpCluster;

constexpr int kClasses = 4, kDeviceTypes = 4;  // ops/fields.py
constexpr int kTable = 0, kTesserae = 1;       // the pick, as the wrapper

struct Args {
  Level0Args q;
  const int32_t* node_type;  // [C, N]
  // a batch lane each: the pick, kTable (gavel, rl) or kTesserae; the
  // member's 16 table scores (gavel's throughputs, rl's action); tesserae's
  // 3 weights
  const int32_t* pick;  // [L]
  const float* table;   // [L, kClasses kDeviceTypes]
  const float* w;       // [L, 3]
  Emit e;
  Expire x;
  Faults f;
  Tap p;
};

// gavel and rl: the table entry of the job's class and the node's type.
struct TablePick {
  static constexpr bool kWaves = false;
  const float* table;
  const int32_t* node_type;  // this cluster's [N]

  __device__ int operator()(const WarpCluster& cl, const int32_t* job) const {
    const float* row =
        table + imin(imax(job[FJCLASS], 0), kClasses - 1) * kDeviceTypes;
    return cl.scored_fit(job, [&](int n) {
      return row[imin(imax(node_type[n], 0), kDeviceTypes - 1)];
    });
  }
};

// tesserae: the weighted demand-free alignment, in XLA's CPU order.
struct TesseraePick {
  static constexpr bool kWaves = false;
  const float* w;

  __device__ int operator()(const WarpCluster& cl, const int32_t* job) const {
    const int R = cl.a.R;
    float rw[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 3; ++r) {  // constant indices: `job` in registers
      if (r < R) rw[r] = fmul_rn(i2f_rn(job[FCORES + r]), w[r]);
    }
    return cl.scored_fit(job, [&](int n) {
      const int32_t* f = cl.m.free + n * R;
      float s = fmul_rn(i2f_rn(f[0]), rw[0]);
#pragma unroll
      for (int r = 1; r < 3; ++r) {
        if (r < R) s = fma_rn(i2f_rn(f[r]), rw[r], s);
      }
      return s;
    });
  }
};

// A warp per cluster runs its span; the tap form then closes it with the
// metrics tap, every thread of the block taking part. __grid_constant__:
// the steps and the epilogues read the parameters where they are, without
// a copy of them in local memory. A lane's pick, table row and weights
// are its own.
template <bool kEmit, bool kExpire, bool kFaults, bool kTap>
__global__ void __launch_bounds__(warp::kMaxWarps * warp::kLanes,
                                  warp::kMinBlocks)
fused_prefix_scored_kernel(const __grid_constant__ Args a) {
  const Common& k = a.q.k;
  const int bl = warp::batch_lane();
  if (!warp::lane_runs(k, bl)) return;  // the whole block: another member's
  const int c = bl * k.C + warp::cluster_index();  // over the batch
  const bool active = warp::cluster_index() < k.C;  // uniform in the warp
  const bool tesserae = a.pick[bl] == kTesserae;
  int bad = 0;
  if (active) {
    const warp::WarpMem m = warp::warp_mem(k.N, k.R, k.Q, tesserae);
    if (tesserae) {
      bad = warp::level0_prefix<kEmit, kExpire, kFaults>(
          a.q, a.e, a.x, a.f, c, m, 0, TesseraePick{a.w + 3 * bl});
    } else {
      bad = warp::level0_prefix<kEmit, kExpire, kFaults>(
          a.q, a.e, a.x, a.f, c, m, -1,
          TablePick{a.table + kClasses * kDeviceTypes * bl,
                    a.node_type + (size_t)c * k.N});
    }
  }
  if (kTap) warp::tap_epilogue(a.p, k, bl, c, active);
  if (k.node_size != 4) warp::node_exit_epilogue(k, a.p, kTap, bl, bad);
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then Level0's
// count and counters, the node types, the per-lane picks, table scores
// and weights, the emit outputs, whether a lane of the launch picks
// tesserae (`order`: its warps stage the BFD order in shared memory), the
// emit flags (the terminal form when `emit` is 0), then (host memory) the
// layout — the node columns' value size, the node exit scratch, and the
// column views of the running set, the lent queue and Level0.
// The faults form's leaves, node capacities and lent count follow the
// expire form's columns, and its flag and settings (interval slots, trace
// mode, mttf, mttr, retry budget) the expire flag; its pointers are null
// and unread when `faults` is 0.
// The lane form: `lane_on` ([L] bytes, null to run every lane) follows
// drops.ingest and L follows C; every [C, ...] array is then [L, C, ...]
// (the tenants or envs of a batch, a row of blocks each), and the
// per-lane parameters are [L] device arrays.
extern "C" int fused_prefix_scored_launch(
    void* node_free, void* node_active, void* run_active, void* arr_ptr,
    void* drop_queue, void* drop_run_full, void* placed_total, void* tr_t,
    void* tr_job, void* tr_node, void* tr_src, void* tr_n, void* rows,
    void* counts, void* drop_ingest, void* lane_on, void* l0_count, void* wait_total,
    void* wait_jobs, void* jobs_in_queue, void* node_type, void* pick,
    void* table, void* w, void* ret_rows,
    void* ret_valid, void* drop_msgs, void* want, void* bjob, void* node_cap,
    void* node_expire, void* health, void* was_active, void* next_fail,
    void* down_until, void* down_since, void* n_fails, void* kills,
    void* requeues, void* down_ms, void* fail_t, void* repair_t, void* key,
    void* drop_failed, void* fault_cap, void* fault_lent_count, int C, int L,
    int N, int R, int Q, int S, int K, int E, int QC, int record_trace, int t,
    int window, int order, int M, int emit, int borrowing, int expire,
    int faults, int fault_events, int fault_trace, int mttf, int mttr,
    int max_retries, int tap, int slot, const int64_t* layout,
    const void* const* tap_ptrs, void* stream) {
  if (Q > kMaxQueue || R > 3) return static_cast<int>(cudaErrorInvalidValue);
  const Common k = make_common(node_free, node_active, run_active, arr_ptr,
                               drop_queue, drop_run_full, placed_total, tr_t,
                               tr_job, tr_node, tr_src, tr_n, rows, counts,
                               drop_ingest, lane_on, C, L, N, R, Q, S, K,
                               E, QC, record_trace, t, window, layout);
  Args a{make_level0(k, layout, l0_count, wait_total, wait_jobs,
                     jobs_in_queue, 0),
         static_cast<const int32_t*>(node_type),
         static_cast<const int32_t*>(pick), static_cast<const float*>(table),
         static_cast<const float*>(w),
         make_emit(ret_rows, ret_valid, drop_msgs, want, bjob, M, borrowing),
         make_expire(node_cap, node_expire),
         make_faults(health, was_active, next_fail, down_until, down_since,
                     n_fails, kills, requeues, down_ms, fail_t, repair_t, key,
                     drop_failed, fault_cap, layout, fault_lent_count,
                     fault_events, fault_trace, mttf, mttr, max_retries),
         make_tap(tap ? tap_ptrs : nullptr, slot)};
  if (C > 0) {
    const warp::Geometry g = warp::geometry(C, L, N, R, Q, order != 0);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    bool launched = false;
    const bool ok = dispatch_forms(emit, expire, faults, tap,
                                   [&](auto e, auto x, auto f, auto p) {
      launched = warp::launch_warps(
          fused_prefix_scored_kernel<decltype(e)::value, decltype(x)::value,
                                     decltype(f)::value, decltype(p)::value>,
          g.blocks(C), L, g.warps, g.smem(), s, a);
    });
    if (!ok || !launched) return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The launch's shape at (C, L, N, R, Q) with `order` (a lane picks
// tesserae): warps a block and shared-memory bytes a warp, as
// fused_prefix_scored_launch takes it.
extern "C" void fused_prefix_scored_geometry(
    int C, int L, int N, int R, int Q, int order, int* warps,
    int64_t* warp_bytes) {
  const warp::Geometry g = warp::geometry(C, L, N, R, Q, order != 0);
  *warps = g.warps;
  *warp_bytes = static_cast<int64_t>(g.warp_bytes);
}
