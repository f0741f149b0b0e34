// One tick's per-cluster prefix, release -> ingest -> schedule:FFD, for
// Hopper (sm_90a).
//
// Replaces: the TPU kernel multi_cluster_simulator_tpu/kernels/fused_tick.py
//   fused_prefix (its pallas_call), on the span the first-fit-decreasing
//   bin-pack engages: [release, ingest (packed rows -> Level0), schedule:
//   FFD in its serial or its wave form], terminal, wide layout, no metrics
//   tap. The TPU kernel replays the traced jaxpr of Engine._span_prefix on
//   a block of clusters; this kernel is written from the semantics instead
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
// The BFD order needs no [Q] scratch: position p's slot is the smallest
//   (key1, key2, slot) strictly after position p-1's, found by one pass
//   over the live rows. That is stable by construction and costs
//   QC x |L0| key reads, which stays small at Level0 depths of hundreds
//   (Q = 768 in the ffd64 config). The placed slots are a bit mask of at
//   most FFD_MAX_QUEUE bits; the wrapper raises above it.
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
//   (PERF.md), because one thread walks each cluster's rows serially.
//
// Design: one thread per cluster, in place, as in the FIFO kernel. Blocks
//   shrink below a warp when there are fewer than 32 x 132 clusters, so
//   that every SM holds some clusters (ffd64: 64 clusters, one per block)
//   and each cluster's Level0 has more of an SM's L1 for the QC passes.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//   -Xcompiler -fPIC (kernels/build.py); bound to PyTorch with ctypes.

#include "prefix_common.cuh"

namespace {

using namespace prefix;

constexpr int kMaxThreads = 32;
constexpr int kSMs = 132;             // H100 SXM
constexpr int kMaxQueue = 1024;       // kernels/fused_tick.py FFD_MAX_QUEUE
constexpr int kMaskWords = kMaxQueue / 32;

struct Args {
  Common k;
  int32_t* l0;             // [C, Q, NF]
  int32_t* l0_count;       // [C]
  float* wait_total;       // [C]
  int32_t* wait_jobs;      // [C]
  int32_t* jobs_in_queue;  // [C]
  int wave;       // the wave form's wait accounting (else serial)
  int mem_first;  // params.ffd_mem_first > 0
};

// (a1, a2, ai) < (b1, b2, bi), lexicographically.
__device__ __forceinline__ bool key_less(int32_t a1, int32_t a2, int ai,
                                         int32_t b1, int32_t b2, int bi) {
  if (a1 != b1) return a1 < b1;
  if (a2 != b2) return a2 < b2;
  return ai < bi;
}

__global__ void __launch_bounds__(kMaxThreads)
fused_prefix_ffd_kernel(Args a) {
  const Common& k = a.k;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k.C) return;
  Cluster cl(k, c);
  int32_t* l0 = a.l0 + (size_t)c * k.Q * NF;

  // 1. release every due running slot.
  cl.release();

  // 2. ingest: append the tick's arrivals to Level0.
  int drop_queue = 0;
  const int count = cl.ingest(l0, a.l0_count[c], &drop_queue);
  const int cnt = k.counts[c];
  a.wait_jobs[c] += cnt;
  a.jobs_in_queue[c] += cnt;

  // 3. FFD: the first n_sweep positions of the BFD order, serially.
  const int f1 = a.mem_first ? FMEM : FCORES;
  const int f2 = a.mem_first ? FCORES : FMEM;
  const int n_sweep = imin(count, k.QC);
  uint32_t placed_mask[kMaskWords];
  for (int w = 0; w < (count + 31) / 32; ++w) placed_mask[w] = 0u;
  int run_full = 0;
  float total = a.wait_total[c];
  long long wave_sum = 0;
  int32_t last1 = 0, last2 = 0;
  int last_i = -1;
  for (int p = 0; p < n_sweep; ++p) {
    // the smallest (-key1, -key2, slot) after position p-1's
    int best = -1;
    int32_t b1 = 0, b2 = 0;
    for (int i = 0; i < count; ++i) {
      const int32_t* row = l0 + i * NF;
      const int32_t k1 = wrap_sub(0, row[f1]), k2 = wrap_sub(0, row[f2]);
      if (last_i >= 0 && !key_less(last1, last2, last_i, k1, k2, i)) continue;
      if (best < 0 || key_less(k1, k2, i, b1, b2, best)) {
        best = i;
        b1 = k1;
        b2 = k2;
      }
    }
    last1 = b1;
    last2 = b2;
    last_i = best;

    // record the wait (scheduler.go:309-312)
    int32_t* job = l0 + best * NF;
    const int32_t cur = wrap_sub(k.t, job[FENQ]);
    const int32_t delta = wrap_sub(cur, job[FREC]);
    if (a.wave) {
      wave_sum += delta;
    } else {
      total = total + (float)delta;
    }
    job[FREC] = cur;

    // first-fit with the has-slot check
    if (cl.attempt(job, SRC_L0, &run_full)) {
      placed_mask[best >> 5] |= 1u << (best & 31);
    }
  }
  if (a.wave) total = total + (float)wave_sum;

  // 4. compact Level0 stably in slot order, dropping the placed slots;
  //    rows at or past the old count are INVALID already.
  int kept = count;
  if (cl.placed > 0) {
    kept = 0;
    for (int i = 0; i < count; ++i) {
      if (placed_mask[i >> 5] & (1u << (i & 31))) continue;
      if (kept != i) copy_row(l0 + kept * NF, l0 + i * NF);
      ++kept;
    }
    for (int i = kept; i < count; ++i) set_queue_invalid(l0 + i * NF);
  }

  a.l0_count[c] = kept;
  a.wait_total[c] = total;
  a.jobs_in_queue[c] -= cl.placed;
  k.drop_queue[c] += drop_queue;
  k.drop_run_full[c] += run_full;
  k.placed_total[c] += cl.placed;
}

}  // namespace

// Launch on `stream` (PyTorch's current stream); returns cudaGetLastError()
// so the Python wrapper can raise on a refused launch. The leading
// arguments are prefix_common.cuh's Common, in its order; then Level0 and
// the FFD counters, and the two flags.
extern "C" int fused_prefix_ffd_launch(
    void* node_free, void* node_active, void* run, void* run_active,
    void* arr_ptr, void* drop_queue, void* drop_run_full, void* placed_total,
    void* tr_t, void* tr_job, void* tr_node, void* tr_src, void* tr_n,
    void* rows, void* counts, void* l0, void* l0_count, void* wait_total,
    void* wait_jobs, void* jobs_in_queue, int C, int N, int R, int Q, int S,
    int K, int E, int QC, int record_trace, int t, int wave, int mem_first,
    void* stream) {
  if (Q > kMaxQueue) return static_cast<int>(cudaErrorInvalidValue);
  Args a{make_common(node_free, node_active, run, run_active, arr_ptr,
                     drop_queue, drop_run_full, placed_total, tr_t, tr_job,
                     tr_node, tr_src, tr_n, rows, counts, C, N, R, Q, S, K,
                     E, QC, record_trace, t),
         static_cast<int32_t*>(l0), static_cast<int32_t*>(l0_count),
         static_cast<float*>(wait_total), static_cast<int32_t*>(wait_jobs),
         static_cast<int32_t*>(jobs_in_queue), wave, mem_first};
  if (C > 0) {
    int threads = kMaxThreads;
    while (threads > 1 && (C + threads - 1) / threads < kSMs) threads /= 2;
    const int blocks = (C + threads - 1) / threads;
    fused_prefix_ffd_kernel<<<blocks, threads, 0,
                              static_cast<cudaStream_t>(stream)>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}
