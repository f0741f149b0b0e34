// The cooperative steps of the prefix kernels (fused_prefix_fifo.cu,
// fused_prefix_ffd.cu, fused_prefix_delay.cu, fused_prefix_scored.cu): one
// warp carries one cluster, its node words in shared memory, and its lanes
// share each walk over the running set and the queues.
//
// Why: one thread per cluster walks its cluster's rows serially, and
// neighbouring threads read rows a cluster apart, so no load coalesces; a
// few clusters (ffd64's 64, config 1's one) leave most of the card idle.
// With a warp per cluster the lanes read neighbouring rows (a narrow leaf
// of 32 rows in one load), the release and the row moves take S/32 and
// n/32 steps, the BFD order is a warp bitonic sort over keys in shared
// memory, first fit a ballot over 32 nodes and the scored pick a shuffle
// reduction over 32 nodes' scores.
//
// How the code is written. Outside the lane helpers below, the code is
// uniform: every lane computes the same values from the same loads (a
// queue row every lane loads is one broadcast transaction), so decisions
// that are serial in the reference — the FIFO drain to its first failure,
// the pick, the sweep in order, DELAY's Level0 head — stay serial and need
// no broadcast. Work that differs by lane goes through a helper that takes
// it as a lambda of the lane (`lanes`, `strided`, `ballot`, `reduce_add`,
// `best_of`), and state a lane keeps across helper calls lives in a
// PerLane<T>. Every helper has a host meaning (a build without nvcc):
// the 32 lanes one after another, PerLane an array of 32, the
// synchronisation a no-op, atomics plain adds; a host build of a kernel
// (a logic check with g++, tests/test_torch_kernel_host.py) then runs
// each warp as one call, through `launch_warps`' host loop. Writes that
// another lane reads later are followed by `sync()` (__syncwarp, which
// orders memory among the warp's lanes); a row move reads a chunk of 32
// rows into registers, syncs, then writes, since a move by fewer than 32
// rows overlaps its own source within the chunk.
//
// The lane form (a batch of L constellations: tenants, envs) is a second
// grid dimension: blockIdx.y is the batch lane (`batch_lane`; not a warp's
// lane), blockIdx.x covers its C clusters, so a block never spans two
// batch lanes. A warp addresses its cluster as bl C + c in every [L, C,
// ...] array; the per-lane parameters are [L] arrays; a launch for one
// member of a mixed set skips the other members' lanes a block at a time
// (`lane_runs`); the epilogues keep a scratch set per batch lane.
//
// What a lane does on its own stays on lane 0 where it is rare: the fault
// step and the waves' replay on negative demands (prefix_common.cuh
// Cluster::faults, fifo_drain_waves, sweep and wave_place), on a Cluster
// over the warp's shared node words, its results passed to the warp
// through the warp's scratch (`from_lane0`).

#pragma once

#include "prefix_common.cuh"

namespace prefix {
namespace warp {

constexpr int kLanes = 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
// Warps (clusters) per block: at most this many, fewer while that would
// leave an H100 SXM's 132 SMs without a block or a block's dynamic shared
// memory past the default 48 KB (warps_for; a warp needs 10.6 KB at
// MAX_QUEUE, so one always fits). Few large blocks keep the epilogues'
// per-block atomics and fences few: the tap's cross-cluster half costs
// about one same-address atomic round a block, so 4,096 clusters in blocks
// of 4 pay it 1,024 times, in blocks of 16 256 times.
constexpr int kMaxWarps = 16;
constexpr int kSMs = 132;
constexpr size_t kBlockSmem = 48 * 1024;
// Blocks an SM must hold at once: the kernels' __launch_bounds__ then cap
// a thread at 64 registers, so 32 warps fit an SM and the headline's 4,096
// warps are all resident at once (at 96 registers an SM holds 21 warps,
// and 4,096 take two rounds).
constexpr int kMinBlocks = 2;
// Bytes of a warp's scratch, where lane 0's results reach the warp.
constexpr int kScratchBytes = 128;
// A host build's shared memory for the one warp it runs at a time.
constexpr size_t kHostSmem = 1 << 18;

// The lane form (L batch lanes of C clusters each: the tenants of a tenant
// batch, the envs of an env batch) adds a second grid dimension, a batch
// lane a row of blocks, so a block never spans two batch lanes; it also
// stops halving once half the warps would exceed C (two clusters a lane
// take blocks of two warps). With L = 1 the shape is the one-lane
// kernel's.
inline int warps_for(int C, int L, size_t warp_bytes) {
  int w = kMaxWarps;
  while (w > 1 && ((C + w - 1) / w * (long long)L < kSMs ||
                   w * warp_bytes > kBlockSmem || w / 2 >= C)) {
    w /= 2;
  }
  return w;
}

__device__ __forceinline__ int warp_in_block() { return threadIdx.x >> 5; }

// The cluster this warp carries, within its batch lane.
__device__ __forceinline__ int cluster_index() {
  return blockIdx.x * (blockDim.x >> 5) + warp_in_block();
}

// The batch lane this block carries (a tenant or an env; not a warp's
// lane): the grid's second dimension.
__device__ __forceinline__ int batch_lane() { return blockIdx.y; }

// Does this launch run batch lane `bl`? A launch of one member of a mixed
// set runs the lanes that select it (`lane_on`, null for every lane); the
// test is uniform over the block, so a block of another member's lane
// returns before any step or epilogue.
__device__ __forceinline__ bool lane_runs(const Common& k, int bl) {
  return k.lane_on == nullptr || k.lane_on[bl] != 0;
}

__device__ __forceinline__ int popc(uint32_t v) {
#ifdef __CUDACC__
  return __popc(v);
#else
  return __builtin_popcount(v);
#endif
}

// 1 + the index of the lowest set bit, 0 for none.
__device__ __forceinline__ int ffs(uint32_t v) {
#ifdef __CUDACC__
  return __ffs(v);
#else
  return __builtin_ffs(v);
#endif
}

// How many lanes below `lane` a ballot holds: the exclusive scan of its
// 0/1 counts.
__device__ __forceinline__ int rank(uint32_t bits, int lane) {
  return popc(bits & ((1u << lane) - 1u));
}

// A (key, slot) pair, ordered lexicographically; the FFD order's keys.
struct Key {
  long long k;
  int32_t i;
};
constexpr long long kNoKey = 0x7FFFFFFFFFFFFFFFll;

__device__ __forceinline__ bool key_less(const Key& a, const Key& b) {
  return a.k != b.k ? a.k < b.k : a.i < b.i;
}

// A node's score and index, the scored pick's candidate.
struct Scored {
  float v;
  int32_t i;
};

// Does a rank before b in the scored pick's order: a NaN before any number
// (torch.argmax's NaN wins), then the larger score — compared as floats, so
// -0.0 and +0.0 tie, as do -inf and -inf — then the lower index (the first
// maximum). A total order over distinct indices, so a reduction in any
// grouping gives the serial scan's winner.
__device__ __forceinline__ bool ranks_before(const Scored& a,
                                             const Scored& b) {
  const bool an = a.v != a.v, bn = b.v != b.v;  // NaN
  if (an != bn) return an;
  if (!an && a.v != b.v) return a.v > b.v;
  return a.i < b.i;
}

#ifdef __CUDACC__

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }
__device__ __forceinline__ void sync() { __syncwarp(); }

template <class T>
struct PerLane {
  T v;
  __device__ __forceinline__ T& operator[](int) { return v; }
};

// f(lane), on every lane.
template <class F>
__device__ __forceinline__ void lanes(F&& f) {
  f(lane_id());
}

// f(lane, i) for i in [0, n), lane-strided.
template <class F>
__device__ __forceinline__ void strided(int n, F&& f) {
  for (int i = lane_id(); i < n; i += kLanes) f(lane_id(), i);
}

template <class F>
__device__ __forceinline__ uint32_t ballot(F&& pred) {
  return __ballot_sync(kFull, pred(lane_id()));
}

// The wrapping int32 sum of f(lane) over the warp.
template <class F>
__device__ __forceinline__ int32_t reduce_add(F&& f) {
  return (int32_t)__reduce_add_sync(kFull, (uint32_t)f(lane_id()));
}

__device__ __forceinline__ void atomic_add(int32_t* p, int32_t v) {
  atomicAdd(p, v);  // wraps, as the reference's int32 add
}

// f() on lane 0, its result (trivially copyable, kScratchBytes at most)
// in every lane, through the warp's scratch.
template <class T, class F>
__device__ __forceinline__ T from_lane0(char* scratch, F&& f) {
  static_assert(sizeof(T) <= kScratchBytes, "the warp's scratch");
  T* box = reinterpret_cast<T*>(scratch);
  sync();
  if (lane_id() == 0) *box = f();
  sync();
  const T v = *box;
  sync();
  return v;
}

// The candidate f(lane) that ranks first over the warp, in every lane: a
// butterfly of shuffles, each lane keeping the better of its own and its
// partner's.
template <class F>
__device__ __forceinline__ Scored best_of(F&& f) {
  Scored s = f(lane_id());
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1) {
    const Scored x{__shfl_xor_sync(kFull, s.v, o),
                   __shfl_xor_sync(kFull, s.i, o)};
    if (ranks_before(x, s)) s = x;
  }
  return s;
}

#else  // a host build: the lanes one after another

__device__ __forceinline__ void sync() {}

template <class T>
struct PerLane {
  T v[kLanes];
  T& operator[](int lane) { return v[lane]; }
};

template <class F>
void lanes(F&& f) {
  for (int l = 0; l < kLanes; ++l) f(l);
}

template <class F>
void strided(int n, F&& f) {
  for (int l = 0; l < kLanes; ++l) {
    for (int i = l; i < n; i += kLanes) f(l, i);
  }
}

template <class F>
uint32_t ballot(F&& pred) {
  uint32_t bits = 0u;
  for (int l = 0; l < kLanes; ++l) bits |= (pred(l) ? 1u : 0u) << l;
  return bits;
}

template <class F>
int32_t reduce_add(F&& f) {
  uint32_t sum = 0u;
  for (int l = 0; l < kLanes; ++l) sum += (uint32_t)f(l);
  return (int32_t)sum;
}

inline void atomic_add(int32_t* p, int32_t v) { *p = wrap_add(*p, v); }

template <class T, class F>
T from_lane0(char*, F&& f) {
  return f();
}

template <class F>
Scored best_of(F&& f) {
  Scored s = f(0);
  for (int l = 1; l < kLanes; ++l) {
    const Scored x = f(l);
    if (ranks_before(x, s)) s = x;
  }
  return s;
}

inline char* host_smem() {
  alignas(16) static char buf[kHostSmem];
  return buf;
}

#endif

// f() on lane 0 alone, the warp synchronised before and after.
template <class F>
__device__ __forceinline__ void lane0(F&& f) {
  lanes([&](int l) {
    sync();
    if (l == 0) f();
    sync();
  });
}

// ---------------------------------------------------------------------------
// A warp's shared memory: its scratch, the node free words (widened to
// int32) and active flags, the placed-slot mask of the sweeps, and for the
// BFD order (FFD, tesserae; `order`) the keys and the order. Sized from N,
// R and Q at launch.
// ---------------------------------------------------------------------------

struct WarpMem {
  char* scratch;
  int32_t* free;   // [N R]
  uint8_t* act;    // [N]
  uint32_t* mask;  // [kMaskWords] the slots the sweep placed
  long long* key;  // [P] the sort keys, P the power of two >= Q
  int16_t* idx;    // [P] the order: position -> slot
};

__host__ __device__ __forceinline__ size_t round16(size_t b) {
  return (b + 15) & ~(size_t)15;
}

__host__ __device__ __forceinline__ int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline size_t warp_mem_bytes(int N, int R, int Q,
                                                 bool order) {
  size_t b = kScratchBytes + round16(4 * (size_t)N * R) + round16(N) +
             4 * kMaskWords;
  if (order) {
    const size_t P = pow2_at_least(Q);
    b += round16(8 * P) + round16(2 * P);
  }
  return b;
}

__device__ __forceinline__ WarpMem warp_mem(int N, int R, int Q, bool order) {
#ifdef __CUDACC__
  extern __shared__ __align__(16) char prefix_smem[];
  char* p = prefix_smem + warp_in_block() * warp_mem_bytes(N, R, Q, order);
#else
  char* p = host_smem();
#endif
  WarpMem m{};
  m.scratch = p;
  p += kScratchBytes;
  m.free = reinterpret_cast<int32_t*>(p);
  p += round16(4 * (size_t)N * R);
  m.act = reinterpret_cast<uint8_t*>(p);
  p += round16(N);
  m.mask = reinterpret_cast<uint32_t*>(p);
  p += 4 * kMaskWords;
  if (order) {
    const size_t P = pow2_at_least(Q);
    m.key = reinterpret_cast<long long*>(p);
    p += round16(8 * P);
    m.idx = reinterpret_cast<int16_t*>(p);
  }
  return m;
}

// A launch's shape: `warps` warps (clusters) a block, `warp_bytes` of
// dynamic shared memory a warp.
struct Geometry {
  int warps;
  size_t warp_bytes;
  int blocks(int C) const { return (C + warps - 1) / warps; }
  size_t smem() const { return warps * warp_bytes; }
};

inline Geometry geometry(int C, int L, int N, int R, int Q, bool order) {
  const size_t b = warp_mem_bytes(N, R, Q, order);
  return Geometry{warps_for(C, L, b), b};
}

// Launch `kernel` on `blocks` x `L` blocks (a row of blocks a batch lane)
// of `warps` warps with `smem` bytes of dynamic shared memory (warps_for
// keeps it within the default 48 KB). A host build runs the warps one
// after another, each as one call. Returns false where the launch cannot
// be made.
template <class A>
inline bool launch_warps(void (*kernel)(A), int blocks, int L, int warps,
                         size_t smem, cudaStream_t stream, const A& a) {
  if (L < 1 || L > 65535) return false;  // the grid's second dimension
#ifdef __CUDACC__
  kernel<<<dim3(blocks, L), warps * kLanes, smem, stream>>>(a);
#else
  (void)stream;
  if (smem / warps > kHostSmem) return false;
  gridDim.x = blocks;
  gridDim.y = L;
  blockDim.x = warps * kLanes;
  for (int bl = 0; bl < L; ++bl) {
    for (int b = 0; b < blocks; ++b) {
      for (int w = 0; w < warps; ++w) {
        blockIdx.x = b;
        blockIdx.y = bl;
        threadIdx.x = w * kLanes;
        kernel(a);
      }
    }
  }
#endif
  return true;
}

// ---------------------------------------------------------------------------
// Rows, a lane a row or a field.
// ---------------------------------------------------------------------------

struct Row {
  int32_t v[NF];
};
static_assert(NF == RF, "queue and running rows share Row");

// row[f] for a field index that differs by lane, without indexing a local
// array at run time (which would put it in local memory).
__device__ __forceinline__ int32_t field_at(const int32_t* row, int f) {
  int32_t v = 0;
#pragma unroll
  for (int i = 0; i < NF; ++i) v = i == f ? row[i] : v;
  return v;
}

// Does v fit a column of `size` bytes (store_checked_as stores it as is)?
__device__ __forceinline__ bool fits_size(int size, int32_t v) {
  return size == 4 || (size == 2 ? v == (int16_t)v : v == (int8_t)v);
}

// Row i of `rows` set to `row`, one field a lane; `checked`: the checked
// narrow store, returning how many fields were clamped (in every lane).
template <int W>
__device__ int store_row(const Rows<W>& rows, int i, const int32_t* row,
                         bool checked) {
  PerLane<int> bad;
  lanes([&](int l) {
    bad[l] = 0;
    if (l >= W) return;
    const int32_t v = field_at(row, l);
    if (checked) {
      bad[l] = rows.set_checked(i, l, v);
    } else {
      rows.set(i, l, v);
    }
  });
  const int32_t n = reduce_add([&](int l) { return bad[l]; });
  sync();
  return n;
}

// Rows [from, to) of a queue set INVALID, a lane a row.
__device__ inline void fill_invalid(const QueueRows& q, int from, int to) {
  strided(to - from, [&](int, int k) {
    q.fill(from + k, from + k + 1, QueueInvalid{});
  });
  sync();
}

// Rows [0, n) of a queue rewritten from rows src(i) >= i, 32 at a time:
// each lane reads its row into registers, the warp syncs, each writes.
template <class Src>
__device__ void move_down(const QueueRows& q, int n, Src src) {
  for (int i0 = 0; i0 < n; i0 += kLanes) {
    PerLane<Row> row;
    lanes([&](int l) {
      if (i0 + l < n) q.load(src(i0 + l), row[l].v);
    });
    sync();
    lanes([&](int l) {
      if (i0 + l < n) q.store(i0 + l, row[l].v);
    });
  }
  sync();
}

// pop_front_n of a queue holding `count` rows: rows [n, count) move to the
// front, a lane a row, and every row from the new count on becomes INVALID
// (those past the old count are). Returns the new count.
__device__ inline int pop_front_n(const QueueRows& q, int count, int n) {
  n = imin(n, count);
  if (n <= 0) return count;
  const int newcount = count - n;
  move_down(q, newcount, [&](int i) { return i + n; });
  fill_invalid(q, newcount, count);
  return newcount;
}

// Stable-remove the slots `mask` marks (the sweep's placements) from the
// queue's first `count` rows; rows from the new count on become INVALID.
// Each kept row's destination is the count of kept rows before it (the
// popc prefix of the mask's complement, a 32-row word at a time). Returns
// the new count.
__device__ inline int compact_placed(const QueueRows& q, int count,
                                     int placed, const uint32_t* mask) {
  if (placed == 0) return count;
  int kept = 0;
  for (int i0 = 0; i0 < count; i0 += kLanes) {
    const uint32_t live =
        count - i0 >= kLanes ? kFull : (1u << (count - i0)) - 1u;
    const uint32_t keep = ~mask[i0 >> 5] & live;
    PerLane<Row> row;
    lanes([&](int l) {
      if ((keep >> l & 1u) && kept + rank(keep, l) != i0 + l) {
        q.load(i0 + l, row[l].v);
      }
    });
    sync();
    lanes([&](int l) {
      const int d = kept + rank(keep, l);
      if ((keep >> l & 1u) && d != i0 + l) q.store(d, row[l].v);
    });
    kept += popc(keep);
  }
  sync();
  fill_invalid(q, kept, count);
  return kept;
}

// Does one of the first n rows of q demand a negative amount?
__device__ inline bool any_negative_demand(const QueueRows& q, int n) {
  for (int i0 = 0; i0 < n; i0 += kLanes) {
    const uint32_t neg = ballot([&](int l) {
      const int i = i0 + l;
      return i < n && (q.get(i, FCORES) < 0 || q.get(i, FMEM) < 0 ||
                       q.get(i, FGPU) < 0);
    });
    if (neg != 0u) return true;
  }
  return false;
}

// An order over precomputed positions (the warp's BFD order in shared
// memory), for the serial steps that take an Order (wave_place, sweep).
struct ArrayOrder {
  const int16_t* idx;
  int p = 0;
  __host__ __device__ int next(const QueueRows&, int) { return idx[p++]; }
};

// What a sweep replayed on lane 0 hands back to the warp.
struct SweepOut {
  SweepAcc acc;
  int slot, n_active, placed;
};

// What the FIFO drain replayed on lane 0 hands back.
struct DrainOut {
  int run_full, n_taken, any_fail, slot, n_active, placed;
  Row job;
};

// ---------------------------------------------------------------------------
// One cluster carried by a warp: its node words in shared memory, its
// running set walked by the lanes. The cursor and counts are uniform.
// ---------------------------------------------------------------------------

struct WarpCluster {
  const Common& a;
  int c;
  WarpMem m;
  RunRows run;
  uint8_t* ract;
  int32_t arr_ptr;   // the arrival cursor and count, read at entry
  int32_t arr_n;
  int slot = 0;      // every running slot below it is active
  int n_active = 0;  // active running slots, after release
  int placed = 0;    // placements this tick

  // The node free words (widened: the span-entry widen of narrow node
  // columns, core/engine.py _widen_nodes) and active flags into shared
  // memory; the arrival cursor and count read in the same round trip.
  __device__ WarpCluster(const Common& args, int cluster, const WarpMem& mem)
      : a(args), c(cluster), m(mem),
        run(&args.run, (size_t)cluster * args.S),
        ract(args.run_active + (size_t)cluster * args.S),
        arr_ptr(args.arr_ptr[cluster]), arr_n(args.counts[cluster]) {
    const int size = a.node_size;
    const char* src = static_cast<const char*>(a.node_free) +
                      (size_t)c * a.N * a.R * size;
    strided(a.N * a.R, [&](int, int i) {
      m.free[i] = load_as(src + (size_t)i * size, size);
    });
    stage_active();
  }

  // The node active flags into shared memory: at entry, and again after
  // the fault step changed them.
  __device__ void stage_active() {
    const uint8_t* act = a.node_active + (size_t)c * a.N;
    strided(a.N, [&](int, int n) { m.act[n] = act[n]; });
    sync();
  }

  // The free words back to the node columns at the span's exit: on narrow
  // columns the checked exit narrow (core/engine.py _narrow_nodes),
  // returning how many words did not fit (in every lane). The capacity
  // words need no store: no step of a terminal prefix writes them.
  __device__ int store_nodes() {
    const int size = a.node_size;
    char* dst = static_cast<char*>(a.node_free) +
                (size_t)c * a.N * a.R * size;
    PerLane<int> bad;
    lanes([&](int l) { bad[l] = 0; });
    strided(a.N * a.R, [&](int l, int i) {
      bad[l] += store_checked_as(dst + (size_t)i * size, size, m.free[i]);
    });
    const int32_t n = reduce_add([&](int l) { return bad[l]; });
    sync();
    return n;
  }

  // A Cluster over the warp's node words, with the warp's cursor and
  // counts, for a step that runs on lane 0.
  __device__ Cluster lane_cluster() const {
    Cluster cl(a, c, m.free, Cluster::Words{});
    cl.slot = slot;
    cl.n_active = n_active;
    cl.placed = placed;
    return cl;
  }

  __device__ void absorb(int slot_, int n_active_, int placed_) {
    slot = slot_;
    n_active = n_active_;
    placed = placed_;
  }

  __device__ bool is_return(int s) const {
    return ract[s] && run.get(s, REND) <= a.t && run.get(s, ROWNER) >= 0;
  }

  // Release, the lanes over the running slots: a due slot (end_t <= t)
  // gives its resources back to its node (shared-memory atomics: int32
  // wrapping adds, exact in any order) and becomes an INVALID, inactive
  // row; the others are counted. The emit form packs the return
  // messages in the reference's order: first the due slots owned by a
  // borrower, in slot order, then every other slot (its pre-release row),
  // in slot order, up to M — each lane's position the count of such slots
  // before it (a ballot's prefix); returns past M count into drops.msgs.
  template <bool kEmit>
  __device__ void release(const Emit* e) {
    const int S = a.S, R = a.R;
    int32_t* out = nullptr;
    uint8_t* valid = nullptr;
    int m_pos = 0;  // the next message slot
    if (kEmit) {
      out = e->ret_rows + (size_t)c * e->M * RF;
      valid = e->ret_valid + (size_t)c * e->M;
      int n_ret = 0;
      for (int s0 = 0; s0 < S; s0 += kLanes) {
        const uint32_t ret = ballot([&](int l) {
          return s0 + l < S && is_return(s0 + l);
        });
        lanes([&](int l) {
          const int pos = m_pos + rank(ret, l);
          if ((ret >> l & 1u) && pos < e->M) {
            run.load(s0 + l, out + (size_t)pos * RF);
            valid[pos] = 1;
          }
        });
        n_ret += popc(ret);
        m_pos = imin(n_ret, e->M);
      }
      const int dropped = imax(n_ret - e->M, 0);
      if (dropped > 0) lane0([&] { e->drop_msgs[c] += dropped; });
    }
    PerLane<int> alive;
    lanes([&](int l) { alive[l] = 0; });
    for (int s0 = 0; s0 < S; s0 += kLanes) {
      uint32_t other = 0u;
      if (kEmit && m_pos < e->M) {
        other = ballot([&](int l) {
          return s0 + l < S && !is_return(s0 + l);
        });
      }
      lanes([&](int l) {
        const int s = s0 + l;
        if (s >= S) return;
        if (kEmit && (other >> l & 1u)) {
          const int pos = m_pos + rank(other, l);
          if (pos < e->M) {
            run.load(s, out + (size_t)pos * RF);
            valid[pos] = 0;
          }
        }
        if (!ract[s]) return;
        if (run.get(s, REND) <= a.t) {
          const int node = imin(imax(run.get(s, RNODE), 0), a.N - 1);
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            if (r < R) {
              atomic_add(&m.free[node * R + r], run.get(s, RCORES + r));
            }
          }
          set_run_invalid(run, s);
          ract[s] = 0;
        } else {
          ++alive[l];
        }
      });
      m_pos += popc(other);
    }
    n_active = reduce_add([&](int l) { return alive[l]; });
    sync();
  }

  // Vnode expiry (core/engine.py _expire_vnodes_local), a lane a node
  // slot: every active node whose contract has ended (expire <= t) goes
  // inactive, its capacity and free zeroed and its expiry back to NEVER.
  // Expiry needs the trader, which is never terminal: the node columns are
  // the engine's widened int32 ones.
  __device__ void expire(const Expire& x) {
    uint8_t* act = a.node_active + (size_t)c * a.N;
    int32_t* cap = x.node_cap + (size_t)c * a.N * a.R;
    int32_t* until = x.node_expire + (size_t)c * a.N;
    strided(a.N, [&](int, int n) {
      if (!m.act[n] || until[n] > a.t) return;
      act[n] = 0;
      m.act[n] = 0;
      for (int r = 0; r < a.R; ++r) {
        cap[n * a.R + r] = 0;
        m.free[n * a.R + r] = 0;
      }
      until[n] = NEVER;
    });
    sync();
  }

  // The fault phase (Cluster::faults) on lane 0, over the shared node
  // words, then the changed active flags staged; adds its queue drops to
  // *drop_queue and sets *n_ingest, the requeues into `tgt` (in every
  // lane).
  __device__ void faults(const Faults& f, const QueueTable& tgt,
                         int32_t* tgt_count, int* drop_queue,
                         int* n_ingest) {
    const int2 out = from_lane0<int2>(m.scratch, [&] {
      Cluster cl = lane_cluster();
      int dq = 0, ni = 0;
      cl.faults(f, tgt, tgt_count, &dq, &ni);
      return int2{dq, ni};
    });
    stage_active();
    *drop_queue += out.x;
    *n_ingest = out.y;
  }

  // Ingest: append this tick's arrivals to queue `qt` holding `count` rows,
  // a lane a row through the checked store (the reference's push_many,
  // counted into the queue's ovf); rows past its capacity count into
  // `*drop_queue`. Tick-indexed (window < 0): the first counts[c] rows of
  // the tick's slice, the cursor advancing by the full count. Windowed
  // (core/engine.py _ingest_local): the stream's rows from the cursor on
  // that are due (enq_t <= t), nondecreasing in enq_t, so a prefix found
  // 32 rows at a time by ballot, of which the first `window` are taken,
  // the rest counting into drops.ingest. `*arrived` is the cursor's
  // advance. Returns the new count.
  __device__ int ingest(const QueueTable& qt, int count, int* drop_queue,
                        int* arrived) {
    const int32_t* arows = a.rows + (size_t)c * a.K * NF;
    int cnt, n_take;
    if (a.window >= 0) {
      const int start = imax(arr_ptr, 0);
      const int end = imin(arr_n, a.K);
      int due = 0;
      for (int i0 = start; i0 < end; i0 += kLanes) {
        const uint32_t stop = ballot([&](int l) {
          const int i = i0 + l;
          return i >= end || arows[(size_t)i * NF + FENQ] > a.t;
        });
        if (stop != 0u) {
          due += ffs(stop) - 1;
          break;
        }
        due += kLanes;
      }
      cnt = n_take = imin(due, a.window);
      if (due > cnt) lane0([&] { a.drop_ingest[c] += due - cnt; });
      arows += (size_t)start * NF;
    } else {
      cnt = arr_n;
      n_take = imin(imax(cnt, 0), a.K);
    }
    const int room = a.Q - count;
    *drop_queue += imax(n_take - room, 0);
    const int added = imin(n_take, room);
    const QueueRows q = queue_rows(qt, c, a.Q);
    PerLane<int> bad;
    lanes([&](int l) { bad[l] = 0; });
    strided(added, [&](int l, int k) {
      bad[l] += q.store_checked(count + k, arows + (size_t)k * NF);
    });
    const int32_t n_bad = reduce_add([&](int l) { return bad[l]; });
    lane0([&] {
      q.count(c, n_bad);
      if (cnt != 0) a.arr_ptr[c] = wrap_add(arr_ptr, cnt);
    });
    *arrived = cnt;
    return count + added;
  }

  // First fit: the lowest active node whose free words cover the job, or
  // -1; a lane a node, 32 nodes at a time.
  __device__ int first_fit(const int32_t* job) const {
    for (int n0 = 0; n0 < a.N; n0 += kLanes) {
      const uint32_t fit = ballot([&](int l) {
        const int n = n0 + l;
        return n < a.N && m.act[n] && fits(m.free + n * a.R, a.R, job);
      });
      if (fit != 0u) return n0 + ffs(fit) - 1;
    }
    return -1;
  }

  // Start `job` on `node` (Cluster::place): its resources off the node,
  // its running row into the lowest inactive slot (found by ballot from
  // the cursor, 32 slots at a time), a field a lane, counted and traced.
  __device__ void place(const int32_t* job, int node, int32_t src) {
    int s = slot;
    uint32_t idle;
    while ((idle = ballot([&](int l) {
              return s + l < a.S && !ract[s + l];
            })) == 0u) {
      s += kLanes;  // the caller checked n_active < S: a slot is free
    }
    s += ffs(idle) - 1;
    const int32_t row[RF] = {wrap_add(a.t, job[FDUR]), node, job[FCORES],
                             job[FMEM], job[FGPU], job[FID], job[FOWNER],
                             job[FDUR], job[FENQ], job[FRETRIES]};
    lanes([&](int l) {
      if (l < a.R) {
        const int32_t d = l == 0 ? job[FCORES] : (l == 1 ? job[FMEM]
                                                         : job[FGPU]);
        m.free[node * a.R + l] = wrap_sub(m.free[node * a.R + l], d);
      }
      if (l < RF) run.set(s, l, field_at(row, l));
      if (l != 0) return;
      ract[s] = 1;
      if (!a.record_trace) return;
      const int32_t n = a.tr_n[c];
      if (n < a.E) {
        const size_t i = (size_t)c * a.E + n;
        a.tr_t[i] = a.t;
        a.tr_job[i] = job[FID];
        a.tr_node[i] = node;
        a.tr_src[i] = src;
        a.tr_n[c] = n + 1;
      }
    });
    slot = s + 1;
    ++n_active;
    ++placed;
    sync();
  }

  // One attempt on the first-fit node, or on a node already picked (-1:
  // none fits), with the has-slot check (prefix_common.cuh
  // Cluster::attempt_on).
  __device__ bool attempt(const int32_t* job, int32_t src, int* run_full) {
    return attempt_on(job, first_fit(job), src, run_full);
  }
  __device__ bool attempt_on(const int32_t* job, int node, int32_t src,
                             int* run_full) {
    if (node < 0) return false;
    if (n_active >= a.S) {
      ++*run_full;
      return false;
    }
    place(job, node, src);
    return true;
  }

  // The reference's wave drain replayed (prefix_common.cuh
  // fifo_drain_waves) on lane 0.
  __device__ void drain_waves(const QueueRows& q, int lim, int* run_full,
                              int* n_taken, bool* any_fail, int32_t* job) {
    const DrainOut o = from_lane0<DrainOut>(m.scratch, [&] {
      Cluster cl = lane_cluster();
      DrainOut r{};
      bool fail = false;
      fifo_drain_waves(cl, q, lim, &r.run_full, &r.n_taken, &fail, r.job.v);
      r.any_fail = fail;
      r.slot = cl.slot;
      r.n_active = cl.n_active;
      r.placed = cl.placed;
      return r;
    });
    absorb(o.slot, o.n_active, o.placed);
    *run_full += o.run_full;
    *n_taken = o.n_taken;
    *any_fail = o.any_fail != 0;
#pragma unroll
    for (int f = 0; f < NF; ++f) job[f] = o.job.v[f];
  }

  // The best-fit-decreasing order of q's `count` rows, valid slots by
  // (-key1, -key2, slot) with key1 = cores and key2 = mem, or swapped with
  // `mem_first`, into m.idx: the keys of every live row staged in shared
  // memory as one int64 each, (-key1) in the high word and (-key2) biased
  // in the low one, so that the int64 order with the slot as the last key
  // is the reference's stable one; keys stay full int32 (a clamped
  // demand negates to a positive key). The sweep never changes the keys,
  // so the order is computed before it, by a warp bitonic sort of all the
  // rows (P the power of two >= count, padded with kNoKey).
  __device__ void bfd_order(const QueueRows& q, int count, int n,
                            int mem_first) {
    if (n <= 0) return;
    const int f1 = mem_first ? FMEM : FCORES, f2 = mem_first ? FCORES : FMEM;
    const int P = pow2_at_least(count);
    strided(P, [&](int, int i) {
      long long k = kNoKey;
      if (i < count) {
        const uint32_t k1 = (uint32_t)wrap_sub(0, q.get(i, f1));
        const uint32_t k2 = (uint32_t)wrap_sub(0, q.get(i, f2)) ^ 0x80000000u;
        k = (long long)(((unsigned long long)k1 << 32) | k2);
      }
      m.key[i] = k;
      m.idx[i] = (int16_t)i;
    });
    sync();
    bitonic_sort(P);
  }

  // Ascending (key, slot) over m.key / m.idx [0, P): each stage's
  // compare-exchanges are disjoint pairs, a lane a pair.
  __device__ void bitonic_sort(int P) {
    for (int k = 2; k <= P; k <<= 1) {
      for (int j = k >> 1; j > 0; j >>= 1) {
        strided(P >> 1, [&](int, int h) {
          const int i = ((h & ~(j - 1)) << 1) | (h & (j - 1));
          const int o = i + j;
          const Key x{m.key[i], m.idx[i]}, y{m.key[o], m.idx[o]};
          if (key_less(y, x) == ((i & k) == 0)) {
            m.key[i] = y.k;
            m.idx[i] = (int16_t)y.i;
            m.key[o] = x.k;
            m.idx[o] = (int16_t)x.i;
          }
        });
        sync();
      }
    }
  }

  // The scored pick: the node whose score(n) ranks first (ranks_before),
  // infeasible nodes at -inf and in the reduction (so with every feasible
  // node at -inf too the pick is node 0, fit or not, as the reference's
  // argmax), -1 when no node fits; a lane a node, 32 nodes a round, the
  // best carried across rounds.
  template <class Score>
  __device__ int scored_fit(const int32_t* job, const Score& score) const {
    Scored best{-INFINITY, INT32_MAX};  // ranks after every node
    bool any = false;
    for (int n0 = 0; n0 < a.N; n0 += kLanes) {
      auto ok = [&](int l) {
        const int n = n0 + l;
        return n < a.N && m.act[n] && fits(m.free + n * a.R, a.R, job);
      };
      any = any || ballot(ok) != 0u;
      const Scored r = best_of([&](int l) {
        return Scored{ok(l) ? score(n0 + l) : -INFINITY, n0 + l};
      });
      if (ranks_before(r, best)) best = r;
    }
    return any ? best.i : -1;
  }

  // The serial sweep (prefix_common.cuh sweep) over the first n positions
  // of an order over q's `count` rows — m.idx where `ordered` (the BFD
  // order), else queue order (position p is slot p) — uniform: each job
  // records its wait (the rec_wait store, checked, by lane 0), is
  // attempted on the node `pick` chooses, and a placed slot is marked in
  // m.mask; with `skip` (DELAY's parity quirk) a success passes over the
  // next position. Where a clamp reached the queue and a swept row demands
  // a negative amount, lane 0 replays the reference's waves instead (the
  // serial `sweep` of prefix_common.cuh, over the same order): only the
  // first-fit picks have a wave form.
  template <class Pick>
  __device__ void sweep(const QueueRows& q, int count, int n, int32_t src,
                        bool ordered, bool wave, bool may_replay, bool skip,
                        const Pick& pick, SweepAcc& acc) {
    strided(kMaskWords, [&](int, int w) { m.mask[w] = 0u; });
    sync();
    const int before = placed;
    if constexpr (Pick::kWaves) {
      if (wave && may_replay && a.N <= kMaxNarrowNodes &&
          warp::any_negative_demand(q, ordered ? count : n)) {
        const SweepOut o = from_lane0<SweepOut>(m.scratch, [&] {
          Cluster cl = lane_cluster();
          SweepAcc r = acc;
          if (ordered) {
            ArrayOrder order{m.idx};
            prefix::sweep(cl, q, count, n, order, FirstFitPick{}, src, true,
                          true, skip, r, m.mask);
          } else {
            QueueOrder order;
            prefix::sweep(cl, q, count, n, order, FirstFitPick{}, src, true,
                          true, skip, r, m.mask);
          }
          return SweepOut{r, cl.slot, cl.n_active, cl.placed};
        });
        acc = o.acc;
        absorb(o.slot, o.n_active, o.placed);
        return;
      }
    }
    const bool narrow = q.rp == nullptr;
    const int rec_size = narrow ? q.t->f[FREC].size : 4;
    bool skipping = false;
    for (int p = 0; p < n; ++p) {
      if (skipping) {
        skipping = false;
        continue;
      }
      const int i = ordered ? m.idx[p] : p;
      int32_t job[NF];
      q.load(i, job);
      record_wait(job, a.t, wave, acc);
      acc.bad += fits_size(rec_size, job[FREC]) ? 0 : 1;
      lanes([&](int l) {
        if (l == 0) q.set_checked(i, FREC, job[FREC]);
      });
      if (attempt_on(job, pick(*this, job), src, &acc.run_full)) {
        lanes([&](int l) {
          if (l == 0) m.mask[i >> 5] |= 1u << (i & 31);
        });
        skipping = skip;
      }
    }
    if (wave) acc.total = acc.total + (float)acc.wave_sum;
    acc.placed = placed - before;
    sync();
  }
};

// The first-fit pick of the warp, by ballot (FFD, DELAY).
struct FirstFit {
  static constexpr bool kWaves = true;
  __device__ int operator()(const WarpCluster& cl, const int32_t* job) const {
    return cl.first_fit(job);
  }
};

// The emit form's borrow request of a kind that never borrows (the
// Level0 kinds): want false and a zero row, as the reference's _zero_io.
__device__ __forceinline__ void emit_no_borrow(const Emit& e, int c) {
  lanes([&](int l) {
    if (l < NF) e.bjob[(size_t)c * NF + l] = 0;
    if (l == 0) e.want[c] = 0;
  });
}

// The Level0 span of cluster c, carried by the calling warp (FFD and the
// scored kinds): release, ingest into Level0, the sweep over the first
// min(|L0|, QC) positions of the BFD order (`mem_first` its first key: 0
// cores, 1 mem; -1 for queue order, which stages no keys) with `pick`,
// the compaction, and the counters; the emit form also packs the returns
// and writes no borrow request, the expire form expires the ended virtual
// nodes between release and ingest, and the faults form opens with the
// fault phase, its requeues into Level0 counted as re-arrivals in
// wait_jobs and jobs_in_queue. Returns the node exit narrow's count (in
// every lane).
template <bool kEmit, bool kExpire, bool kFaults, class Pick>
__device__ __forceinline__ int level0_prefix(const Level0Args& q,
                                             const Emit& e, const Expire& x,
                                             const Faults& f, int c,
                                             const WarpMem& m, int mem_first,
                                             const Pick& pick) {
  const Common& k = q.k;
  // Level0's count and the wait total, read before the entry's other
  // loads complete
  int count = q.l0_count[c];
  SweepAcc acc(q.wait_total[c]);
  WarpCluster cl(k, c, m);
  const QueueRows l0 = queue_rows(q.l0, c, k.Q);
  int drop_queue = 0;
  int requeued = 0;
  if (kFaults) {
    cl.faults(f, q.l0, q.l0_count + c, &drop_queue, &requeued);
    count = q.l0_count[c];
  }
  cl.release<kEmit>(&e);
  if (kEmit) emit_no_borrow(e, c);
  if (kExpire) cl.expire(x);
  int arrived = 0;
  count = cl.ingest(q.l0, count, &drop_queue, &arrived);
  const int n_sweep = imin(count, k.QC);
  const bool ordered = mem_first >= 0;
  if (ordered) cl.bfd_order(l0, count, n_sweep, mem_first);
  cl.sweep(l0, count, n_sweep, SRC_L0, ordered, q.wave != 0,
           clamped(q.l0, c), false, pick, acc);
  const int kept = compact_placed(l0, count, acc.placed, m.mask);
  const int placed = cl.placed;
  lane0([&] {
    // counters move only by what the tick added (no read when nothing)
    const int entered = arrived + requeued;
    if (entered != 0) q.wait_jobs[c] += entered;
    if (entered != placed) q.jobs_in_queue[c] += entered - placed;
    q.l0_count[c] = kept;
    l0.count(c, acc.bad);
    q.wait_total[c] = acc.total;
    if (drop_queue != 0) k.drop_queue[c] += drop_queue;
    if (acc.run_full != 0) k.drop_run_full[c] += acc.run_full;
    if (placed != 0) k.placed_total[c] += placed;
  });
  return cl.store_nodes();
}

// ---------------------------------------------------------------------------
// The epilogues with a warp a cluster: lane 0 of each warp does the
// per-cluster half, the block sums its warps through shared memory, then
// each block adds its sums with integer atomics — exact in any order — and
// the last block to finish does the cross-cluster step. Every thread of
// every block calls them, those of warps past C included.
// ---------------------------------------------------------------------------

// The metrics tap of cluster c after its span (active: c < C): the
// per-cluster half (prefix_common.cuh tap_cluster) on lane 0, then the
// block's placements and depths summed and its depth buckets counted, added
// with integer atomics; the last block to finish writes the ring slot (its
// value rows, the clock) and the tick count and zeroes the scratch for the
// next launch. All of it per batch lane `bl`: each lane has its own buffer
// (its histogram, ring and tick count), its own three scratch words and
// its own count of blocks done, and its last block is the last of the
// lane's gridDim.x blocks; `c` is the cluster's index over the batch. A call, not inlined: inlined into the one-thread scored
// kernel of earlier versions, nvcc compiled the tesserae branch's Level0
// compaction wrong in the faults form (a placed slot stayed in Level0; the
// comparison with the plain version on the card caught it).
static __device__ __noinline__ void tap_epilogue(const Tap& p,
                                                 const Common& k, int bl,
                                                 int c, bool active) {
  // the lane's cross-cluster leaves and scratch
  int32_t* const scratch = p.scratch + 3 * bl;
  int32_t* const hist = p.depth_hist + bl * kDepthBuckets;
  const int ring = bl * kObsRing + p.slot;
#ifdef __CUDACC__
  __shared__ int32_t s_placed[kMaxWarps], s_depth[kMaxWarps];
  __shared__ int s_bucket[kMaxWarps];
  if (lane_id() == 0) {
    int32_t placed_d = 0, depth = 0;
    int bucket = -1;
    if (active) tap_cluster(p, k, c, &placed_d, &depth, &bucket);
    s_placed[warp_in_block()] = placed_d;
    s_depth[warp_in_block()] = depth;
    s_bucket[warp_in_block()] = bucket;
  }
  __syncthreads();
  if (threadIdx.x >= kLanes) return;
  // warp 0 sums the block: lane w reads warp w's values, lane b counts
  // bucket b
  const int W = blockDim.x >> 5, l = lane_id();
  const uint32_t sum_placed =
      __reduce_add_sync(kFull, l < W ? (uint32_t)s_placed[l] : 0u);
  const uint32_t sum_depth =
      __reduce_add_sync(kFull, l < W ? (uint32_t)s_depth[l] : 0u);
  if (l < kDepthBuckets) {
    int hits = 0;
    for (int w = 0; w < W; ++w) hits += s_bucket[w] == l;
    if (hits != 0) atomicAdd(hist + l, hits);
  }
  if (l != 0) return;
  atomicAdd(reinterpret_cast<unsigned*>(scratch), sum_placed);
  atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), sum_depth);
  __threadfence();
  const unsigned done =
      atomicAdd(reinterpret_cast<unsigned*>(scratch + 2), 1u);
  if (done != gridDim.x - 1) return;
  __threadfence();  // the lane's last block: its blocks' sums are in
  p.ring_placed[ring] = atomicExch(scratch, 0);
  p.ring_depth[ring] = atomicExch(scratch + 1, 0);
  scratch[2] = 0;
#else
  // a host build runs the warps one after another
  if (active) {
    int32_t placed_d, depth;
    int bucket;
    tap_cluster(p, k, c, &placed_d, &depth, &bucket);
    scratch[0] = wrap_add(scratch[0], placed_d);
    scratch[1] = wrap_add(scratch[1], depth);
    hist[bucket] += 1;
  }
  if (++scratch[2] != (int32_t)(gridDim.x * (blockDim.x / kLanes))) return;
  p.ring_placed[ring] = scratch[0];
  p.ring_depth[ring] = scratch[1];
  scratch[0] = scratch[1] = scratch[2] = 0;
#endif
  p.ring_t[ring] = k.t;
  p.ticks[bl] += 1;
}

// The node exit narrow's total added to cluster c's run.ovf (and with the
// tap to its buffer's and cursor's ovf); c indexes the whole batch.
__device__ __forceinline__ void apply_exit_total(const Common& k,
                                                 const Tap& p, bool tap,
                                                 int c, int32_t total) {
  k.run.ovf[c] = wrap_add(k.run.ovf[c], total);
  if (tap) {
    p.ovf[c] = wrap_add(p.ovf[c], total);
    p.c_ovf[c] = wrap_add(p.c_ovf[c], total);
  }
}

// The cross-cluster half of the terminal node exit narrow (core/engine.py
// _narrow_nodes), after the span and the tap: the reference counts the
// free and capacity words that do not fit over the WHOLE constellation and
// adds that one total to every cluster's run.ovf (and so, through the
// tap's ovf reading, to the buffer's ovf and the cursor's). Under the lane
// axis a constellation is a batch lane, never the batch: `bad` is the
// warp's count; each block adds its warps' counts atomically into its
// lane's two scratch words, and the last of the lane's blocks applies a
// nonzero total to every cluster of the lane and zeroes the lane's
// scratch for the next launch. Each thread fences its own stores first,
// so the last block reads them. A call, like tap_epilogue.
static __device__ __noinline__ void node_exit_epilogue(const Common& k,
                                                       const Tap& p, bool tap,
                                                       int bl, int bad) {
  int32_t* const scratch = k.exit_scratch + 2 * bl;
  const int c0 = bl * k.C;
#ifdef __CUDACC__
  __shared__ int32_t s_bad[kMaxWarps];
  __shared__ int32_t s_total;
  __threadfence();  // each thread's stores, for the last block to read
  if (lane_id() == 0) s_bad[warp_in_block()] = bad;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t sum = 0u;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) sum += (uint32_t)s_bad[w];
    if (sum != 0u) {
      atomicAdd(reinterpret_cast<unsigned*>(scratch), sum);
    }
    __threadfence();
    const unsigned done =
        atomicAdd(reinterpret_cast<unsigned*>(scratch + 1), 1u);
    int32_t total = 0;
    if (done == gridDim.x - 1) {
      __threadfence();  // the lane's last block: its blocks' counts are in
      total = (int32_t)atomicExch(reinterpret_cast<unsigned*>(scratch), 0u);
      scratch[1] = 0;
    }
    s_total = total;
  }
  __syncthreads();
  const int32_t total = s_total;
  if (total == 0) return;
  for (int c = threadIdx.x; c < k.C; c += blockDim.x) {
    apply_exit_total(k, p, tap, c0 + c, total);
  }
#else
  scratch[0] = wrap_add(scratch[0], bad);
  if (++scratch[1] != (int32_t)(gridDim.x * (blockDim.x / kLanes))) {
    return;
  }
  const int32_t total = scratch[0];
  scratch[0] = scratch[1] = 0;
  if (total == 0) return;
  for (int c = 0; c < k.C; ++c) apply_exit_total(k, p, tap, c0 + c, total);
#endif
}

}  // namespace warp
}  // namespace prefix
