"""The sinkhorn round's numerics: the kernel matrix, the masked Sinkhorn
iterations and the plan, every float step in the order the reference
engine's compiled CPU program takes it (``multi_cluster_simulator_tpu/
market/trader.py:300-321``, compiled with ``PolicyParams`` traced, as
``Engine.run`` compiles it).

Two forms compute the same bits. ``sinkhorn_plain`` is PyTorch ops: the CPU
path, and on the card only the yardstick. ``sinkhorn_kernel`` launches the
hand-written CUDA source ``kernels/csrc/sinkhorn_round.cu``: the card's
path, with no fallback (it raises if the build or a launch fails).

The two products of an iteration follow reduction plans (``Stage``) read
from XLA's code for the round (``XLA_FLAGS=--xla_dump_to=DIR
--xla_dump_hlo_as_text`` over ``Engine.run``, jax 0.9.0, an AVX-512 x86
CPU; the ``*after_optimizations.txt`` HLO, the ``*.ir-with-opt.ll`` and
the object files' ``objdump -d``):

- ``K @ vc`` is XLA's row-major tiled gemv (``row_major_gemv_F32_8_8_*``)
  at every width: ``gemv_plan``.
- ``K.T @ u`` is a loop fusion (transpose, copy and dot), vectorized by
  LLVM over the sellers (``fused_dot_plan``), below 4,096 sellers; from
  there XLA copies K transposed and runs the tiled gemv over it
  (``GEMV_MIN_SELLERS``).

``1 / max(., 1e-30)`` and the ``where(act, ...)`` stay outside both
products (their own fusions, a true division). The kernel matrix is
``xla_exp_f32(fma(jitter, 0.5 eps, v) / eps)`` with ``eps`` traced: a
division, not XLA's product with a constant ``1 / eps``.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import torch

from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32, xla_exp_f32

F32 = torch.float32
TINY = 1e-30
# From this many sellers (the contracted axis) XLA copies K transposed and
# runs ``K.T @ u`` as the tiled gemv (read at 4,096 x 4,096; a loop fusion
# at 4,095 x 4,096, 2,048 x 4,096, 2,048 x 8,192 and 1,024 x 16,384).
GEMV_MIN_SELLERS = 4096
# The kernel's source (kernels/build.py) and the reference lines it replaces.
SOURCE = "multi_cluster_simulator_tpu_torch/kernels/csrc/sinkhorn_round.cu"
REPLACES = "multi_cluster_simulator_tpu/market/trader.py:308"
# Each wrapper's launches since the last ``reset_launches``: one a kernel
# it launches; ``sinkhorn_round`` counts the rounds ``sinkhorn_kernel`` ran.
LAUNCHES: collections.Counter = collections.Counter()


def reset_launches() -> None:
    LAUNCHES.clear()


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage of a reduction over a row's values times a vector.

    ``blocks[a]`` lists, in chain order, the first index of each step of
    accumulator ``a``; its lane ``l`` (of ``lanes``) takes index
    ``block + l``: a chain of fused multiply-adds from 0, or, when
    ``seeded``, lane 0 of accumulator 0 from the running value. The
    accumulators are summed lane by lane in order, ``((a0 + a1) + a2) +
    a3``, then folded across lanes: by the tiled gemv's horizontal sums
    (``_tree8``) for outputs below ``tree_rows``, else by halving. The
    stage's value replaces the running value, or with ``add`` is added to
    it."""

    lanes: int
    blocks: tuple
    seeded: bool = False
    add: bool = False
    tree_rows: int = 0


def gemv_plan(n: int, rows: int) -> tuple:
    """XLA's row-major tiled gemv over [rows, n] (8 x 8 tiles): 8 lanes
    take the columns below the last multiple of 8, a row in a whole tile
    of 8 rows folds them by the AVX horizontal sums, a row past it by
    halving, and the remaining columns are a chain of their own from 0,
    added last."""
    main = 8 * (n // 8)
    stages = []
    if main:
        stages.append(Stage(8, (tuple(range(0, main, 8)),),
                            tree_rows=8 * (rows // 8)))
    if n > main:
        stages.append(Stage(1, (tuple(range(main, n)),), add=bool(main)))
    return tuple(stages)


def _epilogue_lanes(r: int) -> int:
    """The vector width LLVM's epilogue takes for ``r`` values left after
    the main vector body (read over r = 0-31 at 50-1,100 sellers)."""
    if r < 2:
        return 0
    if r < 4:
        return 2
    return 4 if r < 8 or 12 <= r < 16 or 20 <= r < 24 else 8


def fused_dot_plan(n: int) -> tuple:
    """The order of the loop XLA fuses ``K.T @ u`` into, a reduction over
    ``n`` sellers:

    - below 50: one chain in index order (the loop over the sellers is
      unrolled whole and the buyers' loop vectorized);
    - 50-63: two 8-lane accumulators over 48 values, 64-127: four over
      the largest multiple of 32, unrolled whole into ONE chain: the first
      accumulator's blocks in order, then each other one's with its first
      two blocks swapped (LLVM's reassociation);
    - from 128: four 8-lane accumulators in a loop, summed lane by lane;
    - then halving, then the values left: an epilogue of 2, 4 or 8 lanes
      seeded with the sum so far and halved (``_epilogue_lanes``), then a
      chain of its own seeded likewise."""
    if n < 50:
        return (Stage(1, (tuple(range(n)),)),)
    ic, main = (2, 48) if n < 64 else (4, 32 * (n // 32))
    steps = main // (8 * ic)
    if n < 128:
        order = [8 * ic * t for t in range(steps)]
        for a in range(1, ic):
            blk = [8 * (a + ic * t) for t in range(steps)]
            blk[0], blk[1] = blk[1], blk[0]
            order += blk
        stages = [Stage(8, (tuple(order),))]
    else:
        stages = [Stage(8, tuple(tuple(range(8 * a, main, 32))
                                 for a in range(4)))]
    pos = main
    lanes = _epilogue_lanes(n - main)
    if lanes:
        nb = (n - main) // lanes
        stages.append(Stage(lanes, (tuple(range(pos, pos + lanes * nb,
                                                lanes)),), seeded=True))
        pos += lanes * nb
    if pos < n:
        stages.append(Stage(1, (tuple(range(pos, n)),), seeded=True))
    return tuple(stages)


def row_plan(c_loc: int, c_tot: int) -> tuple:
    """``K @ vc`` over [c_loc sellers, c_tot buyers]."""
    return gemv_plan(c_tot, c_loc)


def col_plan(c_loc: int, c_tot: int) -> tuple:
    """``K.T @ u``: a sum over the shard's ``c_loc`` sellers for each of
    ``c_tot`` buyers (the same on a mesh shard: the all-sum across shards
    comes after it)."""
    if c_loc >= GEMV_MIN_SELLERS:
        return gemv_plan(c_loc, c_tot)
    return fused_dot_plan(c_loc)


def group_width(plan: tuple) -> int:
    """The threads the kernel gives an output: a power of 2 at least the
    chains (accumulators x lanes) of the plan's largest stage."""
    chains = max(len(st.blocks) * st.lanes for st in plan)
    return 1 << (chains - 1).bit_length()


def pack_plan(plan: tuple):
    """The plan as the kernel reads it: a stage table [stages, 7] int32
    (lanes, accumulators, steps, seeded, add, tree_rows, offset into the
    block list) and the block list, accumulator by accumulator."""
    rows, flat = [], []
    for st in plan:
        steps = len(st.blocks[0])
        if any(len(b) != steps for b in st.blocks) or len(st.blocks) > 4 \
                or st.lanes > 8:
            raise ValueError(f"unsupported stage {st}")
        rows.append([st.lanes, len(st.blocks), steps, int(st.seeded),
                     int(st.add), st.tree_rows, len(flat)])
        for blk in st.blocks:
            flat.extend(blk)
    return (torch.tensor(rows, dtype=torch.int32).reshape(-1, 7),
            torch.tensor(flat or [0], dtype=torch.int32))


def _tree8(acc: torch.Tensor) -> torch.Tensor:
    """8 lanes reduced as XLA's tiled gemv's AVX horizontal sums do:
    ((0 + 1) + (2 + 3)) + ((4 + 5) + (6 + 7))."""
    a = acc[:, 0::2] + acc[:, 1::2]
    a = a[:, 0::2] + a[:, 1::2]
    return a[:, 0] + a[:, 1]


def _halves(acc: torch.Tensor) -> torch.Tensor:
    """Lanes reduced by halving shuffles, as a vectorized loop's reduction
    does: for 8, ((0 + 4) + (2 + 6)) + ((1 + 5) + (3 + 7))."""
    while acc.shape[1] > 1:
        h = acc.shape[1] // 2
        acc = acc[:, :h] + acc[:, h:]
    return acc[:, 0]


class PlanProduct:
    """``M @ w`` for a fixed f32 matrix ``M`` [R, n] and changing vectors
    ``w``, summed in a plan's order (``Stage``), bitwise. A zero entry of
    ``M`` adds nothing to a chain (``fma(0, w, acc) == acc`` for finite
    ``w``; the round's sums are never -0 where it would matter: each goes
    through ``max(., 1e-30)``), so each chain runs over its nonzero
    entries only, found once for the matrix."""

    def __init__(self, M: torch.Tensor, plan: tuple):
        R = M.shape[0]
        self.R, self.stages = R, []
        for st in plan:
            idx = torch.tensor([[b + l for b in blk] for blk in st.blocks
                                for l in range(st.lanes)],
                               dtype=torch.long, device=M.device)
            X = M[:, idx]  # [R, chains, steps]
            nz = X != 0
            steps = int(nz.sum(-1).max()) if X.numel() else 0
            order = torch.argsort((~nz).to(torch.int8), dim=-1,
                                  stable=True)[..., :steps]
            gi = idx.expand(R, -1, -1).gather(-1, order)
            self.stages.append((st, X.gather(-1, order), gi, steps))

    def __call__(self, w: torch.Tensor) -> torch.Tensor:
        r = None
        for st, X, gi, steps in self.stages:
            chains = X.shape[1]
            acc = torch.zeros((self.R, chains), dtype=F32, device=w.device)
            if st.seeded:
                acc[:, 0] = r
            Wg = w[gi]
            for k in range(steps):
                acc = fma_f32(X[..., k], Wg[..., k], acc)
            acc = acc.view(self.R, len(st.blocks), st.lanes)
            v = acc[:, 0]
            for a in range(1, acc.shape[1]):
                v = v + acc[:, a]
            if st.lanes == 8 and st.tree_rows:
                val = torch.cat([_tree8(v[:st.tree_rows]),
                                 _halves(v[st.tree_rows:])])
            else:
                val = _halves(v)
            r = r + val if st.add else val
        return r


def kernel_matrix(feas, jitter, v, eps) -> torch.Tensor:
    """K [s_loc, C_tot]: XLA's ``exp`` of ``fma(jitter, 0.5 eps, v) / eps``
    where a pair is feasible, 0 elsewhere."""
    score = fma_f32(jitter, (0.5 * eps).expand_as(jitter),
                    v[None, :].expand_as(jitter))
    K = torch.zeros_like(score)
    K[feas] = xla_exp_f32(score[feas] / eps)
    return K


def iterate_plain(K, iters, n_iters: int, ex, trace: bool = False):
    """The masked Sinkhorn iterations over a kernel matrix ``K`` [s_loc,
    C_tot] and the plan: ``(u, vc, plan)``, and with ``trace`` the list of
    every iteration's ``(u, vc)`` after it. ``iters`` is a 0-d tensor (the
    active depth ``mkt_sink_iters``), ``n_iters`` the static loop
    length."""
    C_loc, C_tot = K.shape
    rows = PlanProduct(K, row_plan(C_loc, C_tot))
    cols = PlanProduct(K.T, col_plan(C_loc, C_tot))
    u = torch.ones((C_loc,), dtype=F32, device=K.device)
    vc = torch.ones((C_tot,), dtype=F32, device=K.device)
    seen = []
    for i in range(n_iters):
        act = iters > i  # the masked active depth (data)
        u2 = 1.0 / rows(vc).clamp(min=TINY)
        vc2 = 1.0 / ex.allsum(cols(u2)).clamp(min=TINY)
        u, vc = torch.where(act, u2, u), torch.where(act, vc2, vc)
        if trace:
            seen.append((u.clone(), vc.clone()))
    plan = u[:, None] * K * vc[None, :]
    return (u, vc, plan, seen) if trace else (u, vc, plan)


def sinkhorn_plain(feas, jitter, v, eps, iters, n_iters: int, ex,
                   trace: bool = False):
    """The round in PyTorch ops: ``(K, u, vc, plan)``, and with ``trace``
    every iteration's ``(u, vc)`` after it (``iterate_plain``). ``eps`` is
    a 0-d tensor, the traced ``mkt_sink_eps``."""
    K = kernel_matrix(feas, jitter, v, eps)
    return (K, *iterate_plain(K, iters, n_iters, ex, trace))


@functools.cache
def _packed(c_loc: int, c_tot: int, device: str):
    out = []
    for plan in (row_plan(c_loc, c_tot), col_plan(c_loc, c_tot)):
        table, blocks = pack_plan(plan)
        out.append((table.to(device), blocks.to(device), table.shape[0],
                    group_width(plan)))
    return tuple(out)


def _bind(lib):
    """Set the argument types of the source's entry points (once a
    library): every pointer and the stream as ``c_void_p``, the row
    stride as ``c_long``, counts and flags as ``c_int``."""
    import ctypes

    if getattr(lib, "_sinkhorn_bound", False):
        return lib
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
    sigs = {"sinkhorn_build": [P, P, P, P, P, P, I, I, P],
            "sinkhorn_product": [P, L, I, P, P, I, P, I, P, I, I, P, P],
            "sinkhorn_finish": [P, P, I, P, I, P],
            "sinkhorn_plan": [P, P, P, P, I, I, P]}
    for name, args in sigs.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, I
    lib._sinkhorn_bound = True
    return lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed (error {status})")


def launch_round(lib, stream, feas, jitter, v, eps, iters, n_iters: int, ex,
                 trace: bool = False):
    """The round's launches from library ``lib`` on ``stream``: one builds
    K and its transpose, each iteration launches the row product and the
    column product (on a mesh, the finish after the caller's all-sum),
    one writes the plan. Returns as ``sinkhorn_plain``. The tensors lie on
    the device the library was built for (``sinkhorn_kernel``; a host
    build runs on CPU tensors in the tests); ``stream`` is the stream's
    handle as an int."""
    C_loc, C_tot = feas.shape
    dev = feas.device
    if jitter.shape != feas.shape or v.shape != (C_tot,) or any(
            t.device != dev for t in (jitter, v, eps, iters)):
        raise ValueError(f"sinkhorn round: feas {tuple(feas.shape)}, "
                         f"jitter {tuple(jitter.shape)}, v {tuple(v.shape)}"
                         f", devices {dev}, {jitter.device}, {v.device}")
    lib = _bind(lib)

    def p(t):
        return t.data_ptr()

    feas8 = feas.to(torch.uint8).contiguous()
    jitter = jitter.to(F32).contiguous()
    v = v.to(F32).contiguous()
    eps = eps.to(F32).reshape(1).contiguous()
    iters = iters.to(torch.int32).reshape(1).contiguous()
    K = torch.empty((C_loc, C_tot), dtype=F32, device=dev)
    KT = torch.empty((C_tot, C_loc), dtype=F32, device=dev)
    _check(lib.sinkhorn_build(p(feas8), p(jitter), p(v), p(eps), p(K),
                              p(KT), C_loc, C_tot, stream), "sinkhorn_build")
    LAUNCHES["sinkhorn_build"] += 1
    (rt, rb, rn, rg), (ct, cb, cn, cg) = _packed(C_loc, C_tot, str(dev))
    u = torch.ones((C_loc,), dtype=F32, device=dev)
    vc = torch.ones((C_tot,), dtype=F32, device=dev)
    mesh = ex.size > 1
    part = torch.zeros((C_tot,), dtype=F32, device=dev) if mesh else None
    seen = []
    for i in range(n_iters):
        _check(lib.sinkhorn_product(p(K), C_tot, C_loc, p(vc), p(rt), rn,
                                    p(rb), rg, p(iters), i, 0, p(u),
                                    stream), "sinkhorn_product")
        LAUNCHES["sinkhorn_product"] += 1
        _check(lib.sinkhorn_product(p(KT), C_loc, C_tot, p(u), p(ct), cn,
                                    p(cb), cg, p(iters), i, int(mesh),
                                    p(part if mesh else vc), stream),
               "sinkhorn_product")
        LAUNCHES["sinkhorn_product"] += 1
        if mesh:
            sums = ex.allsum(part).contiguous()
            _check(lib.sinkhorn_finish(p(sums), p(vc), C_tot, p(iters), i,
                                       stream), "sinkhorn_finish")
            LAUNCHES["sinkhorn_finish"] += 1
        if trace:
            seen.append((u.clone(), vc.clone()))
    plan = torch.empty((C_loc, C_tot), dtype=F32, device=dev)
    _check(lib.sinkhorn_plan(p(u), p(K), p(vc), p(plan), C_loc, C_tot,
                             stream), "sinkhorn_plan")
    LAUNCHES["sinkhorn_plan"] += 1
    LAUNCHES["sinkhorn_round"] += 1
    return (K, u, vc, plan, seen) if trace else (K, u, vc, plan)


def sinkhorn_kernel(feas, jitter, v, eps, iters, n_iters: int, ex,
                    trace: bool = False):
    """The round through ``kernels/csrc/sinkhorn_round.cu`` on CUDA
    tensors (``launch_round``), built at first use; raises if the build or
    a launch fails."""
    from multi_cluster_simulator_tpu_torch.kernels import build

    if feas.device.type != "cuda":
        raise ValueError(f"sinkhorn_kernel: tensors on {feas.device}, not "
                         f"a card")
    stream = torch.cuda.current_stream(feas.device).cuda_stream
    return launch_round(build.load("sinkhorn_round"), stream, feas, jitter,
                        v, eps, iters, n_iters, ex, trace)


def sinkhorn_round(feas, jitter, v, eps, iters, n_iters: int, ex):
    """``(K, u, vc, plan)`` of one round: the kernel on a card, the plain
    version on the CPU."""
    if feas.device.type == "cuda":
        return sinkhorn_kernel(feas, jitter, v, eps, iters, n_iters, ex)
    if feas.device.type != "cpu":
        raise ValueError(f"sinkhorn_round: no path for {feas.device}")
    return sinkhorn_plain(feas, jitter, v, eps, iters, n_iters, ex)
