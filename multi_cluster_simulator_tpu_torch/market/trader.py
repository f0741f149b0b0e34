"""The trader resource market as one batched round (the port of
``multi_cluster_simulator_tpu/market/trader.py``).

The reference runs one trader process per cluster: a 10 s monitor checks
its request policies against the streamed cluster state, sizes a contract
from the scheduler's Level1 backlog, fans RequestResource out to every
peer trader, collects approvals in a price heap, and walks the heap
calling ApproveContract until a seller carves a virtual node
(trader.go:280-325, 193-278; trader/server.go:31-85). Here the whole
round — every cluster at once as buyer and seller — is a handful of [C]-
and [C, C]-shaped PyTorch ops on the state's device; MARKET.md documents
the deterministic semantics.

  buyers:  policy check (snapshot state) -> contract sizing (Level1) ->
  sellers: one-request-per-round lock -> ApproveTrade -> carve feasibility
  match:   greedy (per buyer, the lowest approving seller whose carve
           succeeds), sinkhorn (an entropic assignment relaxation over the
           whole feasibility matrix) or cvx (market/cvx.py), the last two
           rounded to a matching by one shared rule ->
  apply:   the seller occupies the carved amounts as Foreign placeholder
           jobs; the buyer activates a virtual node slot; cooldowns,
           locks, spend and contract ids update.

Nothing here reads a value back to the host: every decision stays a
tensor on the device, and the round launches the same ops whatever the
data. Floats round as the reference's compiled CPU code rounds them: the
products XLA fuses into multiply-adds are ``fma_f32`` here (the port's
greedy rounds are bitwise the reference's). The sinkhorn and cvx rounds
take their tie-break jitter from a table the host computes once per
cluster count (``pair_jitter``), bitwise the reference's; their float
leaves agree with the reference to a tolerance (the ``exp`` of the kernel
matrix and the matrix-vector order, ROADMAP queue C), their decisions
exactly where no near-tie is decided by the last bits.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import MatchKind, SimConfig
from multi_cluster_simulator_tpu_torch.core.spec import CORES, GPU, MEM
from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.ops import carve as carve_ops
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.ops import sizing
from multi_cluster_simulator_tpu_torch.ops.queues import I32, icumsum, isum
from multi_cluster_simulator_tpu_torch.ops.sizing import F32, Contract, f32
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32
from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

FOREIGN = -2  # owner sentinel: Ownership == "Foreign" (cluster.go:116)
PLACEHOLDER_ID = -3
INF = 2**31 - 1


def i32(x: int) -> int:
    """A host int wrapped to int32, as the reference's int32 clock sums."""
    return (int(x) + 2**31) % 2**32 - 2**31


@dataclasses.dataclass
class MktHyper:
    """The solver hyperparameters one round runs with: 0-d tensors, the
    ``mkt_*`` leaves of ``PolicyParams``. Iteration counts are ACTIVE
    counts masked inside the static loop lengths the config sets
    (``sinkhorn_iters``/``cvx_iters``)."""

    sink_iters: torch.Tensor  # [] i32
    sink_eps: torch.Tensor  # [] f32
    iters: torch.Tensor  # [] i32 — cvx active iterations
    step: torch.Tensor  # [] f32 — cvx primal sharpness (1/delta)
    rho: torch.Tensor  # [] f32 — cvx price step
    smooth: torch.Tensor  # [] f32 — cvx price carry-over


def market_hyper(params) -> MktHyper:
    return MktHyper(sink_iters=params.mkt_sink_iters,
                    sink_eps=params.mkt_sink_eps, iters=params.mkt_iters,
                    step=params.mkt_step, rho=params.mkt_rho,
                    smooth=params.mkt_smooth)


def _take(con: Contract, idx: torch.Tensor) -> Contract:
    return tree_map(lambda x: x[idx.long()], con)


def _approve_snapshot(tr, mcfg):
    """The seller half of ApproveTrade against the snapshot: the
    thresholds, and the available cores and mem (f32)."""
    tot_c = tr.snap_total_cores.to(F32)
    tot_m = tr.snap_total_mem.to(F32)
    avail_c = fma_f32(-tot_c, tr.snap_core_util, tot_c)
    avail_m = fma_f32(-tot_m, tr.snap_mem_util, tot_m)
    thresh_ok = (tr.snap_core_util < f32(mcfg.approve_core_threshold)) \
        & (tr.snap_mem_util < f32(mcfg.approve_mem_threshold))
    return thresh_ok, avail_c, avail_m


def _match_greedy(state: SimState, tr, t: int, mcfg, ex, gidx, g_buyer,
                  g_con: Contract):
    """The reference's negotiation, determinised (trader.go:193-278): each
    seller evaluates only its lowest-index requesting buyer (the
    one-contract-at-a-time lock, trader/server.go:36-44); per buyer the
    lowest approving seller whose carve succeeds wins. Returns (winner
    [C_tot] global seller index or INF, the contract each local seller
    evaluated, amounts [C_loc, N, R], win_sell [C_loc], the new locks)."""
    C_loc, C_tot = gidx.shape[0], g_buyer.shape[0]
    dev = gidx.device
    bidx = torch.arange(C_tot, dtype=I32, device=dev)

    # sellers (local): one-request-per-round lock + ApproveTrade
    locked = tr.seller_locked_until > t
    req = g_buyer[None, :] & (gidx[:, None] != bidx[None, :])  # [s, b]
    has_req = req.any(1)
    b_first = req.to(torch.uint8).argmax(1).to(I32)  # lowest global buyer
    process = has_req & ~locked
    csel = _take(g_con, b_first)
    thresh_ok, avail_c, avail_m = _approve_snapshot(tr, mcfg)
    t_sec = sizing.seconds(csel.time_ms)
    incentive = fma_f32(f32(mcfg.min_core_incentive) * csel.cores.to(F32),
                        t_sec,
                        f32(mcfg.min_mem_incentive) * csel.mem.to(F32)
                        * t_sec)
    approve = process & thresh_ok & (avail_c >= csel.cores.to(F32)) \
        & (avail_m >= csel.mem.to(F32)) & (csel.price >= incentive)

    # carve feasibility (ApproveContract -> ProvideVirtualNode)
    amounts, carve_ok = carve_ops.carve_plan(
        state.node_free, state.node_active, csel.cores, csel.mem, csel.gpu,
        mcfg.carve_mode)

    # per buyer, the lowest approving seller whose carve succeeds: the
    # min-reduction is the collective form of the offer heap
    cand_ok = approve & carve_ok
    local = torch.full((C_tot,), INF, dtype=I32, device=dev)
    local.scatter_reduce_(0, b_first.long(), torch.where(cand_ok, gidx, INF),
                          "amin")
    winner = ex.allmin(local)
    won = winner[b_first.long()]  # [C_loc] the winner of my buyer
    # sellers the buyer called ApproveContract on: every candidate up to
    # and including the winner (heap fall-through, trader.go:265-276), all
    # of them if none carved; their lock resets (trader/server.go:83),
    # other approvers stay locked until the TTL
    attempted = approve & torch.where(won < INF, gidx <= won, True)
    new_lock = torch.where(process, i32(t + mcfg.contract_ttl_ms),
                           tr.seller_locked_until)
    new_lock = torch.where(attempted, 0, new_lock).to(I32)
    win_sell = cand_ok & (won == gidx)
    return winner, csel, amounts, win_sell, new_lock


def _pair_feasibility(state: SimState, tr, t: int, mcfg, gidx, g_buyer,
                      g_con: Contract) -> torch.Tensor:
    """The [s_loc, b] feasibility matrix the batched matchers (sinkhorn,
    cvx) share: ApproveTrade against the snapshot, the seller not locked,
    the sane carve's capacity (total free over active nodes covers the
    request, per resource, gpu included), and a requesting buyer that is
    not the seller itself."""
    bidx = torch.arange(g_buyer.shape[0], dtype=I32, device=gidx.device)
    locked = tr.seller_locked_until > t
    thresh_ok, avail_c, avail_m = _approve_snapshot(tr, mcfg)
    t_sec = sizing.seconds(g_con.time_ms)
    incentive = fma_f32(
        torch.full_like(t_sec, f32(mcfg.min_core_incentive)),
        g_con.cores.to(F32),
        f32(mcfg.min_mem_incentive) * g_con.mem.to(F32)) * t_sec
    approve = (thresh_ok & ~locked)[:, None] \
        & (avail_c[:, None] >= g_con.cores[None, :].to(F32)) \
        & (avail_m[:, None] >= g_con.mem[None, :].to(F32)) \
        & (g_con.price >= incentive)[None, :]
    tot_free = torch.where(state.node_active[..., None],
                           state.node_free.clamp(min=0), 0).sum(
                               1, dtype=I32)  # [s_loc, R]
    req = torch.stack([g_con.cores, g_con.mem, g_con.gpu], -1)  # [b, R]
    cap_ok = torch.ones_like(approve)
    for r in range(req.shape[1]):
        cap_ok &= tot_free[:, None, r] >= req[None, :, r]
    return approve & cap_ok & g_buyer[None, :] \
        & (gidx[:, None] != bidx[None, :])


def _pair_value(g_con: Contract) -> torch.Tensor:
    """Buyer value: normalised resource volume (what a matched contract is
    worth); sellers are symmetric."""
    v = (g_con.cores.to(F32) + g_con.mem.to(F32) / 1024.0
         + 4.0 * g_con.gpu.to(F32))
    return v / v.max().clamp(min=1.0)


# XLA's CPU vectorizer computes the jitter's argument over the buyer axis in
# 8-wide bodies, as fma(b, 78.233, s * 12.9898), from this many buyers on;
# below it, and in the tail columns past the last full body, it rounds the
# product and the sum apart.
JITTER_VECTOR_MIN, JITTER_VECTOR_WIDTH = 72, 8
# glibc's sinf is within 0.56 ulp of the sine: where the f64 sine lies
# farther than this fraction of an f32 step from the midpoint of the two
# f32 values around it, sinf gives the nearest one, the f64 sine rounded.
_SINF_BAND = 0.125


@functools.cache
def _libm_sinf():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    lib.sinf.restype = ctypes.c_float
    lib.sinf.argtypes = [ctypes.c_float]
    return lib.sinf


def _sinf(arg: np.ndarray) -> np.ndarray:
    """glibc's ``sinf`` of every f32 in ``arg`` (XLA's CPU ``sin`` is this
    function): the f64 sine rounded to f32, and ``sinf`` itself for the
    entries near a rounding midpoint, where the two may differ."""
    s64 = np.sin(arg.astype(np.float64))
    near = s64.astype(np.float32)
    other = np.nextafter(near, np.where(s64 > near, np.inf, -np.inf).astype(
        np.float32))
    mid = (near.astype(np.float64) + other.astype(np.float64)) / 2
    step = np.abs(other.astype(np.float64) - near.astype(np.float64))
    close = np.abs(s64 - mid) < _SINF_BAND * step
    sinf = _libm_sinf()
    near[close] = [sinf(float(a)) for a in arg[close]]
    return near


@functools.cache
def _jitter_table(gidx_offset: int, c_loc: int, c_tot: int) -> np.ndarray:
    sidx = np.arange(gidx_offset, gidx_offset + c_loc,
                     dtype=np.float32)[:, None]
    bfdx = np.arange(c_tot, dtype=np.float32)[None, :]
    s_term = sidx * np.float32(12.9898)
    arg = s_term + bfdx * np.float32(78.233)
    if c_tot >= JITTER_VECTOR_MIN:
        v = JITTER_VECTOR_WIDTH * (c_tot // JITTER_VECTOR_WIDTH)
        b = torch.from_numpy(bfdx[:, :v]).expand(c_loc, v)
        arg[:, :v] = fma_f32(b, torch.full_like(b, 78.233),
                             torch.from_numpy(s_term).expand(c_loc, v)
                             ).numpy()
    frac = np.abs(np.modf(_sinf(arg) * np.float32(43758.5453))[0])
    return frac.astype(np.float32)


def pair_jitter(gidx_offset: int, c_loc: int, c_tot: int,
                device) -> torch.Tensor:
    """The deterministic per-pair jitter in [0, 1) that breaks exact ties
    ``|frac(sin(s*12.9898 + b*78.233) * 43758.5453)|`` over [c_loc
    sellers (global indices from ``gidx_offset``), c_tot buyers], bitwise
    the reference's compiled table: the argument as XLA's vectorizer
    computes it (``JITTER_VECTOR_MIN``), glibc's ``sinf``, the product,
    ``modf`` and ``abs`` in f32. Made on the host once per shape and
    process (the ``sinf`` calls take seconds at 4,096 clusters) and copied
    to ``device``, so the card and the CPU share its bits."""
    return torch.from_numpy(_jitter_table(gidx_offset, c_loc, c_tot)).to(
        device)


def _round_plan_to_matching(state: SimState, plan, feas, gidx,
                            g_con: Contract, ex):
    """The deterministic rounding both fractional matchers share (MARKET.md
    §"The rounding rule"): each buyer claims its argmax-plan feasible
    seller — ties to the LOWEST global seller index — then each claimed
    seller keeps its highest-plan claimant, the sane carve re-checks, and
    the committed winner index min-reduces across shards. Returns (winner
    [C_tot], csel, amounts, win_sell)."""
    C_tot = feas.shape[1]
    dev = feas.device
    any_s = ex.allmax(feas.any(0).to(I32)) > 0  # [b]
    colmax = ex.allmax(torch.where(feas, plan, -1.0).amax(0))
    at_max = feas & (plan >= colmax[None, :])
    cand = ex.allmin(torch.where(at_max, gidx[:, None], INF).amin(0))
    cand = torch.where(any_s, cand, INF)
    claim = (cand[None, :] == gidx[:, None]) & feas  # [s_loc, b]
    sel_b = torch.where(claim, plan, -1.0).argmax(1).to(I32)
    csel = _take(g_con, sel_b)
    amounts, carve_ok = carve_ops.carve_plan(
        state.node_free, state.node_active, csel.cores, csel.mem, csel.gpu,
        "sane")
    win_sell = claim.any(1) & carve_ok
    # winner[b] = the seller that committed to b (INF: unmatched); each
    # buyer is claimed by one seller at most, and the non-winners write
    # into a spare slot past the end
    local = torch.full((C_tot + 1,), INF, dtype=I32, device=dev)
    local.scatter_(0, torch.where(win_sell, sel_b, C_tot).long(),
                   torch.where(win_sell, gidx, INF))
    return ex.allmin(local[:C_tot]), csel, amounts, win_sell


def _match_sinkhorn(state: SimState, tr, t: int, mcfg, ex, gidx, g_buyer,
                    g_con: Contract, hp: MktHyper, jitter):
    """Batched entropic optimal-transport matching (BASELINE config 4):
    the full (seller x buyer) feasibility matrix enters a Sinkhorn
    relaxation of the assignment, rounded to a one-to-one matching. Carve
    semantics are ``sane`` and no seller lock is taken (a matched seller's
    capacity is committed in the same tick). The two products per
    iteration, ``K @ vc`` and ``K.T @ u``, are plain matrix-vector
    products (``torch.matmul``), as the reference leaves them to XLA."""
    C_loc, C_tot = gidx.shape[0], g_buyer.shape[0]
    dev = gidx.device
    feas = _pair_feasibility(state, tr, t, mcfg, gidx, g_buyer, g_con)
    v = _pair_value(g_con)
    eps = hp.sink_eps
    score = fma_f32(jitter, (0.5 * eps).expand_as(jitter),
                    v[None, :].expand_as(jitter))
    K = torch.where(feas, torch.exp(score / eps), 0.0)  # [s_loc, C_tot]
    tiny = 1e-30
    u = torch.ones((C_loc,), dtype=F32, device=dev)
    vc = torch.ones((C_tot,), dtype=F32, device=dev)
    for i in range(mcfg.sinkhorn_iters):
        act = hp.sink_iters > i  # the masked active depth (data)
        u2 = 1.0 / (K @ vc).clamp(min=tiny)
        vc2 = 1.0 / ex.allsum(K.T @ u2).clamp(min=tiny)
        u, vc = torch.where(act, u2, u), torch.where(act, vc2, vc)
    plan = u[:, None] * K * vc[None, :]
    winner, csel, amounts, win_sell = _round_plan_to_matching(
        state, plan, feas, gidx, g_con, ex)
    return winner, csel, amounts, win_sell, tr.seller_locked_until


def _contracts(state: SimState, mcfg, want_fast) -> Contract:
    """Each cluster's contract, sized from its Level1 backlog (ProvideJobs
    streams a GetLevel1 copy, trader_server.go:69-94): the fast node where
    the wait-time policy broke, else the small node."""
    args = (state.l1, mcfg.budget, mcfg.max_core_cost, mcfg.max_mem_cost)
    fast = sizing.fast_node_contract(*args)
    if mcfg.small_node_sizing == "asbuilt":
        small = sizing.small_node_contract_asbuilt(*args)
    else:
        small = sizing.small_node_contract_sane(*args)
    return Contract(**{
        f.name: torch.where(want_fast, getattr(fast, f.name),
                            getattr(small, f.name))
        for f in dataclasses.fields(Contract)})


def _seller_apply(state: SimState, t: int, amounts, csel: Contract,
                  win_sell):
    """The seller occupies the carved amounts as Foreign placeholder jobs
    for the contract's duration (cluster.go:116), one per node it carves
    from, each into the lowest free running slot after the previous
    insert. The reference walks the nodes in order; batched, the k-th
    occupied node takes the k-th free slot, while free slots last
    (``R.start_many``). The node_free decrement is gated on the row
    inserting (without a slot nothing would release the resources later);
    a skipped occupation counts into ``drops.carve``. The placeholder rows
    are a value entry point: on the compact layout their store is checked
    (the reference's ``insert_row``)."""
    run = state.run
    C, N = amounts.shape[:2]
    dev = amounts.device
    occ = win_sell[:, None] & (amounts > 0).any(-1)  # [C, N]
    rank = icumsum(occ.to(I32), 1) - 1
    ok = occ & (rank < isum(~run.active, 1)[:, None])
    full = lambda v: torch.full((C, N), v, dtype=I32, device=dev)  # noqa
    time_ms = csel.time_ms[:, None].expand(C, N)
    rows = R.make_row(time_ms + t, torch.arange(N, dtype=I32,
                                                device=dev).expand(C, N),
                      amounts[..., CORES], amounts[..., MEM],
                      amounts[..., GPU], full(PLACEHOLDER_ID), full(FOREIGN),
                      time_ms, full(i32(t)), full(0))  # [C, N, RF]
    order = torch.sort((~ok).to(torch.uint8), dim=1, stable=True).indices
    rows = torch.gather(rows, 1, order[..., None].expand(-1, -1, R.RF))
    run = R.start_many(run, rows, isum(ok, 1), checked=True)
    free = state.node_free - torch.where(ok[..., None], amounts, 0)
    return run, free, isum(occ & ~ok, 1)


def _buyer_apply(state: SimState, t: int, cfg: SimConfig, free, con,
                 got):
    """AddVirtualNode (cluster.go:65-85): a buyer that won attaches a node
    echoing its contract's cores/mem/gpu (trader_server.go:58) to its
    first healthy vacant virtual slot — a DOWN slot is inactive but not
    vacant — and a win with no such slot counts into ``drops.vslot``.
    With ``expire_virtual_nodes`` the node expires at the contract's end,
    else never."""
    N = state.node_cap.shape[1]
    dev = free.device
    nidx = torch.arange(N, device=dev)
    slot_free = (nidx >= cfg.max_nodes)[None, :] & ~state.node_active \
        & state.faults.health
    slot = slot_free.to(torch.uint8).argmax(1)
    any_free = slot_free.any(1)
    ok = got & any_free
    hot = (nidx[None, :] == slot[:, None]) & ok[:, None]  # [C, N]
    newcap = torch.stack([con.cores, con.mem, con.gpu], -1).to(I32)
    cap = torch.where(hot[..., None], newcap[:, None, :], state.node_cap)
    free = torch.where(hot[..., None], newcap[:, None, :], free)
    expire = con.time_ms + t if cfg.trader.expire_virtual_nodes \
        else torch.full_like(con.time_ms, R.NEVER)
    expire = torch.where(hot, expire[:, None], state.node_expire)
    return cap, free, state.node_active | hot, expire, \
        (got & ~any_free).to(I32)


def next_cadence_t(t: int, mcfg) -> int:
    """The next virtual time strictly after ``t`` (a host int) at which
    the market can act: the 5 s state-stream refresh (the snapshot) or
    the 10 s monitor wakeup (the round). Between two boundaries both
    phases are no-ops whatever the data, which lets the event-compressed
    driver (core/engine.py ``run_compressed``) leap straight to the next
    one. A host int, as the port's clock is on the host."""
    def nxt(c: int) -> int:
        return (t // c + 1) * c
    return min(nxt(mcfg.state_cadence_ms), nxt(mcfg.monitor_period_ms))


def trade_round(state: SimState, t: int, cfg: SimConfig, ex, params,
                jitter) -> SimState:
    """One market round at clock ``t`` (a host int; the engine calls it on
    the monitor cadence, ``Engine.round_due``). ``params`` are the policy
    leaves (their ``mkt_*`` solver hyperparameters); ``jitter`` the
    sinkhorn/cvx tie-break table (``Engine.jitter``, made once per
    engine), None for the greedy market. Returns a new state."""
    mcfg = cfg.trader
    tr = state.trader
    hp = market_hyper(params)
    C_loc = state.arr_ptr.shape[0]
    dev = state.arr_ptr.device
    gidx = ex.global_index(C_loc, dev)

    # buyers: request policies (trader.go:117-139, WaitTime then
    # Utilization as appended in newTrader, trader.go:55-62)
    eligible = tr.cooldown_until <= t
    wt_broken = tr.snap_avg_wait > f32(mcfg.request_max_wait_ms)
    ut_broken = (tr.snap_core_util > f32(mcfg.request_core_max)) \
        | (tr.snap_mem_util > f32(mcfg.request_mem_max))
    want_fast = eligible & wt_broken
    buyer = want_fast | (eligible & ~wt_broken & ut_broken)
    # a zero-resource contract (an empty Level1) trades as in Go
    con = _contracts(state, mcfg, want_fast)

    # the RequestResource fan-out (trader.go:211-229)
    g_buyer = ex.gather(buyer)
    g_con = tree_map(ex.gather, con)

    new_price = tr.mkt_price
    if mcfg.matching == MatchKind.CVX:
        from multi_cluster_simulator_tpu_torch.market import cvx
        winner, csel, amounts, win_sell, new_lock, new_price = \
            cvx.match_cvx(state, tr, t, mcfg, ex, gidx, g_buyer, g_con, hp,
                          jitter)
    elif mcfg.matching == MatchKind.SINKHORN:
        winner, csel, amounts, win_sell, new_lock = _match_sinkhorn(
            state, tr, t, mcfg, ex, gidx, g_buyer, g_con, hp, jitter)
    else:
        winner, csel, amounts, win_sell, new_lock = _match_greedy(
            state, tr, t, mcfg, ex, gidx, g_buyer, g_con)

    run, free, carve_miss = _seller_apply(state, t, amounts, csel, win_sell)
    got = buyer & (winner[gidx.long()] < INF)
    cap, free, active, expire, vslot_miss = _buyer_apply(
        state, t, cfg, free, con, got)

    # cooldowns (the 4 min / 2 min sleeps, trader.go:296-302)
    cooldown = torch.where(
        got, i32(t + mcfg.cooldown_success_ms),
        torch.where(buyer, i32(t + mcfg.cooldown_failure_ms),
                    tr.cooldown_until)).to(I32)
    drops = state.drops
    return state.replace(
        node_cap=cap, node_free=free, node_active=active, node_expire=expire,
        run=run,
        drops=drops.replace(vslot=drops.vslot + vslot_miss,
                            carve=drops.carve + carve_miss),
        trader=tr.replace(
            seller_locked_until=new_lock, cooldown_until=cooldown,
            spent=tr.spent + torch.where(got, con.price, 0.0),
            mkt_price=new_price,
            next_contract_id=tr.next_contract_id + buyer.to(I32)))
