"""The convex market kernel: assignment-LP pricing by descending-price dual
ascent (the port of ``multi_cluster_simulator_tpu/market/cvx.py``).

The buyer<->seller round is one linear program — the assignment
relaxation ``max <score, x>`` with each seller carving one contract and
each buyer attaching one virtual node per round, over the feasibility
matrix the sinkhorn matcher builds (``trader._pair_feasibility``). It is
solved by a FIXED number of primal-dual iterations (``cvx_iters``; the
active depth ``hp.iters`` masks the rest, so it is data):

- primal: ``x = clip(step * (score - lam[b] - mu[s]), 0, 1) * feas``, the
  best response to the prox-regularised Lagrangian (sharpness ``step``);
- dual: prices move by ``rho/(1+i) * clip(violation, -1, 1)`` and project
  to >= 0 — a simultaneous Dutch auction whose prices open at the score
  ceiling and fall toward clearing. The harmonic step is load-bearing: its
  sum diverges (an unmatched buyer's price always reaches zero) while the
  step vanishes (the equilibrium sharpens).

The plan rounds to integer contracts by the rule the sinkhorn matcher
shares (``trader._round_plan_to_matching``).
"""

from __future__ import annotations

import torch

from multi_cluster_simulator_tpu_torch.market import trader as T
from multi_cluster_simulator_tpu_torch.ops.sizing import F32
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32

# The tie-break scale of the per-pair jitter (trader.pair_jitter): far
# below any real value difference, large enough to keep the rounding's
# argmax off exact ties.
JITTER_SCALE = 0.0001
# The opening price: one jitter band above the score ceiling, so that
# every pair opens unprofitable.
PRICE_CEIL = 1.0 + 2.0 * JITTER_SCALE


def solve_prices(feas, score, lam0, hp, n_iters: int, ex):
    """The fixed-iteration descending-price solve over the shard-local
    [s_loc, C_tot] rows ``feas``/``score`` from the opening buyer prices
    ``lam0`` [C_tot]; ``n_iters`` is the loop's length, ``hp.iters`` its
    active depth. Every cross-shard quantity reduces through
    ``ex.allsum``. Returns (x [s_loc, C_tot], lam [C_tot])."""
    C_loc, C_tot = feas.shape
    dev = feas.device
    fmask = feas.to(F32)
    x = torch.zeros((C_loc, C_tot), dtype=F32, device=dev)
    lam = lam0
    mu = torch.zeros((C_loc,), dtype=F32, device=dev)
    for i in range(n_iters):
        act = hp.iters > i  # the masked active depth (data)
        g = score - lam[None, :] - mu[:, None]
        x2 = (hp.step * g).clamp(0.0, 1.0) * fmask
        rho_i = hp.rho / (1.0 + float(i))
        col = ex.allsum(x2.sum(0)) - 1.0  # buyer oversubscription
        row = x2.sum(1) - 1.0  # seller oversubscription
        lam2 = fma_f32(rho_i.expand_as(col), col.clamp(-1.0, 1.0),
                       lam).clamp(min=0.0)
        mu2 = fma_f32(rho_i.expand_as(row), row.clamp(-1.0, 1.0),
                      mu).clamp(min=0.0)
        x = torch.where(act, x2, x)
        lam = torch.where(act, lam2, lam)
        mu = torch.where(act, mu2, mu)
    return x, lam


def match_cvx(state, tr, t: int, mcfg, ex, gidx, g_buyer, g_con, hp,
              jitter):
    """MatchKind.CVX: the matchers' common outputs plus the refreshed
    [C_loc] buyer-price column. Feasibility, value, jitter and rounding
    are the sinkhorn matcher's; only the solver between them differs."""
    feas = T._pair_feasibility(state, tr, t, mcfg, gidx, g_buyer, g_con)
    v = T._pair_value(g_con)
    score = fma_f32(jitter, torch.full_like(jitter, JITTER_SCALE),
                    v[None, :].expand_as(jitter))
    # warm start: last round's closing prices blended into the opening (a
    # smooth of 0, the default, is a cold start from the ceiling)
    g_price = ex.gather(tr.mkt_price)
    lam0 = fma_f32(hp.smooth.expand_as(g_price), g_price,
                   ((1.0 - hp.smooth) * PRICE_CEIL).expand_as(g_price))
    x, lam = solve_prices(feas, score, lam0, hp, mcfg.cvx_iters, ex)
    winner, csel, amounts, win_sell = T._round_plan_to_matching(
        state, x, feas, gidx, g_con, ex)
    return (winner, csel, amounts, win_sell, tr.seller_locked_until,
            lam[gidx.long()])
