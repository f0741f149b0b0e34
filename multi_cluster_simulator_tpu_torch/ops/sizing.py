"""Contract-sizing kernels — the trader's greedy node-size calculators (the
port of ``multi_cluster_simulator_tpu/ops/sizing.py``).

The reference sizes a resource request by streaming Level1 jobs from its
scheduler and folding them greedily (pkg/trader/scheduler_client.go:
126-289). Each algorithm is a masked prefix computation over the Level1
queue tensor, batched over clusters ([C, Q]); "as-built" reproduces the Go
code's observable arithmetic, quirks included, and "sane" is the
documented intended behaviour (MARKET.md).

Times are int32 ms, prices float32, rounded as XLA's CPU backend rounds
the reference's expressions: it turns ``time_ms / 1000.0`` into a product
with the f32 reciprocal, and fuses the first product of ``a*b + c*d`` into
a multiply-add with the second (``policies.kernels.fma_f32``), so the
port's prices equal the reference's bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops.queues import I32, JobQueue, icumsum
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32
from multi_cluster_simulator_tpu_torch.utils.tree import Tree

F32 = torch.float32
# 1/1000 as the f32 the reference multiplies by in place of ``/ 1000.0``
MS_TO_S = float(np.float32(1.0) / np.float32(1000.0))


@dataclasses.dataclass
class Contract(Tree):
    """ContractRequest (proto/trader.proto:21-28), minus the transport
    bits, one per cluster. ``gpu`` is the 3-dim resource extension: it
    sizes and carves like the other axes but trades at cost 0."""

    cores: torch.Tensor  # [C] i32
    mem: torch.Tensor  # [C] i32
    gpu: torch.Tensor  # [C] i32
    time_ms: torch.Tensor  # [C] i32
    price: torch.Tensor  # [C] f32


def f32(x: float) -> float:
    """``x`` rounded to the nearest f32 (the reference's ``jnp.float32``
    of a config constant), as a Python float."""
    return float(np.float32(x))


def seconds(time_ms: torch.Tensor) -> torch.Tensor:
    """``time_ms / 1000`` in f32, as the reference's compiled code has it."""
    return time_ms.to(F32) * MS_TO_S


def _price(cores, mem, time_ms, core_cost: float,
           mem_cost: float) -> torch.Tensor:
    """price = t_sec*cores*coreCost + t_sec*mem*memCost
    (scheduler_client.go:150, 271)."""
    t_s = seconds(time_ms)
    cc = torch.full_like(t_s, f32(core_cost))
    return fma_f32(t_s * cores.to(F32), cc,
                   t_s * mem.to(F32) * f32(mem_cost))


def _contract(cores, mem, gpu, time_ms, price, acc) -> Contract:
    """The contract of each cluster's last accepted prefix position of
    ``acc`` [C, Q] (a zero contract where none is accepted)."""
    k = (acc.sum(1) - 1).to(torch.int64)  # [C]
    has = k >= 0
    idx = k.clamp(min=0)[:, None]

    def g(a):
        return torch.where(has, torch.gather(a, 1, idx)[:, 0],
                           torch.zeros((), dtype=a.dtype, device=a.device))

    return Contract(cores=g(cores), mem=g(mem), gpu=g(gpu),
                    time_ms=g(time_ms), price=g(price))


def _accepted(valid, price, budget: float):
    """Slots whose running price is under the budget (strict <; a negative
    budget is unlimited)."""
    if budget < 0:
        return valid
    return valid & (price < f32(budget))


def _masked(l1: JobQueue, f: int, valid) -> torch.Tensor:
    return torch.where(valid, Q.field(l1, F.QUEUE_FIELDS[f]), 0)


def fast_node_contract(l1: JobQueue, budget: float, core_cost: float,
                       mem_cost: float) -> Contract:
    """calculateFastNodeSize (scheduler_client.go:126-170): size a node to
    run every Level1 job concurrently from t=0 — cores/mem are running
    sums, time the running max of durations — stopping before the job
    whose inclusion would reach the budget. The running price is
    monotone, so the accepted set is a prefix."""
    valid = l1.slot_valid()
    cores = icumsum(_masked(l1, Q.FCORES, valid), 1)
    mem = icumsum(_masked(l1, Q.FMEM, valid), 1)
    gpu = icumsum(_masked(l1, Q.FGPU, valid), 1)
    time_ms = torch.cummax(_masked(l1, Q.FDUR, valid), 1).values
    price = _price(cores, mem, time_ms, core_cost, mem_cost)
    return _contract(cores, mem, gpu, time_ms, price,
                     _accepted(valid, price, budget))


def _threshold_scan(dur: torch.Tensor) -> torch.Tensor:
    """The as-built time trajectory ``t_k = dur_k * [t_{k-1} < dur_k]``,
    ``t_{-1} = 0``, over [C, Q]. Each step is the one-threshold step
    function ``t -> A*[t < theta] + B*[t >= theta]``, a class closed under
    composition (keep the first threshold, map both branch values through
    the second), so the prefix compositions come from a log-depth
    doubling scan of that composition — ceil(log2 Q) vectorised steps, the
    reference's ``associative_scan`` — and ``t_k`` is the prefix applied
    to 0."""
    th, A, B = dur, dur, torch.zeros_like(dur)
    d = 1
    while d < dur.shape[1]:
        # position i composes the prefix ending at i - d, then its own
        pth, pA, pB = th[:, :-d], A[:, :-d], B[:, :-d]
        cth, cA, cB = th[:, d:], A[:, d:], B[:, d:]
        nA = torch.where(pA < cth, cA, cB)
        nB = torch.where(pB < cth, cA, cB)
        th = torch.cat([th[:, :d], pth], 1)
        A = torch.cat([A[:, :d], nA], 1)
        B = torch.cat([B[:, :d], nB], 1)
        d *= 2
    return torch.where(th > 0, A, B)


def small_node_contract_asbuilt(l1: JobQueue, budget: float,
                                core_cost: float,
                                mem_cost: float) -> Contract:
    """calculateSmallNodeSize *as built* (scheduler_client.go:201-289): the
    Go timeline bookkeeping is inert, so cores/mem accumulate sums (a
    zero-sized need leaves them unchanged) and the contract time becomes
    ``dur_k`` when ``dur_k > T_{k-1}`` and is reset to 0 otherwise
    (scheduler_client.go:263-265). The fold stops at the first job over
    the budget."""
    valid = l1.slot_valid()
    cores = icumsum(_masked(l1, Q.FCORES, valid).clamp(min=0), 1)
    mem = icumsum(_masked(l1, Q.FMEM, valid).clamp(min=0), 1)
    gpu = icumsum(_masked(l1, Q.FGPU, valid).clamp(min=0), 1)
    time_ms = _threshold_scan(_masked(l1, Q.FDUR, valid))
    price = _price(cores, mem, time_ms, core_cost, mem_cost)
    ok = _accepted(valid, price, budget)
    # accepted = the ok-prefix of the valid slots before the first
    # valid-but-rejected one
    reject = (valid & ~ok).to(I32)
    stopped = (icumsum(reject, 1) - reject) > 0
    return _contract(cores, mem, gpu, time_ms, price, ok & ~stopped)


def small_node_contract_sane(l1: JobQueue, budget: float, core_cost: float,
                             mem_cost: float) -> Contract:
    """The *intended* small node: the cheapest node that runs the Level1
    backlog sequentially — max individual cores/mem, summed durations —
    truncated at the budget (MARKET.md §sizing)."""
    valid = l1.slot_valid()
    cores = torch.cummax(_masked(l1, Q.FCORES, valid), 1).values
    mem = torch.cummax(_masked(l1, Q.FMEM, valid), 1).values
    gpu = torch.cummax(_masked(l1, Q.FGPU, valid), 1).values
    time_ms = icumsum(_masked(l1, Q.FDUR, valid), 1)
    price = _price(cores, mem, time_ms, core_cost, mem_cost)
    return _contract(cores, mem, gpu, time_ms, price,
                     _accepted(valid, price, budget))
