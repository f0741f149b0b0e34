"""Fault schedules as data: the ``FaultState`` leaves and what makes them
(the port of ``multi_cluster_simulator_tpu/faults/schedule.py``).

A failure schedule is a per-node alternating sequence of (fail, repair)
times, reduced to the two columns the fault phase reads — ``next_fail``
(the clock of the next failure, NEVER when none is scheduled) and
``down_until`` (the repair clock while down) — so the phase
(faults/apply.py) is blind to the mode; the mode only decides where the
next interval comes from:

- **trace** — an explicit event list packed once on the host into per-node
  sorted interval tables ``fail_t``/``repair_t`` ([C, N, E], NEVER-padded),
  indexed by the per-node cursor ``n_fails``;
- **generative** — inverse-CDF exponential draws
  ``dt = clip(ceil(-mean * log(u)), 1, 2^30)`` from counter-based streams:
  draw k of node n in cluster c uses the uniform of
  ``fold_in(fold_in(key_c, n), 2k + kind)``, a pure function of (cluster
  key, node, ordinal).

The draws are bitwise the reference's compiled ones. jax's threefry2x32
``fold_in``, the 32 bits of a scalar draw and ``uniform(minval=1e-7)`` are
integer work, written here on int64 tensors masked to 32 bits (torch has
no CPU ``+``, ``<<`` or ``>>`` for uint32, and ``>>`` on int32 is
arithmetic); the same functions take numpy int64 arrays. XLA's CPU ``log``
is an inline polynomial with fused multiply-adds, not the correctly
rounded log of libm or torch: ``xla_log_f32`` writes it out step by step
(``fma_f32`` for each fused step), as the CUDA kernels' ``xla_logf`` does
with ``__fmaf_rn``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import FaultConfig
from multi_cluster_simulator_tpu_torch.ops.fields import NEVER_I
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32
from multi_cluster_simulator_tpu_torch.utils.tree import Tree

NEVER = NEVER_I
MAX_DT = 1 << 30  # draws are clamped so t + dt stays far from int32 wrap
M32 = 0xFFFFFFFF


@dataclasses.dataclass
class FaultState(Tree):
    health: torch.Tensor  # [C, N] bool — True = up
    was_active: torch.Tensor  # [C, N] bool — node_active at fail time
    next_fail: torch.Tensor  # [C, N] i32 — clock of the next failure
    down_until: torch.Tensor  # [C, N] i32 — repair clock while down
    down_since: torch.Tensor  # [C, N] i32 — fail clock of the outage
    n_fails: torch.Tensor  # [C, N] i32 — completed outages
    kills: torch.Tensor  # [C] i32
    requeues: torch.Tensor  # [C] i32
    down_ms: torch.Tensor  # [C] i32
    fail_t: torch.Tensor  # [C, N, E] i32 — trace-mode interval starts
    repair_t: torch.Tensor  # [C, N, E] i32 — trace-mode interval ends
    key: torch.Tensor  # [C, 2] u32 — per-cluster generative stream root


# --------------------------------------------------------------------------
# the counter-based draws (int64 tensors or numpy arrays, 32-bit values)
# --------------------------------------------------------------------------

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(v, d: int):
    return ((v << d) | (v >> (32 - d))) & M32


def threefry2x32(k0, k1, x0, x1):
    """jax's threefry2x32 block (20 rounds) of key ``(k0, k1)`` over the
    counter words ``(x0, x1)``; every argument and result holds 32-bit
    values in a wider integer type. Returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & M32, (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & M32
    return x0, x1


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """32-bit values held in a wider integer tensor as a uint32 tensor,
    through an int32 of the same bits (a conversion the card's kernels
    have for every build of torch; a uint32 tensor takes copies and views
    only)."""
    x = x.to(torch.int64) & M32
    return (x - ((x >= 2**31).to(torch.int64) << 32)).to(torch.int32).view(
        torch.uint32)


def fold_in(k0, k1, data):
    """``jax.random.fold_in(key, data)``: threefry2x32 of the key over the
    counter ``(0, uint32(data))``; returns the new key's two words."""
    zero = data & 0
    return threefry2x32(k0, k1, zero, data & M32)


def random_bits(k0, k1):
    """The 32 bits of ``jax.random.bits(key, (), uint32)`` under
    ``jax_threefry_partitionable``: both words of threefry2x32 over the
    counter ``(0, 0)``, xor-ed."""
    zero = k0 & 0
    y0, y1 = threefry2x32(k0, k1, zero, zero)
    return y0 ^ y1


def _f32_bits(bits: torch.Tensor) -> torch.Tensor:
    """The f32 whose bit pattern is ``bits`` (32-bit values, any int)."""
    return bits.to(torch.int64).sub(
        (bits >= 2**31).to(torch.int64) << 32).to(torch.int32).view(
            torch.float32)


# uniform(minval=1e-7, maxval=1): the f32 operands jax computes
_MINVAL = np.float32(1e-7)
_SPAN = np.float32(np.float32(1.0) - _MINVAL)


def uniform_scalar(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key, (), float32, 1e-7, 1.0)`` under
    ``jax.jit``: the top 23 bits as a float in [1, 2) less one, then
    ``f * (1 - 1e-7) + 1e-7`` as one fused multiply-add (XLA fuses it),
    then the max with the minimum. f32 tensor of the keys' shape."""
    bits = random_bits(k0, k1)
    f = _f32_bits((bits >> 9) | 0x3F800000) - 1.0
    u = fma_f32(f, torch.full_like(f, float(_SPAN)),
                torch.full_like(f, float(_MINVAL)))
    return torch.maximum(u, torch.full_like(u, float(_MINVAL)))


# XLA's CPU f32 log (the polynomial of its LLVM IR, the constants as the IR
# spells them in hex): x = 2^e * m with m in [sqrt(1/2), sqrt(2)), then a
# degree-9 polynomial in m - 1 split into three cubic parts, evaluated with
# the fused multiply-adds the compiled code uses.
_LOG_A = (0x3FB2043760000000, 0xBFBD7A3700000000, 0x3FBDE4A340000000)
_LOG_B = (0xBFBFCBA9E0000000, 0x3FC23D37E0000000, 0xBFC555CA00000000)
_LOG_C = (0x3FC999D580000000, 0xBFCFFFFF80000000, 0x3FD5555540000000)
_LOG_Q1, _LOG_Q2 = 0xBF2BD01060000000, 0x3FE6300000000000  # ln 2, split
_SQRTH = 0x3FE6A09E60000000
_FLT_MIN = 0x3810000000000000


def _hexf(h: int) -> float:
    return float(np.array([h], np.uint64).view(np.float64)[0])


def xla_log_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.jit(jnp.log)`` on XLA's CPU backend, bitwise, for f32 ``x``
    of any shape: the same polynomial, operation for operation, with each
    multiply-add the compiled code fuses rounded once (``fma_f32``).
    Zero (and a subnormal, read as zero) gives -inf, +inf gives +inf,
    negatives and NaN give the NaN of all-one bits, as the compiled code
    does."""
    def c(h):
        return torch.full_like(x, _hexf(h))

    def fma(a, b, d):
        return fma_f32(a, b, d)

    # the compiled code treats subnormal inputs as zero (DAZ)
    x = torch.where(x.abs() < c(_FLT_MIN), 0.0, x)
    xc = torch.maximum(x, c(_FLT_MIN))
    xi = xc.contiguous().view(torch.int32)
    e = ((xi >> 23) - 127).to(torch.float32) + 1.0
    m = ((xi & -2139095041) | 0x3F000000).view(torch.float32)  # in [.5, 1)
    small = m < c(_SQRTH)
    xx = (m - 1.0) + torch.where(small, m, 0.0)
    e = e - torch.where(small, 1.0, 0.0)
    z = xx * xx
    x3 = z * xx
    pa = fma(fma(xx, c(_LOG_A[0]), c(_LOG_A[1])), xx, c(_LOG_A[2]))
    pb = fma(fma(xx, c(_LOG_B[0]), c(_LOG_B[1])), xx, c(_LOG_B[2]))
    pc = fma(fma(xx, c(_LOG_C[0]), c(_LOG_C[1])), xx, c(_LOG_C[2]))
    q = fma(x3, fma(x3, pa, pb), pc)
    y = fma(x3, q, e * c(_LOG_Q1))
    r = fma(c(_LOG_Q2), e, fma(torch.full_like(x, -0.5), z, xx) + y)
    nan = torch.full_like(xi, -1).view(torch.float32)
    r = torch.where(x > 0, r, nan)
    r = torch.where(x == 0, -torch.inf, r)
    return torch.where(x == torch.inf, torch.inf, r)


def _exp_draws(key: torch.Tensor, counters: torch.Tensor, kind: int,
               mean_ms: int) -> torch.Tensor:
    """[C, N] int32 exponential durations (ms, >= 1) for each node's draw
    ordinal ``counters`` [C, N] under the per-cluster keys ``key``
    [C, 2] (uint32): one inverse-CDF uniform per node from
    ``fold_in(fold_in(key, node), 2k + kind)``. ``kind`` 0 is
    time-to-failure, 1 time-to-repair."""
    k = key.to(torch.int64)
    n = torch.arange(counters.shape[-1], dtype=torch.int64,
                     device=key.device).expand(counters.shape)
    a0, a1 = fold_in(k[:, 0:1], k[:, 1:2], n)
    b0, b1 = fold_in(a0, a1, (2 * counters.to(torch.int64) + kind) & M32)
    u = uniform_scalar(b0, b1)
    dt = torch.ceil(-float(np.float32(mean_ms)) * xla_log_f32(u))
    return dt.clamp(1.0, float(MAX_DT)).to(torch.int32)


def gather_event(table: torch.Tensor, cursor: torch.Tensor) -> torch.Tensor:
    """[C, N] entry ``table[c, n, cursor[c, n]]``, NEVER past the last
    interval: the trace-mode next-interval lookup."""
    E = table.shape[-1]
    idx = cursor.clamp(0, E - 1).long()[..., None]
    got = torch.gather(table, -1, idx)[..., 0]
    return torch.where(cursor < E, got, NEVER)


def initial_next_fail(key: torch.Tensor, n_nodes: int, fc: FaultConfig,
                      eligible=None) -> torch.Tensor:
    """[C, N] first-failure clocks in generative mode (draw ordinal 0,
    relative to t = 0) for the keys ``key`` [C, 2]. ``eligible`` [C, N]
    masks churn to real machines: other slots get NEVER."""
    zeros = torch.zeros((key.shape[0], n_nodes), dtype=torch.int32,
                        device=key.device)
    nf = _exp_draws(key, zeros, 0, fc.mttf_ms)
    if eligible is None:
        return nf
    return torch.where(torch.as_tensor(eligible, device=key.device), nf,
                       NEVER)


def pack_fault_trace(events: Sequence[tuple], C: int, N: int,
                     max_events: int) -> tuple[np.ndarray, np.ndarray]:
    """Pack an explicit ``(cluster, node, fail_t_ms, repair_t_ms)`` event
    list into the per-node sorted interval tables (host numpy, once per
    run). Intervals sort by fail time; a repair at or before its fail
    makes a zero-length outage that still kills. More than ``max_events``
    intervals on one node raise rather than truncate."""
    fail = np.full((C, N, max_events), NEVER, np.int32)
    repair = np.full((C, N, max_events), NEVER, np.int32)
    per_node: dict[tuple, list] = {}
    for c, n, ft, rt in events:
        if not (0 <= c < C and 0 <= n < N):
            raise ValueError(f"fault event ({c}, {n}) outside [{C}, {N})")
        per_node.setdefault((int(c), int(n)), []).append((int(ft), int(rt)))
    for (c, n), ivals in per_node.items():
        if len(ivals) > max_events:
            raise ValueError(
                f"node ({c}, {n}) has {len(ivals)} fault intervals; "
                f"faults.max_events={max_events} — raise the bound")
        ivals.sort()
        for i, (ft, rt) in enumerate(ivals):
            fail[c, n, i] = ft
            repair[c, n, i] = rt
    return fail, repair


def cluster_keys(seed: int, C: int) -> torch.Tensor:
    """[C, 2] uint32 (CPU): ``fold_in(PRNGKey(seed), c)`` for every global
    cluster index c, ``PRNGKey(seed)`` being ``(0, uint32(seed))``."""
    c = torch.arange(C, dtype=torch.int64)
    k0, k1 = fold_in(c & 0, (c & 0) + (int(seed) & M32), c)
    return torch.stack([k0, k1], 1).to(torch.uint32)


def init_fault_state(fc: FaultConfig, C: int, N: int,
                     events: Optional[Sequence[tuple]] = None,
                     eligible=None, device=None) -> FaultState:
    """The pristine all-healthy fault state, on ``device``. ``events``
    gives the trace-mode schedule (required when ``fc.mode == "trace"``
    and ``fc.enabled``); generative mode derives per-cluster keys from
    ``fc.seed`` and the global cluster index and draws first failures for
    the ``eligible`` [C, N] slots only (all when None). With the plane off
    the leaves are inert zeros and NEVERs."""
    E = max(int(fc.max_events), 1)
    never = torch.full((C, N), NEVER, dtype=torch.int32)
    keys = torch.zeros((C, 2), dtype=torch.uint32)
    fail_t = torch.full((C, N, E), NEVER, dtype=torch.int32)
    repair_t = fail_t.clone()
    next_fail = never
    if fc.enabled and fc.mode == "trace":
        if events is None:
            raise ValueError("faults.mode='trace' needs an event list "
                             "(init_state(..., fault_events=...))")
        ft, rt = pack_fault_trace(events, C, N, E)
        fail_t, repair_t = torch.from_numpy(ft), torch.from_numpy(rt)
        next_fail = fail_t[:, :, 0].clone()
    elif fc.enabled:
        keys = cluster_keys(fc.seed, C)
        elig = None if eligible is None else torch.as_tensor(
            np.asarray(eligible, bool))
        next_fail = initial_next_fail(keys, N, fc, elig)

    def dev(x):  # a tensor of its own: the engine updates leaves in place
        return x.to(device, copy=True).contiguous()

    zc = torch.zeros((C,), dtype=torch.int32)
    return FaultState(
        health=dev(torch.ones((C, N), dtype=torch.bool)),
        was_active=dev(torch.zeros((C, N), dtype=torch.bool)),
        next_fail=dev(next_fail), down_until=dev(never),
        down_since=dev(torch.zeros((C, N), dtype=torch.int32)),
        n_fails=dev(torch.zeros((C, N), dtype=torch.int32)),
        kills=dev(zc), requeues=dev(zc), down_ms=dev(zc),
        fail_t=dev(fail_t), repair_t=dev(repair_t), key=dev(keys))


def reseed(fs: FaultState, key: torch.Tensor, fc: FaultConfig,
           eligible=None) -> FaultState:
    """A pristine generative fault state re-derived from the root key
    ``key`` ([2] uint32): per-cluster keys ``fold_in(key, c)`` and fresh
    first failures for the ``eligible`` [C, N] slots (all when None);
    the trace tables are kept."""
    C, N = fs.health.shape
    dev = fs.health.device
    k = key.to(torch.int64).to(dev)
    c = torch.arange(C, dtype=torch.int64, device=dev)
    k0, k1 = fold_in(k[0] + (c & 0), k[1] + (c & 0), c)
    keys = torch.stack([k0, k1], 1)
    keys = to_u32(keys)
    next_fail = initial_next_fail(keys, N, fc, eligible)

    def full(shape, value, dtype=torch.int32):
        return torch.full(shape, value, dtype=dtype, device=dev)

    return fs.replace(
        health=full((C, N), True, torch.bool),
        was_active=full((C, N), False, torch.bool),
        next_fail=next_fail, down_until=full((C, N), NEVER),
        down_since=full((C, N), 0), n_fails=full((C, N), 0),
        kills=full((C,), 0), requeues=full((C,), 0), down_ms=full((C,), 0),
        key=keys)
