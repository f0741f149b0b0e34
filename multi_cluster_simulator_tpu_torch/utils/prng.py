"""jax.random's threefry draws as PyTorch ops, bitwise, on any device.

The environment mode splits a key per env and step and draws each tick's
arrivals from it (workload/traces.py ``tick_arrivals_device``,
envs/cluster_env.py). These are jax's algorithms under
``jax_threefry_partitionable`` (the default from jax 0.5): a draw of
shape S from key k takes the threefry2x32 block of k over the counter
``(hi, lo)`` of each element's row-major index in S. A key is a ``[..., 2]``
uint32 tensor (a batch of keys has leading axes); the words compute on
int64 tensors masked to 32 bits (faults/schedule.py ``threefry2x32``),
since torch has no CPU arithmetic on uint32. ``normal`` is
``jax.random.normal``: the uniform on [nextafter(-1, 0), 1) through XLA's
CPU f32 ``ErfInv`` written out (``xla_erf_inv_f32``), times f32 sqrt(2).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.faults.schedule import (
    M32, _hexf, threefry2x32, to_u32, xla_log_f32,
)
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax makes it from a 32-bit seed
    (its default, 64-bit types off): ``(0, seed mod 2^32)``, a [2] uint32
    tensor."""
    return to_u32(torch.tensor([0, int(seed) & M32], dtype=torch.int64,
                               device=device))


def words(key: torch.Tensor) -> torch.Tensor:
    """A uint32 key's words as int64 values in [0, 2^32) (read through an
    int32 view of the same bits)."""
    if key.dtype == torch.uint32:
        key = key.view(torch.int32)
    return key.to(torch.int64) & M32


def _blocks(key: torch.Tensor, shape: tuple):
    """threefry2x32 of each key over the counters of every element of
    ``shape``: two int64 word tensors of shape ``key.shape[:-1] + shape``."""
    k = words(key)
    lead = tuple(k.shape[:-1])
    n = math.prod(shape)
    idx = torch.arange(n, dtype=torch.int64, device=k.device).reshape(shape)
    expand = (None,) * len(shape)
    k0 = k[(..., 0, *expand)]
    k1 = k[(..., 1, *expand)]
    lo = idx.expand(lead + tuple(shape)) if lead else idx
    return threefry2x32(k0, k1, (lo >> 32) & M32, lo & M32)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)``: [..., num, 2] uint32, key i the
    block over the counter (0, i)."""
    y0, y1 = _blocks(key, (num,))
    return to_u32(torch.stack([y0, y1], -1))


def random_bits(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """The 32 random bits of every element (``jax.random.bits``): both
    block words xor-ed; int64 holding 32-bit values."""
    y0, y1 = _blocks(key, tuple(shape))
    return y0 ^ y1


def uniform(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in [0, 1), f32: the top 23 bits
    as a float in [1, 2), less one (exact)."""
    bits = random_bits(key, shape)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


def randint(key: torch.Tensor, shape: tuple, minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for int32
    bounds: two draws of 32 bits (the key split in two) folded into the
    span by the reference's remainder arithmetic, in uint32."""
    ks = split(key, 2)
    hi = random_bits(ks[..., 0, :], shape)
    lo = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & M32 if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = (mult * mult & M32) % span
    off = (((hi % span) * mult & M32) + lo % span) & M32
    off = off % span
    return (minval + off).to(torch.int32)


# XLA's CPU lowering of f32 ``log1p`` (the ``*.ir-with-opt.ll`` that
# ``XLA_FLAGS=--xla_dump_to=DIR`` writes for ``jax.jit(lax.erf_inv)``):
# below |a| < _LOG1P_SMALL the rational a - a^2/2 + a^3 P(a)/Q(a), each
# Horner step one fused multiply-add in the object file; above it the log
# of 1 + a (faults/schedule.py ``xla_log_f32``, the same inline code)
_LOG1P_SMALL = 0x3FDA8279A0000000
_LOG1P_Q = (0x402E2035A0000000, 0x4054C30B60000000, 0x406BB865A0000000,
            0x4073519460000000, 0x406B0DB140000000, 0x404E0F3040000000)
_LOG1P_P = (0x3F07BC0960000000, 0x3FDFE818A0000000, 0x401A509F40000000,
            0x403DE97380000000, 0x404E798EC0000000, 0x404C8E75A0000000,
            0x40340A2020000000)
# XLA's ErfInv32 (Giles' single-precision polynomial): the w < 5 branch
# on w - 2.5, the other on sqrt(w) - 3, highest degree first
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def xla_log1p_f32(a: torch.Tensor) -> torch.Tensor:
    """``log1p`` of f32 ``a`` as XLA's CPU backend compiles it, bitwise."""
    def c(h):
        return torch.full_like(a, _hexf(h))

    a2 = a * a
    q = torch.ones_like(a)
    for h in _LOG1P_Q:
        q = fma_f32(q, a, c(h))
    p = c(_LOG1P_P[0])
    for h in _LOG1P_P[1:]:
        p = fma_f32(p, a, c(h))
    small = fma_f32(torch.full_like(a, -0.5), a2, (a * a2) * (p / q)) + a
    return torch.where(a.abs() < c(_LOG1P_SMALL), small, xla_log_f32(a + 1.0))


def xla_erf_inv_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.lax.erf_inv`` of f32 ``x`` as XLA's CPU backend compiles it,
    bitwise (``torch.erfinv`` rounds differently): ``w = -log1p(-x^2)``,
    one of two polynomials by Horner's rule with a fused multiply-add a
    step, times ``x``; +-1 give +-inf."""
    l = xla_log1p_f32(x * -x)
    lt = l > -5.0  # w = -l < 5
    # the f32 square root correctly rounded, as the compiled code's: through
    # f64, exact for f32 arguments (torch's CPU f32 sqrt is not)
    root = torch.sqrt(-l.double()).to(torch.float32)
    t = torch.where(lt, -2.5 - l, root - 3.0)

    def coef(i):
        return torch.where(lt, torch.full_like(x, _ERFINV_LT[i]),
                           torch.full_like(x, _ERFINV_GE[i]))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT)):
        p = fma_f32(p, t, coef(i))
    p = torch.where(x.abs() == 1.0, torch.inf, p)
    return x * p


_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
SQRT2_F32 = float(np.float32(np.sqrt(2.0)))


def normal_erf_inv(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.normal``'s draw before its last product: the uniform on
    [nextafter(-1, 0), 1) from ``key``'s bits (its span rounds to 2 in
    f32, so the scale is exact) through ``xla_erf_inv_f32``. A caller
    that scales the normal by a constant multiplies this by the folded
    constant, as XLA's simplifier folds ``c * (sqrt(2) * x)``."""
    u = uniform(key, shape) * 2.0 + _NORMAL_LO
    u = torch.maximum(u, torch.full_like(u, _NORMAL_LO))
    return xla_erf_inv_f32(u)


def normal(key: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` (f32), bitwise: ``normal_erf_inv``
    times f32 sqrt(2)."""
    return normal_erf_inv(key, shape) * SQRT2_F32
