"""Float steps written out so that they round as the reference's compiled
CPU code rounds them.

XLA's CPU backend fuses some multiplies and adds into one fused
multiply-add (the tesserae dot, the market's ``a*b + c*d`` and
``x - y*z``, the uniform draw's ``f * span + min``, the steps of its f32
``log``); PyTorch rounds each product and sum on its own. ``fma_f32`` is
the fused step on any device, the one the CUDA kernels spell
``__fmaf_rn``.
"""

from __future__ import annotations

import torch


def fma_f32(a: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` of f32 tensors rounded once to f32 (the IEEE fused
    multiply-add, which the CUDA kernel calls as ``__fmaf_rn``): the
    product is exact in f64 (24 + 24 significant bits), the sum is rounded
    to odd in f64 through its two-sum error term, and the one rounding to
    f32 after that is the correctly rounded result."""
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(torch.float64)
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.to(torch.float32)


# XLA's CPU tree reduction (``TreeReductionRewriter``): a sum over more
# values than this is a ``reduce-window`` of windows this wide, then a
# reduce over the windows' sums
REDUCE_WINDOW = 32


def xla_sum(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum over the leading axis as the reference's compiled reduce
    adds it: up to ``REDUCE_WINDOW`` values one chain from 0 in index
    order; beyond, the values padded with zeros to whole windows (the
    padding split low ``p // 2``, high the rest), each window a chain from
    0, and the windows' sums reduced the same way again."""
    n = x.shape[0]
    if n > REDUCE_WINDOW:
        m = -(-n // REDUCE_WINDOW)
        pad = REDUCE_WINDOW * m - n
        z = x.new_zeros((pad // 2,) + x.shape[1:])
        x = torch.cat([z, x, x.new_zeros((pad - pad // 2,) + x.shape[1:])])
        windows = x.view((m, REDUCE_WINDOW) + x.shape[1:]).transpose(0, 1)
        return xla_sum(xla_sum(windows))
    acc = torch.zeros_like(x[0])
    for part in x.unbind(0):
        acc = acc + part
    return acc


def _f32(h: int) -> float:
    """The f32 constant LLVM prints as the double of hex bits ``h``."""
    import struct
    return struct.unpack(">d", h.to_bytes(8, "big"))[0]


# XLA's CPU f32 ``exp`` (the ``*.ir-with-opt.ll`` and object file that
# ``XLA_FLAGS=--xla_dump_to=DIR`` writes for ``jax.jit(jnp.exp)``): the
# argument clamped, n = floor(x log2 e + 1/2) clamped to +-127, the
# Cody-Waite reduction by ln 2 in two parts, a degree-5 polynomial, times
# 2^n; every multiply-add of it one fused step in the object file
_EXP_LO, _EXP_HI = _f32(0xC055F33340000000), _f32(0x4056333340000000)
_FLT_MIN = _f32(0x3810000000000000)
_EXP_LOG2E = _f32(0x3FF7154760000000)
_EXP_LN2 = (_f32(0x3FE6300000000000), _f32(0xBF2BD01060000000))
_EXP_P = tuple(_f32(h) for h in (0x3F2A0D2CE0000000, 0x3F56E879C0000000,
                                 0x3F81112100000000, 0x3FA5553820000000,
                                 0x3FC5555540000000))


def xla_exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``jax.jit(jnp.exp)`` on XLA's CPU backend, bitwise, for finite f32
    ``x`` of any shape (``torch.exp`` rounds differently; a result below
    the least normal f32 is 0, as the compiled code flushes it)."""
    def c(v):
        return torch.full_like(x, v)

    x = torch.minimum(torch.maximum(x, c(_EXP_LO)), c(_EXP_HI))
    n = torch.floor(fma_f32(x, c(_EXP_LOG2E), c(0.5))).clamp(-127.0, 127.0)
    r = fma_f32(-n, c(_EXP_LN2[1]), fma_f32(-n, c(_EXP_LN2[0]), x))
    p = c(_EXP_P[0])
    for k in _EXP_P[1:]:
        p = fma_f32(p, r, c(k))
    p = fma_f32(p, r, c(0.5))
    y = fma_f32(p, r * r, r) + 1.0
    scale = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = y * scale
    # the compiled code flushes a subnormal result to zero
    return torch.where(out < _FLT_MIN, 0.0, out)
