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
