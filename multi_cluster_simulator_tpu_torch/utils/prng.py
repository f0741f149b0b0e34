"""jax.random's threefry draws as PyTorch ops, bitwise, on any device.

The environment mode splits a key per env and step and draws each tick's
arrivals from it (workload/traces.py ``tick_arrivals_device``,
envs/cluster_env.py). These are jax's algorithms under
``jax_threefry_partitionable`` (the default from jax 0.5): a draw of
shape S from key k takes the threefry2x32 block of k over the counter
``(hi, lo)`` of each element's row-major index in S. A key is a ``[..., 2]``
uint32 tensor (a batch of keys has leading axes); the words compute on
int64 tensors masked to 32 bits (faults/schedule.py ``threefry2x32``),
since torch has no CPU arithmetic on uint32.
"""

from __future__ import annotations

import math

import torch

from multi_cluster_simulator_tpu_torch.faults.schedule import (
    M32, threefry2x32, to_u32,
)


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
