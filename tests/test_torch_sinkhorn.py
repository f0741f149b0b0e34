"""The sinkhorn round's numerics (``market/sinkhorn.py``) against the
reference's compiled program, and its CUDA source against its plain
version, on the CPU.

``reference_iterations`` is the reference round's Sinkhorn scan
(``multi_cluster_simulator_tpu/market/trader.py:310-321``) with the
active depth traced, as ``Engine.run`` compiles it: ``jax.jit`` of it gives
the same HLO for the scan body and the same object code for its two
products as the engine's program does (read from ``XLA_FLAGS=
--xla_dump_to`` dumps of both at 64 and 73 clusters). Each width's
``u`` and ``vc`` after every iteration and the plan must equal the plain
version's bitwise, from kernel matrices with entries from 1 to e^30 and
from 1 to e^1.5 (the first decides no order where one product dominates a
sum; the second does).

The CUDA source ``kernels/csrc/sinkhorn_round.cu`` also compiles as host
C++ (g++, ``-ffp-contract=off``, a shim ``cuda_runtime.h``): its launches
(``sinkhorn.launch_round``) on CPU tensors must equal the plain version
bitwise in K, in ``u`` and ``vc`` after every iteration and in the plan,
on one device and with a mesh's all-sum between the products. On a card
tests/test_torch_sinkhorn_card.py holds the built kernel the same way.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu_torch.kernels import build
from multi_cluster_simulator_tpu_torch.market import sinkhorn as S
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange

torch.set_num_threads(1)

ITERS = 16


def reference_iterations(K, iters):
    """The reference round's scan over a kernel matrix ``K``, the active
    depth ``iters`` traced: ``(u, vc, plan)``."""
    C_loc, C_tot = K.shape
    tiny = jnp.float32(1e-30)

    def sink_step(uv, i):
        u, vc = uv
        act = i < iters
        u2 = 1.0 / jnp.maximum(K @ vc, tiny)
        vc2 = 1.0 / jnp.maximum(K.T @ u2, tiny)
        return (jnp.where(act, u2, u), jnp.where(act, vc2, vc)), None

    (u, vc), _ = jax.lax.scan(
        sink_step, (jnp.ones((C_loc,), jnp.float32),
                    jnp.ones((C_tot,), jnp.float32)),
        jnp.arange(ITERS, dtype=jnp.int32))
    return u, vc, u[:, None] * K * vc[None, :]


_REFERENCE = jax.jit(reference_iterations)


def kernel_matrix(c_loc, c_tot, seed, density, top):
    rng = np.random.default_rng(seed)
    K = np.exp(rng.uniform(0, top, (c_loc, c_tot))).astype(np.float32)
    return K * (rng.uniform(size=(c_loc, c_tot)) < density)


def bits(x):
    return np.asarray(x).view(np.int32)


def assert_orders_equal(c_loc, c_tot, density, seeds=(0,)):
    for seed in seeds:
        for top in (30.0, 1.5):
            K = kernel_matrix(c_loc, c_tot, seed, density, top)
            u, vc, plan, seen = S.iterate_plain(
                torch.from_numpy(K), torch.tensor(ITERS), ITERS,
                LocalExchange(), trace=True)
            for i, (tu, tvc) in enumerate(seen):
                ju, jvc, jplan = _REFERENCE(K, jnp.int32(i + 1))
                what = f"{c_loc}x{c_tot} seed {seed} top {top} iteration {i}"
                np.testing.assert_array_equal(bits(tu), bits(ju), what)
                np.testing.assert_array_equal(bits(tvc), bits(jvc), what)
            np.testing.assert_array_equal(bits(plan), bits(jplan))


@pytest.mark.parametrize("shape", [(16, 16), (24, 24), (64, 64), (73, 73),
                                   (50, 50), (100, 100), (2, 4), (128, 256),
                                   (256, 256), (300, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_orders_equal_jit(shape):
    """The widths the port runs config 4's world at on one device (16, 24,
    64, 73, 256), the mesh's shards (tests/test_torch_mesh_paths.py's 2 x
    4, the 256-cluster cell's 128 x 256 over 2 ranks), and one of each
    other class (50: two accumulators; 100 and 300: a 4-lane epilogue)."""
    assert_orders_equal(*shape, density=0.6)


@pytest.mark.parametrize("shape", [
    (1024, 1024), pytest.param((4096, 4096), marks=pytest.mark.slow)],
    ids=lambda s: f"{s[0]}x{s[1]}")
def test_orders_equal_jit_at_width(shape):
    """1,024 (10e's width; ``K.T @ u`` the loop fusion) and 4,096 (config
    4; the tiled gemv over K's transposed copy), sparse as the round's K
    is."""
    assert_orders_equal(*shape, density=0.05)


@pytest.mark.slow
def test_orders_equal_jit_sweep():
    """Every seller count 1-160 and 256-290 (each remainder past the main
    vector body), square and with four times the buyers, and the mesh's
    2,048 x 4,096 shard."""
    shapes = [(n, n) for n in range(1, 161)] + \
        [(n, n) for n in range(256, 291)] + \
        [(n, 4 * n) for n in (7, 49, 50, 63, 64, 73, 127, 128, 131)] + \
        [(2048, 4096)]
    for c_loc, c_tot in shapes:
        assert_orders_equal(c_loc, c_tot,
                            density=0.05 if c_loc > 1000 else 0.6)


@pytest.mark.parametrize("n", [1, 5, 31, 49, 50, 63, 64, 73, 99, 127, 128,
                               131, 300, 4095, 4096])
def test_plans_take_every_index_once(n):
    for plan in (S.fused_dot_plan(n), S.gemv_plan(n, 9),
                 S.col_plan(n, max(n, 4096))):
        seen = sorted(b + lane for st in plan for blk in st.blocks
                      for b in blk for lane in range(st.lanes))
        assert seen == list(range(n))
        table, blocks = S.pack_plan(plan)
        assert table.shape == (len(plan), 7)


# ---------------------------------------------------------------------------
# the CUDA source, built as host C++
# ---------------------------------------------------------------------------

SHIM = """#pragma once
#include <stddef.h>
#include <stdint.h>
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++: the kernel's host build needs a C++17 compiler")
    d = tmp_path_factory.mktemp("sinkhorn_host")
    (d / "cuda_runtime.h").write_text(SHIM)
    out = d / "libsinkhorn_round.so"
    proc = subprocess.run(
        [gxx, "-std=c++17", "-O1", "-shared", "-fPIC", "-ffp-contract=off",
         "-w", "-I", str(d), "-x", "c++",
         str(build.CSRC / build.SOURCES["sinkhorn_round"]), "-o", str(out)],
        capture_output=True, text=True)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return ctypes.CDLL(str(out))


class DoubledSum:
    """A stand-in for a mesh of 2 shards holding the same partial sums:
    ``allsum`` is the partial added to itself, as in both paths."""

    size = 2

    def allsum(self, x):
        return x + x


def round_inputs(c_loc, c_tot, seed, iters=ITERS):
    rng = np.random.default_rng(seed)
    feas = torch.from_numpy(rng.uniform(size=(c_loc, c_tot)) < 0.4)
    jitter = torch.from_numpy(
        rng.uniform(size=(c_loc, c_tot)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 1, c_tot).astype(np.float32))
    return (feas, jitter, v, torch.tensor(0.05, dtype=torch.float32),
            torch.tensor(iters, dtype=torch.int32))


def assert_rounds_equal(want, got, what):
    for name, a, b in zip(("K", "u", "vc", "plan"), want[:4], got[:4]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), \
            f"{what}: {name}"
    assert len(want[4]) == len(got[4])
    for i, ((ua, va), (ub, vb)) in enumerate(zip(want[4], got[4])):
        assert torch.equal(ua.view(torch.int32), ub.view(torch.int32)), \
            f"{what}: u after iteration {i}"
        assert torch.equal(va.view(torch.int32), vb.view(torch.int32)), \
            f"{what}: vc after iteration {i}"


@pytest.mark.parametrize("shape", [(3, 5), (16, 16), (24, 24), (64, 64),
                                   (73, 73), (100, 100), (128, 256),
                                   (300, 300)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh"])
def test_host_kernel_equals_plain(host_lib, shape, mesh):
    """Every launch of the round's source (build, the two products, the
    mesh's finish, the plan) on CPU tensors against ``sinkhorn_plain``,
    with the full active depth and with 5 of 16 iterations active."""
    ex = DoubledSum() if mesh else LocalExchange()
    for iters in (ITERS, 5):
        args = round_inputs(*shape, seed=shape[0], iters=iters)
        S.reset_launches()
        got = S.launch_round(host_lib, 0, *args, ITERS, ex,
                             trace=True)
        assert S.LAUNCHES["sinkhorn_round"] == 1
        assert S.LAUNCHES["sinkhorn_product"] == 2 * ITERS
        assert S.LAUNCHES["sinkhorn_finish"] == (ITERS if mesh else 0)
        want = S.sinkhorn_plain(*args, ITERS, ex, trace=True)
        assert_rounds_equal(want, got, f"{shape} iters {iters}")


@pytest.mark.slow
def test_host_kernel_at_4096(host_lib):
    """Config 4's width: the column product as the tiled gemv over KT."""
    args = round_inputs(4096, 4096, seed=4)
    args = (args[0] & (torch.rand(4096, 4096,
                                  generator=torch.Generator().manual_seed(4))
                       < 0.05), *args[1:])
    got = S.launch_round(host_lib, 0, *args, ITERS,
                         LocalExchange(), trace=True)
    want = S.sinkhorn_plain(*args, ITERS, LocalExchange(), trace=True)
    assert_rounds_equal(want, got, "4096")


def test_round_routes_by_device():
    """The CPU takes the plain version and launches nothing; a tensor on
    no supported device raises."""
    args = round_inputs(8, 8, seed=1)
    S.reset_launches()
    K, u, vc, plan = S.sinkhorn_round(*args, ITERS, LocalExchange())
    assert not S.LAUNCHES and plan.shape == (8, 8)
    with pytest.raises(ValueError, match="not a card"):
        S.sinkhorn_kernel(*args, ITERS, LocalExchange())
