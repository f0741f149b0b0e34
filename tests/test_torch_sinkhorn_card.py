"""The sinkhorn round's CUDA kernel (``kernels/csrc/sinkhorn_round.cu``)
against its plain version on a card: K, ``u`` and ``vc`` after every
iteration and the plan, bitwise, on one device and with a mesh's all-sum
between the products. Marked ``cuda``: it skips without a card (the kernel
has no CPU form; tests/test_torch_sinkhorn.py holds the same source built
as host C++). Run on the card with ``python -m pytest
tests/test_torch_sinkhorn_card.py -m cuda -q``."""

import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu_torch.market import sinkhorn as S
from multi_cluster_simulator_tpu_torch.parallel.exchange import LocalExchange

ITERS = 16


class DoubledSum:
    """A stand-in for a mesh of 2 shards holding the same partial sums."""

    size = 2

    def allsum(self, x):
        return x + x


def round_inputs(c_loc, c_tot, seed, device, density=0.4):
    rng = np.random.default_rng(seed)
    feas = torch.from_numpy(rng.uniform(size=(c_loc, c_tot)) < density)
    jitter = torch.from_numpy(
        rng.uniform(size=(c_loc, c_tot)).astype(np.float32))
    v = torch.from_numpy(rng.uniform(0, 1, c_tot).astype(np.float32))
    args = (feas, jitter, v, torch.tensor(0.05, dtype=torch.float32),
            torch.tensor(ITERS, dtype=torch.int32))
    return [a.to(device) for a in args]


def with_edges(args):
    """tests/test_torch_sinkhorn.py's edge cases of the compact forms: two
    buyers whose exps underflow to 0, one with the largest finite exps, a
    seller and a buyer with no feasible pair, a seller whose feasible
    pairs all fall in one chain of the row plan."""
    feas, jitter, v, eps, iters = (a.clone() for a in args)
    C_loc, C_tot = feas.shape
    rows = torch.arange(C_loc, device=feas.device)[:, None]
    v[4:6] = -10.0
    feas[:, 4:6] |= rows % 3 == 0
    v[6] = 4.4
    feas[:, 6] = True
    feas[1] = False
    feas[:, 2] = False
    feas[3] = False
    feas[3, 3:8 * (C_tot // 8):8] = True
    return feas, jitter, v, eps, iters


def assert_equal_rounds(want, got):
    for name, a, b in zip(("K", "u", "vc", "plan"), want[:4], got[:4]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), name
    assert len(want[4]) == len(got[4])
    for i, ((ua, va), (ub, vb)) in enumerate(zip(want[4], got[4])):
        assert torch.equal(ua.view(torch.int32), ub.view(torch.int32)), i
        assert torch.equal(va.view(torch.int32), vb.view(torch.int32)), i


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU form")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 64), (73, 73), (128, 256),
                                   (1024, 1024), (4096, 4096)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh"])
def test_kernel_equals_plain_on_the_card(card, shape, mesh):
    ex = DoubledSum() if mesh else LocalExchange()
    args = round_inputs(*shape, seed=shape[0], device=card)
    got = S.sinkhorn_kernel(*args, ITERS, ex, trace=True)
    want = S.sinkhorn_plain(*args, ITERS, ex, trace=True)
    torch.cuda.synchronize()
    assert_equal_rounds(want, got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 300, 1024, 4096])
@pytest.mark.parametrize("mesh", [False, True], ids=["one", "mesh"])
def test_kernel_sparse_edges_on_the_card(card, n, mesh):
    """K at config 4's sparsity with the compact forms' edge cases, at the
    full and a partial active depth."""
    ex = DoubledSum() if mesh else LocalExchange()
    for depth in (ITERS, 7):
        args = with_edges(round_inputs(n, n, seed=n, device=card,
                                       density=0.025))
        args = (*args[:4], torch.tensor(depth, dtype=torch.int32,
                                        device=card))
        got = S.sinkhorn_kernel(*args, ITERS, ex, trace=True)
        want = S.sinkhorn_plain(*args, ITERS, ex, trace=True)
        torch.cuda.synchronize()
        assert_equal_rounds(want, got)
