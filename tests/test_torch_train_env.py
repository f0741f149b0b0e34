"""The port's ES trainer (multi_cluster_simulator_tpu_torch/tools/
train_env_demo.py) against the JAX package's tools/train_env_demo.py, on
the CPU, and the draws it rests on.

``utils/prng.py normal`` is ``jax.random.normal`` bitwise: the uniform on
[nextafter(-1, 0), 1) through XLA's CPU f32 ``ErfInv`` written out
(``xla_erf_inv_f32``: ``w = -log1p(-x^2)``, Giles' two polynomials, a
fused multiply-add a step; ``log1p`` as the compiled code's rational and
its ``log``), times f32 sqrt(2); ``torch.erfinv`` is not. The trainer's
float steps follow the reference's compiled code (read from XLA's dump):
the perturbation one multiply-add with the folded constant sigma *
sqrt(2), the head's gemv a fused multiply-add a feature, the returns'
mean and deviation and the update's weighted sum in XLA's order, read
from its dumps at 1-64, 96, 100, 128, 256, 512, 1,000, 1,024 and 2,048
envs (ROADMAP C3) — so the returns and the head are bitwise the
reference's, no tolerance, at env counts on both sides of every switch
between the compiled forms, and the update alone (``_update`` against the
reference's update lines jitted the same way) over returns spread across
six decades. The resume (tests/test_preempt.py:386, generative faults) is
bitwise, and a bundle the reference wrote resumes in the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from multi_cluster_simulator_tpu.config import FaultConfig as JFaultConfig
from multi_cluster_simulator_tpu_torch.config import FaultConfig
from multi_cluster_simulator_tpu_torch.tools import train_env_demo as T
from multi_cluster_simulator_tpu_torch.utils import prng
from tools import train_env_demo as JT

FAULTS = dict(enabled=True, mode="generative", mttf_ms=8_000, mttr_ms=2_000,
              seed=5)


def bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_normal_is_jax_random_normal(seed):
    n = 1 << 20
    want = jax.random.normal(jax.random.PRNGKey(seed), (n,))
    got = prng.normal(prng.prng_key(seed), (n,))
    np.testing.assert_array_equal(bits(want), bits(got.numpy()))
    shape = (8, 19, 16)  # the trainer's draw
    want = jax.random.normal(jax.random.PRNGKey(seed), shape)
    np.testing.assert_array_equal(
        bits(want), bits(prng.normal(prng.prng_key(seed), shape).numpy()))


def test_erf_inv_is_the_compiled_erf_inv():
    lo = np.nextafter(np.float32(-1), np.float32(0))
    ends = np.array([-1.0, lo, -0.5, -0.0, 0.0, 1e-30, -1e-30, 0.41, 0.42,
                     0.8, 0.9975329, 1 - 2 ** -24, 1.0], np.float32)
    u = np.random.default_rng(0).uniform(-1, 1, 1 << 20).astype(np.float32)
    x = np.concatenate([ends, u, np.zeros(3, np.float32)])
    want = np.asarray(jax.jit(lax.erf_inv)(x))
    got = prng.xla_erf_inv_f32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(bits(want), bits(got))
    assert np.isinf(got[0]) and got[0] < 0 and np.isinf(got[12])


def test_torch_erfinv_differs():
    """Why the port writes ErfInv out: torch's rounds otherwise."""
    u = np.random.default_rng(1).uniform(-1, 1, 1 << 16).astype(np.float32)
    want = np.asarray(jax.jit(lax.erf_inv)(u))
    assert (bits(torch.erfinv(torch.from_numpy(u)).numpy())
            != bits(want)).any()


# env counts on both sides of each switch between the reference's compiled
# forms of the update (``weighted_sum_plan``, ``xla_sum``)
SWITCH_ENVS = (7, 9, 15, 16, 19, 20, 23, 24, 31, 33)


@pytest.mark.parametrize("kw", [
    dict(iters=3, n_envs=8, n_clusters=2, episode_ticks=8, seed=1),
    dict(iters=2, n_envs=32, n_clusters=4, episode_ticks=4, seed=0),
    dict(iters=3, n_envs=13, n_clusters=2, episode_ticks=8, seed=1),
    dict(iters=1, n_envs=1024, n_clusters=1, episode_ticks=4, seed=1),
] + [dict(iters=2, n_envs=b, n_clusters=2, episode_ticks=8, seed=2)
     for b in SWITCH_ENVS] + [
    dict(iters=2, n_envs=16, n_clusters=c, episode_ticks=12, seed=3)
    for c in (3, 5)],
    ids=lambda kw: f"{kw['n_envs']}-envs" + (
        f"-{kw['n_clusters']}-clusters" if kw["n_clusters"] in (3, 5)
        else ""))
def test_train_equals_jax(kw):
    """The returns and the trained head bitwise the reference's: 8 and 32
    envs, 13 (not a multiple of 8), 1,024 (the card's batch width,
    chip_smoke.py 10b), each side of every switch of forms, and 3 and 5
    clusters (the reward's mean over the clusters: a folded constant
    other than a power of two)."""
    want = JT.train(**kw)
    got = T.train(**kw, device="cpu")
    assert got["mean_return_per_iter"] == want["mean_return_per_iter"]
    np.testing.assert_array_equal(bits(got["W"]), bits(want["W"]))
    assert got["head_norm"] == want["head_norm"] > 0
    for k in ("envs", "episode_ticks", "iters", "episodes_simulated",
              "reward", "first_iter_return", "last_iter_return"):
        assert got[k] == want[k], k


LR, SIGMA, HEAD = 0.5, 0.3, (19, 16)


def reference_update(B, W, key, ret):
    """The reference's update lines (tools/train_env_demo.py es_iter) with
    the rollout's returns given: the draws, the perturbed heads (the
    rollout's input, so the draws have the same two consumers), the
    normalised returns and the step, jitted as the trainer is."""
    def upd(W, key, ret):
        key, ke = jax.random.split(key)
        eps = jax.random.normal(ke, (B,) + W.shape)
        Wb = W[None] + SIGMA * eps
        z = (ret - ret.mean()) / (ret.std() + 1e-6)
        W2 = W + (LR / B) * jnp.einsum("b,b...->...", z, eps)
        return W2, ret.mean(), Wb
    W2, mean, _ = jax.jit(upd)(W, key, ret)
    return np.asarray(W2), np.asarray(mean)


@pytest.mark.parametrize("B", [1, 2, 6, 7, 8, 9, 15, 16, 17, 18, 19, 20, 23,
                               24, 25, 31, 32, 33, 34, 36, 40, 44, 47, 48, 63,
                               64, 96, 100, 1000, 1024, 2048, 4095])
def test_update_equals_reference_update(B):
    """``_update`` against the reference's update on returns spread over six
    decades around an offset (so every sum's order shows in its bits): the
    mean and the new head bitwise, on each side of every switch, in each
    epilogue class (2, 4 and 8 lanes, 4 lanes over 12-15 envs left) and
    across the tree reduction's one and two levels."""
    rng = np.random.default_rng(B)
    ret = (rng.standard_normal(B) * 10 ** rng.uniform(-3, 3, B)
           - rng.uniform(-50, 50)).astype(np.float32)
    W = (0.1 * rng.standard_normal(HEAD)).astype(np.float32)
    want_W, want_mean = reference_update(B, jnp.asarray(W),
                                         jax.random.PRNGKey(B),
                                         jnp.asarray(ret))
    ke = prng.split(prng.prng_key(B), 2)[1]
    eps = prng.normal_erf_inv(ke, (B,) + HEAD) * prng.SQRT2_F32
    got_W, got_mean = T._update(torch.from_numpy(W), eps,
                                torch.from_numpy(ret), LR, B)
    np.testing.assert_array_equal(bits(got_mean.numpy()), bits(want_mean))
    np.testing.assert_array_equal(bits(got_W.numpy()), bits(want_W))


def test_update_refuses_unread_env_counts():
    """From 4,096 envs the reference compiles the weighted sum another way,
    whose order was not read: the trainer refuses rather than round
    otherwise."""
    with pytest.raises(ValueError, match="read for 1-4095 envs"):
        T.weighted_sum_plan(T.MAX_ENVS + 1)
    with pytest.raises(ValueError, match="not 4096"):
        T.train(iters=1, n_envs=4096, device="cpu")


def test_resume_with_generative_faults_bitwise(tmp_path):
    """tests/test_preempt.py:386 on the port: a killed run resumes
    bitwise, the reset batch's per-env fault streams included; its
    returns and head are the reference's too."""
    kw = dict(iters=3, n_envs=4, n_clusters=2, episode_ticks=5, seed=3)
    ck = str(tmp_path / "train.ckpt")
    full = T.train(**kw, faults=FaultConfig(**FAULTS), device="cpu")
    T.train(**{**kw, "iters": 1}, faults=FaultConfig(**FAULTS),
            checkpoint=ck, device="cpu")
    res = T.train(**kw, faults=FaultConfig(**FAULTS), checkpoint=ck,
                  resume=True, device="cpu")
    assert res["mean_return_per_iter"] == full["mean_return_per_iter"]
    np.testing.assert_array_equal(res["W"], full["W"])
    from multi_cluster_simulator_tpu_torch.core import checkpoint as ckio
    assert ckio.load_extra(ck)["iter"] == 3
    want = JT.train(**kw, faults=JFaultConfig(**FAULTS))
    assert full["mean_return_per_iter"] == want["mean_return_per_iter"]
    np.testing.assert_array_equal(bits(full["W"]), bits(want["W"]))


def test_jax_written_bundle_resumes_in_the_port(tmp_path):
    kw = dict(iters=3, n_envs=4, n_clusters=2, episode_ticks=5, seed=3)
    ck = str(tmp_path / "jax.ckpt")
    want = JT.train(**kw, faults=JFaultConfig(**FAULTS))
    JT.train(**{**kw, "iters": 1}, faults=JFaultConfig(**FAULTS),
             checkpoint=ck)
    got = T.train(**kw, faults=FaultConfig(**FAULTS), checkpoint=ck,
                  resume=True, device="cpu")
    assert got["mean_return_per_iter"] == want["mean_return_per_iter"]
    np.testing.assert_array_equal(bits(got["W"]), bits(want["W"]))


def test_main_gates_and_timings(capsys):
    assert T.main(["--iters", "2", "--envs", "8", "--clusters", "2",
                   "--episode-ticks", "8", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "| iter | mean return |" in out
    # three ticks place every job at once: zero returns, a dead update
    assert T.main(["--iters", "2", "--envs", "4", "--clusters", "2",
                   "--episode-ticks", "3", "--device", "cpu"]) == 1
    assert "the head never moved" in capsys.readouterr().err
    res = T.train(iters=2, n_envs=4, n_clusters=2, episode_ticks=3,
                  device="cpu", timings=True)
    assert {len(v) for v in res["split"].values()} == {2}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.train(iters=1, n_envs=2, n_clusters=1, episode_ticks=1)
