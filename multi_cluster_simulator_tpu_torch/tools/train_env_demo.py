"""Train a tiny policy head end to end on the device: the proof the RL loop
closes (the port of ``tools/train_env_demo.py``, which imports jax).

The head is one linear map ``W: [n_obs] -> [N_JOB_CLASSES *
N_DEVICE_TYPES]`` from the mean-pooled cluster observation to the rl
action matrix (the ``rl_scores`` leaf). Training is evolution strategies:
every env of the batch rolls out one perturbed head ``W + sigma * eps_i``
for a full episode (its own PRNG stream drawing its own arrivals), and the
update moves ``W`` along the return-weighted perturbation mean. An
iteration is one reset batch (cloned from the reset the run made once) and
``episode_ticks`` calls of ``ClusterEnv.batch_step_fn``, each launching
the scored kernel once over every env with each env's own table.

The draws are ``jax.random.normal``'s, bitwise (``utils/prng.py
normal``), and the float steps follow the reference's compiled CPU code
as XLA's dump shows them (``--xla_dump_to``): the head's pooled mean and
matrix-vector product, the perturbation, the returns' mean and deviation
and the update (``_head``, ``_perturb``, ``_update``), so a run on the
CPU is the reference's bitwise at every env count the update's order was
read for (tests/test_torch_train_env.py).

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.train_env_demo
[--iters N] [--envs B] [--device cpu]`` (the card by default).
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.market.sinkhorn import (
    PlanProduct,
    Stage,
    epilogue_lanes,
)
from multi_cluster_simulator_tpu_torch.ops.floats import (
    REDUCE_WINDOW,
    fma_f32,
    xla_sum,
)
from multi_cluster_simulator_tpu_torch.utils.prng import SQRT2_F32


def train_specs(n_clusters: int):
    """Heterogeneous clusters (the tournament's shape, ``tournament._specs``):
    the last two of five nodes accelerator-typed, so the class ->
    device-type action matrix has something real to steer."""
    from multi_cluster_simulator_tpu_torch.tools.tournament import _specs

    return _specs(n_clusters)


def train_cfg(faults=None):
    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig

    cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                    queue_capacity=16, max_running=64, max_arrivals=8,
                    max_ingest_per_tick=8, max_nodes=5, max_virtual_nodes=0)
    return cfg if faults is None else dataclasses.replace(cfg, faults=faults)


def _seq_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The f32 sum over ``dim`` in index order, as XLA's CPU loop adds."""
    parts = x.unbind(dim)
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    return acc


def _recip(n: int) -> float:
    """XLA's CPU code divides by a constant as a product with its f32
    reciprocal."""
    return float(np.float32(1.0) / np.float32(n))


def _head(W: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """[B, 4, 4] actions: each env's observation pooled over its clusters
    (the sum in cluster order, times 1 / C) and mapped by its own head,
    as XLA's column-major gemv: one fused multiply-add a feature, in
    feature order."""
    B = obs.shape[0]
    pooled = _seq_sum(obs, 1) * _recip(obs.shape[1])  # [B, F]
    acc = torch.zeros(W.shape[0], W.shape[2], dtype=torch.float32,
                      device=W.device)
    for f in range(W.shape[1]):
        acc = fma_f32(pooled[:, f, None].expand_as(acc), W[:, f], acc)
    return acc.reshape(B, 4, 4)


def _perturb(W: torch.Tensor, r: torch.Tensor, sigma: float):
    """``W[None] + sigma * eps`` for ``eps = sqrt(2) * r``: XLA folds the
    two constants into one f32 product and fuses the rest into one
    multiply-add."""
    c = float(np.float32(sigma) * np.float32(SQRT2_F32))
    return fma_f32(r, torch.full_like(r, c), W[None].expand_as(r))


# The weighted sum's order was read up to this many envs; from 4,096 the
# reference compiles the einsum another way (not read)
MAX_ENVS = 4095


def weighted_sum_plan(B: int) -> tuple:
    """The order of ``einsum("b,b...->...", z, eps)`` over ``B`` envs, as a
    reduction plan (``market/sinkhorn.py`` ``Stage``): LLVM's vectorized
    loop over the envs in the reference's compiled code, a fused
    multiply-add a step.

    - 1-7 and 9-15: one chain in env order;
    - 8: 8 lanes, halved;
    - 16-19: 8 lanes over envs 0-15 in one chain; 20-23: 4 lanes over
      envs 0-15 in one chain, blocks 0, 8, 12, 4 (the loop unrolled, the
      second accumulator's blocks swapped); 24-31: 8 lanes over envs 0-23
      in one chain;
    - from 32: two 8-lane accumulators over the largest multiple of 16,
      summed lane by lane;
    - then halving; then, after the 8-lane forms but 24-31, the ``r``
      envs left take an epilogue of 2, 4 or 8 lanes seeded with the sum
      so far and halved (``epilogue_lanes``); then a chain of their own,
      seeded likewise."""
    if not 1 <= B <= MAX_ENVS:
        raise ValueError(f"the reference's order of the ES update was read "
                         f"for 1-{MAX_ENVS} envs, not {B}")
    if B != 8 and B < 16:
        return (Stage(1, (tuple(range(B)),)),)
    epilogue = True
    if B == 8:
        stages, pos = [Stage(8, ((0,),))], 8
    elif B < 20:
        stages, pos = [Stage(8, ((0, 8),))], 16
    elif B < 24:
        stages, pos, epilogue = [Stage(4, ((0, 8, 12, 4),))], 16, False
    elif B < 32:
        stages, pos, epilogue = [Stage(8, ((0, 8, 16),))], 24, False
    else:
        pos = 16 * (B // 16)
        stages = [Stage(8, (tuple(range(0, pos, 16)),
                            tuple(range(8, pos, 16))))]
    lanes = epilogue_lanes(B - pos) if epilogue else 0
    if lanes:
        nb = (B - pos) // lanes
        stages.append(Stage(lanes, (tuple(range(pos, pos + lanes * nb,
                                                lanes)),), seeded=True))
        pos += lanes * nb
    if pos < B:
        stages.append(Stage(1, (tuple(range(pos, B)),), seeded=True))
    return tuple(stages)


def _update(W: torch.Tensor, eps: torch.Tensor, ret: torch.Tensor,
            lr: float, n_envs: int):
    """The ES step: ``z = (ret - mean) / (std + 1e-6)`` and ``W + (lr / B)
    * sum_b z_b eps_b``, every float step in the reference's compiled
    order at every env count it was read for (ROADMAP C3): the mean
    ``xla_sum`` times 1 / B; the squares up to ``REDUCE_WINDOW`` envs a
    chain of fused multiply-adds from 0 (the reduce fused with them),
    beyond rounded first and summed by ``xla_sum``; a true division for
    ``z``; the weighted sum by ``weighted_sum_plan``; the update one fused
    multiply-add with the f32 constant ``lr / n_envs``."""
    B = ret.shape[0]
    plan = weighted_sum_plan(B)
    mean = xla_sum(ret) * _recip(B)
    d = ret - mean
    if B > REDUCE_WINDOW:
        sq = xla_sum(d * d)
    else:
        sq = torch.zeros_like(d[0])
        for x in d.unbind(0):
            sq = fma_f32(x, x, sq)
    std = torch.sqrt((sq * _recip(B)).double()).float()
    z = d / (std + 1e-6)
    ws = PlanProduct(eps.reshape(B, -1).T, plan)(z).reshape(W.shape)
    scale = torch.full_like(W, float(np.float32(lr / n_envs)))
    return fma_f32(ws, scale, W), mean


def train(iters=10, n_envs=32, n_clusters=4, episode_ticks=20, lr=0.5,
          sigma=0.3, seed=0, rate=2.0, reward="neg_mean_wait",
          checkpoint=None, resume=False, faults=None, device=None,
          timings=False):
    """Run ``iters`` ES iterations; returns a dict with the per-iteration
    mean returns, the trained head and timing, the reference's keys.
    Deterministic for a fixed seed (common random numbers: every iteration
    rolls out from the same reset batch).

    ``checkpoint`` saves the bundle ``{"W", "key", "es0", "obs0"}`` after
    every iteration in the reference's ``MCSCKPT1`` format (a file either
    package writes resumes in the other); ``resume=True`` continues from
    it, the saved reset batch (with every env's fault streams) replacing
    the one this call made. ``faults`` is an optional FaultConfig for
    churn during training. ``device`` defaults to the card.
    ``timings=True`` adds the seconds each iteration spent on the draws,
    the steps and the update (each phase synchronised)."""
    from multi_cluster_simulator_tpu_torch.core.state import resolve_device
    from multi_cluster_simulator_tpu_torch.envs import ClusterEnv, StreamGen
    from multi_cluster_simulator_tpu_torch.ops import fields as F
    from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
    from multi_cluster_simulator_tpu_torch.utils import prng
    from multi_cluster_simulator_tpu_torch.utils.tree import tree_map

    weighted_sum_plan(n_envs)  # refuses a count whose order was not read
    dev = resolve_device(device)
    cfg = train_cfg(faults)
    env = ClusterEnv(cfg, train_specs(n_clusters),
                     episode_ticks=episode_ticks,
                     gen=StreamGen(rate=rate, k_max=8, max_cores=24,
                                   max_mem=18_000, max_dur_ms=10_000),
                     policies=PolicySet(("rl",)), reward=reward, device=dev)
    act_dim = F.N_JOB_CLASSES * F.N_DEVICE_TYPES
    obs0, es0 = env.reset_batch(prng.prng_key(seed, dev), n_envs)
    step = env.batch_step_fn()

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return time.perf_counter()

    split = {"draws_s": [], "steps_s": [], "update_s": []}

    def es_iter(W, key):
        t0 = sync() if timings else 0.0
        ks = prng.split(key, 2)
        key, ke = ks[0].clone(), ks[1]
        r = prng.normal_erf_inv(ke, (n_envs,) + tuple(W.shape))
        eps = r * SQRT2_F32  # jax.random.normal's draws
        Wb = _perturb(W, r, sigma)
        t1 = sync() if timings else 0.0
        es = tree_map(torch.clone, es0)
        obs = obs0
        ret = torch.zeros(n_envs, dtype=torch.float32, device=dev)
        for _ in range(episode_ticks):
            obs, r, _d, _info, es = step(es, _head(Wb, obs))
            ret = ret + r
        t2 = sync() if timings else 0.0
        W2, mean = _update(W, eps, ret, lr, n_envs)
        if timings:
            t3 = sync()
            split["draws_s"].append(t1 - t0)
            split["steps_s"].append(t2 - t1)
            split["update_s"].append(t3 - t2)
        return W2, key, mean

    W = torch.zeros((env.n_obs, act_dim), dtype=torch.float32, device=dev)
    key = prng.prng_key(seed + 1, dev)
    means = []
    start_iter = 0
    if checkpoint is not None and resume and os.path.exists(checkpoint):
        from multi_cluster_simulator_tpu_torch.core import checkpoint as ckio

        bundle = ckio.load_tree(
            checkpoint, {"W": W, "key": key, "es0": es0, "obs0": obs0},
            cfg=cfg)
        extra = ckio.load_extra(checkpoint)
        W, key = bundle["W"], bundle["key"]
        # the reset batch is restored, not re-derived: es0 carries every
        # env's fault streams and PRNG state
        es0, obs0 = bundle["es0"], bundle["obs0"]
        start_iter = int(extra.get("iter", 0))
        means = list(extra.get("means", []))
        print(f"# resumed ES training from {checkpoint} at iter "
              f"{start_iter}", file=sys.stderr)
    t0 = sync()
    for i in range(start_iter, iters):
        W, key, mean_ret = es_iter(W, key)
        means.append(float(mean_ret))
        if checkpoint is not None:
            from multi_cluster_simulator_tpu_torch.core import (
                checkpoint as ckio,
            )

            ckio.save_tree(
                {"W": W, "key": key, "es0": es0, "obs0": obs0},
                checkpoint, t=i + 1,
                extra={"iter": i + 1, "means": means}, cfg=cfg)
    wall = sync() - t0
    out = {
        "mean_return_per_iter": means,
        "first_iter_return": means[0],
        "last_iter_return": means[-1],
        "head_norm": float(np.linalg.norm(W.cpu().numpy())),
        "W": W.cpu().numpy(),
        "envs": n_envs, "episode_ticks": episode_ticks, "iters": iters,
        "episodes_simulated": iters * n_envs,
        "wall_s": round(wall, 3),
        "reward": reward,
    }
    if timings:
        out["split"] = split
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--envs", type=int, default=32)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--episode-ticks", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reward", default="neg_mean_wait")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="save the training bundle (EnvState batch + ES "
                         "optimizer state + PRNG keys) after every "
                         "iteration")
    ap.add_argument("--resume", action="store_true",
                    help="continue a killed run from --checkpoint "
                         "bit-identically")
    args = ap.parse_args(argv)
    res = train(iters=args.iters, n_envs=args.envs,
                n_clusters=args.clusters, episode_ticks=args.episode_ticks,
                seed=args.seed, reward=args.reward, device=args.device,
                checkpoint=args.checkpoint, resume=args.resume)
    print(f"# {res['episodes_simulated']} episodes "
          f"({res['envs']} envs x {res['iters']} iters x "
          f"{res['episode_ticks']} ticks) in {res['wall_s']} s, "
          f"reward={res['reward']}", file=sys.stderr)
    print("| iter | mean return |")
    print("|---|---|")
    for i, m in enumerate(res["mean_return_per_iter"]):
        print(f"| {i} | {m:.4f} |")
    if not np.isfinite(res["mean_return_per_iter"]).all():
        print("non-finite returns", file=sys.stderr)
        return 1
    if res["head_norm"] == 0.0:
        print("the head never moved — the update is dead", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
