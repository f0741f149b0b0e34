"""The simulator as a batched gym on the device (the port of
``multi_cluster_simulator_tpu/envs/cluster_env.py``).

``ClusterEnv.step`` is the engine's tick (``Engine.step_tick``, the same
code ``run`` loops over) wrapped with observation, reward and auto-reset;
a batch of B envs is a lane-stacked state (every leaf with a leading [B],
core/engine.py ``lanes_of``), so one step launches each kernel once over
all B C clusters, each env's rl action read as its lane's table:

- **per-env PRNG streams**: every ``EnvState`` carries its own key; a step
  splits it and the generative workload draws the tick's arrivals from
  the split (workload/traces.py ``tick_arrivals_device``, bitwise the
  reference's draws) — no key is shared across the batch.
- **auto-reset with no host round trip**: an ending episode selects every
  state leaf back to the cached reset constellation (a per-leaf
  ``torch.where``), the fault streams' first failures re-derived from the
  env's own keys.
- **actions are policy parameters**: the action is the ``rl`` kind's
  ``rl_scores`` leaf [N_JOB_CLASSES, N_DEVICE_TYPES], a lane's own table
  in the scored kernel.
- **reward is data**: ``EnvState.reward_w`` weighs (negative mean wait,
  throughput, drop penalty); ``REWARD_VARIANTS`` names the built-ins.
- **two workload modes**: ``arrivals=`` replays a host-bucketed
  ``TickArrivals`` (on the device once) shared by every env; ``gen=``
  draws each tick's arrivals on the device from the env's key.

The batch's envs step in lockstep, so the env tracks their clock and
episode tick on the host beside the ``EnvState`` it returned: a step
hands the engine that clock and each lane's member (known since
construction), and neither the step nor its auto-reset synchronises
the host (``torch.cuda.set_sync_debug_mode("error")`` holds over a step
loop on the card). Handing a step an ``EnvState`` that no reset or step
returned reads the clock once. Steps update the ``EnvState`` in place (the reference's
donated batch step); ``donate=False`` steps a copy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core import state as st
from multi_cluster_simulator_tpu_torch.core.engine import Engine
from multi_cluster_simulator_tpu_torch.core.state import (
    SimState, TickArrivals, clone_state, init_state,
)
from multi_cluster_simulator_tpu_torch.envs.obs import n_obs_features, observe
from multi_cluster_simulator_tpu_torch.faults import schedule as fsch
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops.floats import fma_f32, xla_sum
from multi_cluster_simulator_tpu_torch.ops.queues import isum
from multi_cluster_simulator_tpu_torch.utils import prng
from multi_cluster_simulator_tpu_torch.utils.tree import (
    Tree, leaves_with_keys, tree_map,
)
from multi_cluster_simulator_tpu_torch.workload.traces import (
    tick_arrivals_device,
)

# reward variants as data: (wait, throughput, drop) weights for
# EnvState.reward_w. wait is the negated mean avg-wait in SECONDS,
# throughput the jobs placed this step, drop the summed drop-counter delta.
REWARD_VARIANTS = {
    "neg_mean_wait": (1.0, 0.0, 0.0),
    "throughput": (0.0, 1.0, 0.0),
    "drop_penalty": (1.0, 0.0, 10.0),
}


@dataclasses.dataclass(frozen=True)
class StreamGen:
    """Generative-mode workload parameters: ``rate`` expected jobs per
    cluster per tick, ``k_max`` the per-(tick, cluster) candidates (the
    bucketed path's K), the size and duration ceilings and the Beta
    shape."""

    rate: float = 2.0
    k_max: int = 8
    max_cores: int = 8
    max_mem: int = 6_000
    max_dur_ms: int = 20_000
    beta: float = 2.0


@dataclasses.dataclass
class EnvState(Tree):
    """One env's carried state, or a batch's (every leaf with a leading
    [B]); ``key`` is the env's own stream."""

    sim: SimState
    key: torch.Tensor  # [2] u32 — the env's PRNG stream
    t_ep: torch.Tensor  # [] i32 — tick within the current episode
    episodes: torch.Tensor  # [] i32 — completed (auto-reset) episodes
    reward_w: torch.Tensor  # [3] f32 — (wait, throughput, drop) weights


@dataclasses.dataclass
class EnvInfo(Tree):
    """Per-step diagnostics (device tensors)."""

    placed: torch.Tensor  # [] i32 — jobs placed this step
    dropped: torch.Tensor  # [] i32 — drop-counter delta this step
    episodes: torch.Tensor  # [] i32 — completed episodes after this step
    t: torch.Tensor  # [] i32 — the clock after the tick (before a reset)


def _drop_sum(s: SimState) -> torch.Tensor:
    """Every drop counter summed over the clusters, with the compact
    layout's narrow-store overflow counters: [...] i32 (one per env)."""
    d = s.drops
    parts = [d.queue, d.msgs, d.run_full, d.vslot, d.carve, d.ingest,
             d.failed]
    parts += [part.ovf for part in (s.l0, s.l1, s.ready, s.wait, s.lent,
                                    s.borrowed, s.run)
              if hasattr(part, "ovf")]
    total = isum(parts[0], -1)
    for x in parts[1:]:
        total = total + isum(x, -1)
    return total


def _tile(x: torch.Tensor, B: int) -> torch.Tensor:
    """B copies of ``x`` on a new leading axis (a uint32 leaf through an
    int32 view of its bits)."""
    if x.dtype == torch.uint32:
        return _tile(x.view(torch.int32), B).view(torch.uint32)
    return x.expand(B, *x.shape).clone()


class ClusterEnv:
    """Batched ``reset(key) -> (obs, EnvState)`` / ``step(EnvState, action)
    -> (obs, reward, done, info, EnvState)`` over the engine, on
    ``device`` (the card unless named).

    ``policies`` defaults to the config's singleton set; pass
    ``PolicySet(("rl",))`` for the learned-scheduler action port (another
    set ignores the action and runs its own policy). Exactly one of
    ``arrivals`` (a host-bucketed TickArrivals covering >= episode_ticks,
    replayed by every env and episode) or ``gen`` (a StreamGen drawn per
    tick from the env's key) selects the workload. ``plan`` builds the
    compact layout (core/compact.py). Keys are [2] uint32 tensors
    (``utils.prng.prng_key``)."""

    def __init__(self, cfg: SimConfig, specs, episode_ticks: int,
                 arrivals: TickArrivals | None = None,
                 gen: StreamGen | None = None, policies=None,
                 reward="neg_mean_wait", plan=None, device=None):
        if (arrivals is None) == (gen is None):
            raise ValueError("pass exactly one of arrivals= (replay) or "
                             "gen= (on-device generation)")
        if gen is not None and cfg.borrowing:
            raise ValueError(
                "generative mode emits tick-local job ids, and the "
                "borrowing return path matches borrowed rows on (id, "
                "cores, mem, dur) — gen= requires cfg.borrowing=False "
                "(replay a globally-id'd TickArrivals stream instead)")
        self.cfg = cfg
        self.specs = list(specs)
        self.engine = Engine(cfg, device=device, policies=policies)
        self.device = self.engine.device
        self.pset = self.engine.pset
        self.episode_ticks = int(episode_ticks)
        if self.episode_ticks < 1:
            raise ValueError("episode_ticks must be >= 1")
        if arrivals is not None and \
                arrivals.rows.shape[0] < self.episode_ticks:
            raise ValueError(
                f"replay TickArrivals covers {arrivals.rows.shape[0]} ticks, "
                f"episode needs {self.episode_ticks}")
        self.gen = gen
        # the replay rows on the device once: a step gathers its tick's
        self._arr = None if arrivals is None else tuple(
            torch.from_numpy(np.ascontiguousarray(x)).to(self.device)
            for x in (arrivals.rows, arrivals.counts))
        self._params = self.pset.params_for(cfg, device=self.device)
        self._member = int(self._params.idx)  # the one host read of it
        w = REWARD_VARIANTS[reward] if isinstance(reward, str) else reward
        self.reward_name = reward if isinstance(reward, str) else "custom"
        self._reward_w = torch.as_tensor(np.asarray(w, np.float32)).to(
            self.device)
        if tuple(self._reward_w.shape) != (3,):
            raise ValueError("reward weights must be 3 floats "
                             "(wait, throughput, drop)")
        self._sim0 = init_state(cfg, specs, plan=plan, device=self.device)
        self._t0 = int(self._sim0.t)
        # generative churn: each env folds its own reset key into its
        # per-cluster fault streams (trace-mode tables replay in every env)
        self._fault_gen = (cfg.faults.enabled
                           and cfg.faults.mode == "generative")
        # churn eligibility: the reset constellation's real machines
        self._fault_eligible = self._sim0.node_active
        # the host's copy of the clock and episode tick of the EnvState
        # the last step returned: (that object, clock, episode tick)
        self._host_clock = None

    # -- geometry ----------------------------------------------------------

    @property
    def n_clusters(self) -> int:
        return len(self.specs)

    @property
    def n_obs(self) -> int:
        return n_obs_features(self.cfg)

    @property
    def action_shape(self) -> tuple:
        """The rl action matrix: per-class scores over node device types
        (the ``rl_scores`` leaf a step substitutes)."""
        return (F.N_JOB_CLASSES, F.N_DEVICE_TYPES)

    def provenance(self, action=None) -> dict:
        """The registered policy name(s) and the params digest (the zero
        action's when none is given), and the reward variant's name."""
        params = self._params if action is None else self._params.replace(
            rl_scores=torch.as_tensor(action, dtype=torch.float32))
        return {"policy": self.engine.policy_provenance(params),
                "reward": self.reward_name}

    # -- reset -------------------------------------------------------------

    def _key(self, key) -> torch.Tensor:
        return torch.as_tensor(key).to(self.device)

    def reset(self, key):
        """One env: ``(obs, EnvState)`` from its key. With generative faults
        the env's churn streams derive from a branch of the key
        (``faults.schedule.reseed``)."""
        key = self._key(key)
        sim = clone_state(self._sim0)
        if self._fault_gen:
            ks = prng.split(key, 2)
            key = ks[0]
            sim = sim.replace(faults=fsch.reseed(
                sim.faults, ks[1], self.cfg.faults,
                eligible=self._fault_eligible))
        es = EnvState(sim=sim, key=key.clone(),
                      t_ep=torch.zeros((), dtype=torch.int32,
                                       device=self.device),
                      episodes=torch.zeros((), dtype=torch.int32,
                                           device=self.device),
                      reward_w=self._reward_w.clone())
        self._host_clock = (es, self._t0, 0)
        return observe(es.sim, self.cfg), es

    def reset_batch(self, key, n_envs: int):
        """B envs with independent streams: the root key split once, each
        env owning one branch. Returns ``(obs [B, C, F], EnvState)`` with
        every leaf on the batch axis."""
        keys = prng.split(self._key(key), n_envs)
        if self._fault_gen:
            from multi_cluster_simulator_tpu_torch.tenancy import stack_lanes
            cells = [self.reset(keys[i]) for i in range(n_envs)]
            es = stack_lanes([c[1] for c in cells])
            self._host_clock = (es, self._t0, 0)
            return torch.stack([c[0] for c in cells]), es
        B = n_envs
        sim = tree_map(lambda x: _tile(x, B), self._sim0)
        es = EnvState(
            sim=sim, key=keys.clone(),
            t_ep=torch.zeros((B,), dtype=torch.int32, device=self.device),
            episodes=torch.zeros((B,), dtype=torch.int32,
                                 device=self.device),
            reward_w=self._reward_w.expand(B, 3).clone())
        self._host_clock = (es, self._t0, 0)
        return observe(sim, self.cfg), es

    # -- step --------------------------------------------------------------

    def _clock_of(self, es: EnvState) -> tuple:
        """The batch's clock and episode tick as host ints: the copy kept
        for the EnvState the last step returned, else read once from the
        device (the envs must be in lockstep)."""
        kept = self._host_clock
        if kept is not None and kept[0] is es:
            return kept[1], kept[2]
        ts = set(es.sim.t.reshape(-1).tolist())
        eps = set(es.t_ep.reshape(-1).tolist())
        if len(ts) != 1 or len(eps) != 1:
            raise ValueError(f"envs out of lockstep: clocks {sorted(ts)}, "
                             f"episode ticks {sorted(eps)}")
        return ts.pop(), eps.pop()

    def _kept(self, es: EnvState):
        """The host's (clock, episode tick) of ``es`` when the last step
        returned it, else None."""
        kept = self._host_clock
        return kept[1:] if kept is not None and kept[0] is es else None

    def _step(self, es: EnvState, action):
        """One step of a batch ``es`` (every leaf with a leading [B]),
        ``action`` [B, 4, 4] or None, in place."""
        cfg = self.cfg
        B = es.t_ep.shape[0]
        t, t_ep = self._clock_of(es)
        ks = prng.split(es.key, 2)
        key, karr = ks[:, 0], ks[:, 1]
        if self._arr is not None:
            tick = es.t_ep.long()
            rows, counts = self._arr[0][tick], self._arr[1][tick]
        else:
            g = self.gen
            rows, counts = tick_arrivals_device(
                karr, es.sim.t + cfg.tick_ms, self.n_clusters, g.k_max,
                g.rate, g.max_cores, g.max_mem, g.max_dur_ms, g.beta)
        params = self._params if action is None else self._params.replace(
            rl_scores=torch.as_tensor(action).to(self.device,
                                                 torch.float32))
        sim = es.sim
        placed0 = isum(sim.placed_total, -1)
        drops0 = _drop_sum(sim)
        self.engine.step_tick(sim, rows, counts, params=params, clock=t,
                              members=(self._member,) * B)
        placed_d = isum(sim.placed_total, -1) - placed0
        drops_d = _drop_sum(sim) - drops0
        # the mean over the clusters in seconds as the reference's compiled
        # code takes it, on every device alike: the reduce's sum (in
        # cluster order) times one folded f32 constant, (1 / C) * 1e-3
        waits = st.avg_wait_ms(sim)
        C = waits.shape[1]
        wait_s = xla_sum(waits.transpose(0, 1)) * float(
            np.float32(np.float32(1.0) / np.float32(C)) * np.float32(1e-3))
        w = es.reward_w
        # XLA's CPU code fuses the weighted sum's first product and sum
        # into one multiply-add (ops/floats.py fma_f32)
        reward = fma_f32(w[:, 0], -wait_s,
                         w[:, 1] * placed_d.to(torch.float32)) \
            + w[:, 2] * (-drops_d.to(torch.float32))
        done = (es.t_ep + 1) >= self.episode_ticks
        info = EnvInfo(placed=placed_d, dropped=drops_d, episodes=None,
                       t=sim.t.clone())
        ends = t_ep + 1 >= self.episode_ticks  # every env's, in lockstep
        if ends:
            self._auto_reset(sim, done)
        es.key.view(torch.int32).copy_(key.view(torch.int32))
        es.t_ep.copy_(torch.where(done, 0, es.t_ep + 1))
        es.episodes.add_(done.to(torch.int32))
        info.episodes = es.episodes.clone()
        t_next = self._t0 if ends else t + cfg.tick_ms
        return (observe(sim, cfg), reward, done, info, es), \
            (t_next, 0 if ends else t_ep + 1)

    def _auto_reset(self, sim: SimState, done: torch.Tensor) -> None:
        """Select every leaf of the finishing envs back to the cached
        reset constellation, in place (a per-leaf ``torch.where``); with
        generative faults keep each env's own fault keys and re-derive
        its first failures from them (the draw ``reseed`` makes)."""
        if self._fault_gen:
            fkeys = sim.faults.key.clone()
            nf_pre = sim.faults.next_fail.clone()
        for (_, cur), (_, fresh) in zip(leaves_with_keys(sim),
                                        leaves_with_keys(self._sim0)):
            if cur.dtype == torch.uint32:  # selected through int32 views
                cur, fresh = cur.view(torch.int32), fresh.view(torch.int32)
            d = done.view(done.shape + (1,) * fresh.dim())
            cur.copy_(torch.where(d, fresh, cur))
        if self._fault_gen:
            B, C, N = sim.faults.health.shape
            nf0 = fsch.initial_next_fail(
                fkeys.reshape(B * C, 2), N, self.cfg.faults,
                self._fault_eligible.expand(B, C, N).reshape(B * C, N))
            sim.faults.key.copy_(fkeys)
            sim.faults.next_fail.copy_(torch.where(
                done[:, None, None], nf0.view(B, C, N), nf_pre))

    def step_fn(self, donate: bool = False):
        """The single-env step: ``(EnvState, action) -> (obs, reward, done,
        info, EnvState)`` (scalars and [C, F] obs). Without ``donate`` it
        steps a copy and returns that."""
        def call(es, action=None):
            kept = self._kept(es)
            es = es if donate else tree_map(torch.clone, es)
            batch = tree_map(lambda x: x.unsqueeze(0), es)
            if kept is not None:
                self._host_clock = (batch,) + kept
            act = None if action is None else \
                torch.as_tensor(action).to(self.device).unsqueeze(0)
            (obs, r, done, info, _), clock = self._step(batch, act)
            self._host_clock = (es,) + clock
            return (obs[0], r[0], done[0],
                    tree_map(lambda x: x[0], info), es)
        return call

    def batch_step_fn(self, donate: bool = True):
        """The batched step: ``(EnvState[B], action[B]) -> (obs[B],
        reward[B], done[B], info[B], EnvState[B])``, each kernel launched
        once over every env. With ``donate`` (the default) the batch
        updates in place and the same object comes back; without it the
        step runs on a copy."""
        def call(es, action=None):
            kept = self._kept(es)
            if not donate:
                es = tree_map(torch.clone, es)
                if kept is not None:
                    self._host_clock = (es,) + kept
            out, clock = self._step(es, action)
            self._host_clock = (es,) + clock
            return out
        return call


def shard_env_batch(es: EnvState, mesh, axis: str = "envs"):
    """This rank's slice of a batched ``EnvState`` over ``mesh``
    (``parallel.mesh.Mesh``, one rank a process): every leaf split on its
    leading (env) dimension, on the rank's device. Envs are independent,
    so each rank steps its envs with no collective and the gathered batch
    (``parallel.sharded_engine.gather_batch``) is bitwise the unsharded
    one's. A batch that does not divide raises, naming the nearest valid
    batch sizes."""
    from multi_cluster_simulator_tpu_torch.parallel.sharded_engine import (
        shard_batch,
    )
    return shard_batch(es, mesh, "env batch", "batch sizes")
