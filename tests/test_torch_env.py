"""The port's environment mode (``multi_cluster_simulator_tpu_torch.envs``)
against the JAX package's ``ClusterEnv``, on the CPU.

The mirror of tests/test_env.py. A batch of envs is a lane-stacked state
stepped by the engine's lane form; every case holds the port against the
JAX env, leaf by leaf through ``interop``, every leaf bitwise (floats by
their bits), the rewards and observations included: a batch-1 replay env
equals ``Engine.run`` and JAX's env, on both layouts; ``observe``;
``tick_arrivals_device``, the threefry helpers and ``reset_batch``'s keys
over several keys and shapes; auto-reset, with and without generative
faults; per-env streams; the reward variants; the rl action steering
placement; the constructor's refusals; the batch over a 2-rank mesh. The draws are
jax's under ``jax_threefry_partitionable``, which the module pins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_cluster_simulator_tpu.config import FaultConfig
from multi_cluster_simulator_tpu.core import compact as jcompact
from multi_cluster_simulator_tpu.core.engine import Engine as JEngine
from multi_cluster_simulator_tpu.core.engine import pack_arrivals_by_tick
from multi_cluster_simulator_tpu.core.spec import ClusterSpec, NodeSpec
from multi_cluster_simulator_tpu.core.state import init_state as jinit_state
from multi_cluster_simulator_tpu.envs import ClusterEnv as JEnv
from multi_cluster_simulator_tpu.envs import StreamGen as JGen
from multi_cluster_simulator_tpu.envs import observe as jobserve
from multi_cluster_simulator_tpu.policies.base import PolicySet as JSet
from multi_cluster_simulator_tpu.workload.traces import (
    from_arrays, tick_arrivals_device as jtick_arrivals, uniform_stream,
)
from multi_cluster_simulator_tpu_torch import tenancy
from multi_cluster_simulator_tpu_torch.core import compact as tcompact
from multi_cluster_simulator_tpu_torch.core import engine as tengine
from multi_cluster_simulator_tpu_torch.core import spec as tspec
from multi_cluster_simulator_tpu_torch.core import state as tstate
from multi_cluster_simulator_tpu_torch.envs import (
    REWARD_VARIANTS, ClusterEnv, StreamGen, n_obs_features, observe,
    shard_env_batch,
)
from multi_cluster_simulator_tpu_torch.policies.base import PolicySet
from multi_cluster_simulator_tpu_torch.utils import prng
from multi_cluster_simulator_tpu_torch.workload.traces import (
    tick_arrivals_device,
)
from tests.test_env import _cfg, _specs
from tests.test_torch_engine import jax_leaves, port_cfg
from tests.test_torch_tenancy import assert_bitwise, port

C, T = 4, 30


@pytest.fixture(autouse=True, scope="module")
def partitionable_threefry():
    """The draws are jax's under jax_threefry_partitionable (this jax's
    default): pinned for the module, restored after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    yield
    jax.config.update("jax_threefry_partitionable", old)


def tspecs(n=C):
    return [tspec.uniform_cluster(c + 1, 5) for c in range(n)]


def replay(cfg, n_ticks=T + 5, seed=3):
    arr = uniform_stream(C, 40, T * 1_000, max_cores=8, max_mem=6_000,
                         max_dur_ms=15_000, seed=seed)
    return arr, pack_arrivals_by_tick(arr, n_ticks, cfg.tick_ms)


def port_ta(ta):
    return tstate.TickArrivals(rows=np.asarray(ta.rows),
                               counts=np.asarray(ta.counts))


def key_of(jkey) -> torch.Tensor:
    return torch.from_numpy(np.asarray(jkey).astype(np.int64)).to(
        torch.uint32)


def run_ref(cfg, ta, n_ticks, plan=None):
    """The port's Engine.run over the same bucketed arrivals."""
    tcfg = port_cfg(cfg)
    return tengine.Engine(tcfg, device="cpu").run(
        tstate.init_state(tcfg, tspecs(), plan=plan, device="cpu"),
        port_ta(ta), n_ticks)


def step_both(jenv, tenv, jes, tes, steps, actions=None, batch=True):
    """Step the JAX env and the port's side by side; every step's
    observation, reward, done, info and state held bitwise."""
    jstep = jenv.batch_step_fn(donate=False) if batch else jenv.step_fn()
    tstep = tenv.batch_step_fn() if batch else tenv.step_fn()
    for k in range(steps):
        act = None if actions is None else actions[k]
        jo, jr, jd, ji, jes = jstep(jes, None if act is None
                                    else jnp.asarray(act))
        to, tr, td, ti, tes = tstep(tes, None if act is None
                                    else torch.from_numpy(act))
        what = f"step {k}"
        assert_bitwise(jax_leaves(jes), port(tes), what)
        assert_bitwise({"": np.asarray(jo)}, {"": to.numpy()}, what + " obs")
        assert_bitwise({"": np.asarray(jr)}, {"": tr.numpy()}, what + " r")
        assert_bitwise({"": np.asarray(jd)}, {"": td.numpy()}, what + " d")
        assert_bitwise(jax_leaves(ji), port(ti), what + " info")
    return jes, tes


# ---------------------------------------------------------------------------
# the single-env pins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compact", [False, True])
def test_batch1_replay_equals_engine_run_and_jax(compact):
    """A batch-1 replay env stepped T times IS Engine.run over the same
    bucketed arrivals, on either layout, and equals JAX's env."""
    cfg = _cfg()
    arr, ta = replay(cfg)
    plan = jcompact.derive_plan(cfg, _specs(), arr) if compact else None
    tplan = None if plan is None else tcompact.CompactPlan(
        queue=plan.queue, run=plan.run, node=plan.node)
    jenv = JEnv(cfg, _specs(), episode_ticks=T + 5, arrivals=ta, plan=plan)
    tenv = ClusterEnv(port_cfg(cfg), tspecs(), episode_ticks=T + 5,
                      arrivals=port_ta(ta), plan=tplan, device="cpu")
    _, jes = jenv.reset(jax.random.PRNGKey(0))
    _, tes = tenv.reset(prng.prng_key(0))
    jes, tes = step_both(jenv, tenv, jes, tes, T, batch=False)
    assert_bitwise(port(run_ref(cfg, ta, T, tplan)), port(tes.sim))
    assert int(tes.sim.placed_total.sum()) > 0


# ---------------------------------------------------------------------------
# observations
# ---------------------------------------------------------------------------

def test_observe_equals_jax_wide_and_compact():
    """observe has the static [C, n_obs_features] shape, equals the
    reference's on both layouts (and over a batch axis), and reads a
    fresh state's empty queues and free capacity."""
    cfg = _cfg()
    tcfg = port_cfg(cfg)
    arr, ta = replay(cfg)
    plan = jcompact.derive_plan(cfg, _specs(), arr)
    tplan = tcompact.CompactPlan(queue=plan.queue, run=plan.run,
                                 node=plan.node)
    outs = []
    for p in (None, tplan):
        s = run_ref(cfg, ta, 12, p)
        jplan = None if p is None else plan
        jstate = JEngine(cfg).run_jit()(
            jinit_state(cfg, _specs(), plan=jplan),
            jax.tree.map(lambda x: x[:12], ta), 12)
        got = observe(s, tcfg)
        assert tuple(got.shape) == (C, n_obs_features(tcfg))
        assert_bitwise({"": np.asarray(jobserve(jstate, cfg))},
                       {"": got.numpy()})
        assert_bitwise({"": np.asarray(jax.jit(jobserve, static_argnums=1)(
            jstate, cfg))}, {"": got.numpy()})
        outs.append(got)
    assert torch.equal(outs[0], outs[1]), "observe must be layout-blind"
    s0 = tstate.init_state(tcfg, tspecs(), device="cpu")
    obs0 = observe(s0, tcfg)
    assert torch.equal(obs0[:, :7], torch.zeros((C, 7)))
    assert bool((obs0[:, 7 + 4] > 0.99).all())
    batch = tenancy.stack_tenant_states([s0, run_ref(cfg, ta, 12)])
    assert torch.equal(observe(batch, tcfg)[1], outs[0])


def test_utilization_equals_jax():
    """core/state.py utilization (used over total, active nodes only) on a
    run's state and on a batch of states, bitwise the reference's."""
    from multi_cluster_simulator_tpu.core.state import (
        utilization as jutilization,
    )
    from multi_cluster_simulator_tpu_torch.core.state import utilization

    cfg = _cfg()
    _, ta = replay(cfg)
    jstate = JEngine(cfg).run_jit()(jinit_state(cfg, _specs()),
                                    jax.tree.map(lambda x: x[:9], ta), 9)
    s = run_ref(cfg, ta, 9)
    want = [np.asarray(x) for x in jutilization(jstate)]
    got = utilization(s)
    for w, g in zip(want, got):
        assert_bitwise({"": w}, {"": g.numpy()})
    batch = tenancy.stack_tenant_states([s, s])
    assert torch.equal(utilization(batch)[1][1], got[1])
    assert float(got[0].max()) > 0.0


def test_env_state_crosses_through_interop():
    """A JAX EnvState batch crosses into the port through interop and
    back, and both packages step it to the same state."""
    from multi_cluster_simulator_tpu_torch import interop

    cfg = _cfg()
    jenv = JEnv(cfg, _specs(3), episode_ticks=5, gen=JGen())
    tenv = ClusterEnv(port_cfg(cfg), tspecs(3), episode_ticks=5,
                      gen=StreamGen(), device="cpu")
    _, jes = jenv.reset_batch(jax.random.PRNGKey(5), 3)
    jes = jenv.batch_step_fn(donate=False)(jes)[-1]
    tes = interop.env_state_from_numpy(jax_leaves(jes), device="cpu")
    assert_bitwise(jax_leaves(jes), interop.env_state_to_numpy(tes))
    step_both(jenv, tenv, jes, tes, 6)


# ---------------------------------------------------------------------------
# the draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,n_clusters,k_max,rate,beta", [
    (0, 4, 8, 2.0, 2.0), (3, 2, 6, 1.7, 2.0), (11, 8, 8, 2.0, 2.0),
    (5, 3, 5, 3.3, 1.0), (2**31 + 5, 1, 16, 0.5, 3.0)])
def test_tick_arrivals_device_bitwise(seed, n_clusters, k_max, rate, beta):
    """One tick's generative draw equals the reference's, eager and
    jitted, for one key and for a batch of keys."""
    jkey = jax.random.PRNGKey(seed)
    args = (n_clusters, k_max, rate, 8, 6_000, 15_000, beta)
    want = jtick_arrivals(jkey, 1_000, *args)
    got = tick_arrivals_device(key_of(jkey), 1_000, *args)
    jitted = jax.jit(lambda k: jtick_arrivals(k, 1_000, *args))(jkey)
    for w in (want, jitted):
        assert_bitwise({"r": np.asarray(w[0]), "c": np.asarray(w[1])},
                       {"r": got[0].numpy(), "c": got[1].numpy()})
    keys = jax.random.split(jkey, 3)
    ts = jnp.arange(3, dtype=jnp.int32) * 1_000
    want = jax.jit(jax.vmap(lambda k, t: jtick_arrivals(k, t, *args)))(
        keys, ts)
    got = tick_arrivals_device(key_of(keys), torch.from_numpy(
        np.asarray(ts)), *args)
    assert_bitwise({"r": np.asarray(want[0]), "c": np.asarray(want[1])},
                   {"r": got[0].numpy(), "c": got[1].numpy()})


@pytest.mark.parametrize("seed", [0, 7, 123_456_789, 2**40 + 3])
def test_threefry_helpers_and_reset_keys_bitwise(seed):
    """PRNGKey, split, bits, uniform and randint are jax's; reset_batch
    splits the root key as the reference does."""
    jkey = jax.random.PRNGKey(seed)
    tkey = prng.prng_key(seed)
    assert np.array_equal(np.asarray(jkey), tkey.numpy())
    assert np.array_equal(np.asarray(jax.random.split(jkey, 5)),
                          prng.split(tkey, 5).numpy())
    assert np.array_equal(np.asarray(jax.random.bits(jkey, (3, 4))),
                          prng.random_bits(tkey, (3, 4)).numpy()
                          .astype(np.uint32))
    assert np.array_equal(
        np.asarray(jax.random.uniform(jkey, (4, 8, 3))).view(np.int32),
        prng.uniform(tkey, (4, 8, 3)).numpy().view(np.int32))
    for hi in (1, 15_000, 70_000, 2**31 - 1):
        assert np.array_equal(
            np.asarray(jax.random.randint(jkey, (4, 8), 0, hi)),
            prng.randint(tkey, (4, 8), 0, hi).numpy())
    cfg = _cfg()
    _, ta = replay(cfg)
    jenv = JEnv(cfg, _specs(), 8, arrivals=ta)
    tenv = ClusterEnv(port_cfg(cfg), tspecs(), 8, arrivals=port_ta(ta),
                      device="cpu")
    jo, jes = jenv.reset_batch(jkey, 5)
    to, tes = tenv.reset_batch(tkey, 5)
    assert_bitwise(jax_leaves(jes), port(tes))
    assert_bitwise({"": np.asarray(jo)}, {"": to.numpy()})


# ---------------------------------------------------------------------------
# auto-reset, PRNG streams, rewards
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faults", [False, True])
def test_auto_reset_against_jax(faults):
    """Stepping past the episode boundary resets every leaf to the cached
    reset constellation — with generative faults keeping each env's own
    fault keys and re-deriving its first failures — bitwise JAX's batch
    over two episodes, with a distinct seeded action per env and step;
    the episode counters read 2."""
    kw = dict(faults=FaultConfig(enabled=True, mode="generative",
                                 mttf_ms=4_000, mttr_ms=2_000, seed=3),
              queue_capacity=4) if faults else {}
    cfg = _cfg(**kw)
    B, ep = 4, 6
    jenv = JEnv(cfg, _specs(3), episode_ticks=ep, gen=JGen(),
                policies=JSet(("rl",)), reward="drop_penalty")
    tenv = ClusterEnv(port_cfg(cfg), tspecs(3), episode_ticks=ep,
                      gen=StreamGen(), policies=PolicySet(("rl",)),
                      reward="drop_penalty", device="cpu")
    _, jes = jenv.reset_batch(jax.random.PRNGKey(7), B)
    _, tes = tenv.reset_batch(prng.prng_key(7), B)
    rng = np.random.default_rng(1)
    acts = rng.normal(size=(2 * ep + 2, B, 4, 4)).astype(np.float32)
    jes, tes = step_both(jenv, tenv, jes, tes, 2 * ep + 2, acts)
    assert tes.episodes.tolist() == [2] * B
    assert tes.t_ep.tolist() == [2] * B


def test_replay_auto_reset_reruns_the_episode():
    """Replay mode re-runs the identical episode after a reset: the state
    at step T_ep + k equals the state at step k."""
    cfg = _cfg()
    ep = 6
    _, ta = replay(cfg, n_ticks=ep)
    env = ClusterEnv(port_cfg(cfg), tspecs(), episode_ticks=ep,
                     arrivals=port_ta(ta), device="cpu")
    _, es = env.reset(prng.prng_key(0))
    step = env.step_fn()
    snaps = []
    for _ in range(2 * ep + 2):
        _, _, _, _, es = step(es)
        snaps.append(port(es.sim))
    assert int(es.episodes) == 2 and int(es.t_ep) == 2
    for k in range(2):
        assert_bitwise(snaps[ep + k], snaps[k])


def test_per_env_prng_streams_diverge():
    """Envs reset from split keys draw their own streams (states diverge);
    the same root key replays bitwise."""
    cfg = _cfg()
    env = ClusterEnv(port_cfg(cfg), tspecs(), episode_ticks=50,
                     gen=StreamGen(rate=2.0, k_max=8), device="cpu")
    step = env.batch_step_fn(donate=False)
    states = []
    for _ in range(2):
        _, es = env.reset_batch(prng.prng_key(7), 4)
        for _ in range(10):
            _, _, _, _, es = step(es)
        states.append(es)
    placed = states[0].sim.placed_total.sum(1)
    arrived = states[0].sim.arr_ptr.sum(1)
    assert len(set(zip(placed.tolist(), arrived.tolist()))) > 1, \
        "every env drew the identical stream: keys are shared"
    assert_bitwise(port(states[0]), port(states[1]))


@pytest.mark.parametrize("reward", list(REWARD_VARIANTS) + [(0.7, 0.3, 2.5)])
def test_reward_variants_against_jax(reward):
    """Reward weights are data: each variant's reward stream is JAX's
    bitwise (the mean over clusters and XLA's fused multiply-add), and
    the simulation does not depend on it."""
    cfg = _cfg(queue_capacity=4)
    _, ta = replay(cfg)
    jenv = JEnv(cfg, _specs(), T + 5, arrivals=ta, reward=reward)
    tenv = ClusterEnv(port_cfg(cfg), tspecs(), T + 5, arrivals=port_ta(ta),
                      reward=reward, device="cpu")
    _, jes = jenv.reset_batch(jax.random.PRNGKey(0), 2)
    _, tes = tenv.reset_batch(prng.prng_key(0), 2)
    step_both(jenv, tenv, jes, tes, 10)
    assert set(REWARD_VARIANTS) >= {"neg_mean_wait", "throughput",
                                    "drop_penalty"}


def test_rewards_have_their_signs():
    cfg = _cfg()
    _, ta = replay(cfg)
    out = {}
    for name in ("neg_mean_wait", "throughput"):
        env = ClusterEnv(port_cfg(cfg), tspecs(), T + 5,
                         arrivals=port_ta(ta), reward=name, device="cpu")
        _, es = env.reset(prng.prng_key(0))
        step = env.step_fn()
        total = 0.0
        for _ in range(10):
            _, r, _, _, es = step(es)
            total += float(r)
        out[name] = (total, port(es.sim))
    assert out["throughput"][0] > 0.0 >= out["neg_mean_wait"][0]
    assert_bitwise(out["throughput"][1], out["neg_mean_wait"][1])


# ---------------------------------------------------------------------------
# the rl action port
# ---------------------------------------------------------------------------

def test_rl_action_steers_placement():
    """A core-heavy job first-fits node 0 under the zero action and lands
    on the first accelerator-typed node when the action prefers device
    type 1 for its class: the action reaches the scored pass, as in
    JAX's env."""
    cfg = _cfg(queue_capacity=8, max_arrivals=4)
    nodes = tuple(NodeSpec(id=i + 1, cores=32, memory=24_000,
                           device_type=1 if i >= 3 else 0) for i in range(5))
    jspecs = [ClusterSpec(id=1, nodes=nodes)]
    tnodes = tuple(tspec.NodeSpec(id=i + 1, cores=32, memory=24_000,
                                  device_type=1 if i >= 3 else 0)
                   for i in range(5))
    arr = from_arrays(t_ms=[[500]], cores=[[16]], mem=[[1_000]],
                      dur_ms=[[5_000]])
    ta = pack_arrivals_by_tick(arr, 3, cfg.tick_ms)
    jenv = JEnv(cfg, jspecs, episode_ticks=3, arrivals=ta,
                policies=JSet(("rl",)))
    tenv = ClusterEnv(port_cfg(cfg), [tspec.ClusterSpec(id=1, nodes=tnodes)],
                      episode_ticks=3, arrivals=port_ta(ta),
                      policies=PolicySet(("rl",)), device="cpu")
    zero = np.zeros(tenv.action_shape, np.float32)
    steer = zero.copy()
    steer[1, 1] = 5.0  # class 1 (core-heavy) -> device type 1
    free = {}
    for name, act in (("zero", zero), ("steer", steer)):
        _, jes = jenv.reset(jax.random.PRNGKey(0))
        _, tes = tenv.reset(prng.prng_key(0))
        jes, tes = step_both(jenv, tenv, jes, tes, 1, [act], batch=False)
        free[name] = tes.sim.node_free[0]
    cap = tes.sim.node_cap[0]
    assert bool((free["zero"][0] < cap[0]).any())
    assert bool((free["steer"][3] < cap[3]).any())
    assert bool((free["steer"][0] == cap[0]).all())
    assert tenv.provenance(steer) == jenv.provenance(jnp.asarray(steer))
    assert tenv.provenance() == jenv.provenance()


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------

def test_constructor_rejects_invalid_modes():
    tcfg = port_cfg(_cfg())
    _, ta = replay(_cfg())
    ta = port_ta(ta)
    with pytest.raises(ValueError, match="exactly one"):
        ClusterEnv(tcfg, tspecs(), episode_ticks=8, device="cpu")
    with pytest.raises(ValueError, match="exactly one"):
        ClusterEnv(tcfg, tspecs(), episode_ticks=8, arrivals=ta,
                   gen=StreamGen(), device="cpu")
    with pytest.raises(ValueError, match="borrowing"):
        ClusterEnv(port_cfg(_cfg(borrowing=True)), tspecs(),
                   episode_ticks=8, gen=StreamGen(), device="cpu")
    with pytest.raises(ValueError, match="episode_ticks"):
        ClusterEnv(tcfg, tspecs(), episode_ticks=0, gen=StreamGen(),
                   device="cpu")
    with pytest.raises(ValueError, match="covers 35 ticks"):
        ClusterEnv(tcfg, tspecs(), episode_ticks=40, arrivals=ta,
                   device="cpu")
    with pytest.raises(ValueError, match="3 floats"):
        ClusterEnv(tcfg, tspecs(), episode_ticks=8, gen=StreamGen(),
                   reward=(1.0, 2.0), device="cpu")
    ClusterEnv(port_cfg(_cfg(borrowing=True)), tspecs(), episode_ticks=8,
               arrivals=ta, device="cpu")
    with pytest.raises(ValueError, match="integer b"):
        tick_arrivals_device(prng.prng_key(0), 0, 2, 4, 1.0, 8, 100, 100,
                             beta=2.5)


def test_shard_env_batch_at_2_ranks_equals_one_rank():
    """The env batch over a mesh of 2 rank processes (``shard_env_batch``:
    each rank steps its half of the envs): the gathered batch equals the
    one-process batch bitwise, and a batch of 5 names the nearest valid
    sizes as tests/test_env.py:150 does."""
    from multi_cluster_simulator_tpu_torch.parallel.launch import RankGroup
    from multi_cluster_simulator_tpu_torch.parallel.mesh import Mesh
    from tests import _torch_mesh_tasks as tasks

    tcfg = port_cfg(_cfg())
    _, ta = replay(_cfg())
    env = ClusterEnv(tcfg, tspecs(), episode_ticks=T + 5,
                     arrivals=port_ta(ta), device="cpu")
    _, es = env.reset_batch(prng.prng_key(1), 4)
    step = env.batch_step_fn()
    for _ in range(T):
        _, _, _, _, es = step(es, None)
    with RankGroup(2, device="cpu", timeout=300) as ranks:
        got = ranks.run(2, tasks.env_sharded, tcfg, tspecs(), port_ta(ta), 4,
                        1, T)[0]
    assert_bitwise(port(es.sim), got)
    _, es5 = env.reset_batch(prng.prng_key(2), 5)
    with pytest.raises(ValueError, match=r"nearest valid batch sizes: 4 or 6"):
        shard_env_batch(es5, Mesh(0, 2, "envs", torch.device("cpu")))
