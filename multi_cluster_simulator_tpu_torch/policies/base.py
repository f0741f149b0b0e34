"""Policy-as-data: the parameter leaves, the registry, and the dispatcher
(the port of ``multi_cluster_simulator_tpu/policies/base.py``).

- ``PolicyParams`` — one flat set of parameter leaves shared by every
  kernel family (a kernel reads the leaves it understands), as 0-d and
  small tensors on the engine's device. Leaves, not config: kernels read
  them as tensors, so the plain path never syncs on them; the CUDA kernels
  take the few host ints they need once, at a run's entry.
- ``PolicySpec`` / ``register`` / ``variant`` — the registered table: name
  -> kernel KIND, ingest target, and default parameter overrides. The
  built-ins are the reference's, in the same order, so a name means the
  same policy in both packages (tests/test_torch_copies.py pins the table
  and every ``default_params`` leaf).
- ``PolicySet`` — the tuple of registered names an engine runs, every
  kind of the zoo; a scalar ``params.idx`` selects the member
  (``dispatch``). A batched index [L] selects a member per lane of a
  lane-stacked run (``members``; ``stacked_params`` stacks every member's
  params on that axis, the tournament's cell axis): the engine reads it
  once per run and launches each member's kernel over its own lanes.
- ``params_digest`` — the provenance digest of concrete parameter leaves,
  the reference's character for character: what the checkpoint header
  records (core/checkpoint.py) and ``PolicySet.provenance`` reports.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.config import SimConfig
from multi_cluster_simulator_tpu_torch.core.state import SimState
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.policies import kernels as K
from multi_cluster_simulator_tpu_torch.utils.tree import Tree


@dataclasses.dataclass
class PolicyParams(Tree):
    """Per-policy parameter leaves, the reference's schema and dtypes."""

    idx: torch.Tensor  # [] i32 — which PolicySet member this cell runs
    max_wait_ms: torch.Tensor  # [] i32 — DELAY Level0->Level1 promotion
    ffd_mem_first: torch.Tensor  # [] i32 — FFD sort tie-break (0: cores)
    gavel_tput: torch.Tensor  # [N_JOB_CLASSES, N_DEVICE_TYPES] f32
    tess_w: torch.Tensor  # [3] f32 — tesserae resource weights
    rl_scores: torch.Tensor  # [N_JOB_CLASSES, N_DEVICE_TYPES] f32
    mkt_sink_iters: torch.Tensor  # [] i32 — active Sinkhorn iterations
    mkt_sink_eps: torch.Tensor  # [] f32 — entropic temperature
    mkt_iters: torch.Tensor  # [] i32 — active cvx dual-ascent iterations
    mkt_step: torch.Tensor  # [] f32 — cvx primal sharpness (1/delta)
    mkt_rho: torch.Tensor  # [] f32 — cvx price step per iteration
    mkt_smooth: torch.Tensor  # [] f32 — cvx price carry-over


_DEFAULT_GAVEL_TPUT = (
    (1.0, 1.0, 1.0, 1.0),
    (1.0, 1.0, 1.0, 1.0),
    (0.5, 3.0, 1.0, 1.0),
    (0.5, 3.0, 1.0, 1.0),
)
_DEFAULT_TESS_W = (1.0, 1e-3, 1.0)


@dataclasses.dataclass(frozen=True)
class PolicySpec:
    """One registered policy: a kernel KIND plus parameter overrides.
    ``to_delay`` picks the arrival ingest target (Level0 for the
    queue-sweep families, the ReadyQueue for FIFO)."""

    name: str
    kind: str  # "fifo" | "delay" | "ffd" | "gavel" | "tesserae" | "rl"
    to_delay: bool
    overrides: tuple = ()


KINDS = ("fifo", "delay", "ffd", "gavel", "tesserae", "rl")

REGISTRY: dict[str, PolicySpec] = {}


def register(spec: PolicySpec) -> PolicySpec:
    """Add a policy to the registered table (re-registering an identical
    spec is allowed; changing an existing name is an error)."""
    if spec.kind not in KINDS:
        raise ValueError(f"unknown policy kind {spec.kind!r}; one of {KINDS}")
    prev = REGISTRY.get(spec.name)
    if prev is not None and prev != spec:
        raise ValueError(f"policy {spec.name!r} already registered as {prev}")
    REGISTRY[spec.name] = spec
    return spec


def variant(name: str, base: str, **overrides) -> PolicySpec:
    """Register a parameter variant of an existing policy: same kernel
    kind, different parameter leaves."""
    b = REGISTRY[base]
    ov = dict(b.overrides)
    ov.update(overrides)
    return register(PolicySpec(name=name, kind=b.kind, to_delay=b.to_delay,
                               overrides=tuple(sorted(ov.items()))))


register(PolicySpec("fifo", kind="fifo", to_delay=False))
register(PolicySpec("delay", kind="delay", to_delay=True))
register(PolicySpec("ffd", kind="ffd", to_delay=True))
register(PolicySpec("gavel", kind="gavel", to_delay=True))
register(PolicySpec("tesserae", kind="tesserae", to_delay=True))
register(PolicySpec("rl", kind="rl", to_delay=True))
variant("delay-eager", "delay", max_wait_ms=2_000)
variant("delay-patient", "delay", max_wait_ms=30_000)
variant("ffd-memfirst", "ffd", ffd_mem_first=1)
variant("delay-cvx-fast", "delay", mkt_iters=64)
variant("delay-cvx-tight", "delay", mkt_rho=1.5)
variant("delay-cvx-smooth", "delay", mkt_smooth=0.5)


def default_params(cfg: SimConfig, spec: PolicySpec, idx: int = 0,
                   device="cpu") -> PolicyParams:
    """The spec's parameter leaves on ``device``: config-derived defaults
    and the spec's overrides, with the reference's dtypes."""
    vals = {
        "idx": np.int32(idx),
        "max_wait_ms": np.int32(cfg.max_wait_ms),
        "ffd_mem_first": np.int32(0),
        "gavel_tput": np.asarray(_DEFAULT_GAVEL_TPUT, np.float32),
        "tess_w": np.asarray(_DEFAULT_TESS_W, np.float32),
        "rl_scores": np.zeros((F.N_JOB_CLASSES, F.N_DEVICE_TYPES),
                              np.float32),
        "mkt_sink_iters": np.int32(cfg.trader.sinkhorn_iters),
        "mkt_sink_eps": np.float32(cfg.trader.sinkhorn_eps),
        "mkt_iters": np.int32(cfg.trader.cvx_iters),
        "mkt_step": np.float32(cfg.trader.cvx_step),
        "mkt_rho": np.float32(cfg.trader.cvx_rho),
        "mkt_smooth": np.float32(cfg.trader.cvx_smooth),
    }
    for name, val in spec.overrides:
        if name not in vals or name == "idx":
            raise ValueError(f"{spec.name}: unknown param override {name!r}")
        vals[name] = np.asarray(val, vals[name].dtype)
    return PolicyParams(**{k: torch.from_numpy(np.array(v)).to(device)
                           for k, v in vals.items()})


def params_digest(params: PolicyParams) -> str:
    """Provenance digest of concrete parameter leaves (host-side): sha1[:12]
    over each leaf's key path and C-order bytes, the leaves sorted by the
    path's string. The path strings are the ones jax's
    ``tree_flatten_with_path`` gives the reference's flax dataclass —
    ``"(GetAttrKey(name='idx'),)"`` — so the digest is the reference's."""
    h = hashlib.sha1()
    leaves = sorted(((f"(GetAttrKey(name={f.name!r}),)",
                      getattr(params, f.name))
                     for f in dataclasses.fields(params)),
                    key=lambda kv: kv[0])
    for path, leaf in leaves:
        h.update(path.encode())
        h.update(np.ascontiguousarray(leaf.detach().cpu().numpy()).tobytes())
    return h.hexdigest()[:12]


# --------------------------------------------------------------------------
# dispatch
# --------------------------------------------------------------------------

def _zero_io(state: SimState):
    C = state.arr_ptr.shape[0]
    dev = state.arr_ptr.device
    return (torch.zeros((C,), dtype=torch.bool, device=dev),
            torch.zeros((C, Q.NF), dtype=Q.I32, device=dev))


def _run_kind(spec: PolicySpec, state: SimState, t: int,
              params: PolicyParams, cfg: SimConfig):
    """One policy's whole scheduling pass over every cluster. Returns
    ``(state, borrow_want [C], borrow_job rows [C, NF])`` like the
    reference; the non-FIFO families emit an all-False want."""
    if spec.kind == "fifo":
        state, want, bjob = K._fifo_local(state, t, cfg)
        return state, want, bjob.vec
    if spec.kind == "delay":
        fn = (K._delay_wave_local
              if not cfg.parity and cfg.delay_sweep == "wave"
              else K._delay_local)
    elif spec.kind == "ffd":
        fn = (K._ffd_wave_local
              if not cfg.parity and cfg.ffd_sweep == "wave"
              else K._ffd_local)
    elif spec.kind == "gavel":
        fn = K._gavel_local
    elif spec.kind == "rl":
        fn = K._rl_local
    else:  # tesserae
        fn = K._tesserae_local
    state = fn(state, t, cfg, params)
    want, bjob = _zero_io(state)
    return state, want, bjob


@dataclasses.dataclass(frozen=True)
class PolicySet:
    """The tuple of registered policy names an engine runs; ``params.idx``
    selects the member. Hashable, like the config."""

    names: tuple

    def __post_init__(self):
        if not self.names:
            raise ValueError("PolicySet needs at least one policy name")
        for n in self.names:
            if n not in REGISTRY:
                raise ValueError(
                    f"unregistered policy {n!r}; known: {sorted(REGISTRY)}")

    @classmethod
    def from_config(cls, cfg: SimConfig) -> "PolicySet":
        """The singleton set for a classic ``cfg.policy`` run."""
        return cls((cfg.policy.value.lower(),))

    @property
    def specs(self) -> tuple:
        return tuple(REGISTRY[n] for n in self.names)

    @property
    def kinds(self) -> tuple:
        return tuple(s.kind for s in self.specs)

    @property
    def has_fifo(self) -> bool:
        return "fifo" in self.kinds

    def index_of(self, name: str) -> int:
        return self.names.index(name)

    def params_for(self, cfg: SimConfig, name=None,
                   device="cpu") -> PolicyParams:
        """PolicyParams for one member (the first by default), idx set to
        its position in this set."""
        name = self.names[0] if name is None else name
        i = self.index_of(name)
        return default_params(cfg, self.specs[i], idx=i, device=device)

    def stacked_params(self, cfg: SimConfig, device="cpu") -> PolicyParams:
        """Every member's params stacked on a leading axis, in the set's
        order — the policy axis a tournament runs as lanes (``idx`` [M]
        then selects member m in lane m)."""
        cells = [self.params_for(cfg, n, device=device) for n in self.names]
        return PolicyParams(**{
            f.name: torch.stack([getattr(c, f.name) for c in cells])
            for f in dataclasses.fields(PolicyParams)})

    def provenance(self, cfg: SimConfig, name=None) -> dict:
        """(registered name, param digest) for detail dicts."""
        name = self.names[0] if name is None else name
        return {"name": name,
                "params_digest": params_digest(self.params_for(cfg, name))}

    def ingest_to_delay(self):
        """Arrival ingest target across the set: a bool when every member
        agrees, else None (the engine then takes the selected member's)."""
        targets = {s.to_delay for s in self.specs}
        return targets.pop() if len(targets) == 1 else None

    def to_delay_table(self) -> torch.Tensor:
        """[members] bool: each member's ingest target is Level0."""
        return torch.tensor([s.to_delay for s in self.specs])

    def kind_flag_table(self, kind: str) -> torch.Tensor:
        """[members] bool: which members are of ``kind``."""
        return torch.tensor([s.kind == kind for s in self.specs])

    def member(self, idx) -> PolicySpec:
        """The member a scalar ``params.idx`` selects (an int, or a 0-d
        tensor read once: a host sync on the card). A batched index
        selects a member per lane: ``members``."""
        if isinstance(idx, torch.Tensor):
            if idx.dim() != 0:
                raise ValueError(
                    f"member() takes a scalar params.idx; a batched one of "
                    f"shape {tuple(idx.shape)} selects a member per lane "
                    f"(PolicySet.members)")
            idx = int(idx)
        if not 0 <= idx < len(self.names):
            raise IndexError(f"params.idx {idx} outside the set's "
                             f"{len(self.names)} members {self.names}")
        return self.specs[idx]

    def members(self, idx) -> tuple:
        """The members a batched ``params.idx`` [L] selects, a lane each
        (one host read of the index; a 0-d index is one lane)."""
        if isinstance(idx, torch.Tensor):
            idx = idx.reshape(-1).tolist()
        return tuple(self.member(int(i)) for i in np.atleast_1d(idx))

    def dispatch(self, state: SimState, t: int, params: PolicyParams,
                 cfg: SimConfig, member: PolicySpec = None):
        """The scheduling pass of the member ``params.idx`` selects (or
        ``member``, when the caller read the index already). Members that
        share ``(kind, to_delay)`` share one path: their differences are
        parameter leaves. A scalar index runs only the selected branch,
        as the reference's ``lax.switch`` does."""
        spec = self.member(params.idx) if member is None else member
        return _run_kind(spec, state, t, params, cfg)

    def leap_masks(self, s: SimState, cfg: SimConfig, params: PolicyParams,
                   member: PolicySpec = None):
        """The leap-accrual masks (``kernels.leap_wait_masks``) of the
        member ``params.idx`` selects (or ``member``, when the caller read
        the index already), as ``dispatch`` runs its pass."""
        spec = self.member(params.idx) if member is None else member
        return K.leap_wait_masks(spec.kind, s, cfg, params)
