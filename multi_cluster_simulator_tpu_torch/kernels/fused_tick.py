"""The tick's per-cluster prefix as one hand-written CUDA kernel per span.

The port of ``multi_cluster_simulator_tpu/kernels/fused_tick.py``. There,
``fused_prefix`` replays the traced jaxpr of ``Engine._span_prefix`` inside
one ``pallas_call`` over cluster blocks, so that each state column is
loaded and stored once per tick. Generic jaxpr replay has no Hopper
counterpart, so the port writes one CUDA kernel per engaged span. The
kernels differ in the schedule slot (``KERNELS``):

- ``fused_prefix_fifo`` — ``[release, ingest -> ReadyQueue, schedule:
  FIFO]`` (``csrc/fused_prefix_fifo.cu``);
- ``fused_prefix_ffd`` — ``[release, ingest -> Level0, schedule: FFD]``,
  the serial and the wave sweep (``csrc/fused_prefix_ffd.cu``);
- ``fused_prefix_delay`` — ``[release, ingest -> Level0, schedule:
  DELAY]``, the serial sweep (with the parity skip) and the wave sweep of
  Level1, then the Level0 head (``csrc/fused_prefix_delay.cu``);
- ``fused_prefix_scored`` — ``[release, ingest -> Level0, schedule:
  gavel | tesserae | rl]``, the Level0 sweep with a scored node pick
  (``csrc/fused_prefix_scored.cu``).

Each comes in twelve forms, instantiations of one template on four flags:
the eight combinations of the emit, expire and faults flags, and the four
of the emit and faults flags with the tap flag (expiry needs the trader,
which is never terminal, and the tap runs only on a terminal prefix).
The emit flag (``emit_returns``: borrowing, or a ``run_io`` tick) makes
the release step also pack the finished foreign jobs' return messages and
the pass write the borrow request (``want``, ``bjob_vec``) — the outputs
the cross-cluster phases after the prefix consume; without it the kernel
updates the state only. The expire flag (the trader's
``expire_virtual_nodes``) adds the vnode expiry step between release and
ingest (``engaged_span``): the node columns ``node_active``, ``node_cap``,
``node_free`` and ``node_expire`` of the slots whose contract ended. The
faults flag (the fault plane, ``cfg.faults.enabled``) opens the span with
the fault phase (faults/apply.py ``fault_phase_local``): nodes fail and
repair, the jobs on failed nodes are killed and requeued into the
member's ingest target or the LentQueue, and the generative mode draws
the next outage on the card, bitwise the reference's draws. The tap flag
(a run with a ``MetricsBuffer`` on a terminal prefix) closes the span
with the metrics tap (obs/device.py): the per-cluster half
(``tap_tick_local``: the counters differenced against the cursor, the
queue depth), and the cross-cluster half (``tap_tick_global``) folded in
with integer atomics: the depth histogram, and the ring slot, written by
the last block to finish. The FIFO emit form, the borrowing path's kernel,
is counted as its own entry, ``fused_prefix_fifo_emit``; the Level0
kernels' emit forms count under their kernel's name. Every expire form
counts as an entry of its own (``..._expire``), the FIFO emit form's as
``fused_prefix_fifo_emit_expire``, and so does every tap form
(``..._tap``) and every faults form (``..._faults``, after the other
suffixes).

Every kernel also takes the windowed ``Arrivals`` form of the ingest
(``windowed``): the whole packed stream ``[C, A, NF]`` and its counts in
place of one tick's rows, and the window ``min(max_ingest_per_tick, A)``
(-1 for a tick's rows); a runtime branch of the shared ingest step.

Every kernel takes both state layouts (core/compact.py) as a runtime
property too: the queues and the running set reach it as column views —
per field a base address, the bytes between rows and the value's size —
in a host array (``_layout``: the wide rows' fields at 4-byte offsets in
40-byte rows, or the compact layout's narrow leaves), built once per
state objects and kept in ``host``. Its stores into a narrow leaf are the
checked narrow store of ``ops/fields.py`` where the reference checks, into
the table's ``ovf``. Narrow node columns (the terminal prefix of a compact
state; a non-terminal tick hands the kernel the widened columns the
engine made, ``core/engine.py _widen_nodes``) are widened at the span's
entry and narrowed back, checked, at its exit, the cross-cluster count
added to every cluster's ``run.ovf`` by the last block.

Each source's header states what bounds it on the H100 and what its
design does about that. Every kernel carries a cluster per warp, their
cooperative steps in ``csrc/prefix_warp.cuh`` (FFD and the scored kinds
share its Level0 prefix, ``level0_prefix``, with another order and
pick); what they share besides, the column views and the steps one lane
runs on its own (the fault step, the waves' replay), is
``csrc/prefix_common.cuh``.
The kernel is the one of the member ``params.idx`` selects in the
engine's ``PolicySet``, read once at a run's entry (``host_params``).

Every kernel also has a lane form, the same template with the lane count
L a runtime argument: a lane-stacked batch (the tenants of a tenant
batch, the envs of an env batch; every state leaf [L, C, ...]) viewed as
its L C clusters end to end, a row of blocks a lane (``blockIdx.y``), so
a block never spans two lanes. The parameters the kernels read — FFD's
tie-break, DELAY's promotion threshold, the scored kinds' pick, 4x4
table and 3 weights — are [L] device tensors, each lane reading its own
row; the tap's histogram, ring and tick count and the node exit narrow's
total are per lane (a scratch set and a count of blocks done a lane).
One lane is the one-constellation launch. ``fused_prefix_lanes`` runs a
tick over a batch: ONE launch a kernel source (``host["groups"]``), each
with a [L] lane mask where a mixed ``PolicySet`` gives lanes to several
sources; its plain version is the loop over the lanes
(``fused_prefix_lanes_reference``).

``fused_prefix`` is the wrapper every tick calls:

- on CUDA tensors it checks device, dtype, shape and contiguity, launches
  the selected member's kernel on PyTorch's current stream — never
  synchronising, allocating nothing when the caller hands it its output
  buffers — and adds one to that kernel's ``launches``. A CUDA state has
  no other path: the wrapper launches or raises.
- on CPU tensors it runs ``fused_prefix_reference``, the plain PyTorch
  version (``Engine._span_prefix``: the ported release, return pack,
  ingest and policy ops), and leaves the launch counts alone.

Either way the state's tensors are updated in place, and it returns
``(state, want, bjob_vec, ret_rows, ret_valid, obs_out)``; the four
outputs are None in the terminal form, which nothing after the prefix
reads (the reference's terminal kernel computes ``want``/``bjob_vec`` and
XLA drops them), and ``obs_out`` is None without the tap.
``cfg.fused`` is copied with the config but chooses nothing here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from multi_cluster_simulator_tpu_torch.core.state import empty_io
from multi_cluster_simulator_tpu_torch.obs import device as obs_device
from multi_cluster_simulator_tpu_torch.ops import fields as F
from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.policies.kernels import _sweep_len
from multi_cluster_simulator_tpu_torch.utils.tree import (
    leaves_with_keys, tree_map,
)

REPLACES = "multi_cluster_simulator_tpu/kernels/fused_tick.py:160"
CSRC = "multi_cluster_simulator_tpu_torch/kernels/csrc/"

# The Level0 and Level1 sweeps' static limit: their placed-slot mask is a
# fixed-size bit array (csrc/prefix_common.cuh kMaxQueue), and the BFD
# order (FFD, tesserae) holds this many keys in a warp's shared memory.
MAX_QUEUE = 1024
# The fault step's failed-node mask, likewise (kMaxFaultNodes).
MAX_FAULT_NODES = 64
# The node slots a cluster may have on the compact layout: every kernel's
# replay of the waves computes on local arrays of them (kMaxNarrowNodes).
MAX_NARROW_NODES = 32
# The storage dtypes a column view takes (1, 2 or 4 bytes a value).
_INT_DTYPES = (torch.int8, torch.int16, torch.int32)


@dataclasses.dataclass
class Kernel:
    """One hand-written prefix kernel: its name, the policy kinds whose
    spans it carries, the library that holds it (``kernels/build.py``;
    its name unless given), whether it is an emit, an expire, a tap and a
    faults form, how many times the wrapper launched it, and how many of
    those launches took the windowed ingest."""

    name: str
    kinds: tuple
    lib: str = ""
    emit: bool = False
    expire: bool = False
    faults: bool = False
    tap: bool = False
    launches: int = 0
    windowed_launches: int = 0

    def __post_init__(self):
        self.lib = self.lib or self.name

    @property
    def source(self) -> str:
        return f"{CSRC}{self.lib}.cu"


_LEVEL0 = (("fused_prefix_ffd", ("ffd",)),
           ("fused_prefix_delay", ("delay",)),
           ("fused_prefix_scored", ("gavel", "tesserae", "rl")))


def _forms(faults: bool) -> tuple:
    """Every kernel form with the given faults flag, the faults forms
    named by a ``_faults`` suffix, the tap forms by ``_tap`` before it."""
    sfx = "_faults" if faults else ""
    fifo = "fused_prefix_fifo"
    return (
        Kernel(fifo + sfx, ("fifo",), lib=fifo, faults=faults),
        *(Kernel(name + sfx, kinds, lib=name, faults=faults)
          for name, kinds in _LEVEL0),
        Kernel(f"{fifo}_emit{sfx}", ("fifo",), lib=fifo, emit=True,
               faults=faults),
        Kernel(f"{fifo}_expire{sfx}", ("fifo",), lib=fifo, expire=True,
               faults=faults),
        Kernel(f"{fifo}_emit_expire{sfx}", ("fifo",), lib=fifo, emit=True,
               expire=True, faults=faults),
        *(Kernel(f"{name}_expire{sfx}", kinds, lib=name, expire=True,
                 faults=faults) for name, kinds in _LEVEL0),
        Kernel(f"{fifo}_tap{sfx}", ("fifo",), lib=fifo, tap=True,
               faults=faults),
        Kernel(f"{fifo}_emit_tap{sfx}", ("fifo",), lib=fifo, emit=True,
               tap=True, faults=faults),
        *(Kernel(f"{name}_tap{sfx}", kinds, lib=name, tap=True,
                 faults=faults) for name, kinds in _LEVEL0))


KERNELS = {k.name: k for k in _forms(False) + _forms(True)}


def reset_launches() -> None:
    """Set every kernel's launch counts to 0."""
    for k in KERNELS.values():
        k.launches = k.windowed_launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k.name: k.launches for k in KERNELS.values()}


def windowed_launch_counts() -> dict:
    """{kernel name: launches with the windowed ingest since the last
    reset}."""
    return {k.name: k.windowed_launches for k in KERNELS.values()}


def expires(cfg) -> bool:
    """Does the config engage vnode expiry (the trader on, with
    ``expire_virtual_nodes``)?"""
    return cfg.trader.enabled and cfg.trader.expire_virtual_nodes


def engaged_span(cfg) -> tuple[str, ...]:
    """The prefix phases a config engages, in tick order: the fault
    phase first where the fault plane is on, vnode expiry between release
    and ingest where ``expires``; the schedule slot is the selected
    member's."""
    return (*(("faults",) if cfg.faults.enabled else ()), "release",
            *(("expire",) if expires(cfg) else ()), "ingest", "schedule")


def kernel_for(member, emit: bool = False, expire: bool = False,
               faults: bool = False, tap: bool = False) -> Kernel:
    """The kernel that carries the span of ``member`` (a ``PolicySpec``)
    on the card, in the emit form when ``emit``, the expire form when
    ``expire``, the tap form when ``tap`` and the faults form when
    ``faults`` (the FIFO emit forms are entries of their own; the Level0
    kernels' emit forms share their kernel's). There is no form with both
    expiry and the tap: the trader is never terminal."""
    found = [k for k in KERNELS.values() if member.kind in k.kinds
             and k.expire == expire and k.faults == faults and k.tap == tap]
    if not found:
        raise ValueError(f"no {member.kind} kernel with expire={expire}, "
                         f"tap={tap}")
    return next((k for k in found if k.emit == emit), found[0])


def provenance(engine, params=None) -> dict:
    """What a recorded number ran: the engaged span, whether the tick ends
    with it (``Engine.prefix_terminal``), whether the prefix emits the
    return pack and the borrow request (``cfg.borrowing``, the form
    ``run``/``run_chunks`` take; ``run_io`` always emits), the member
    ``params.idx`` selects (the engine's default params unless given) and
    the kernel that carries it on the card; ``epilogue_tap``: whether a
    run with the metrics plane folds the tap into the kernel (a terminal
    prefix), and then ``tap_kernel``, the form it launches."""
    member = engine.member(params)
    emit = engine.cfg.borrowing
    faults = engine.cfg.faults.enabled
    k = kernel_for(member, emit, expires(engine.cfg), faults)
    terminal = engine.prefix_terminal()
    return {"span": list(engaged_span(engine.cfg)),
            "terminal": terminal, "policy": member.name,
            "schedule": member.kind, "kernel": k.name, "route": "cuda",
            "source": k.source, "replaces": REPLACES, "emit_returns": emit,
            "epilogue_tap": terminal,
            "tap_kernel": (kernel_for(member, emit, False, faults,
                                      tap=True).name if terminal else None)}


# the scored kernel's picks (csrc/fused_prefix_scored.cu kTable, kTesserae)
_PICK = {"gavel": 0, "rl": 0, "tesserae": 1}


@dataclasses.dataclass
class Group:
    """The lanes of a batch one kernel source carries in one launch a
    tick: its kernels (as ``host_params`` names them), the [L] uint8 mask
    of its lanes on the device (None where it carries every lane), and
    whether a lane of it picks tesserae (its warps stage the BFD order)."""

    kernels: dict
    lane_on: torch.Tensor = None
    order: int = 0
    host: dict = None


def _lane_plan(engine, members: tuple, device) -> dict:
    """The host-side grouping of a batch's lanes by the kernel source
    their members run (one launch a source a tick, DELAY's variants and
    the scored kinds sharing theirs through per-lane parameters) and the
    per-lane tables it needs on the device, made once per (engine,
    members, device) and cached on the engine: a later run over the same
    lanes copies nothing to the device."""
    key = (members, str(device))
    cached = engine._lane_plans.get(key)
    if cached is not None:
        return cached
    specs = [engine.pset.member(i) for i in members]
    libs = []
    for spec in specs:
        lib = kernel_for(spec).lib
        if lib not in libs:
            libs.append(lib)
    groups = []
    for lib in libs:
        on = [kernel_for(spec).lib == lib for spec in specs]
        first = specs[on.index(True)]
        mask = None if all(on) else torch.tensor(on, dtype=torch.uint8,
                                                 device=device)
        order = int(any(o and spec.kind == "tesserae"
                        for o, spec in zip(on, specs)))
        groups.append((first, mask, order))

    def flags(kinds):
        return torch.tensor([spec.kind in kinds for spec in specs],
                            device=device)

    plan = {"specs": specs, "groups": groups,
            "pick": torch.tensor([_PICK.get(spec.kind, 0) for spec in specs],
                                 dtype=torch.int32, device=device),
            "gavel": flags(("gavel",)), "rl": flags(("rl",))}
    engine._lane_plans[key] = plan
    return plan


def host_params(engine, params, members=None) -> dict:
    """What the kernels take from the host, made once at a run's entry and
    never inside a chunk: each launch's kernels, and the parameters they
    read, as device tensors a lane each — FFD's tie-break, DELAY's
    promotion threshold, the scored kinds' pick, 4x4 f32 table (gavel's
    throughputs or rl's scores) and tesserae's 3 f32 weights, handed to
    the kernel by pointer.

    ``params`` is one member's (0-d ``idx``: one lane) or a lane-stacked
    batch's (every leaf with a leading [L]; the engine broadcasts shared
    leaves). ``members`` is the host tuple of each lane's member index;
    when None it is read from ``params.idx`` (one host sync), else the
    entry reads nothing from the device. The lanes group by kernel source
    (``groups``, one launch each a tick): the terminal and the emit form,
    both expire forms where the config engages expiry, both faults forms
    where the fault plane is on, and on a terminal prefix the two tap
    forms. For one lane the first group's kernels are also the dict's own
    (``kernel``, ``emit_kernel``, ...), and ``member`` its member."""
    stacked = params.idx.dim() == 1
    if members is None:
        members = tuple(int(i) for i in params.idx.reshape(-1).tolist())
    p = params if stacked else tree_map(lambda x: x.unsqueeze(0), params)
    L = len(members)
    plan = _lane_plan(engine, tuple(members), p.idx.device)
    expire = expires(engine.cfg)
    faults = engine.cfg.faults.enabled
    tap = engine.prefix_terminal()
    groups = []
    for first, mask, order in plan["groups"]:
        groups.append(Group({
            "kernel": kernel_for(first, False, expire, faults),
            "emit_kernel": kernel_for(first, True, expire, faults),
            "tap_kernel": (kernel_for(first, False, False, faults, tap=True)
                           if tap else None),
            "emit_tap_kernel": (kernel_for(first, True, False, faults,
                                           tap=True) if tap else None)},
            mask, order))
    f32, i32 = torch.float32, torch.int32
    # a lane's table: gavel's throughputs or rl's scores (zeros for the
    # kinds that read none)
    table = torch.where(plan["gavel"][:, None],
                        p.gavel_tput.reshape(L, 16).to(f32),
                        torch.where(plan["rl"][:, None],
                                    p.rl_scores.reshape(L, 16).to(f32), 0.0))
    host = {"L": L, "stacked": stacked,
            "specs": plan["specs"], "groups": groups, "lane_on": None,
            "order": groups[0].order, "expire": expire, "faults": faults,
            "member": plan["specs"][0],
            "ffd_mem_first": (p.ffd_mem_first > 0).to(i32).reshape(L)
            .contiguous(),
            "max_wait_ms": p.max_wait_ms.to(i32).reshape(L).contiguous(),
            "pick": plan["pick"], "table": table.contiguous(),
            "weights": p.tess_w.to(f32).reshape(L, 3).contiguous()}
    host.update(groups[0].kernels)
    for g in groups:  # each launch's own dict: its mask, its caches
        g.host = dict(host, lane_on=g.lane_on, order=g.order, **g.kernels)
    return host


def fused_prefix_reference(engine, state, rows, counts, t: int, params,
                           member=None, emit_returns: bool = False, obs=None,
                           windowed: bool = False):
    """The plain PyTorch version: the ported per-cluster prefix ops on any
    device, for ``member`` (the one ``params.idx`` selects when None), with
    the metrics tap's per-cluster half after them when ``obs`` gives a
    ``(pc, cursor)`` pair. Returns ``(state, want, bjob_vec, ret_rows,
    ret_valid, obs_out)`` as ``Engine._span_prefix`` does, with a new
    state; the input is left as it was."""
    return engine._span_prefix(state, rows, counts, t, params, member,
                               emit_returns, obs, windowed)


def _copy_into(dst, src) -> None:
    for (_, d), (_, s_) in zip(leaves_with_keys(dst), leaves_with_keys(src)):
        if d is not s_:
            d.copy_(s_)


def _on_cpu(engine, state, rows, counts, host, obs) -> bool:
    """Whether a prefix call runs the plain version (every tensor on the
    CPU) rather than a launch (every tensor on one CUDA device), after
    the checks both routes share; raises on a mixed placement, on the tap
    of a non-terminal prefix and on narrow node columns there."""
    devices = _state_devices(state, host) | {rows.device, counts.device}
    if obs is not None and not engine.prefix_terminal():
        raise ValueError("fused_prefix: the metrics tap runs on a terminal "
                         "prefix only")
    if state.node_free.dtype != torch.int32 and not engine.prefix_terminal():
        raise ValueError(
            "fused_prefix: narrow node columns on a non-terminal prefix; "
            "the engine's tick widens them first (core/engine.py "
            "_widen_nodes) and narrows them after its last phase")
    if devices == {torch.device("cpu")}:
        return True
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"fused_prefix needs every tensor on one CUDA device or all on "
            f"the CPU; got {sorted(str(d) for d in devices)}")
    return False


def fused_prefix(engine, state, rows: torch.Tensor, counts: torch.Tensor,
                 t: int, params, host: dict, emit_returns: bool = False,
                 out=None, obs=None, windowed: bool = False):
    """Run tick ``t``'s prefix (the fault phase where engaged -> release
    -> vnode expiry where engaged -> ingest -> the selected member's
    pass) on ``state`` in place. ``rows``
    [C, K, NF] int32 and ``counts`` [C] int32 are the tick's arrival
    slice — with ``windowed``, the whole packed stream [C, A, NF] and its
    counts, from which the tick ingests its window; ``t`` is the
    post-tick clock as a host int; ``params`` are the policy's leaves (the
    plain path reads them) and ``host`` what the kernels take
    (``host_params``).
    With ``emit_returns`` the release step also packs the return messages
    and the pass writes the borrow request, into ``out`` (a ``TickIO`` of
    buffers on the state's device, allocated when None).
    ``obs``, a ``(MetricsBuffer, TapCursor)`` pair on a terminal prefix,
    closes the prefix with the metrics tap, both halves
    (``obs.device.tap_tick``), updating the buffer and the cursor in place;
    the kernels' operand pointers for it are checked once per (state,
    buffer, cursor) objects and kept in ``host`` (a caller that swaps a
    leaf tensor of one passes a new object).
    Returns ``(state, want, bjob_vec, ret_rows, ret_valid, obs_out)``, the
    four outputs None without ``emit_returns``, ``obs_out = (pc', cursor',
    placed_d, depth)`` (the buffer's per-cluster leaves, the cursor, the
    tick's placements and queue depths, [C] each) or None."""
    if _on_cpu(engine, state, rows, counts, host, obs):
        tap_in = None if obs is None else (obs_device.tap_pc(obs[0]), obs[1])
        new, *io, obs_out = fused_prefix_reference(
            engine, state, rows, counts, t, params, host["member"],
            emit_returns, tap_in, windowed)
        _copy_into(state, new)
        if obs is not None:
            pc, cur, placed_d, depth = obs_out
            _copy_into(obs[0], obs_device.tap_tick_global(
                obs[0].replace(**pc), placed_d, depth, t,
                engine.cfg.tick_ms))
            _copy_into(obs[1], cur)
            obs_out = (obs_device.tap_pc(obs[0]), obs[1], placed_d, depth)
        if not emit_returns:
            return state, None, None, None, None, obs_out
        if out is None:
            return (state, *io, obs_out)
        for (_, dst), src in zip(leaves_with_keys(out), io):
            dst.copy_(src)
        return (state, *_outputs(out), obs_out)
    tap = None
    if obs is not None:
        tap = _tap_args(engine, state, obs[0], obs[1], host)
    if emit_returns and out is None:
        out = empty_io((counts.shape[0],), engine.n_msgs(), counts.device)
    io = out if emit_returns else None
    if tap is None:
        k = host["emit_kernel" if emit_returns else "kernel"]
    else:
        k = host["emit_tap_kernel" if emit_returns else "tap_kernel"]
    _LAUNCH[k.lib](engine.cfg, state, rows, counts, t, host, io,
                   windowed, tap)
    k.launches += 1
    if windowed:
        k.windowed_launches += 1
    obs_out = None if tap is None else (tap.pc, obs[1], tap.placed_d,
                                        tap.depth)
    if not emit_returns:
        return state, None, None, None, None, obs_out
    return (state, *_outputs(out), obs_out)


# --------------------------------------------------------------------------
# the lane form: a batch of L constellations (tenants, envs) of C clusters
# --------------------------------------------------------------------------

def lane(tree, i: int):
    """Lane ``i`` of a lane-stacked tree (a state, params, a buffer, a
    TickIO: every leaf with a leading [L]): a view of each leaf, so that
    an in-place update of the lane updates the batch."""
    return tree_map(lambda x: x[i], tree)


def _flat(tree, keep=()):
    """A lane-stacked tree's clusters end to end: every leaf [L, C, ...]
    viewed as [L C, ...], but the leaves whose paths ``keep`` names (a
    state's clock, a buffer's cross-cluster leaves), which carry only the
    lane axis. The views share the batch's storage."""
    def walk(x, path=""):
        if dataclasses.is_dataclass(x):
            return dataclasses.replace(x, **{
                f.name: walk(getattr(x, f.name), f"{path}.{f.name}")
                for f in dataclasses.fields(x)})
        if path in keep:
            return x
        return x.view(x.shape[0] * x.shape[1], *x.shape[2:])
    return walk(tree)


_MBUF_LANE_LEAVES = (".ticks", ".depth_hist", ".ring_placed", ".ring_depth",
                     ".ring_t", ".leap_hist")


def _flat_cached(host: dict, name: str, tree, keep=()):
    """``_flat(tree)``, made once per tree object and kept in ``host``
    (the engine updates a batch's tensors in place; a caller that swaps a
    leaf passes a new object), so that the kernels' cached operands stay
    valid across ticks."""
    cached = host.get(name)
    if cached is not None and cached[0] is tree:
        return cached[1]
    flat = _flat(tree, keep)
    host[name] = (tree, flat)
    return flat


def fused_prefix_lanes_reference(engine, state, rows, counts, t: int, params,
                                 host: dict, emit_returns: bool = False,
                                 out=None, obs=None, windowed: bool = False):
    """The lane form's plain version, on any device: a loop over the lanes
    that runs the plain span (``fused_prefix_reference``) on each lane's
    [C] views, its member the lane's own, with the tap's two halves per
    lane under ``obs``. ``state``, ``params``, ``rows`` [L, C, K, NF],
    ``counts`` [L, C], ``out`` and ``obs`` carry the lane axis; the state,
    the buffer and the cursor are updated in place. Returns as
    ``fused_prefix_lanes``."""
    L, C = host["L"], state.arr_ptr.shape[-1]
    if emit_returns and out is None:
        out = empty_io((L, C), engine.n_msgs(), state.device)
    for i in range(L):
        s_i = lane(state, i)
        tap_in = None
        if obs is not None:
            mb_i, cur_i = lane(obs[0], i), lane(obs[1], i)
            tap_in = (obs_device.tap_pc(mb_i), cur_i)
        new, *io, obs_out = fused_prefix_reference(
            engine, s_i, rows[i], counts[i], t, lane(params, i),
            host["specs"][i], emit_returns, tap_in, windowed)
        _copy_into(s_i, new)
        if obs is not None:
            pc, cur, placed_d, depth = obs_out
            _copy_into(mb_i, obs_device.tap_tick_global(
                mb_i.replace(**pc), placed_d, depth, t, engine.cfg.tick_ms))
            _copy_into(cur_i, cur)
        if emit_returns:
            for (_, dst), src in zip(leaves_with_keys(lane(out, i)), io):
                dst.copy_(src)
    if not emit_returns:
        return state, None, None, None, None, None
    return (state, *_outputs(out), None)


def fused_prefix_lanes(engine, state, rows: torch.Tensor,
                       counts: torch.Tensor, t: int, params, host: dict,
                       emit_returns: bool = False, out=None, obs=None,
                       windowed: bool = False):
    """``fused_prefix`` over a batch of L lanes in lockstep (one clock
    ``t``): ``state``, ``params`` (``host_params`` of lane-stacked params),
    ``rows`` [L, C, K, NF] (contiguous), ``counts`` [L, C], ``out`` (a
    TickIO of [L, C, ...]) and ``obs`` (a lane-stacked buffer and cursor)
    carry the lane axis. On CUDA tensors each group of ``host["groups"]``
    — the lanes whose members one kernel source carries — is ONE launch
    over all L C clusters, a row of blocks a lane, the lanes of other
    sources masked out (``lane_on``) and every parameter read per lane
    from the device; the tap and the node exit narrow close each lane on
    its own. On CPU tensors it runs the plain per-lane loop
    (``fused_prefix_lanes_reference``). Either way the state (and the
    buffer and cursor) are updated in place. Returns ``(state, want,
    bjob_vec, ret_rows, ret_valid, None)``, the four [L, C, ...] outputs
    None without ``emit_returns``."""
    if _on_cpu(engine, state, rows, counts, host, obs):
        return fused_prefix_lanes_reference(engine, state, rows, counts, t,
                                            params, host, emit_returns, out,
                                            obs, windowed)
    if emit_returns and out is None:
        out = empty_io(tuple(counts.shape), engine.n_msgs(), counts.device)
    for k in launch_lanes(engine, state, rows, counts, t, host,
                          out if emit_returns else None, obs, windowed):
        k.launches += 1
        if windowed:
            k.windowed_launches += 1
    if not emit_returns:
        return state, None, None, None, None, None
    return (state, *_outputs(out), None)


def launch_lanes(engine, state, rows, counts, t: int, host: dict, out=None,
                 obs=None, windowed: bool = False) -> list:
    """The lane form's launches, one per group of ``host["groups"]``, over
    the batch's clusters end to end (the state, ``rows``, ``counts``,
    ``out`` and the buffer's per-cluster leaves viewed [L C, ...]; the
    views are made once per object and kept in ``host``). Emits into
    ``out`` when given. Returns the kernels launched; counts nothing."""
    L, C = host["L"], state.arr_ptr.shape[-1]
    if tuple(state.arr_ptr.shape) != (L, C):
        raise ValueError(f"fused_prefix_lanes: a state of "
                         f"{tuple(state.arr_ptr.shape)} clusters, {L} lanes")
    flat = _flat_cached(host, "flat_state", state, (".t",))
    rows_f = rows.view(L * C, *rows.shape[2:])
    counts_f = counts.view(L * C)
    io = None if out is None else _flat(out)
    launched = []
    for g in host["groups"]:
        tap = None
        if obs is not None:
            tap = _tap_args(
                engine, flat,
                _flat_cached(g.host, "flat_mbuf", obs[0], _MBUF_LANE_LEAVES),
                _flat_cached(g.host, "flat_cursor", obs[1]), g.host)
        if tap is None:
            k = g.kernels["emit_kernel" if io is not None else "kernel"]
        else:
            k = g.kernels["emit_tap_kernel" if io is not None
                          else "tap_kernel"]
        _LAUNCH[k.lib](engine.cfg, flat, rows_f, counts_f, t, g.host, io,
                       windowed, tap)
        launched.append(k)
    return launched


def _state_devices(state, host) -> set:
    """The devices of every leaf of ``state``, walked once per state object
    and kept in ``host`` (the engine updates a state's tensors in place;
    a caller that swaps a leaf tensor of one passes a new object, as for
    the tap's operands)."""
    cached = host.get("devices")
    if cached is not None and cached[0] is state:
        return cached[1]
    devices = {x.device for _, x in leaves_with_keys(state)}
    host["devices"] = (state, devices)
    return devices


def prepare(engine, state, host: dict, emit_returns: bool = False,
            obs=None) -> None:
    """Check and keep in ``host`` what a launch on ``state`` reads from
    the host (its leaves' devices, its column views and, with ``obs``,
    the tap's operands), as the first launch on it would: a caller timing
    a launch does this outside the timed span."""
    _state_devices(state, host)
    if state.device.type != "cuda":
        return
    lib = host["emit_kernel" if emit_returns else "kernel"].lib
    _layout(engine.cfg, state, _OWN_TABLES[lib](state), host)
    if obs is not None:
        _tap_args(engine, state, obs[0], obs[1], host)


def prepare_lanes(engine, state, host: dict, emit_returns: bool = False,
                  obs=None) -> None:
    """``prepare`` for the lane form: check and keep in ``host`` (and each
    group's) what ``fused_prefix_lanes`` on the lane-stacked ``state``
    reads from the host — the leaves' devices, the clusters viewed end to
    end, each group's column views and, with ``obs``, its tap operands —
    as its first launch would: a caller timing a launch does this
    outside the timed span."""
    _state_devices(state, host)
    if state.device.type != "cuda":
        return
    flat = _flat_cached(host, "flat_state", state, (".t",))
    for g in host["groups"]:
        lib = g.kernels["emit_kernel" if emit_returns else "kernel"].lib
        _layout(engine.cfg, flat, _OWN_TABLES[lib](flat), g.host)
        if obs is not None:
            _tap_args(engine, flat,
                      _flat_cached(g.host, "flat_mbuf", obs[0],
                                   _MBUF_LANE_LEAVES),
                      _flat_cached(g.host, "flat_cursor", obs[1]), g.host)


def _outputs(io) -> tuple:
    return io.borrow_want, io.borrow_job, io.ret_rows, io.ret_valid


def _check(name: str, x: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"fused_prefix: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape}; got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    return x


_INT = ctypes.c_int
_PTR = ctypes.c_void_p


@functools.cache
def _entry(name: str, n_ptr: int, n_int: int, n_host: int):
    """Kernel ``name``'s launch function, built and typed at first use: its
    tensor pointers, its ints, its host pointers, then the stream."""
    from multi_cluster_simulator_tpu_torch.kernels import build

    fn = getattr(build.load(name), f"{name}_launch")
    fn.argtypes = [_PTR] * n_ptr + [_INT] * n_int + [_PTR] * (n_host + 1)
    fn.restype = _INT
    return fn


def _common(cfg, s, rows, counts, t: int, windowed: bool, host: dict):
    """The checked pointers and ints every prefix kernel takes first: the
    node vectors, the running set, the counters of release/ingest/place,
    the trace, the tick's arrivals (or the windowed stream and its
    counts, with ``drops.ingest``), the launch's lane mask, the clusters a
    lane and the lanes (``host["L"]``; ``s`` holds the batch's clusters
    end to end, [L C, ...]) and the window (-1 for a tick's rows)."""
    if not -2**31 <= t < 2**31:
        raise ValueError(f"fused_prefix: clock {t} does not fit int32")
    C, N, n_res = s.node_free.shape
    L = host.get("L", 1)  # one lane unless the host says otherwise
    if C % L:
        raise ValueError(f"fused_prefix: {C} clusters do not split into "
                         f"{L} lanes")
    lane_on = host.get("lane_on")
    Qc, S = cfg.queue_capacity, cfg.max_running
    K = rows.shape[1] if rows.dim() == 3 else -1
    E = s.trace.t.shape[-1]
    i32, u8 = torch.int32, torch.bool
    c_shape = (C,)
    if s.node_free.dtype not in _INT_DTYPES:
        raise ValueError(f"fused_prefix: node_free of dtype "
                         f"{s.node_free.dtype}")
    ptrs = [
        _check("node_free", s.node_free, (C, N, n_res), s.node_free.dtype),
        _check("node_active", s.node_active, (C, N), u8),
        _check("run.active", s.run.active, (C, S), u8),
        _check("arr_ptr", s.arr_ptr, c_shape, i32),
        _check("drops.queue", s.drops.queue, c_shape, i32),
        _check("drops.run_full", s.drops.run_full, c_shape, i32),
        _check("placed_total", s.placed_total, c_shape, i32),
        _check("trace.t", s.trace.t, (C, E), i32),
        _check("trace.job", s.trace.job, (C, E), i32),
        _check("trace.node", s.trace.node, (C, E), i32),
        _check("trace.src", s.trace.src, (C, E), i32),
        _check("trace.n", s.trace.n, c_shape, i32),
        _check("rows", rows, (C, K, Q.NF), i32),
        _check("counts", counts, c_shape, i32),
        _check("drops.ingest", s.drops.ingest, c_shape, i32)
        if windowed else None,
        None if lane_on is None else _check("lane_on", lane_on, (L,),
                                            torch.uint8),
    ]
    window = min(cfg.max_ingest_per_tick, K) if windowed else -1
    ints = [C // L, L, N, n_res, Qc, S, K, E, _sweep_len(cfg),
            int(cfg.record_trace), t, window]
    return ptrs, ints


@dataclasses.dataclass
class TapArgs:
    """The tap form's operands for one (state, buffer, cursor): the host
    array of their pointers the kernel reads (``csrc/prefix_common.cuh
    make_tap``'s order), the tensors it points at, the per-tick outputs
    ``placed_d`` and ``depth``, and the buffer's per-cluster leaves as
    ``obs_device.tap_pc`` gives them."""

    key: tuple
    ptrs: ctypes.Array
    tensors: list
    placed_d: torch.Tensor
    depth: torch.Tensor
    pc: dict


_OVF_TABLES = ("l0", "l1", "ready", "wait", "lent", "borrowed", "run")


def _tap_args(engine, state, mbuf, cur, host: dict) -> TapArgs:
    """The tap form's checked operands, built once per (state, buffer,
    cursor) objects and kept in ``host["tap"]`` (which holds the objects,
    so their ids stay theirs): the buffer's per-cluster leaves
    (``PC_LEAVES``), the cursor, the two per-tick outputs, the buffer's
    cross-cluster leaves and a zeroed scratch of three words (the ring
    sums and the count of blocks done), then the state counters the tap
    reads, then the seven overflow counters (null on a wide table). A
    lane-stacked buffer's cross-cluster leaves carry a leading [L] (its
    per-cluster leaves and the cursor come flat, [L C]), and the scratch
    is three words a lane."""
    cached = host.get("tap")
    if cached is not None and cached.key[0] is state and \
            cached.key[1] is mbuf and cached.key[2] is cur:
        return cached
    C = state.arr_ptr.shape[0]
    dev = state.device
    i32, f32 = torch.int32, torch.float32
    c_shape = (C,)
    B, Rg = obs_device.OBS_DEPTH_BUCKETS, obs_device.OBS_RING
    L = host["L"]
    lead = (L,) if host["stacked"] else ()

    def leaf(name, x, dtype=i32, shape=c_shape):
        return _check(name, x, shape, dtype)

    placed_d = torch.empty(c_shape, dtype=i32, device=dev)
    depth = torch.empty(c_shape, dtype=i32, device=dev)
    tensors = [
        *(leaf(f"mbuf.{k}", getattr(mbuf, k),
               f32 if k == "wait_accrued" else i32)
          for k in obs_device.PC_LEAVES),
        *(leaf(f"cursor.{f.name}", getattr(cur, f.name),
               f32 if f.name == "wait" else i32)
          for f in dataclasses.fields(cur)),
        placed_d, depth,
        leaf("mbuf.ticks", mbuf.ticks, shape=lead),
        leaf("mbuf.depth_hist", mbuf.depth_hist, shape=lead + (1, B)),
        leaf("mbuf.ring_placed", mbuf.ring_placed, shape=lead + (1, Rg)),
        leaf("mbuf.ring_depth", mbuf.ring_depth, shape=lead + (1, Rg)),
        leaf("mbuf.ring_t", mbuf.ring_t, shape=lead + (Rg,)),
        torch.zeros(3 * L, dtype=i32, device=dev),
        leaf("wait_total", state.wait_total, f32),
        leaf("lent.count", state.lent.count),
        leaf("l0.count", state.l0.count),
        leaf("l1.count", state.l1.count),
        leaf("ready.count", state.ready.count),
        leaf("wait.count", state.wait.count),
        leaf("faults.kills", state.faults.kills),
        leaf("faults.requeues", state.faults.requeues),
        leaf("faults.down_ms", state.faults.down_ms),
        leaf("drops.failed", state.drops.failed),
    ]
    if {x.device for x in tensors} != {dev}:
        raise ValueError("fused_prefix: the metrics buffer and cursor must "
                         f"live on the state's device {dev}")
    # the compact layout's overflow counters (csrc/prefix_common.cuh
    # kOvfCounters), null where a table is wide
    ovf = [getattr(getattr(state, n), "ovf", None) for n in _OVF_TABLES]
    ovf = [x if x is None else leaf(f"{n}.ovf", x)
           for n, x in zip(_OVF_TABLES, ovf)]
    ptrs = (ctypes.c_void_p * (len(tensors) + len(ovf)))(
        *[x.data_ptr() for x in tensors],
        *[None if x is None else x.data_ptr() for x in ovf])
    tensors += [x for x in ovf if x is not None]
    host["tap"] = TapArgs((state, mbuf, cur), ptrs, tensors, placed_d, depth,
                          obs_device.tap_pc(mbuf))
    return host["tap"]


def _tap(cfg, tap: TapArgs, t: int):
    """The ints and the host pointer every launch function takes last:
    whether the tap runs, the ring slot of clock ``t``, the operands."""
    if tap is None:
        return [0, 0], None
    return [1, (t // cfg.tick_ms) % obs_device.OBS_RING], tap.ptrs


def _count(name: str, q, C: int):
    return [_check(f"{name}.count", q.count, (C,), torch.int32)]


def _table_words(name: str, x, C: int, L: int) -> list:
    """The layout words of one table (``csrc/prefix_common.cuh
    make_table``): per field its base address, the bytes between rows and
    the value's size, then the ``ovf`` counter's address (0 on the wide
    layout). The wide rows' field f lies at byte 4 f of a 4 NF-byte row."""
    fields = F.QUEUE_FIELDS if isinstance(x, (Q.JobQueue, Q.SoAJobQueue)) \
        else F.RUN_FIELDS
    if isinstance(x, (Q.JobQueue, R.RunningSet)):
        p = _check(f"{name}.data", x.data, (C, L, len(fields)),
                   torch.int32).data_ptr()
        return [w for f in range(len(fields))
                for w in (p + 4 * f, 4 * len(fields), 4)] + [0]
    words = []
    for n in fields:
        leaf = x.leaf(n)
        if leaf.dtype not in _INT_DTYPES:
            raise ValueError(f"fused_prefix: {name}.f_{n} of dtype "
                             f"{leaf.dtype}")
        _check(f"{name}.f_{n}", leaf, (C, L), leaf.dtype)
        words += [leaf.data_ptr(), leaf.element_size(), leaf.element_size()]
    return words + [_check(f"{name}.ovf", x.ovf, (C,),
                           torch.int32).data_ptr()]


@dataclasses.dataclass
class Layout:
    """The layout array of one set of tables (``_layout``): the objects it
    was built from, the host array, and the node exit's scratch."""

    key: tuple
    words: ctypes.Array
    scratch: torch.Tensor


# the layouts ``_layout`` keeps in ``host``, the newest last
_LAYOUTS_KEPT = 4
# each kernel's own queues, after the running set and the lent queue
_OWN_TABLES = {"fused_prefix_fifo": lambda s: (s.ready, s.wait),
               "fused_prefix_ffd": lambda s: (s.l0,),
               "fused_prefix_delay": lambda s: (s.l0, s.l1),
               "fused_prefix_scored": lambda s: (s.l0,)}


def _layout(cfg, s, own: tuple, host: dict) -> ctypes.Array:
    """The host array every launch function takes (``csrc/prefix_common.cuh
    make_table``'s order): the node columns' value size and the node exit
    scratch (two zeroed words a lane, 0 on int32 columns), then the column views
    of the running set, the lent queue and the kernel's own queues
    ``own``. Built once per (node dtype, lanes, table objects); the newest few
    are kept in ``host["layouts"]``, which holds the objects, so their ids
    stay theirs."""
    L = host["L"]
    key = (s.node_free.dtype, L, s.run, s.lent, *own)
    kept = host.setdefault("layouts", [])
    for cached in kept:
        if len(cached.key) == len(key) and cached.key[:2] == key[:2] and \
                all(a is b for a, b in zip(cached.key[2:], key[2:])):
            return cached.words
    C, N, n_res = s.node_free.shape
    Qc, S = cfg.queue_capacity, cfg.max_running
    size = s.node_free.element_size()
    scratch = torch.zeros(2 * L, dtype=torch.int32, device=s.device)
    compact = size != 4 or any(isinstance(x, (Q.SoAJobQueue,
                                              R.SoARunningSet))
                               for x in key[2:])
    if compact and (N > MAX_NARROW_NODES or n_res > 3):
        # the wave replay's local node arrays
        raise ValueError(f"fused_prefix: the compact layout's {N} x {n_res} "
                         f"node words exceed the kernel's "
                         f"{MAX_NARROW_NODES} x 3")
    if size != 4:
        if not isinstance(s.run, R.SoARunningSet):
            raise ValueError("fused_prefix: narrow node columns count into "
                             "the compact running set's ovf")
    words = [size, scratch.data_ptr() if size != 4 else 0]
    words += _table_words("run", s.run, C, S)
    words += _table_words("lent", s.lent, C, Qc)
    for i, q in enumerate(own):
        words += _table_words(f"queue {i}", q, C, Qc)
    arr = (ctypes.c_int64 * len(words))(*words)
    kept.append(Layout(key, arr, scratch))
    del kept[:-_LAYOUTS_KEPT]
    return arr


def _level0(name: str, s, C: int, Qc: int):
    """Level0 and the counters its sweeps update, for the FFD, DELAY and
    scored kernels, after checking the sweeps' queue limit."""
    if Qc > MAX_QUEUE:
        raise ValueError(f"{name}: queue_capacity {Qc} exceeds the kernel's "
                         f"limit {MAX_QUEUE}")
    c_shape = (C,)
    return _count("l0", s.l0, C) + [
        _check("wait_total", s.wait_total, c_shape, torch.float32),
        _check("wait_jobs", s.wait_jobs, c_shape, torch.int32),
        _check("jobs_in_queue", s.jobs_in_queue, c_shape, torch.int32),
    ]


def _emit(cfg, s, io):
    """The emit outputs' pointers (None on a terminal launch) and ints
    that every launch function takes after its own: the return rows and
    flags, ``drops.msgs``, ``want`` and ``bjob_vec``; the message slots,
    whether to emit, whether borrowing is on."""
    if io is None:
        return [None] * 5, [0, 0, int(cfg.borrowing)]
    C = s.arr_ptr.shape[0]
    M = io.ret_valid.shape[-1]
    if M != min(cfg.max_msgs, cfg.max_running):
        raise ValueError(f"fused_prefix: {M} message slots, the config "
                         f"packs {min(cfg.max_msgs, cfg.max_running)}")
    ptrs = [_check("ret_rows", io.ret_rows, (C, M, R.RF), torch.int32),
            _check("ret_valid", io.ret_valid, (C, M), torch.bool),
            _check("drops.msgs", s.drops.msgs, (C,), torch.int32),
            _check("want", io.borrow_want, (C,), torch.bool),
            _check("bjob_vec", io.borrow_job, (C, Q.NF), torch.int32)]
    return ptrs, [M, 1, int(cfg.borrowing)]


def _expire(s, host: dict):
    """The expire form's node columns (None without expiry; the node
    vectors themselves ``_common`` checks) and its flag, which every
    launch function takes after the emit arguments."""
    if not host["expire"]:
        return [None, None], [0]
    C, N, n_res = s.node_free.shape
    return [_check("node_cap", s.node_cap, (C, N, n_res), torch.int32),
            _check("node_expire", s.node_expire, (C, N), torch.int32)], [1]


def _faults(cfg, s, host: dict):
    """The faults form's leaves (None without the fault plane) with the
    node capacities (in the node columns' dtype) and the lent count its
    repairs and requeues need (the lent queue's view is in ``_layout``), and
    its flag and settings, which every launch function takes after the
    expire arguments."""
    if not host["faults"]:
        return [None] * 15, [0, 1, 0, 0, 0, 0]
    C, N, n_res = s.node_free.shape
    if N > MAX_FAULT_NODES:
        raise ValueError(f"fused_prefix: {N} node slots exceed the fault "
                         f"step's limit {MAX_FAULT_NODES}")
    fs, fc = s.faults, cfg.faults
    E = fs.fail_t.shape[-1]
    i32, u8 = torch.int32, torch.bool
    cn, c_shape = (C, N), (C,)
    ptrs = [_check("faults.health", fs.health, cn, u8),
            _check("faults.was_active", fs.was_active, cn, u8),
            _check("faults.next_fail", fs.next_fail, cn, i32),
            _check("faults.down_until", fs.down_until, cn, i32),
            _check("faults.down_since", fs.down_since, cn, i32),
            _check("faults.n_fails", fs.n_fails, cn, i32),
            _check("faults.kills", fs.kills, c_shape, i32),
            _check("faults.requeues", fs.requeues, c_shape, i32),
            _check("faults.down_ms", fs.down_ms, c_shape, i32),
            _check("faults.fail_t", fs.fail_t, (C, N, E), i32),
            _check("faults.repair_t", fs.repair_t, (C, N, E), i32),
            _check("faults.key", fs.key, (C, 2), torch.uint32),
            _check("drops.failed", s.drops.failed, c_shape, i32),
            _check("node_cap", s.node_cap, (C, N, n_res), s.node_free.dtype),
            *_count("lent", s.lent, C)]
    return ptrs, [1, E, int(fc.mode == "trace"), int(fc.mttf_ms),
                  int(fc.mttr_ms), int(fc.max_retries)]


def _run(name: str, ptrs, ints, rows, host_ptrs=()):
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    fn = _entry(name, len(ptrs), len(ints), len(host_ptrs))
    err = fn(*[None if p is None else p.data_ptr() for p in ptrs], *ints,
             *[None if h is None else ctypes.addressof(h) for h in host_ptrs],
             stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name(rows.device)})")


def _lane_param(name: str, host: dict, dtype, width=()) -> torch.Tensor:
    """A per-lane parameter of ``host``, checked: [L] (or [L, width])."""
    return _check(name, host[name], (host["L"], *width), dtype)


def _launch_fifo(cfg, s, rows, counts, t: int, host: dict, io=None,
                 windowed: bool = False, tap: TapArgs = None) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t, windowed, host)
    C = s.arr_ptr.shape[0]
    ints += [int(cfg.fifo_drain == "wave")]
    ptrs += (_count("ready", s.ready, C) + _count("wait", s.wait, C)
             + _count("lent", s.lent, C))
    e_ptrs, e_ints = _emit(cfg, s, io)
    x_ptrs, x_ints = _expire(s, host)
    f_ptrs, f_ints = _faults(cfg, s, host)
    t_ints, t_ptrs = _tap(cfg, tap, t)
    layout = _layout(cfg, s, _OWN_TABLES["fused_prefix_fifo"](s), host)
    _run("fused_prefix_fifo", ptrs + e_ptrs + x_ptrs + f_ptrs,
         ints + e_ints + x_ints + f_ints + t_ints, rows, (layout, t_ptrs))


def _launch_ffd(cfg, s, rows, counts, t: int, host: dict, io=None,
                windowed: bool = False, tap: TapArgs = None) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t, windowed, host)
    C = s.arr_ptr.shape[0]
    ptrs += _level0("fused_prefix_ffd", s, C, cfg.queue_capacity) + [
        _lane_param("ffd_mem_first", host, torch.int32)]
    wave = int(not cfg.parity and cfg.ffd_sweep == "wave")
    ints += [wave]
    e_ptrs, e_ints = _emit(cfg, s, io)
    x_ptrs, x_ints = _expire(s, host)
    f_ptrs, f_ints = _faults(cfg, s, host)
    t_ints, t_ptrs = _tap(cfg, tap, t)
    layout = _layout(cfg, s, _OWN_TABLES["fused_prefix_ffd"](s), host)
    _run("fused_prefix_ffd", ptrs + e_ptrs + x_ptrs + f_ptrs,
         ints + e_ints + x_ints + f_ints + t_ints, rows, (layout, t_ptrs))


def _launch_delay(cfg, s, rows, counts, t: int, host: dict, io=None,
                  windowed: bool = False, tap: TapArgs = None) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t, windowed, host)
    C = s.arr_ptr.shape[0]
    ptrs += (_level0("fused_prefix_delay", s, C, cfg.queue_capacity)
             + _count("l1", s.l1, C)
             + [_lane_param("max_wait_ms", host, torch.int32)])
    wave = int(not cfg.parity and cfg.delay_sweep == "wave")
    ints += [wave, int(cfg.parity)]
    e_ptrs, e_ints = _emit(cfg, s, io)
    x_ptrs, x_ints = _expire(s, host)
    f_ptrs, f_ints = _faults(cfg, s, host)
    t_ints, t_ptrs = _tap(cfg, tap, t)
    layout = _layout(cfg, s, _OWN_TABLES["fused_prefix_delay"](s), host)
    _run("fused_prefix_delay", ptrs + e_ptrs + x_ptrs + f_ptrs,
         ints + e_ints + x_ints + f_ints + t_ints, rows, (layout, t_ptrs))


def _launch_scored(cfg, s, rows, counts, t: int, host: dict, io=None,
                   windowed: bool = False, tap: TapArgs = None) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t, windowed, host)
    C, N = s.node_free.shape[:2]
    ptrs += _level0("fused_prefix_scored", s, C, cfg.queue_capacity) + [
        _check("node_type", s.node_type, (C, N), torch.int32),
        _lane_param("pick", host, torch.int32),
        _lane_param("table", host, torch.float32, (16,)),
        _lane_param("weights", host, torch.float32, (3,))]
    ints += [host["order"]]
    e_ptrs, e_ints = _emit(cfg, s, io)
    x_ptrs, x_ints = _expire(s, host)
    f_ptrs, f_ints = _faults(cfg, s, host)
    t_ints, t_ptrs = _tap(cfg, tap, t)
    layout = _layout(cfg, s, _OWN_TABLES["fused_prefix_scored"](s), host)
    _run("fused_prefix_scored", ptrs + e_ptrs + x_ptrs + f_ptrs,
         ints + e_ints + x_ints + f_ints + t_ints, rows, (layout, t_ptrs))


_LAUNCH = {"fused_prefix_fifo": _launch_fifo,
           "fused_prefix_ffd": _launch_ffd,
           "fused_prefix_delay": _launch_delay,
           "fused_prefix_scored": _launch_scored}
