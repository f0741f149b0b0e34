"""The tick's per-cluster prefix as one hand-written CUDA kernel per span.

The port of ``multi_cluster_simulator_tpu/kernels/fused_tick.py``. There,
``fused_prefix`` replays the traced jaxpr of ``Engine._span_prefix`` inside
one ``pallas_call`` over cluster blocks, so that each state column is
loaded and stored once per tick. Generic jaxpr replay has no Hopper
counterpart, so the port writes one CUDA kernel per engaged span. Both
spans ported so far are terminal, wide-layout and untapped, and differ in
the schedule slot (``KERNELS``):

- ``fused_prefix_fifo`` — ``[release, ingest -> ReadyQueue, schedule:
  FIFO]`` (``csrc/fused_prefix_fifo.cu``);
- ``fused_prefix_ffd`` — ``[release, ingest -> Level0, schedule: FFD]``,
  the serial and the wave sweep (``csrc/fused_prefix_ffd.cu``).

Each source's header states what bounds it on the H100 and what its
design does about that; what they share is ``csrc/prefix_common.cuh``.

``fused_prefix`` is the wrapper every tick calls:

- on CUDA tensors it checks device, dtype, shape and contiguity, launches
  the engine's kernel on PyTorch's current stream — never synchronising,
  allocating nothing — and adds one to that kernel's ``launches``. A CUDA
  state has no other path: the wrapper launches or raises.
- on CPU tensors it runs ``fused_prefix_reference``, the plain PyTorch
  version (``Engine._span_prefix``: the ported release, ingest and policy
  ops), and leaves the launch counts alone.

Either way the state's tensors are updated in place and the state is
returned. ``cfg.fused`` is copied with the config but chooses nothing here.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.policies.kernels import _sweep_len
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

REPLACES = "multi_cluster_simulator_tpu/kernels/fused_tick.py:160"
CSRC = "multi_cluster_simulator_tpu_torch/kernels/csrc/"

# The FFD kernel's static limits: Level0's placed-slot mask is a
# fixed-size bit array per thread.
FFD_MAX_QUEUE = 1024


@dataclasses.dataclass
class Kernel:
    """One hand-written prefix kernel: its name (also the library's name in
    ``kernels/build.py``), the policy kind whose span it carries, and how
    many times the wrapper launched it."""

    name: str
    kind: str
    launches: int = 0

    @property
    def source(self) -> str:
        return f"{CSRC}{self.name}.cu"


KERNELS = {k.kind: k for k in (Kernel("fused_prefix_fifo", "fifo"),
                               Kernel("fused_prefix_ffd", "ffd"))}


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}."""
    return {k.name: k.launches for k in KERNELS.values()}


def engaged_span(cfg) -> tuple[str, ...]:
    """The prefix phases a config engages, in tick order. ``Engine``
    admits no config that engages the faults head or vnode expiry, so
    every engine of the port has this span; the schedule slot is the
    policy's."""
    return ("release", "ingest", "schedule")


def kernel_for(engine) -> Kernel:
    """The kernel that carries ``engine``'s span on the card."""
    return KERNELS[engine.spec.kind]


def provenance(engine) -> dict:
    """What a recorded number ran: the engaged span and the kernel that
    carries it on the card."""
    k = kernel_for(engine)
    return {"span": list(engaged_span(engine.cfg)), "schedule": k.kind,
            "kernel": k.name, "route": "cuda", "source": k.source,
            "replaces": REPLACES, "epilogue_tap": False}


def host_params(params) -> dict:
    """The policy parameters the kernels take as host ints, read once (a
    host sync) at a run's entry and never inside a chunk."""
    return {"ffd_mem_first": int(params.ffd_mem_first > 0)}


def fused_prefix_reference(engine, state, rows, counts, t: int, params):
    """The plain PyTorch version: the ported per-cluster prefix ops on any
    device. Returns a new state; the input is left as it was."""
    return engine._span_prefix(state, rows, counts, t, params)


def fused_prefix(engine, state, rows: torch.Tensor, counts: torch.Tensor,
                 t: int, params, host: dict):
    """Run tick ``t``'s prefix (release -> ingest -> the policy's pass) on
    ``state`` in place and return it. ``rows`` [C, K, NF] int32 and
    ``counts`` [C] int32 are the tick's arrival slice; ``t`` is the
    post-tick clock as a host int; ``params`` are the policy's leaves
    (the plain path reads them) and ``host`` their host-int form
    (``host_params``, what the kernels read)."""
    devices = {x.device for _, x in leaves_with_keys(state)}
    devices |= {rows.device, counts.device}
    if devices == {torch.device("cpu")}:
        new = fused_prefix_reference(engine, state, rows, counts, t, params)
        for (_, dst), (_, src) in zip(leaves_with_keys(state),
                                      leaves_with_keys(new)):
            if dst is not src:
                dst.copy_(src)
        return state
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"fused_prefix needs every tensor on one CUDA device or all on "
            f"the CPU; got {sorted(str(d) for d in devices)}")
    k = kernel_for(engine)
    _LAUNCH[k.kind](engine.cfg, state, rows, counts, t, host)
    k.launches += 1
    return state


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
def _entry(name: str, n_ptr: int, n_int: int):
    """Kernel ``name``'s launch function, built and typed at first use."""
    from multi_cluster_simulator_tpu_torch.kernels import build

    fn = getattr(build.load(name), f"{name}_launch")
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * n_ptr + [_INT] * n_int + [_PTR]
        fn.restype = _INT
    return fn


def _common(cfg, s, rows, counts, t: int):
    """The checked pointers and ints every prefix kernel takes first: the
    node vectors, the running set, the counters of release/ingest/place,
    the trace, and the tick's arrivals."""
    if not -2**31 <= t < 2**31:
        raise ValueError(f"fused_prefix: clock {t} does not fit int32")
    C, N, n_res = s.node_free.shape
    Qc, S = cfg.queue_capacity, cfg.max_running
    K = rows.shape[1] if rows.dim() == 3 else -1
    E = s.trace.t.shape[-1]
    i32, u8 = torch.int32, torch.bool
    c_shape = (C,)
    ptrs = [
        _check("node_free", s.node_free, (C, N, n_res), i32),
        _check("node_active", s.node_active, (C, N), u8),
        _check("run.data", s.run.data, (C, S, R.RF), i32),
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
    ]
    ints = [C, N, n_res, Qc, S, K, E, _sweep_len(cfg), int(cfg.record_trace),
            t]
    return ptrs, ints


def _queue(name: str, q, C: int, Qc: int):
    return [_check(f"{name}.data", q.data, (C, Qc, Q.NF), torch.int32),
            _check(f"{name}.count", q.count, (C,), torch.int32)]


def _run(name: str, ptrs, ints, rows):
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    fn = _entry(name, len(ptrs), len(ints))
    err = fn(*[p.data_ptr() for p in ptrs], *ints, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({torch.cuda.get_device_name(rows.device)})")


def _launch_fifo(cfg, s, rows, counts, t: int, host: dict) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t)
    C, Qc = ints[0], ints[3]
    ptrs += (_queue("ready", s.ready, C, Qc) + _queue("wait", s.wait, C, Qc)
             + _queue("lent", s.lent, C, Qc))
    _run("fused_prefix_fifo", ptrs, ints, rows)


def _launch_ffd(cfg, s, rows, counts, t: int, host: dict) -> None:
    ptrs, ints = _common(cfg, s, rows, counts, t)
    C, Qc = ints[0], ints[3]
    if Qc > FFD_MAX_QUEUE:
        raise ValueError(f"fused_prefix_ffd: queue_capacity {Qc} exceeds "
                         f"the kernel's limit {FFD_MAX_QUEUE}")
    c_shape = (C,)
    ptrs += _queue("l0", s.l0, C, Qc) + [
        _check("wait_total", s.wait_total, c_shape, torch.float32),
        _check("wait_jobs", s.wait_jobs, c_shape, torch.int32),
        _check("jobs_in_queue", s.jobs_in_queue, c_shape, torch.int32),
    ]
    wave = int(not cfg.parity and cfg.ffd_sweep == "wave")
    ints += [wave, host["ffd_mem_first"]]
    _run("fused_prefix_ffd", ptrs, ints, rows)


_LAUNCH = {"fifo": _launch_fifo, "ffd": _launch_ffd}
