"""The tick's per-cluster prefix as one hand-written CUDA kernel.

The port of ``multi_cluster_simulator_tpu/kernels/fused_tick.py``. There,
``fused_prefix`` replays the traced jaxpr of ``Engine._span_prefix`` inside
one ``pallas_call`` over cluster blocks, so that each state column is
loaded and stored once per tick. Generic jaxpr replay has no Hopper
counterpart, so the port writes one CUDA kernel per engaged span. This
slice has the headline's span: ``[release, ingest, schedule: FIFO]``,
terminal, wide layout, no metrics tap
(``csrc/fused_prefix_fifo.cu``; its header states what bounds it on the
H100 and what its design does about that).

``fused_prefix`` is the wrapper every tick calls:

- on CUDA tensors it checks device, dtype, shape and contiguity, launches
  the kernel on PyTorch's current stream — never synchronising, allocating
  nothing — and adds one to ``fused_prefix.launches``. A CUDA state has no
  other path: the wrapper launches or raises.
- on CPU tensors it runs ``fused_prefix_reference``, the plain PyTorch
  version (``Engine._span_prefix``: the ported release, ingest and FIFO
  ops), and leaves the launch count alone.

Either way the state's tensors are updated in place and the state is
returned. ``cfg.fused`` is copied with the config but chooses nothing here.
"""

from __future__ import annotations

import ctypes

import torch

from multi_cluster_simulator_tpu_torch.ops import queues as Q
from multi_cluster_simulator_tpu_torch.ops import runset as R
from multi_cluster_simulator_tpu_torch.utils.tree import leaves_with_keys

KERNEL = "fused_prefix_fifo"
SOURCE = "multi_cluster_simulator_tpu_torch/kernels/csrc/fused_prefix_fifo.cu"
REPLACES = "multi_cluster_simulator_tpu/kernels/fused_tick.py:160"


def engaged_span(cfg) -> tuple[str, ...]:
    """The prefix phases a config engages, in tick order. ``Engine``
    admits no config that engages the faults head or vnode expiry, so this
    slice has one span."""
    return ("release", "ingest", "schedule")


def provenance(cfg) -> dict:
    """What a recorded number ran: the engaged span and the kernel that
    carries it on the card."""
    return {"span": list(engaged_span(cfg)), "kernel": KERNEL,
            "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "epilogue_tap": False}


def fused_prefix_reference(engine, state, rows, counts, t: int):
    """The plain PyTorch version: the ported per-cluster prefix ops on any
    device. Returns a new state; the input is left as it was."""
    return engine._span_prefix(state, rows, counts, t)


def fused_prefix(engine, state, rows: torch.Tensor, counts: torch.Tensor,
                 t: int):
    """Run tick ``t``'s prefix (release -> ingest -> FIFO schedule) on
    ``state`` in place and return it. ``rows`` [C, K, NF] int32 and
    ``counts`` [C] int32 are the tick's arrival slice; ``t`` is the
    post-tick clock as a host int."""
    devices = {x.device for _, x in leaves_with_keys(state)}
    devices |= {rows.device, counts.device}
    if devices == {torch.device("cpu")}:
        new = fused_prefix_reference(engine, state, rows, counts, t)
        for (_, dst), (_, src) in zip(leaves_with_keys(state),
                                      leaves_with_keys(new)):
            if dst is not src:
                dst.copy_(src)
        return state
    if len(devices) != 1 or next(iter(devices)).type != "cuda":
        raise ValueError(
            f"fused_prefix needs every tensor on one CUDA device or all on "
            f"the CPU; got {sorted(str(d) for d in devices)}")
    _launch(engine.cfg, state, rows, counts, t)
    fused_prefix.launches += 1
    return state


fused_prefix.launches = 0


def _check(name: str, x: torch.Tensor, shape: tuple, dtype) -> torch.Tensor:
    if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous():
        raise ValueError(
            f"fused_prefix: {name} must be a contiguous {dtype} tensor of "
            f"shape {shape}; got {x.dtype} {tuple(x.shape)} "
            f"contiguous={x.is_contiguous()}")
    return x


_INT = ctypes.c_int
_PTR = ctypes.c_void_p


def _entry():
    from multi_cluster_simulator_tpu_torch.kernels import build

    fn = build.load(KERNEL).fused_prefix_fifo_launch
    if fn.argtypes is None:
        fn.argtypes = [_PTR] * 21 + [_INT] * 10 + [_PTR]
        fn.restype = _INT
    return fn


def _launch(cfg, s, rows, counts, t: int) -> None:
    from multi_cluster_simulator_tpu_torch.policies.kernels import _sweep_len

    if not -2**31 <= t < 2**31:
        raise ValueError(f"fused_prefix: clock {t} does not fit int32")
    C, N, n_res = s.node_free.shape
    Qc, S = cfg.queue_capacity, cfg.max_running
    K = rows.shape[1] if rows.dim() == 3 else -1
    E = s.trace.t.shape[-1]
    i32, u8 = torch.int32, torch.bool
    q_shape, c_shape = (C, Qc, Q.NF), (C,)
    ptrs = [
        _check("node_free", s.node_free, (C, N, n_res), i32),
        _check("node_active", s.node_active, (C, N), u8),
        _check("ready.data", s.ready.data, q_shape, i32),
        _check("ready.count", s.ready.count, c_shape, i32),
        _check("wait.data", s.wait.data, q_shape, i32),
        _check("wait.count", s.wait.count, c_shape, i32),
        _check("lent.data", s.lent.data, q_shape, i32),
        _check("lent.count", s.lent.count, c_shape, i32),
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
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = _entry()(*[p.data_ptr() for p in ptrs], C, N, n_res, Qc, S, K, E,
                   _sweep_len(cfg), int(cfg.record_trace), t, stream)
    if err != 0:
        raise RuntimeError(f"fused_prefix_fifo launch failed: CUDA error "
                           f"{err} ({torch.cuda.get_device_name(rows.device)})")
