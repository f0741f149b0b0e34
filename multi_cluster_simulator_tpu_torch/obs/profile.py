"""The profile plane: tick phases and dispatch sites as
``torch.profiler`` ranges (the port of
``multi_cluster_simulator_tpu/obs/profile.py``).

In the reference, ``phase_scope`` is a ``jax.named_scope``: metadata
attached at trace time, free at run time. The port runs eagerly, so a
range entered every tick costs host time on every tick. Both primitives
therefore enter a ``torch.profiler.record_function`` range only while a
profiler session is active (``start_trace`` here, or any
``torch.profiler.profile`` around the run), and are a null context
otherwise: a run that nobody traces pays one flag check per scope.

The phase-prefix ablation is ``Engine.run_prefix`` (the tick truncated
after its first k phases of ``TICK_PHASES``), and
``multi_cluster_simulator_tpu_torch/tools/profile_capture.py`` drives it
and one ``start_trace`` session around a run.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.autograd import profiler as _autograd_profiler

# The documented determinization of the reference's concurrent goroutines
# (its core/engine.py module docstring; PARITY.md §phase order).
TICK_PHASES = (
    "faults",    # 1. node failures kill/requeue, repairs restore (faults/)
    "release",   # 2. completions + finished-foreign returns
    "expire",    # 3. virtual-node expiry (sane mode only)
    "ingest",    # 4. arrivals -> Level0 / ReadyQueue
    "schedule",  # 5. the policy zoo's scheduling pass
    "borrow",    # 6. cross-cluster borrow matching
    "snapshot",  # 7. trader state snapshot
    "trade",     # 8. trader market round
)

_SESSION: list = []  # the profile start_trace opened, while it runs
_NULL = contextlib.nullcontext()  # reusable: entering it costs no allocation


def profiling() -> bool:
    """Is a profiler session recording now?"""
    return bool(_autograd_profiler._is_profiler_enabled)


def phase_scope(name: str):
    """A ``tick.<name>`` range over one tick phase while a profiler
    records; a null context otherwise."""
    if not profiling():
        return _NULL
    return torch.profiler.record_function(f"tick.{name}")


def annotate_dispatch(name: str):
    """A ``mcs.dispatch.<name>`` range around a host dispatch site while a
    profiler records; a null context otherwise."""
    if not profiling():
        return _NULL
    return torch.profiler.record_function(f"mcs.dispatch.{name}")


def start_trace(logdir: str) -> None:
    """Start a profiler session (the card's activity too, where there is a
    card) that writes a Chrome trace into ``logdir`` at ``stop_trace``."""
    if _SESSION:
        raise RuntimeError("a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _SESSION.append((prof, logdir))


def stop_trace() -> None:
    """End the session ``start_trace`` opened and write its trace."""
    prof, logdir = _SESSION.pop()
    prof.stop()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def trace_artifacts(logdir: str) -> list[str]:
    """The trace files a finished session left under ``logdir``."""
    out = []
    for root, _dirs, files in os.walk(logdir):
        out.extend(os.path.join(root, f) for f in files
                   if f.endswith((".json", ".json.gz")))
    return sorted(out)
