"""The preemption plane: resumable, bit-identical long runs (the port of
``multi_cluster_simulator_tpu/core/preempt.py``).

Three pieces, for the chunked drivers:

- **RunCheckpoint** — the run bundle: the ``SimState`` (which carries the
  fault plane's churn clocks, retry budgets and interval cursors), the
  metrics plane's ``MetricsBuffer`` (so a resumed run's harvest covers the
  whole run), and the driver's resume cursors in the header: the completed
  tick, the chunk index, and the time-compression provenance so far
  (``ticks_executed`` and the log2 leap histogram), which telescopes over
  kill/resume cycles to the uninterrupted run's totals. The header carries
  the config, plan and policy validity record (core/checkpoint.py).

- **AsyncCheckpointer** — checkpoint writes off the dispatch path. The
  engine advances a state in place, so the next chunk's kernels overwrite
  the very tensors a boundary hands over. ``submit`` therefore copies every
  leaf, on the dispatching stream, into one flat byte tensor (one
  ``torch.cat``) and records a CUDA event behind it, then returns; a
  worker thread waits on that event on a stream of its own, copies the
  bytes to pinned host memory there in one transfer (never queued behind
  the next chunk's kernels), serializes and renames atomically.
  Submissions are latest-wins: a slow disk skips intermediate snapshots
  (counted), never queues them without bound.

- **PreemptionGuard** — SIGTERM sets a flag the driver checks at every
  chunk boundary: save, flush, and exit ``EXIT_PREEMPTED``. kill -9 needs
  no handler: the latest atomic checkpoint is the resume point.
"""

from __future__ import annotations

import dataclasses
import signal
import sys
import threading
from typing import Any, Optional

import numpy as np
import torch

from multi_cluster_simulator_tpu_torch.core import checkpoint as ck
from multi_cluster_simulator_tpu_torch.core.state import LEAP_BUCKETS
from multi_cluster_simulator_tpu_torch.utils.tree import (
    leaves_with_keys, tree_map,
)

# sysexits EX_TEMPFAIL: "try again later", the conventional exit code of a
# clean save-and-exit under preemption
EXIT_PREEMPTED = 75

_UNSET = ck._UNSET


def policy_digest_for(cfg) -> str:
    """The default policy-params digest a config-built engine runs with,
    what the checkpoint header records (``Engine(cfg).policy_provenance()
    ['params_digest']``)."""
    from multi_cluster_simulator_tpu_torch.policies.base import (
        PolicySet, params_digest,
    )
    pset = PolicySet.from_config(cfg)
    return params_digest(pset.params_for(cfg))


@dataclasses.dataclass
class RunCheckpoint:
    """A loaded run bundle: the restored state (and the MetricsBuffer,
    where one was saved) and the resume cursors from the header."""

    state: Any
    mbuf: Any  # MetricsBuffer or None
    meta: dict  # tick, chunk_idx, ticks_executed, leap_hist, ...

    @property
    def tick(self) -> int:
        return int(self.meta.get("tick", 0))


def _host_int(x) -> int:
    return int(ck._to_host(x))


def fold_cursors(dense_ticks: int, leap_stats, prior: Optional[dict] = None
                 ) -> tuple[int, list]:
    """The telescoping fold of the time-compression cursors: this run's
    dense-chunk ticks plus the compressed chunks' executed ticks (their
    ``LeapStats``), accumulated onto the ``prior`` cursors a resume
    loaded. Returns ``(ticks_executed, leap_hist)``, the histogram cut
    after its last non-zero bucket."""
    prior = prior or {}
    executed = int(dense_ticks)
    hist = np.zeros((LEAP_BUCKETS,), np.int64)
    for ls in leap_stats or []:
        executed += _host_int(ls.ticks_executed)
        hist += ck._to_host(ls.leaps).astype(np.int64)
    prior_hist = prior.get("leap_hist") or []
    hist[: len(prior_hist)] += np.asarray(prior_hist, np.int64)
    executed += int(prior.get("ticks_executed", 0))
    nz = np.flatnonzero(hist)
    return executed, (hist[: nz[-1] + 1].tolist() if len(nz) else [])


def _finalize_meta(meta: dict) -> dict:
    """The cursors a submit carried, as host ints: ``dense_ticks`` (this
    run's dense-chunk ticks), ``leap_stats`` (the compressed chunks'
    LeapStats) and ``prior`` (the meta loaded at resume) fold into
    ``ticks_executed`` and ``leap_hist``."""
    meta = dict(meta)
    prior = meta.pop("prior", None) or {}
    leap_stats = meta.pop("leap_stats", None) or []
    executed, hist = fold_cursors(meta.pop("dense_ticks", 0), leap_stats,
                                  prior)
    meta["ticks_executed"] = executed
    meta["leap_hist"] = hist
    return meta


def save_run(path: str, state, mbuf=None, meta: Optional[dict] = None,
             cfg=None, plan=_UNSET, policy_digest: Optional[str] = None,
             tick_ms: int = 1000) -> None:
    """Write a RunCheckpoint synchronously (the AsyncCheckpointer's worker
    calls this; tests and small drivers call it directly). ``meta`` may
    carry ``leap_stats``/``dense_ticks``/``prior``, resolved here."""
    meta = _finalize_meta(meta or {})
    mbuf = _reduce_mbuf_partials(mbuf)
    bundle = {"state": state}
    if mbuf is not None:
        bundle["mbuf"] = mbuf
    t = _host_int(state.t)
    meta.setdefault("tick", t // max(int(tick_ms), 1))
    ck.save_tree(bundle, path, t=t,
                 extra={"run": {**meta, "has_mbuf": mbuf is not None}},
                 cfg=cfg, plan=plan, policy_digest=policy_digest)


def _reduce_mbuf_partials(mbuf):
    """Fold the buffer's shard-local partial leaves (a leading axis of one
    row per shard) to one row before serializing, keeping the storage
    dtype: totals are preserved and the saved buffer is the same on any
    mesh. The port's buffers hold one row, so the fold only moves them to
    the host."""
    if mbuf is None:
        return None
    host = tree_map(ck._to_host, mbuf)

    def fold(a):  # keep the storage dtype (np.sum promotes to int64)
        return a.sum(axis=0, keepdims=True, dtype=a.dtype)

    return host.replace(depth_hist=fold(host.depth_hist),
                        ring_placed=fold(host.ring_placed),
                        ring_depth=fold(host.ring_depth))


def load_run(path: str, state_template, cfg=None, plan=_UNSET,
             policy_digest: Optional[str] = None) -> RunCheckpoint:
    """Load a RunCheckpoint (the header verified first) onto the
    template's device. The MetricsBuffer's template comes from the state
    template (``obs.device.metrics_init``)."""
    header = ck._read_header(path)
    ck._check_header(header, path, cfg=cfg, plan=plan,
                     policy_digest=policy_digest)
    run_meta = dict((header.get("extra") or {}).get("run") or {})
    has_mbuf = bool(run_meta.pop("has_mbuf", False))
    template = {"state": state_template}
    if has_mbuf:
        from multi_cluster_simulator_tpu_torch.obs.device import metrics_init
        template["mbuf"] = metrics_init(state_template)
    bundle = ck.load_tree(path, template, cfg=cfg, plan=plan,
                          policy_digest=policy_digest)
    return RunCheckpoint(state=bundle["state"], mbuf=bundle.get("mbuf"),
                         meta=run_meta)


def save_run_sharded(path: str, sh, state, mbuf=None,
                     meta: Optional[dict] = None, **kw) -> None:
    """The mesh cut: every rank of ``sh`` (a ``parallel.ShardedEngine``)
    calls this at the same chunk boundary with its shard (and its
    ``MetricsBuffer`` carry); the shards gather (``gather_state``,
    ``collect_metrics``) and rank 0 writes ONE file, byte for byte the
    file a one-process run at the same tick writes; every rank returns
    once it is written. ``kw`` as ``save_run``'s."""
    import torch.distributed as dist

    whole = sh.gather_state(state)
    mb = sh.collect_metrics(mbuf) if mbuf is not None else None
    if sh.mesh.rank == 0:
        save_run(path, whole, mbuf=mb, meta=meta, **kw)
    if sh.mesh.group is not None:
        dist.barrier(group=sh.mesh.group)


def load_run_sharded(path: str, sh, state_template, **kw) -> RunCheckpoint:
    """A checkpoint (written by one process or by ``save_run_sharded``)
    resumed on a mesh: every rank loads the file against the global
    ``state_template`` and keeps its shard (``shard_state``; the buffer
    through ``shard_metrics``). ``kw`` as ``load_run``'s."""
    rc = load_run(path, state_template, **kw)
    return RunCheckpoint(
        state=sh.shard_state(rc.state),
        mbuf=None if rc.mbuf is None else sh.shard_metrics(rc.mbuf),
        meta=rc.meta)


class _Snapshot:
    """A submit's trees (the state, the buffer, the meta's LeapStats)
    packed into one flat byte tensor by one copy on the dispatching stream
    (``torch.cat`` of every leaf's bytes), and on the card the event
    recorded behind it; the trees' structure is kept as (dtype, shape)
    skeletons, never the live tensors."""

    def __init__(self, state, mbuf, meta: dict):
        meta = dict(meta)
        trees = [state, mbuf, *(meta.get("leap_stats") or [])]
        leaves = [x for tree in trees if tree is not None
                  for _, x in leaves_with_keys(tree)]
        self.skeletons = [None if tree is None else tree_map(
            lambda x: (ck.np_dtype(x.dtype), tuple(x.shape)), tree)
            for tree in trees]
        self.meta = meta
        self.flat = torch.cat([x.detach().reshape(-1).view(torch.uint8)
                               for x in leaves])
        dev = self.flat.device
        self.event = None
        if dev.type == "cuda":
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(dev))

    def to_host(self, stream) -> tuple:
        """``(state, mbuf, meta)`` on the host, numpy views of one host
        copy of the flat bytes: on the card a single copy into pinned
        memory on ``stream``, after it waits for the packing (the
        dispatching stream may already hold the next chunk's kernels)."""
        host = self.flat
        if self.event is not None:
            host = torch.empty(self.flat.shape, dtype=torch.uint8,
                               pin_memory=True)
            stream.wait_event(self.event)
            with torch.cuda.stream(stream):
                host.copy_(self.flat, non_blocking=True)
            stream.synchronize()
        buf, off = host.numpy(), 0

        def take(spec):
            nonlocal off
            dtype, shape = spec
            n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
            off += n
            return buf[off - n:off].view(dtype).reshape(shape)

        state, mbuf, *leap = [None if sk is None else tree_map(take, sk)
                              for sk in self.skeletons]
        meta = dict(self.meta, leap_stats=leap) if leap else self.meta
        return state, mbuf, meta


class AsyncCheckpointer:
    """Background-thread checkpoint writer for chunked drivers.

    ``submit`` is what the dispatch loop calls at a chunk boundary: it
    packs the live tensors (``_Snapshot``: one copy of every leaf's bytes
    on the dispatching stream, then an event) and hands the packed bytes
    to the worker, which waits on the event on its own stream, copies them
    to the host, serializes, fsyncs and renames. ``flush`` waits until
    every submitted snapshot is on disk and re-raises any worker error.

    Latest-wins: a submit that arrives while an older snapshot still waits
    replaces it (``skipped`` counts them); the final submit of a run is
    always written."""

    def __init__(self, path: str, cfg=None, plan=_UNSET,
                 policy_digest: Optional[str] = None, tick_ms: int = 1000,
                 save_fn=None):
        self.path = path
        self._cfg, self._plan, self._pdigest = cfg, plan, policy_digest
        self._tick_ms = tick_ms
        self._save_fn = save_fn if save_fn is not None else save_run
        self._cond = threading.Condition()
        self._pending: Optional[_Snapshot] = None  # latest wins
        self._busy = False
        self._stop = False
        self._error: Optional[BaseException] = None
        self._stream = None  # the worker's stream, made on first use
        self.writes = 0
        self.skipped = 0
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="mcs-ckpt-writer")
        self._thread.start()

    def submit(self, state, mbuf=None, meta: Optional[dict] = None) -> None:
        snap = _Snapshot(state, mbuf, meta or {})
        with self._cond:
            if self._error is not None:
                raise RuntimeError(
                    "async checkpoint writer already failed"
                ) from self._error
            if self._pending is not None:
                self.skipped += 1
            self._pending = snap
            self._cond.notify_all()

    def _worker(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._stop:
                    self._cond.wait()
                if self._pending is None and self._stop:
                    return
                snap = self._pending
                self._pending = None
                self._busy = True
            try:
                if snap.event is not None and self._stream is None:
                    self._stream = torch.cuda.Stream(snap.flat.device)
                state, mbuf, meta = snap.to_host(self._stream)
                del snap
                self._save_fn(self.path, state, mbuf=mbuf, meta=meta,
                              cfg=self._cfg, plan=self._plan,
                              policy_digest=self._pdigest,
                              tick_ms=self._tick_ms)
                with self._cond:
                    self.writes += 1
            except BaseException as e:  # surfaced by flush/close
                with self._cond:
                    if self._error is None:
                        self._error = e
            finally:
                with self._cond:
                    self._busy = False
                    self._cond.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted snapshot is durably on disk (or the
        worker failed: its error re-raises here)."""
        with self._cond:
            self._cond.wait_for(
                lambda: (self._pending is None and not self._busy)
                or self._error is not None, timeout=timeout)
            if self._error is not None:
                err, self._error = self._error, None
                raise RuntimeError(
                    f"async checkpoint write to {self.path} failed") from err
            if self._pending is not None or self._busy:
                raise TimeoutError(
                    f"async checkpoint flush timed out after {timeout}s")

    def close(self) -> None:
        """Flush (raising any stored worker error), then stop the worker.
        Idempotent; ``abort`` afterwards is a no-op."""
        try:
            self.flush()
        finally:
            with self._cond:
                self._stop = True
                self._cond.notify_all()
            self._thread.join(timeout=30)

    def abort(self) -> None:
        """Best-effort shutdown for cleanup paths: drop any pending
        snapshot, stop the worker, never raise."""
        with self._cond:
            self._pending = None
            self._stop = True
            self._cond.notify_all()
        self._thread.join(timeout=10)


class PreemptionGuard:
    """SIGTERM → save-and-exit at the next chunk boundary.

    Installing replaces the handler (the previous one is restored on
    ``uninstall`` or context exit); the handler only sets a flag, and the
    driver thread does the work at a chunk boundary, where the state is a
    consistent cut. Signal handlers install only from the main thread;
    elsewhere the guard stays an inert flag (``installed`` False)."""

    def __init__(self, signals=(signal.SIGTERM,)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._old: dict = {}
        self.installed = False

    def install(self) -> "PreemptionGuard":
        for sig in self._signals:
            try:
                self._old[sig] = signal.signal(sig, self._on_signal)
                self.installed = True
            except (ValueError, OSError):  # not the main thread
                pass
        return self

    def uninstall(self) -> None:
        for sig, old in self._old.items():
            try:
                signal.signal(sig, old)
            except (ValueError, OSError):
                pass
        self._old.clear()
        self.installed = False

    def _on_signal(self, signum, frame) -> None:
        self._event.set()

    @property
    def triggered(self) -> bool:
        return self._event.is_set()

    def __enter__(self) -> "PreemptionGuard":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    def save_and_exit(self, checkpointer: AsyncCheckpointer, state,
                      mbuf=None, meta: Optional[dict] = None) -> None:
        """The boundary action: submit the current cut, wait until it is
        durable, announce, exit ``EXIT_PREEMPTED``. Never returns."""
        checkpointer.submit(state, mbuf=mbuf, meta=meta)
        checkpointer.flush()
        tick = ck.peek_checkpoint_t(checkpointer.path)
        print(f"# preempted: checkpoint saved at t={tick} ms -> "
              f"{checkpointer.path}", file=sys.stderr)
        sys.stderr.flush()
        sys.exit(EXIT_PREEMPTED)
