"""Host-side helpers for reading engine traces and checking invariants (the
port of ``multi_cluster_simulator_tpu/utils/trace.py``; numpy)."""

from __future__ import annotations

import numpy as np

from multi_cluster_simulator_tpu_torch.core.compact import overflow_total
from multi_cluster_simulator_tpu_torch.core.state import SimState


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def extract_trace(state: SimState) -> list[list[tuple[int, int, int, int]]]:
    """Per-cluster placement event lists of (t, job_id, node, src)."""
    tr = state.trace
    t, job, node, src, n = (_np(tr.t), _np(tr.job), _np(tr.node),
                            _np(tr.src), _np(tr.n))
    return [[(int(t[c, i]), int(job[c, i]), int(node[c, i]), int(src[c, i]))
             for i in range(int(n[c]))] for c in range(t.shape[0])]


def check_conservation(state: SimState) -> None:
    """Invariant: free + sum(running on node) == capacity for active nodes,
    and free >= 0. Honors the configured resource width (n_res)."""
    free = _np(state.node_free)
    cap = _np(state.node_cap)
    active = _np(state.node_active)
    run = state.run
    r_node, r_act = _np(run.node), _np(run.active)
    r_res = np.stack([_np(run.cores), _np(run.mem), _np(run.gpu)], axis=-1)
    C, N, n_res = free.shape
    used = np.zeros((C, N, 3), np.int64)
    cc, ss = np.nonzero(r_act)
    np.add.at(used, (cc, r_node[cc, ss]), r_res[cc, ss])
    assert (free >= 0).all(), "negative free resources"
    recon = free + used[..., :n_res]
    mism = (recon != cap) & active[..., None]
    assert not mism.any(), f"conservation violated at {np.argwhere(mism)[:5]}"


def total_drops(state: SimState) -> dict:
    """Summed ``SimState.drops`` counters — every one should be zero on a
    correctly sized config. ``narrow`` is the compact layouts'
    checked-narrow overflow total (core/compact.py ``overflow_total``):
    nonzero means a narrowing store clamped instead of wrapping."""
    d = state.drops
    out = {k: int(getattr(d, k).sum())
           for k in ("queue", "msgs", "run_full", "vslot", "carve", "ingest",
                     "failed")}
    out["narrow"] = overflow_total(state)
    return out


def assert_no_drops(state: SimState) -> None:
    """Fail unless every drop counter and the narrow overflow total are
    zero (``total_drops``): a parity claim needs no static bound to
    bind."""
    drops = total_drops(state)
    assert all(v == 0 for v in drops.values()), f"static bounds bound: {drops}"
