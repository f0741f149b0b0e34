"""Reduction of a ``torch.profiler`` session to what the per-layer metrics
read: the card's timeline (kernels, copies and sets, merged into busy
intervals), the host ranges (the benchmark's ``cardbench.episode`` and
the program's ``mcs.dispatch.*`` and ``tick.*`` ranges, aten ops), each
kernel's launches in order, and the idle gaps named by the host range
open in each."""

from __future__ import annotations

import bisect
import dataclasses

# record_function ranges show on the card's timeline too, as annotations
# over their kernels; they are not device work
_RANGE_PREFIXES = ("cardbench.", "mcs.", "tick.")


def _is_range(name: str) -> bool:
    return name.startswith(_RANGE_PREFIXES)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


@dataclasses.dataclass
class Summary:
    """Times in seconds. ``episodes``: each traced episode's host wall and
    the seconds of its ``mcs.dispatch.chunk`` ranges. ``launches``: each
    kernel name's device durations in launch order (over all traced
    episodes). ``device_ops``: device seconds by name. ``gaps``: idle
    seconds by the innermost host range open at each gap's middle."""

    window_s: float
    busy_s: float
    episodes: list
    launches: dict
    device_ops: dict
    gaps: dict

    def kernel(self, part: str) -> list:
        """Durations of the launches of the kernels whose name contains
        ``part``, in launch order."""
        hits = [(name, d) for name, d in self.launches.items() if part in name]
        if not hits:
            return []
        merged = sorted(x for _, d in hits for x in d)
        return [d for _, d in merged]

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def summarize(events, walls) -> Summary | None:
    """``events``: ``prof.events()`` of the traced segment; ``walls``: the
    host walls of its episodes. Returns None when no episode range is
    found."""
    dev, host = [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if getattr(e.device_type, "name", str(e.device_type)) == "CUDA":
            if not _is_range(e.name):
                dev.append((start, end, e.name))
        else:
            host.append((start, end, e.name))
    eps = sorted((s, e) for s, e, n in host if n == "cardbench.episode")
    if not eps:
        return None
    lo, hi = eps[0][0], eps[-1][1]
    chunks = [(s, e) for s, e, n in host if n == "mcs.dispatch.chunk"]
    episodes = []
    for (s, e), wall in zip(eps, walls):
        copy_us = sum(ce - cs for cs, ce in chunks if cs >= s and ce <= e)
        episodes.append({"wall_s": wall, "chunk_s": copy_us / 1e6})
    dev = [(s, e, n) for s, e, n in dev if e > lo and s < hi]
    launches, ops = {}, {}
    for s, e, n in dev:
        launches.setdefault(n, []).append((s, (e - s) / 1e6))
        ops[n] = ops.get(n, 0.0) + (e - s) / 1e6
    busy = _merge([(max(s, lo), min(e, hi)) for s, e, _ in dev])
    busy_us = sum(e - s for s, e in busy)
    # idle gaps inside the window, named by the innermost host range open
    # at the gap's middle (the latest-starting one that covers it)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    host_sorted = sorted((s, e, n) for s, e, n in host
                         if n != "cardbench.episode")
    starts = [h[0] for h in host_sorted]
    gaps = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = (a + b) / 2
        i = bisect.bisect_right(starts, mid)
        name = "host outside any range"
        for s, e, n in reversed(host_sorted[max(0, i - 256):i]):
            if e >= mid:
                name = n
                break
        gaps[name] = gaps.get(name, 0.0) + (b - a) / 1e6
    return Summary(window_s=(hi - lo) / 1e6, busy_s=busy_us / 1e6,
                   episodes=episodes, launches=launches, device_ops=ops,
                   gaps=gaps)
