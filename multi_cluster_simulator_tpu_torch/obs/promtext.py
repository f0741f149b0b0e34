"""Prometheus exposition-format parser — the scrape side of the serving
surface.

``telemetry.Meter.render_prometheus`` writes the text format; this module
reads it back, strictly enough to catch a malformed rendering (the CI
scrape gate and tests/test_obs.py both parse a real ``/metrics`` response
through it and then compare values against the Meter's OTLP export, so the
two surfaces can never silently diverge). Pure stdlib.
"""

from __future__ import annotations

import re

_SAMPLE_RE = re.compile(
    r"^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(?:\{(?P<labels>[^}]*)\})?"
    r"\s+(?P<value>[^\s]+)\s*$")
_LABEL_RE = re.compile(r'^\s*([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"\s*$')


class PromParseError(ValueError):
    pass


def parse_prometheus(text: str) -> dict:
    """Parse an exposition payload into
    ``{metric_name: {(sorted label items) or (): float value}}``.

    Raises ``PromParseError`` on any line that is neither a comment, a
    blank, nor a well-formed sample — a scrape "parses" only if every line
    does. ``# TYPE``/``# HELP`` lines must name a metric."""
    out: dict = {}
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("#"):
            parts = line.split(None, 3)
            if len(parts) >= 2 and parts[1] in ("HELP", "TYPE"):
                if len(parts) < 3:
                    raise PromParseError(f"line {lineno}: bare # {parts[1]}")
            continue
        m = _SAMPLE_RE.match(line)
        if m is None:
            raise PromParseError(f"line {lineno}: not a sample: {line!r}")
        labels = ()
        if m.group("labels"):
            items = []
            for part in m.group("labels").split(","):
                lm = _LABEL_RE.match(part)
                if lm is None:
                    raise PromParseError(
                        f"line {lineno}: bad label pair {part!r}")
                items.append((lm.group(1), lm.group(2)))
            labels = tuple(sorted(items))
        try:
            value = float(m.group("value").replace("+Inf", "inf"))
        except ValueError as e:
            raise PromParseError(
                f"line {lineno}: bad value {m.group('value')!r}") from e
        out.setdefault(m.group("name"), {})[labels] = value
    return out


def scalar_samples(parsed: dict) -> dict:
    """Flatten the label-free samples to ``{name: value}`` (the gauge /
    counter surface the consistency checks compare against OTLP)."""
    return {name: series[()] for name, series in parsed.items()
            if () in series}
