"""Telemetry: structured logging, spans, metrics — the OTel/zerolog layer.

The reference wires every service with an OTLP span exporter, a periodic
metric reader, and a zerolog console/file logger via its telemetry factory
(internal/service/telemetry.go:43-143); no collector ships with the repo, so
in practice the artifacts are the log files. Here the same three factories
exist without an external collector dependency:

- ``create_logger`` — structured key=value console/file logging
  (telemetry.go:121-143: development -> console, production -> file
  ``logs/<SERVICE_NAME>-log-<timestamp>``, "both" -> both).
- ``Tracer`` — spans as JSONL records with trace/span ids and a
  ``traceparent``-style HTTP propagation header (the otelhttp transport
  equivalent, pkg/scheduler/server.go:47).
- ``Meter`` — named up/down counters and histograms with a periodic
  export thread (CreateMeterProvider's PeriodicReader,
  telemetry.go:94-119); snapshots are JSONL + a Prometheus text rendering
  (with # HELP/# TYPE) for a /metrics route.

Ecosystem compatibility (the reference's env contract, telemetry.go:26-31):
when ``OTEL_EXPORTER_OTLP_ENDPOINT`` is set, every Tracer batches spans and
every Meter posts periodic snapshots to the collector. The transport
follows the standard ``OTEL_EXPORTER_OTLP_PROTOCOL`` selector:

- ``grpc`` — the reference's transport (otlptracegrpc/otlpmetricgrpc,
  telemetry.go:43-58,94-119): protobuf Export calls on
  ``/opentelemetry.proto.collector.{trace,metrics}.v1.*Service/Export``
  against a :4317-style gRPC collector, over stubs generated from the
  transcribed OTLP schema (services/proto/otlp_*.proto).
- ``http/json`` (default here) — protojson POSTs to
  ``<endpoint>/v1/{traces,metrics}`` via stdlib urllib.

Any other selector (e.g. the spec's ``http/protobuf``) fails fast at
Tracer/Meter construction when an endpoint is configured — it used to fall
silently through to the JSON POST path. ``OTEL_EXPORTER_OTLP_INSECURE``
(truthy) forces a plaintext gRPC channel even to an https:// endpoint, per
the standard env contract.

The JSONL paths stay the no-collector default, exactly like the reference
run without a collector.
"""

from __future__ import annotations

import contextvars
import json
import logging
import os
import re
import secrets
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

TRACE_HEADER = "X-Trace-Context"  # traceparent analogue (HTTP)
TRACE_METADATA_KEY = "x-trace-context"  # gRPC metadata (keys must be lowercase)

OTLP_ENDPOINT_ENV = "OTEL_EXPORTER_OTLP_ENDPOINT"  # telemetry.go:28
# Standard OTel transport selector: "grpc" exports over the reference's
# transport (otlptracegrpc/otlpmetricgrpc, telemetry.go:43-58,94-119 —
# what a gRPC-only collector on :4317 accepts); "http/json" (this
# framework's default) posts protojson to <endpoint>/v1/{traces,metrics}.
OTLP_PROTOCOL_ENV = "OTEL_EXPORTER_OTLP_PROTOCOL"
# Standard OTel TLS opt-out (the spec's OTEL_EXPORTER_OTLP_INSECURE): a
# truthy value forces a plaintext channel even to an https:// endpoint.
OTLP_INSECURE_ENV = "OTEL_EXPORTER_OTLP_INSECURE"

SUPPORTED_OTLP_PROTOCOLS = ("grpc", "http/json")


def _otlp_endpoint() -> Optional[str]:
    ep = os.environ.get(OTLP_ENDPOINT_ENV, "").strip()
    return ep.rstrip("/") or None


def _otlp_protocol() -> str:
    return os.environ.get(OTLP_PROTOCOL_ENV, "").strip() or "http/json"


def _check_otlp_protocol(protocol: str) -> str:
    """Fail fast on a transport this framework does not implement: an
    unrecognized selector (e.g. the spec's ``http/protobuf``) used to fall
    silently through to the JSON POST path, exporting a payload a
    protobuf-only collector rejects with no hint at the real cause."""
    if protocol not in SUPPORTED_OTLP_PROTOCOLS:
        raise ValueError(
            f"unsupported OTLP protocol {protocol!r} (from {OTLP_PROTOCOL_ENV}"
            " or otlp_protocol=): supported protocols are "
            f"{', '.join(SUPPORTED_OTLP_PROTOCOLS)}")
    return protocol


def _otlp_insecure() -> bool:
    return os.environ.get(OTLP_INSECURE_ENV, "").strip().lower() in (
        "1", "true", "yes")


def _make_grpc_channel(endpoint: str):
    """A long-lived channel to the collector; https:// selects TLS (a
    plaintext channel to a TLS collector fails every handshake silently)
    unless OTEL_EXPORTER_OTLP_INSECURE opts out."""
    import grpc

    secure = endpoint.startswith("https://") and not _otlp_insecure()
    target = endpoint
    for scheme in ("http://", "https://", "grpc://"):
        if target.startswith(scheme):
            target = target[len(scheme):]
            break
    if secure:
        return grpc.secure_channel(target, grpc.ssl_channel_credentials())
    return grpc.insecure_channel(target)


def _is_hex(s: str, n: int) -> bool:
    if len(s) != n:
        return False
    try:
        bytes.fromhex(s)
        return True
    except ValueError:
        return False


def _span_pb(span: dict):
    """One OTLP Span protobuf from the internal JSON-shaped span dict.
    Returns None for a span whose ids don't convert (a malformed propagated
    context must not poison the whole batch — see start_span's validation,
    the first line of defense)."""
    from multi_cluster_simulator_tpu_torch.services.proto import otlp_trace_pb2 as T

    if not (_is_hex(span["traceId"], 32) and _is_hex(span["spanId"], 16)):
        return None
    pb = T.Span(trace_id=bytes.fromhex(span["traceId"]),
                span_id=bytes.fromhex(span["spanId"]),
                name=span["name"], kind=span.get("kind", 1),
                start_time_unix_nano=int(span["startTimeUnixNano"]),
                end_time_unix_nano=int(span["endTimeUnixNano"]))
    parent = span.get("parentSpanId")
    if parent and _is_hex(parent, 16):
        pb.parent_span_id = bytes.fromhex(parent)
    for kv in span.get("attributes", []):
        a = pb.attributes.add(key=kv["key"])
        v = kv["value"]
        if "boolValue" in v:
            a.value.bool_value = v["boolValue"]
        elif "intValue" in v:
            a.value.int_value = int(v["intValue"])
        elif "doubleValue" in v:
            a.value.double_value = v["doubleValue"]
        else:
            a.value.string_value = v.get("stringValue", "")
    return pb


def _grpc_export_spans(channel, service: str, batch: list[dict],
                       timeout: float = 3.0) -> bool:
    """Export over /opentelemetry.proto.collector.trace.v1.TraceService/
    Export — the reference's transport. Never raises."""
    try:
        from multi_cluster_simulator_tpu_torch.services.proto import (
            otlp_trace_service_pb2 as TS,
        )
        req = TS.ExportTraceServiceRequest()
        rs = req.resource_spans.add()
        rs.resource.attributes.add(
            key="service.name").value.string_value = service
        ss = rs.scope_spans.add()
        ss.scope.name = "multi_cluster_simulator_tpu_torch"
        for span in batch:
            pb = _span_pb(span)
            if pb is not None:
                ss.spans.append(pb)
        export = channel.unary_unary(
            "/opentelemetry.proto.collector.trace.v1.TraceService/Export",
            request_serializer=TS.ExportTraceServiceRequest.SerializeToString,
            response_deserializer=TS.ExportTraceServiceResponse.FromString)
        export(req, timeout=timeout)
        return True
    except Exception:
        return False


def _grpc_export_metrics(channel, payload: dict,
                         timeout: float = 3.0) -> bool:
    """Export the Meter's OTLP envelope over /opentelemetry.proto.collector.
    metrics.v1.MetricsService/Export. ``otlp_payload()`` is already
    protojson-shaped, so json_format.Parse does the whole conversion (and
    cannot silently drop shapes a hand-rolled copier doesn't know)."""
    try:
        from google.protobuf import json_format

        from multi_cluster_simulator_tpu_torch.services.proto import (
            otlp_metrics_service_pb2 as MS,
        )
        req = json_format.Parse(json.dumps(payload),
                                MS.ExportMetricsServiceRequest())
        export = channel.unary_unary(
            "/opentelemetry.proto.collector.metrics.v1.MetricsService/Export",
            request_serializer=MS.ExportMetricsServiceRequest.SerializeToString,
            response_deserializer=MS.ExportMetricsServiceResponse.FromString)
        export(req, timeout=timeout)
        return True
    except Exception:
        return False


def _otlp_post(url: str, payload: dict, timeout: float = 3.0) -> bool:
    """POST one OTLP/HTTP JSON envelope; never raises (telemetry must not
    take a service down — the reference's exporter retries silently too)."""
    import urllib.error
    import urllib.request

    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout):
            return True
    except (urllib.error.URLError, OSError):
        return False


def _kv(key: str, value) -> dict:
    """An OTLP KeyValue with the matching AnyValue arm."""
    if isinstance(value, bool):
        v = {"boolValue": value}
    elif isinstance(value, int):
        v = {"intValue": str(value)}  # protojson renders int64 as string
    elif isinstance(value, float):
        v = {"doubleValue": value}
    else:
        v = {"stringValue": str(value)}
    return {"key": key, "value": v}

# The active span context ("trace_id:span_id") for this thread of execution —
# the otel context.Context equivalent. start_span sets it for the span's
# extent; transports (httpd.post_json, rpc clients) read it to inject the
# propagation header, exactly as otelhttp.NewTransport / otelgrpc stats
# handlers do in the reference (pkg/scheduler/server.go:47, trader.go:216).
_CURRENT: contextvars.ContextVar[Optional[str]] = contextvars.ContextVar(
    "mcs_trace_ctx", default=None)


def current_context() -> Optional[str]:
    """The propagatable "trace_id:span_id" of the innermost active span."""
    return _CURRENT.get()


def wrap_ctx(fn: Callable) -> Callable:
    """Bind the caller's trace context (and the rest of its contextvars)
    into ``fn`` for execution on another thread — the hand-rolled version of
    Go's context.Context flowing through a goroutine fan-out
    (pkg/scheduler/server.go:183-215)."""
    ctx = contextvars.copy_context()
    return lambda *a, **kw: ctx.run(fn, *a, **kw)


def create_logger(service_name: str, mode: str = "development",
                  log_dir: str = "logs") -> logging.Logger:
    """zerolog factory (telemetry.go:121-143): console in development, file
    otherwise, both with mode="both"."""
    logger = logging.getLogger(f"mcs.{service_name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    if logger.handlers:  # idempotent per process
        return logger
    fmt = logging.Formatter(
        "%(asctime)s " + service_name + " %(levelname)s %(message)s")
    if mode in ("development", "both"):
        h = logging.StreamHandler()
        h.setFormatter(fmt)
        logger.addHandler(h)
    if mode in ("production", "both"):
        os.makedirs(log_dir, exist_ok=True)
        stamp = time.strftime("%Y-%m-%dT%H-%M-%S")
        h = logging.FileHandler(os.path.join(
            log_dir, f"{service_name}-log-{stamp}"))
        h.setFormatter(fmt)
        logger.addHandler(h)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger


class Tracer:
    """Span recorder. Spans land as JSONL rows in ``path`` (or are dropped
    when neither path nor an OTLP endpoint is configured — the no-collector
    default, matching the reference running without one). With
    ``OTEL_EXPORTER_OTLP_ENDPOINT`` set (or ``otlp_endpoint=`` passed),
    finished spans batch to ``<endpoint>/v1/traces`` as OTLP/HTTP JSON —
    the BatchSpanProcessor + otlptracegrpc equivalent of
    internal/service/telemetry.go:43-92.

    Ids are OTLP-sized (16-byte trace / 8-byte span, hex) so collectors
    like Jaeger accept them unmodified."""

    def __init__(self, service_name: str, path: Optional[str] = None,
                 otlp_endpoint: Optional[str] = None,
                 otlp_protocol: Optional[str] = None,
                 flush_period_s: float = 2.0):
        self.service = service_name
        self.path = path
        # explicit "" opts out even when the env var is set
        self.otlp = (otlp_endpoint if otlp_endpoint is not None
                     else _otlp_endpoint()) or None
        self.otlp_protocol = otlp_protocol or _otlp_protocol()
        if self.otlp is not None:  # exports would actually use it
            _check_otlp_protocol(self.otlp_protocol)
        self.flush_period_s = flush_period_s
        self._lock = threading.Lock()  # guards: _batch, _flusher, _channel
        self._batch: list[dict] = []
        self._flusher: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._channel = None  # lazily-built long-lived gRPC channel

    def _grpc_channel(self):
        # raced by the periodic flusher thread and shutdown's final flush
        with self._lock:
            if self._channel is None:
                self._channel = _make_grpc_channel(self.otlp)
            return self._channel

    @contextmanager
    def start_span(self, name: str, parent: Optional[str] = None, **attrs):
        """Open a span. ``parent`` is a propagated "trace_id:span_id"
        context string (from TRACE_HEADER / gRPC metadata); when omitted,
        the innermost active span on this execution context is the parent —
        so nested ``start_span`` calls chain automatically, like OTel's
        implicit context."""
        parent = parent or _CURRENT.get()
        trace_id, _, parent_id = (parent or "").partition(":")
        # a malformed propagated header (non-hex / wrong length) must not
        # enter the system: it would poison binary exports downstream
        if not _is_hex(trace_id, 32):
            trace_id, parent_id = "", ""
        if not _is_hex(parent_id, 16):
            parent_id = ""
        trace_id = trace_id or secrets.token_hex(16)
        span_id = secrets.token_hex(8)
        ctx = f"{trace_id}:{span_id}"
        token = _CURRENT.set(ctx)
        t0 = time.time()
        try:
            yield ctx
        finally:
            _CURRENT.reset(token)
            t1 = time.time()
            if self.path is not None:
                row = {"service": self.service, "name": name,
                       "trace_id": trace_id, "span_id": span_id,
                       "parent_id": parent_id or None,
                       "start": t0, "dur_ms": (t1 - t0) * 1e3, **attrs}
                with self._lock, open(self.path, "a") as f:
                    f.write(json.dumps(row) + "\n")
            if self.otlp is not None:
                span = {"traceId": trace_id, "spanId": span_id,
                        "name": name, "kind": 1,  # SPAN_KIND_INTERNAL
                        "startTimeUnixNano": str(int(t0 * 1e9)),
                        "endTimeUnixNano": str(int(t1 * 1e9)),
                        "attributes": [_kv(k, v) for k, v in attrs.items()]}
                if parent_id:
                    span["parentSpanId"] = parent_id
                with self._lock:
                    self._batch.append(span)
                    self._start_flusher_locked()

    # -- OTLP batching (BatchSpanProcessor analogue) --
    def _start_flusher_locked(self) -> None:  # holds: _lock
        """Spawn the periodic flusher once; caller holds self._lock (the
        check and the assignment must be atomic or two first-span threads
        each spawn one)."""
        # a span ending concurrently with shutdown() must not resurrect the
        # flusher (and with it a gRPC channel nothing would ever close)
        if self._flusher is not None or self._stop.is_set():
            return

        def loop():
            while not self._stop.wait(self.flush_period_s):
                self.flush()
            self.flush()

        self._flusher = threading.Thread(target=loop, daemon=True,
                                         name=f"tracer:{self.service}")
        self._flusher.start()

    def flush(self) -> bool:
        """Export the pending batch to <endpoint>/v1/traces. Returns True
        when there was nothing to send or the send succeeded; a failed
        batch is re-queued (bounded: keeps the newest 4096 spans)."""
        with self._lock:
            batch, self._batch = self._batch, []
        if not batch or self.otlp is None:
            return True
        if self.otlp_protocol == "grpc":
            ok = _grpc_export_spans(self._grpc_channel(), self.service, batch)
        else:
            payload = {"resourceSpans": [{
                "resource": {"attributes": [_kv("service.name", self.service)]},
                "scopeSpans": [{
                    "scope": {"name": "multi_cluster_simulator_tpu_torch"},
                    "spans": batch,
                }],
            }]}
            ok = _otlp_post(self.otlp + "/v1/traces", payload)
        if ok:
            return True
        with self._lock:
            self._batch = (batch + self._batch)[-4096:]
        return False

    def shutdown(self) -> None:
        self._stop.set()
        # take ownership under the lock, then join/close outside it (the
        # flusher's exit path flushes, which takes the lock itself)
        with self._lock:
            flusher, self._flusher = self._flusher, None
        if flusher is not None:
            flusher.join(timeout=3)  # its exit path flushes
        else:
            self.flush()
        with self._lock:
            channel, self._channel = self._channel, None
        if channel is not None:
            channel.close()


# Prometheus metric names admit only [a-zA-Z0-9_:] — service names here
# are dashed ("serve-tput"), which OTLP accepts but the exposition format
# does not. This is the standard OTLP->Prometheus name translation
# (invalid chars -> "_"), applied ONLY at the exposition rendering; the
# OTLP export keeps the original name (pinned by tests/test_tracing.py).
_PROM_NAME_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def prom_metric_name(name: str) -> str:
    n = _PROM_NAME_BAD.sub("_", name)
    return ("_" + n) if n[:1].isdigit() else n


def prom_split_labels(key: str) -> tuple[str, str]:
    """Split a metric key into (name, label-suffix). Keys may carry a
    Prometheus label set verbatim — ``placed_total{tenant="3"}`` — which
    the name sanitizer must NOT eat (it would mangle the braces to
    underscores); only the name half passes through prom_metric_name."""
    base, brace, rest = key.partition("{")
    return base, (brace + rest) if brace else ""


class Meter:
    """Counters + histograms with periodic export.

    The reference declares ``<SERVICE_NAME>_jobs_in_queue`` (up/down counter)
    and ``<SERVICE_NAME>_waitTime`` (histogram) and records every 5 s
    (pkg/scheduler/metrics.go:11-31)."""

    _BOUNDS = (10, 50, 100, 500, 1_000, 5_000, 10_000, 60_000, 300_000)

    def __init__(self, service_name: str, export_path: Optional[str] = None,
                 export_period_s: float = 5.0,
                 otlp_endpoint: Optional[str] = None,
                 otlp_protocol: Optional[str] = None):
        self.service = service_name
        self.export_path = export_path
        self.export_period_s = export_period_s
        self.otlp = (otlp_endpoint if otlp_endpoint is not None
                     else _otlp_endpoint()) or None  # "" opts out
        self.otlp_protocol = otlp_protocol or _otlp_protocol()
        if self.otlp is not None:  # exports would actually use it
            _check_otlp_protocol(self.otlp_protocol)
        self._counters: dict[str, float] = {}
        self._gauges: dict[str, float] = {}
        self._hists: dict[str, list[int]] = {}
        self._hist_sum: dict[str, float] = {}
        self._lock = threading.Lock()  # guards: _counters, _gauges, _hists, _hist_sum, _thread, _channel
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._channel = None  # lazily-built long-lived gRPC channel

    def add(self, name: str, value: float) -> None:
        """Up/down counter add (Int64UpDownCounter.Add)."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + value

    def set_gauge(self, name: str, value: float) -> None:
        """Absolute gauge set (ObservableGauge analogue) — the bridge the
        device metrics plane uses: the serving tier's snapshot refresh
        writes the harvested device rows here, so the Prometheus /metrics
        surface and the OTLP export render the SAME numbers from the same
        store (tests/test_obs.py pins the two surfaces equal)."""
        with self._lock:
            self._gauges[name] = value

    def record(self, name: str, value: float) -> None:
        """Histogram record (Float64Histogram.Record)."""
        with self._lock:
            buckets = self._hists.setdefault(name, [0] * (len(self._BOUNDS) + 1))
            i = sum(1 for b in self._BOUNDS if value > b)
            buckets[i] += 1
            self._hist_sum[name] = self._hist_sum.get(name, 0.0) + value

    def snapshot(self) -> dict:
        with self._lock:
            return {"service": self.service, "time": time.time(),
                    "counters": dict(self._counters),
                    "gauges": dict(self._gauges),
                    "histograms": {k: {"buckets": list(v),
                                       "sum": self._hist_sum.get(k, 0.0),
                                       "bounds": list(self._BOUNDS)}
                                   for k, v in self._hists.items()}}

    def render_prometheus(self) -> str:
        """Prometheus exposition text (for a /metrics route), conformant
        with # HELP/# TYPE lines: counters here are up/down (OTel
        Int64UpDownCounter) so they expose as gauges, absolute gauges
        (set_gauge) expose as gauges, histograms as cumulative
        le-buckets."""
        snap = self.snapshot()
        lines = []
        seen = set()  # one HELP/TYPE per metric family (labeled series share)
        for kind, table in (("up/down counter", snap["counters"]),
                            ("gauge", snap["gauges"])):
            for k, v in table.items():
                base, labels = prom_split_labels(k)
                full = prom_metric_name(f"{self.service}_{base}")
                if full not in seen:
                    seen.add(full)
                    lines.append(
                        f"# HELP {full} {kind} {base} of {self.service}")
                    lines.append(f"# TYPE {full} gauge")
                lines.append(f"{full}{labels} {v}")
        for k, h in snap["histograms"].items():
            full = prom_metric_name(f"{self.service}_{k}")
            lines.append(f"# HELP {full} histogram {k} of {self.service}")
            lines.append(f"# TYPE {full} histogram")
            acc = 0
            for bound, n in zip(list(self._BOUNDS) + ["+Inf"], h["buckets"]):
                acc += n
                lines.append(f'{full}_bucket{{le="{bound}"}} {acc}')
            lines.append(f"{full}_sum {h['sum']}")
            lines.append(f"{full}_count {acc}")
        return "\n".join(lines) + "\n"

    def otlp_payload(self) -> dict:
        """The current snapshot as one OTLP/HTTP JSON envelope
        (/v1/metrics): up/down counters as non-monotonic cumulative sums,
        histograms as cumulative explicit-bounds histograms — the shapes
        otlpmetricgrpc exports in the reference (telemetry.go:94-119)."""
        snap = self.snapshot()
        now = str(int(snap["time"] * 1e9))
        metrics = []
        for k, v in snap["counters"].items():
            metrics.append({"name": f"{self.service}_{k}", "sum": {
                "dataPoints": [{"asDouble": v, "timeUnixNano": now}],
                "aggregationTemporality": 2,  # CUMULATIVE
                "isMonotonic": False}})
        for k, v in snap["gauges"].items():
            metrics.append({"name": f"{self.service}_{k}", "gauge": {
                "dataPoints": [{"asDouble": v, "timeUnixNano": now}]}})
        for k, h in snap["histograms"].items():
            metrics.append({"name": f"{self.service}_{k}", "histogram": {
                "dataPoints": [{
                    "count": str(sum(h["buckets"])),
                    "sum": h["sum"],
                    "bucketCounts": [str(n) for n in h["buckets"]],
                    "explicitBounds": list(h["bounds"]),
                    "timeUnixNano": now}],
                "aggregationTemporality": 2}})
        return {"resourceMetrics": [{
            "resource": {"attributes": [_kv("service.name", self.service)]},
            "scopeMetrics": [{
                "scope": {"name": "multi_cluster_simulator_tpu_torch"},
                "metrics": metrics,
            }],
        }]}

    def export_otlp(self) -> bool:
        """Push the current snapshot to the configured collector over the
        configured transport (grpc or http/json)."""
        if self.otlp is None:
            return True
        if self.otlp_protocol == "grpc":
            # raced by the exporter thread and the final shutdown export
            with self._lock:
                if self._channel is None:
                    self._channel = _make_grpc_channel(self.otlp)
                channel = self._channel
            return _grpc_export_metrics(channel, self.otlp_payload())
        return _otlp_post(self.otlp + "/v1/metrics", self.otlp_payload())

    def start_exporter(self) -> None:
        """PeriodicReader analogue: append snapshots to export_path and/or
        push them to the OTLP collector every period."""
        if self.export_path is None and self.otlp is None:
            return

        def loop():
            while not self._stop.wait(self.export_period_s):
                if self.export_path is not None:
                    with open(self.export_path, "a") as f:
                        f.write(json.dumps(self.snapshot()) + "\n")
                self.export_otlp()

        th = threading.Thread(target=loop, daemon=True,
                              name=f"meter:{self.service}")
        with self._lock:  # the once-check and the publish must be atomic
            if self._thread is not None:
                return
            self._thread = th
        th.start()

    def stop_exporter(self) -> None:
        self._stop.set()
        with self._lock:
            th, self._thread = self._thread, None
        if th is not None:
            th.join(timeout=2)
        with self._lock:
            channel, self._channel = self._channel, None
        if channel is not None:
            channel.close()
