"""Gate for the serving observability surface (the port of
``tools/metrics_smoke.py``, which imports jax): run a real localhost
serving window on the port's ``ServingScheduler``, scrape /metrics and
/healthz over HTTP, and assert

- the Prometheus exposition PARSES (obs/promtext.py, strict),
- the core gauges are present and nonzero,
- the scraped gauge values MATCH the OTLP Meter export for the same
  window (the two surfaces render from one store),
- /healthz answers 200 while the loops are alive, 503 after quiesce.

Exit is nonzero on any violation. The front door runs on ``--device``
(the card by default).

Run: ``python -m multi_cluster_simulator_tpu_torch.tools.metrics_smoke
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    from multi_cluster_simulator_tpu_torch.config import PolicyKind, SimConfig
    from multi_cluster_simulator_tpu_torch.core.spec import uniform_cluster
    from multi_cluster_simulator_tpu_torch.obs.promtext import (
        parse_prometheus, scalar_samples,
    )
    from multi_cluster_simulator_tpu_torch.services import httpd
    from multi_cluster_simulator_tpu_torch.services.scheduler_host import (
        job_to_json,
    )
    from multi_cluster_simulator_tpu_torch.services.serving import (
        ServingScheduler,
    )
    from multi_cluster_simulator_tpu_torch.services.telemetry import (
        prom_metric_name,
    )

    C = 4
    cfg = SimConfig(policy=PolicyKind.FIFO, parity=True, n_res=2,
                    queue_capacity=64, max_running=128, max_arrivals=64,
                    max_ingest_per_tick=16, max_nodes=5,
                    max_virtual_nodes=0)
    specs = [uniform_cluster(c + 1, 5) for c in range(C)]
    s = ServingScheduler("metrics-smoke", specs, cfg, speed=200.0, window=4,
                         pacer=True, warm_k=(16,), k_cap=64,
                         max_staged=10 ** 5, device=args.device)
    s.start()
    try:
        code, body = httpd.get(s.url + "/healthz")
        health = json.loads(body)
        assert code == 200, f"/healthz -> {code}: {body!r}"
        assert health["status"] == "ok", health

        # real traffic through the batched front door, honoring the 503
        # retry quotes (the wire contract back-pressured clients follow)
        rng = np.random.default_rng(3)
        total = 0
        for batch_i in range(8):
            batch = [{**job_to_json(batch_i * 100 + i + 1,
                                    int(rng.integers(1, 4)),
                                    int(rng.integers(100, 2000)),
                                    int(rng.integers(500, 2000))),
                      "Cluster": int(rng.integers(0, C))}
                     for i in range(32)]
            total += len(batch)
            deadline = time.time() + 60
            while batch:
                code, body = httpd.post_json(s.url + "/submitBatch", batch)
                if code == 200:
                    break
                assert code == 503, f"submitBatch -> {code}"
                assert time.time() < deadline, "retry loop stuck on 503s"
                e = json.loads(body)
                batch = [batch[k] for k in e["RejectedIdx"]]
                time.sleep(e["RetryAfterMs"] / 1000.0)
        deadline = time.time() + 60
        while time.time() < deadline:
            if s.snapshot.placed >= total and s.snapshot.staged_jobs == 0:
                break
            time.sleep(0.05)
        assert s.snapshot.placed >= total, (
            f"only {s.snapshot.placed}/{total} placed")

        # freeze the loops so the scrape and the OTLP read see ONE window;
        # quiesce also flips /healthz to 503
        s.quiesce()
        code, body = httpd.get(s.url + "/healthz")
        assert code == 503, f"/healthz after quiesce -> {code} ({body!r})"

        code, text = httpd.get(s.url + "/metrics")
        assert code == 200, f"/metrics -> {code}"
        flat = scalar_samples(parse_prometheus(text.decode()))
        core = ["metrics-smoke_placed_total", "metrics-smoke_jobs_submitted",
                "metrics-smoke_dispatches", "metrics-smoke_ticks_dispatched",
                "metrics-smoke_obs_ticks", "metrics-smoke_obs_placed"]
        for name in core:
            pn = prom_metric_name(name)
            assert pn in flat, f"core gauge {pn} missing from /metrics"
            assert flat[pn] > 0, f"core gauge {pn} is zero"
        assert flat[prom_metric_name("metrics-smoke_obs_placed")] == total, (
            "device plane placement count diverged from the submitted total")

        otlp = {}
        for rm in s.meter.otlp_payload()["resourceMetrics"]:
            for sm in rm["scopeMetrics"]:
                for m in sm["metrics"]:
                    arm = m.get("sum") or m.get("gauge")
                    if arm:
                        otlp[m["name"]] = arm["dataPoints"][0]["asDouble"]
        for name in core:
            assert name in otlp, f"{name} missing from the OTLP payload"
            assert otlp[name] == flat[prom_metric_name(name)], (
                f"surface mismatch for {name}: "
                f"/metrics={flat[prom_metric_name(name)]} OTLP={otlp[name]}")
        print(f"# metrics_smoke OK on {s.engine.device}: {total} jobs, "
              f"{len(flat)} scalar samples parsed, {len(core)} core gauges "
              f"nonzero and OTLP-consistent", file=sys.stderr)
    finally:
        s.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
