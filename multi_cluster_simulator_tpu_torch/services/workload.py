"""The workload-generator client service.

Reference: pkg/client — a service that learns its scheduler's cluster over
the ``/newClient`` handshake (client.go:44-66), derives max job sizes from
the biggest node (setMaxCluster, client.go:68-83), and then streams jobs
whose sizes are Beta(2,2)-scaled and durations Uniform[0,600) s, with
Poisson(λ=10/min) or Weibull(λ=10,k=3) arrival processes
(sendJobs, client.go:85-147). Jobs go out as POST ``/delay`` with a
``Referer`` header (SendJob, client/server.go:35-66).

Quirk handling: the Go Poisson loop computes ``60/jobs`` seconds between
jobs, which (a) divides by zero when the draw is 0 — the live generator
skips the empty minute instead of crashing — and (b) makes a "minute"
take ``n*floor(60/n) <= 60`` s, so batches drift early; the live client
reproduces that drift (workload/generator.py documents the batch-grid
divergence the *batch* generator chose instead).
"""

from __future__ import annotations

import json
import threading
from typing import Optional

import numpy as np

from multi_cluster_simulator_tpu_torch.config import WorkloadConfig
from multi_cluster_simulator_tpu_torch.services import httpd
from multi_cluster_simulator_tpu_torch.services.backoff import jittered_backoff_ms
from multi_cluster_simulator_tpu_torch.services.lifecycle import Service
from multi_cluster_simulator_tpu_torch.services.scheduler_host import job_to_json


class WorkloadClientService(Service):
    service_name = "Client"
    required_services: list = []  # cmd/client never registers (main.go:14-41)

    def __init__(self, name: str, scheduler_url: str,
                 wcfg: WorkloadConfig = WorkloadConfig(),
                 speed: float = 1.0, max_jobs: Optional[int] = None, **kw):
        super().__init__(name, speed=speed, **kw)
        self.scheduler_url = scheduler_url.rstrip("/")
        self.wcfg = wcfg
        self.max_jobs = max_jobs
        self.max_job_cores = 0
        self.max_job_mem = 0
        self.jobs_sent = 0
        self.acks = 0
        # client-side backoff discipline: a 503 quote's RetryAfterMs is a
        # BASE delay, not a fixed sleep — retries are jittered exponential
        # under a bounded attempt budget, and exhaustion is counted +
        # logged instead of spinning forever
        self.retry_attempts = 8
        self.retries_503 = 0
        self.conn_retries = 0  # transport failures (dead/restarting server)
        self.retries_exhausted = 0
        self._rng = np.random.default_rng(wcfg.seed)
        # the ack counter is bumped by HTTP handler threads and read by the
        # generator thread / tests
        self._ack_lock = threading.Lock()  # guards: acks
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def register_handlers(self) -> None:
        self.httpd.route("GET", "/", lambda b, h: (200, b"Hello!"))
        self.httpd.route("GET", "/jobAdded", self._handle_ack)

    def _handle_ack(self, body: bytes, headers: dict):
        with self._ack_lock:  # handler threads race each other here
            self.acks += 1  # the "ack!" print (client/server.go:27-31)
        return 200, None

    def on_start(self) -> None:
        self._new_client()
        self._thread = threading.Thread(target=self._send_jobs, daemon=True,
                                        name=f"{self.name}-gen")
        self._thread.start()

    def on_shutdown(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- the /newClient handshake (client.go:44-83) --
    def _new_client(self) -> None:
        status, body = httpd.get(self.scheduler_url + "/newClient")
        if status != 200:
            raise RuntimeError(f"newClient handshake failed: {status}")
        cluster = json.loads(body)
        for node in cluster.get("Nodes", []):
            self.max_job_cores = max(self.max_job_cores, int(node["Cores"]))
            self.max_job_mem = max(self.max_job_mem, int(node["Memory"]))
        self.logger.info("learned cluster %s: max job %d cores / %d MB",
                         cluster.get("Id"), self.max_job_cores,
                         self.max_job_mem)

    # -- job generation (sendJobs, client.go:85-147) --
    def _get_job(self) -> dict:
        self.jobs_sent += 1
        cores = int(self._rng.beta(self.wcfg.beta_alpha, self.wcfg.beta_beta)
                    * self.max_job_cores)
        mem = int(self._rng.beta(self.wcfg.beta_alpha, self.wcfg.beta_beta)
                  * self.max_job_mem)
        dur_s = int(self._rng.integers(0, self.wcfg.max_duration_s))
        return job_to_json(self.jobs_sent, cores, mem, dur_s * 1000)

    def _send_one(self, payload: dict) -> None:
        """POST one job; a 503 back-pressure quote honors RetryAfterMs and
        a transport failure (status 0 — a dead or restarting scheduler,
        including one killed mid-response, which httpd maps to 0) is
        equally retryable, both with jittered exponential backoff under
        the bounded attempt budget (services/backoff.py)."""
        body = json.dumps(payload).encode()
        for attempt in range(self.retry_attempts):
            status, resp = httpd.post_bytes(
                self.scheduler_url + "/delay", body,
                content_type="application/json")
            if status == 200:
                return
            if status not in (0, 503):
                self.logger.error("job %s rejected: %s", payload["Id"],
                                  status)
                return
            quote_ms = 100.0
            if status == 503:
                self.retries_503 += 1
                try:
                    # the server's quote is already wall-scaled (it
                    # divides by its own speed): used as-is for the base
                    quote_ms = float(json.loads(resp)["RetryAfterMs"])
                except (ValueError, TypeError, KeyError):
                    pass
            else:
                self.conn_retries += 1
            delay = jittered_backoff_ms(
                attempt, max(quote_ms, 1.0), 5_000.0 / self.speed,
                self._rng) / 1000.0
            if self._stop.wait(delay):
                return
        self.retries_exhausted += 1
        self.logger.error(
            "job %s: retry budget (%d attempts) exhausted against "
            "back-pressure/transport failures — giving up", payload["Id"],
            self.retry_attempts)

    def _send_jobs(self) -> None:
        if self.wcfg.arrival == "weibull":
            self._weibull_loop()
        else:
            self._poisson_loop()

    def _poisson_loop(self) -> None:
        lam = self.wcfg.poisson_lambda_per_min
        while not self._done():
            jobs = int(self._rng.poisson(lam))
            if jobs == 0:  # Go would panic on 60/0 (client.go:116)
                if self._stop.wait(60.0 / self.speed):
                    return
                continue
            gap = (60 // jobs) / self.speed  # Go integer division
            for _ in range(jobs):
                if self._done():
                    return
                self._send_one(self._get_job())
                if self._stop.wait(gap):
                    return

    def _weibull_loop(self) -> None:
        lam, k = self.wcfg.weibull_lambda_s, self.wcfg.weibull_k
        while not self._done():
            self._send_one(self._get_job())
            gap = lam * float(self._rng.weibull(k))
            if self._stop.wait(gap / self.speed):
                return

    def _done(self) -> bool:
        return self._stop.is_set() or (
            self.max_jobs is not None and self.jobs_sent >= self.max_jobs)
