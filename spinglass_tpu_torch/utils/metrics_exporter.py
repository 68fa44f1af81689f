"""Prometheus metrics exporter (text exposition format, stdlib only).

Copied from ``spinglass_tpu.utils.metrics_exporter``: the port imports nothing of
the JAX package.

The reference declares prometheus-client (requirements.txt:9) and ships
scrape configs (monitoring/prometheus.yml, docker/grafana/*) but wires no
exporter in code (SURVEY §5). This module closes that gap without adding a
dependency: a registry rendering the Prometheus text format, served by a
background stdlib HTTP server on /metrics, fed from PerformanceMonitor
counters and solver stats.
"""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional, Tuple


def _fmt_labels(labels: Optional[Dict[str, str]]) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class MetricsRegistry:
    """Counters + gauges + simple histograms, rendered in the Prometheus
    text exposition format."""

    def __init__(self, namespace: str = "spinglass"):
        self.namespace = namespace
        self._lock = threading.Lock()
        # name -> (type, help, {labelkey: value})
        self._metrics: Dict[str, dict] = {}

    def _entry(self, name: str, mtype: str, help_: str) -> dict:
        m = self._metrics.setdefault(
            name, {"type": mtype, "help": help_, "values": {}})
        return m

    def counter_inc(self, name: str, value: float = 1.0,
                    labels: Optional[Dict[str, str]] = None,
                    help_: str = "") -> None:
        with self._lock:
            m = self._entry(name, "counter", help_)
            key = _fmt_labels(labels)
            m["values"][key] = m["values"].get(key, 0.0) + value

    def gauge_set(self, name: str, value: float,
                  labels: Optional[Dict[str, str]] = None,
                  help_: str = "") -> None:
        with self._lock:
            m = self._entry(name, "gauge", help_)
            m["values"][_fmt_labels(labels)] = float(value)

    def observe(self, name: str, value: float,
                buckets: Tuple[float, ...] = (0.01, 0.1, 1.0, 10.0),
                help_: str = "") -> None:
        """Histogram observation (cumulative buckets + sum + count)."""
        with self._lock:
            m = self._entry(name, "histogram", help_)
            v = m["values"]
            for b in buckets:
                if value <= b:
                    k = _fmt_labels({"le": repr(b)})
                    v[k] = v.get(k, 0.0) + 1.0
            inf = _fmt_labels({"le": "+Inf"})
            v[inf] = v.get(inf, 0.0) + 1.0
            v["__sum__"] = v.get("__sum__", 0.0) + value
            v["__count__"] = v.get("__count__", 0.0) + 1.0

    def render(self) -> str:
        lines = []
        with self._lock:
            for name in sorted(self._metrics):
                m = self._metrics[name]
                full = f"{self.namespace}_{name}"
                if m["help"]:
                    lines.append(f"# HELP {full} {m['help']}")
                lines.append(f"# TYPE {full} {m['type']}")
                for key, val in sorted(m["values"].items()):
                    if key == "__sum__":
                        lines.append(f"{full}_sum {val}")
                    elif key == "__count__":
                        lines.append(f"{full}_count {val}")
                    elif m["type"] == "histogram":
                        lines.append(f"{full}_bucket{key} {val}")
                    else:
                        lines.append(f"{full}{key} {val}")
        return "\n".join(lines) + "\n"

    def sync_from_monitor(self, monitor) -> None:
        """Pull PerformanceMonitor counters + latest sample into gauges."""
        snap = monitor.snapshot()
        for k, v in snap.get("counters", {}).items():
            self.gauge_set(f"counter_{k}", v)
        latest = snap.get("latest") or {}
        for k in ("cpu_percent", "mem_percent"):
            if k in latest:
                self.gauge_set(f"host_{k}", latest[k])
        for dev, stats in (latest.get("device") or {}).items():
            self.gauge_set("device_bytes_in_use", stats["bytes_in_use"],
                           labels={"device": dev})


_global_registry: Optional[MetricsRegistry] = None


def global_registry() -> MetricsRegistry:
    global _global_registry
    if _global_registry is None:
        _global_registry = MetricsRegistry()
    return _global_registry


class MetricsServer:
    """Background /metrics HTTP endpoint for Prometheus scrapes.

    ``auth``: optional utils.security.TokenAuthenticator — when set, every
    request must carry ``Authorization: Bearer <token>`` with at least the
    ``reader`` role (401 otherwise; checks are constant-time and audited).
    This is the one real HTTP surface the framework exposes, gated with the
    intent of the reference's enterprise tier
    (security/enterprise_security.py:78-1089) minus the simulation."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 host: str = "127.0.0.1", port: int = 9109, auth=None):
        self.registry = registry or global_registry()
        reg = self.registry
        authenticator = auth

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path.rstrip("/") not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                if authenticator is not None:
                    header = self.headers.get("Authorization", "")
                    token = (header[len("Bearer "):]
                             if header.startswith("Bearer ") else None)
                    if not authenticator.check(token, "reader"):
                        self.send_response(401)
                        self.send_header("WWW-Authenticate", "Bearer")
                        self.end_headers()
                        return
                body = reg.render().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence request logging
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self.port = self._server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def start(self) -> "MetricsServer":
        self._thread = threading.Thread(
            target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None


_global_server: Optional[MetricsServer] = None


def maybe_start_server_from_env() -> Optional[MetricsServer]:
    """Start the global /metrics server when SGT_METRICS_PORT is set
    (SGT_METRICS_HOST to bind non-loopback, e.g. 0.0.0.0 in a container).
    Idempotent; returns the server or None. This is the in-process wiring
    the docker-compose stack uses: the solver container sets the env vars
    and Prometheus scrapes it directly (a separate `sgt monitor` process
    could not see the solver's registry)."""
    global _global_server
    import os

    port = os.environ.get("SGT_METRICS_PORT", "").strip()
    if not port or _global_server is not None:
        return _global_server
    host = os.environ.get("SGT_METRICS_HOST", "127.0.0.1").strip()
    _global_server = MetricsServer(host=host, port=int(port)).start()
    return _global_server


def publish_anneal_result(result, solver: str = "sa") -> None:
    """Gauge the headline solver stats into the global registry (the
    reference's grafana dashboard panels: flips/s, best energy, exchange
    rate). Cheap dict writes; safe to call after every run."""
    reg = global_registry()
    labels = {"solver": solver}
    reg.gauge_set("solver_flips_per_sec",
                  float(getattr(result, "spin_flips_per_second", 0.0)),
                  labels=labels, help_="spin flips per second, last run")
    reg.gauge_set("solver_best_energy", float(result.best_energy),
                  labels=labels, help_="best energy found, last run")
    reg.counter_inc("solver_runs_total", 1.0, labels=labels,
                    help_="completed solver runs")
    rates = (getattr(result, "metadata", None) or {}).get("exchange_rates")
    if rates is not None and len(rates):
        import numpy as _np

        reg.gauge_set("solver_exchange_rate_mean",
                      float(_np.mean(_np.asarray(rates))), labels=labels,
                      help_="mean PT replica-exchange acceptance, last run")


def publish_rl_metrics(env_steps_per_second: float,
                       final_mean_best_energy: float) -> None:
    """Gauge RL-controller training stats (grafana env-steps/s panel)."""
    reg = global_registry()
    reg.gauge_set("rl_env_steps_per_sec", float(env_steps_per_second),
                  help_="PPO/DQN steady-state env steps per second")
    reg.gauge_set("rl_final_mean_best_energy",
                  float(final_mean_best_energy),
                  help_="mean best energy across envs at end of training")
