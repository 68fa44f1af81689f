"""The port's utilities (``spinglass_tpu_torch.utils``) and the standard
benchmark runner on the CPU, against the JAX package's unit tests for the
same modules: the classes below are the assertions of
``tests/unit/test_utils.py`` (logging, validation, monitoring, health,
robust, metrics auth), ``tests/unit/test_enterprise_security.py``, the
cache and profiler parts of ``tests/unit/test_batch_adaptive.py`` and the
anomaly, autoscale and metrics parts of ``tests/unit/test_scaling_infra.py``,
run on the port's copies (the device checks on ``device="cpu"``). Then the
port's own: the metrics registry renders the JAX registry's text for the
same calls, the port's drivers publish their results, the card's memory
stats are empty without a card, and the runner's summary keys are the JAX
runner's.
"""

import json
import logging
import time
import urllib.request

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.anneal.sa import SAConfig  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.utils import cache as C  # noqa: E402
from spinglass_tpu_torch.utils import enterprise_security as es  # noqa: E402
from spinglass_tpu_torch.utils import health as H  # noqa: E402
from spinglass_tpu_torch.utils import monitoring as mon  # noqa: E402
from spinglass_tpu_torch.utils import validation as V  # noqa: E402
from spinglass_tpu_torch.utils.exceptions import (  # noqa: E402
    AnnealingError, ValidationError)
from spinglass_tpu_torch.utils.logging import (  # noqa: E402
    JSONFormatter, PerformanceLogger, RedactionFilter, setup_logger)
from spinglass_tpu_torch.utils.profiling import PerformanceProfiler  # noqa: E402
from spinglass_tpu_torch.utils.robust import robust_operation  # noqa: E402


@pytest.fixture
def small_problem():
    """The JAX suite's 16-spin +-J instance, on the CPU."""
    j = topology.fully_connected(16, dist="binary", seed=7)
    h = np.random.default_rng(7).normal(0, 0.5, 16)
    return IsingProblem.from_dense(j, h, device="cpu")


def _problems(ns, seed=0):
    return [IsingProblem.from_dense(
        topology.fully_connected(n, dist="binary", seed=seed + i),
        device="cpu") for i, n in enumerate(ns)]


FAST = SAConfig(n_sweeps=60, n_replicas=8, use_kernel="never")


class TestLogging:
    def test_json_formatter(self):
        rec = logging.LogRecord("t", logging.INFO, "f", 1, "hello %s",
                                ("x",), None)
        import json
        out = json.loads(JSONFormatter().format(rec))
        assert out["message"] == "hello x"
        assert out["level"] == "INFO"

    def test_redaction(self):
        rec = logging.LogRecord("t", logging.INFO, "f", 1,
                                "connect api_key=SECRET123 ok", (), None)
        RedactionFilter().filter(rec)
        assert "SECRET123" not in rec.getMessage()
        assert "redacted" in rec.getMessage()

    def test_performance_logger_timing(self):
        pl = PerformanceLogger(setup_logger("t1"))
        with pl.timer("op"):
            time.sleep(0.01)
        s = pl.summary()
        assert s["op"]["n"] == 1
        assert s["op"]["mean"] >= 0.01

    def test_rotating_file(self, tmp_path):
        log_file = str(tmp_path / "x.log")
        lg = setup_logger("t2", log_file=log_file)
        lg.info("file line")
        for h in lg.handlers:
            h.flush()
        assert "file line" in open(log_file).read()


class TestValidation:
    def test_spins(self):
        V.validate_spins(np.array([1.0, -1.0, 1.0]))
        with pytest.raises(ValidationError):
            V.validate_spins(np.array([1.0, 0.5]))

    def test_couplings(self):
        j = np.array([[0.0, 1.0], [1.0, 0.0]])
        V.validate_couplings(j)
        with pytest.raises(ValidationError):
            V.validate_couplings(np.array([[0.0, 1.0], [2.0, 0.0]]))
        with pytest.raises(ValidationError):
            V.validate_couplings(np.eye(2))

    def test_temperature(self):
        V.validate_temperature(1.0)
        for bad in (0.0, -1.0, float("nan")):
            with pytest.raises(ValidationError):
                V.validate_temperature(bad)
        with pytest.raises(ValidationError):
            V.validate_temperature_range(2.0, 1.0)

    def test_problem(self, small_problem):
        V.validate_problem(small_problem)


class TestMonitoring:
    def test_sampler_thread(self):
        m = mon.PerformanceMonitor(interval=0.05).start()
        deadline = time.time() + 3.0
        while time.time() < deadline and m.snapshot()["n_samples"] < 1:
            time.sleep(0.05)
        m.stop()
        assert m.snapshot()["n_samples"] >= 1

    def test_counters(self):
        m = mon.PerformanceMonitor()
        m.record("sweeps", 10)
        m.record("sweeps", 5)
        assert m.snapshot()["counters"]["sweeps"] == 15

    def test_circuit_breaker_trips_and_recovers(self):
        cb = mon.CircuitBreaker(failure_threshold=2, cooldown_seconds=0.05)
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            raise RuntimeError("boom")

        for _ in range(2):
            with pytest.raises(RuntimeError):
                cb.call(flaky)
        assert cb.state == "open"
        with pytest.raises(AnnealingError):
            cb.call(flaky)
        assert calls["n"] == 2  # open circuit short-circuits
        time.sleep(0.06)
        assert cb.state == "half_open"
        assert cb.call(lambda: 42) == 42
        assert cb.state == "closed"


class TestHealth:
    def test_device_and_deps(self):
        assert (H.check_device_compute("cpu").status
                == H.HealthStatus.HEALTHY)
        assert H.check_dependencies().status == H.HealthStatus.HEALTHY

    def test_model_check(self, small_problem):
        assert H.check_model(small_problem).status == H.HealthStatus.HEALTHY

    def test_monitor_aggregates(self):
        rep = H.HealthMonitor([H.check_dependencies,
                               lambda: H.check_device_compute("cpu")]).run()
        assert rep["status"] == "healthy"
        assert set(rep["checks"]) == {"dependencies", "device_compute"}

    def test_annealer_micro_check(self):
        assert H.check_annealer("cpu").status == H.HealthStatus.HEALTHY


class TestRobust:
    def test_retries_then_succeeds(self):
        calls = {"n": 0}

        @robust_operation(max_retries=3, backoff=0.001)
        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("flake")
            return "ok"

        assert flaky() == "ok"
        assert calls["n"] == 3

    def test_fallback_used(self):
        @robust_operation(max_retries=1, backoff=0.001,
                          fallback=lambda: "fallback")
        def broken():
            raise RuntimeError("always")

        assert broken() == "fallback"

    def test_raises_after_exhaustion(self):
        @robust_operation(max_retries=1, backoff=0.001)
        def broken():
            raise ValueError("nope")

        with pytest.raises(ValueError):
            broken()


class TestMetricsAuth:
    """Token-gated metrics endpoint (VERDICT.md next-round #10: the one real
    HTTP surface, gated with the reference enterprise tier's intent)."""

    def test_token_roles_and_revocation(self, tmp_path):
        from spinglass_tpu_torch.utils.security import AuditLogger, TokenAuthenticator

        audit = AuditLogger(path=str(tmp_path / "audit.jsonl"))
        auth = TokenAuthenticator(tokens={}, audit=audit)
        reader = auth.issue("reader")
        admin = auth.issue("admin")
        assert auth.check(reader, "reader")
        assert not auth.check(reader, "admin")
        assert auth.check(admin, "reader")   # hierarchy: admin >= reader
        assert auth.check(admin, "admin")
        assert not auth.check("wrong-token")
        assert not auth.check(None)
        assert auth.revoke(reader)
        assert not auth.check(reader)
        actions = [e["action"] for e in audit.entries()]
        assert "token_issued" in actions and "auth_check" in actions

    def test_metrics_server_requires_bearer_token(self):
        import urllib.request
        import urllib.error

        from spinglass_tpu_torch.utils.metrics_exporter import (MetricsRegistry,
                                                          MetricsServer)
        from spinglass_tpu_torch.utils.security import TokenAuthenticator

        reg = MetricsRegistry()
        reg.counter_inc("sweeps_total", 3.0)
        auth = TokenAuthenticator(tokens={})
        token = auth.issue("reader")
        srv = MetricsServer(reg, port=0, auth=auth).start()
        try:
            url = f"http://127.0.0.1:{srv.port}/metrics"
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(url)
            assert exc.value.code == 401
            req = urllib.request.Request(
                url, headers={"Authorization": f"Bearer {token}"})
            body = urllib.request.urlopen(req).read().decode()
            assert "spinglass_sweeps_total 3.0" in body
        finally:
            srv.stop()


class TestKeyLifecycle:
    def test_derive_stable_and_purpose_scoped(self):
        km = es.KeyManager(master_key=b"m" * 32)
        k1, v1 = km.current("checkpoints")
        k2, _ = km.current("checkpoints")
        k3, _ = km.current("results")
        assert k1 == k2 and v1 == 1
        assert k1 != k3

    def test_rotation_keeps_old_versions_decryptable(self):
        km = es.KeyManager()
        arr = np.arange(12, dtype=np.float32).reshape(3, 4)
        blob = es.encrypt_array(arr, km, purpose="p")
        v2 = km.rotate("p")
        assert v2 == 2
        # old blob still decrypts via its recorded version
        np.testing.assert_array_equal(es.decrypt_array(blob, km), arr)
        # new encryptions use the new version
        blob2 = es.encrypt_array(arr, km, purpose="p")
        assert blob2["key_version"] == 2
        np.testing.assert_array_equal(es.decrypt_array(blob2, km), arr)

    def test_purge_retired(self):
        km = es.KeyManager()
        km.current("p")
        km.rotate("p")
        assert km.purge_retired("p") == 1
        with pytest.raises(KeyError):
            km.by_version("p", 1)


class TestEncryptArray:
    def test_roundtrip_and_tamper_detection(self):
        km = es.KeyManager()
        arr = np.random.default_rng(0).normal(size=(8, 8))
        blob = es.encrypt_array(arr, km)
        np.testing.assert_array_equal(es.decrypt_array(blob, km), arr)
        # ciphertext differs from plaintext bytes
        assert blob["ciphertext"] != arr.tobytes()
        # tampering is detected
        ct = bytearray(blob["ciphertext"])
        ct[0] ^= 0xFF
        blob["ciphertext"] = bytes(ct)
        with pytest.raises(ValueError, match="integrity"):
            es.decrypt_array(blob, km)

    def test_keystream_not_repeating_xor(self):
        """The reference repeated the key (advanced_security_framework.py:
        85-90); a PRF counter keystream must not repeat with period 32."""
        ks = es._keystream(b"k" * 32, b"n" * 16, 128)
        assert ks[:32] != ks[32:64]


class TestRBAC:
    def test_default_roles_and_wildcards(self):
        rbac = es.RBAC()
        rbac.assign("alice", "researcher")
        rbac.assign("bob", "viewer")
        assert rbac.has_permission("alice", "problems/tsp1", "solve")
        assert not rbac.has_permission("bob", "problems/tsp1", "solve")
        assert rbac.has_permission("bob", "results/run9", "read")
        rbac.revoke("alice", "researcher")
        assert not rbac.has_permission("alice", "problems/tsp1", "solve")

    def test_session_expiry_and_scope(self):
        rbac = es.RBAC()
        rbac.assign("op", "operator")
        tok = rbac.create_session("op", duration_seconds=3600,
                                  scope=["metrics/*"])
        # scoped session: metrics ok, problems denied even though the ROLE
        # would allow it
        assert rbac.has_permission("op", "metrics/latency", "read", tok)
        assert not rbac.has_permission("op", "problems/x", "read", tok)
        # expired session
        tok2 = rbac.create_session("op", duration_seconds=-1)
        assert rbac.validate_session(tok2) is None
        assert not rbac.has_permission("op", "metrics/x", "read", tok2)

    def test_unknown_role_rejected(self):
        rbac = es.RBAC()
        with pytest.raises(KeyError):
            rbac.assign("x", "superuser")


class TestDifferentialPrivacy:
    def test_budget_accounting_and_exhaustion(self):
        dp = es.DifferentialPrivacy(epsilon=1.0, seed=0)
        x = np.zeros(1000)
        dp.laplace(x, eps=0.4)
        dp.gaussian(x, eps=0.4)
        assert dp.remaining_budget() == pytest.approx(0.2)
        with pytest.raises(RuntimeError, match="budget"):
            dp.laplace(x, eps=0.3)

    def test_noise_scales_with_epsilon(self):
        lo = es.DifferentialPrivacy(epsilon=100.0, seed=1)
        hi = es.DifferentialPrivacy(epsilon=100.0, seed=1)
        x = np.zeros(20000)
        noisy_tight = lo.laplace(x, sensitivity=1.0, eps=10.0)
        noisy_loose = hi.laplace(x, sensitivity=1.0, eps=0.1)
        assert noisy_loose.std() > 10 * noisy_tight.std()

    def test_private_mean(self):
        dp = es.DifferentialPrivacy(epsilon=5.0, seed=2)
        parties = [np.full(500, v, float) for v in (1.0, 2.0, 3.0)]
        agg = dp.private_mean(parties, sensitivity=1.0, eps=2.0)
        assert abs(agg.mean() - 2.0) < 0.1


class TestSecretSharing:
    def test_exact_reconstruction(self):
        ss = es.SecretSharing(n_parties=4, seed=3)
        secret = np.random.default_rng(0).normal(size=(5, 7))
        shares = ss.share(secret)
        assert len(shares) == 4
        np.testing.assert_allclose(ss.reconstruct(shares), secret,
                                   atol=1e-5)

    def test_single_share_is_uninformative(self):
        ss = es.SecretSharing(n_parties=3, seed=4)
        a = ss.share(np.zeros(100))
        b = ss.share(np.ones(100) * 123.456)
        # first shares of wildly different secrets are identically
        # distributed uniform noise — compare gross statistics
        assert abs(float(np.mean(a[0])) - float(np.mean(b[0]))) < 0.3 * float(
            np.std(a[0]))

    def test_secure_sum(self):
        ss = es.SecretSharing(n_parties=3, seed=5)
        inputs = [np.array([1.5, -2.0]), np.array([0.5, 4.0]),
                  np.array([2.0, 1.0])]
        np.testing.assert_allclose(ss.secure_sum(inputs),
                                   np.array([4.0, 3.0]), atol=1e-5)


def test_security_report():
    rbac = es.RBAC()
    rbac.assign("u", "viewer")
    rbac.has_permission("u", "problems/x", "write")  # denied
    km = es.KeyManager()
    km.current("p")
    rep = es.security_report(rbac, km)
    assert rep["n_users"] == 1
    assert rep["n_denied"] >= 1
    assert rep["key_purposes"] == {"p": 1}


class TestCache:
    def test_lru_basic_and_eviction(self):
        c = C.LRUCache(max_size=2)
        c.put("a", 1)
        c.put("b", 2)
        assert c.get("a") == 1
        c.put("c", 3)          # evicts b (a was refreshed)
        assert c.get("b") is None
        assert c.get("a") == 1
        assert 0 < c.hit_rate < 1

    def test_ttl_expiry(self):
        import time
        c = C.LRUCache(ttl=0.05)
        c.put("k", "v")
        assert c.get("k") == "v"
        time.sleep(0.06)
        assert c.get("k") is None

    def test_cached_anneal_hits(self):
        p = _problems([10])[0]
        cache = C.LRUCache()
        calls = {"n": 0}

        def fake_anneal(problem, config):
            calls["n"] += 1
            return "result"

        r1 = C.cached_anneal(p, FAST, cache=cache, anneal_fn=fake_anneal)
        r2 = C.cached_anneal(p, FAST, cache=cache, anneal_fn=fake_anneal)
        assert r1 == r2 == "result"
        assert calls["n"] == 1
        assert cache.hit_rate == 0.5

    def test_fingerprint_distinguishes_problems(self):
        p1, p2 = _problems([10, 10], seed=0), _problems([10, 10], seed=9)
        assert C.problem_fingerprint(p1[0]) != C.problem_fingerprint(p2[0])
        assert C.problem_fingerprint(p1[0]) == C.problem_fingerprint(p1[0])

    def test_memoize_decorator(self):
        calls = {"n": 0}

        @C.memoize()
        def f(x):
            calls["n"] += 1
            return x * 2

        assert f(3) == 6 and f(3) == 6
        assert calls["n"] == 1


class TestProfiler:
    def test_phase_and_decorator(self):
        """Spans by name with their self time: a span's time less what its
        children cover (the decorator form is gone: drivers open spans)."""
        prof = PerformanceProfiler()
        assert prof.summary() == {}
        with prof.recording() as spans:
            with prof.phase("a"):
                time.sleep(0.02)
                for _ in range(2):
                    with prof.phase("b"):
                        time.sleep(0.01)
        s = prof.summary()
        assert s["a"]["n"] == 1 and s["b"]["n"] == 2
        a, b = s["a"], s["b"]
        assert a["total_s"] >= 0.04 and b["total_s"] >= 0.02
        assert a["self_s"] == pytest.approx(a["total_s"] - b["total_s"])
        assert b["self_s"] == b["total_s"]
        assert b["mean_s"] == pytest.approx(b["total_s"] / 2)
        assert b["max_s"] <= b["total_s"]
        assert prof.summary(spans) == s and prof.last is spans


class TestAnomaly:
    def test_spike_detected(self):
        from spinglass_tpu_torch.utils.anomaly import AnomalyDetector

        det = AnomalyDetector(warmup=3)
        for _ in range(10):
            assert det.observe("lat", 1.0 + np.random.default_rng(0)
                               .normal(0, 1e-3)) is None or True
        a = det.observe("lat", 100.0)
        assert a is not None and a.kind == "spike"

    def test_stuck_detected(self):
        from spinglass_tpu_torch.utils.anomaly import AnomalyDetector

        det = AnomalyDetector(stuck_after=4, z_threshold=1e9)
        out = [det.observe("x", 5.0) for _ in range(8)]
        kinds = [a.kind for a in out if a]
        assert "stuck" in kinds

    def test_self_healing_fires_and_limits(self):
        from spinglass_tpu_torch.utils.anomaly import (AdaptiveMonitoringSystem,
                                                 AnomalyDetector,
                                                 SelfHealingSystem)

        calls = []
        healer = SelfHealingSystem(max_attempts_per_metric=2)
        healer.register("hbm*", "*", lambda a: calls.append(a.metric),
                        name="shrink_batch")
        sys_ = AdaptiveMonitoringSystem(
            AnomalyDetector(warmup=2, z_threshold=2.0), healer)
        for v in [1.0, 1.0, 1.0, 1.0, 50.0, 1.0, 80.0, 1.0, 90.0]:
            sys_.record("hbm_used", v)
        assert 1 <= len(calls) <= 2  # healed, but capped at max_attempts
        rep = sys_.report()
        assert rep["healing"]["n_healings"] == len(calls)


class TestAutoscale:
    def test_scale_up_on_high_util(self):
        from spinglass_tpu_torch.utils.autoscale import AdaptiveScaler

        d = AdaptiveScaler(cooldown_s=0.0).decide(
            n_replicas=256, utilization=0.95, hbm_used_fraction=0.4,
            queue_depth=10)
        assert d.target > 256

    def test_scale_down_on_memory_pressure(self):
        from spinglass_tpu_torch.utils.autoscale import AdaptiveScaler

        d = AdaptiveScaler(cooldown_s=0.0).decide(
            n_replicas=1024, utilization=0.99, hbm_used_fraction=0.95,
            queue_depth=10)
        assert d.target == 512 and "hbm" in d.reason

    def test_cooldown_blocks_change(self):
        from spinglass_tpu_torch.utils.autoscale import AdaptiveScaler

        s = AdaptiveScaler(cooldown_s=1000.0)
        d1 = s.decide(n_replicas=256, utilization=0.95,
                      hbm_used_fraction=0.4, queue_depth=5)
        d2 = s.decide(n_replicas=d1.target, utilization=0.95,
                      hbm_used_fraction=0.4, queue_depth=5)
        assert d1.changed and not d2.changed

    def test_predictor_tracks_trend(self):
        from spinglass_tpu_torch.utils.autoscale import WorkloadPredictor

        p = WorkloadPredictor()
        for i in range(20):
            p.observe(float(i))
        assert p.predict(1) > 15.0

    def test_multiobjective_respects_memory(self):
        from spinglass_tpu_torch.utils.autoscale import MultiObjectiveScaler

        m = MultiObjectiveScaler()
        m.observe(256, 500, 1e9)
        out = m.decide(hbm_bytes_per_replica=64 * 1024 * 1024,
                       hbm_budget=8 * 1024 ** 3)
        assert out["est_hbm"] <= 8 * 1024 ** 3
        assert out["n_replicas"] >= 64

    def test_manager_ticks(self):
        from spinglass_tpu_torch.utils.autoscale import AutoScalingManager

        mgr = AutoScalingManager()
        for _ in range(3):
            d = mgr.tick(n_replicas=128, utilization=0.9,
                         hbm_used_fraction=0.3, queue_depth=8)
        assert d.resource == "n_replicas"


class TestMetricsExporter:
    def test_render_counter_gauge_histogram(self):
        from spinglass_tpu_torch.utils.metrics_exporter import MetricsRegistry

        reg = MetricsRegistry()
        reg.counter_inc("sweeps_total", 5, labels={"algo": "sa"},
                        help_="total sweeps")
        reg.gauge_set("replicas", 256)
        reg.observe("solve_seconds", 0.05)
        text = reg.render()
        assert 'spinglass_sweeps_total{algo="sa"} 5.0' in text
        assert "spinglass_replicas 256.0" in text
        assert "spinglass_solve_seconds_count 1.0" in text
        assert "# TYPE spinglass_sweeps_total counter" in text

    def test_http_endpoint(self):
        from spinglass_tpu_torch.utils.metrics_exporter import (MetricsRegistry,
                                                          MetricsServer)

        reg = MetricsRegistry()
        reg.gauge_set("up", 1)
        srv = MetricsServer(reg, port=0).start()
        try:
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5).read()
            assert b"spinglass_up 1.0" in body
        finally:
            srv.stop()


class TestComposeMonitoringWiring:
    """The docker-compose monitoring stack must stay consistent with the
    exporter (VERDICT.md r4 missing #2: the reference composes prometheus +
    grafana; the rebuild had a better exporter but nothing scraping it)."""

    def _repo(self):
        import os

        return os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

    def test_scrape_target_matches_exporter(self):
        import os

        import yaml

        repo = self._repo()
        comp = yaml.safe_load(open(os.path.join(repo, "docker-compose.yml")))
        prom = yaml.safe_load(open(os.path.join(
            repo, "deployment/monitoring/prometheus.yml")))
        env = comp["services"]["solver"]["environment"]
        target = prom["scrape_configs"][0]["static_configs"][0]["targets"][0]
        assert target == f"solver:{env['SGT_METRICS_PORT']}"
        assert prom["scrape_configs"][0]["metrics_path"] == "/metrics"
        assert env["SGT_METRICS_HOST"] == "0.0.0.0"
        assert {"prometheus", "grafana"} <= set(comp["services"])

    def test_dashboard_panels_query_published_metrics(self):
        """Every dashboard expr must reference a metric name the exporter
        actually publishes (publish_anneal_result / publish_rl_metrics /
        sync_from_monitor) — no dead panels."""
        import json
        import os
        import re

        repo = self._repo()
        dash = json.load(open(os.path.join(
            repo, "deployment/monitoring/grafana-dashboard.json")))
        published = {
            "spinglass_solver_flips_per_sec",
            "spinglass_solver_best_energy",
            "spinglass_solver_exchange_rate_mean",
            "spinglass_solver_runs_total",
            "spinglass_rl_env_steps_per_sec",
            "spinglass_rl_final_mean_best_energy",
            "spinglass_host_cpu_percent", "spinglass_host_mem_percent",
            "spinglass_device_bytes_in_use",
        }
        exprs = [t["expr"] for p in dash["panels"]
                 for t in p.get("targets", [])]
        assert exprs
        for expr in exprs:
            names = set(re.findall(r"spinglass_[a-z_]+", expr))
            assert names and names <= published, expr

    def test_solver_publishes_and_env_gated_server_serves(self, monkeypatch):
        """End to end in-process: SGT_METRICS_PORT starts the server, a
        solve + a PT run + publish_rl_metrics populate the gauges, and a
        scrape of /metrics sees them."""
        import urllib.request

        import numpy as np

        from spinglass_tpu_torch.anneal.pt import PTConfig, run as pt_run
        from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
        from spinglass_tpu_torch.core import topology
        from spinglass_tpu_torch.core.problem import IsingProblem
        from spinglass_tpu_torch.utils import metrics_exporter as me

        monkeypatch.setenv("SGT_METRICS_PORT", "0")  # ephemeral port
        monkeypatch.setattr(me, "_global_server", None)
        srv = me.maybe_start_server_from_env()
        assert srv is not None
        assert me.maybe_start_server_from_env() is srv  # idempotent
        try:
            p = IsingProblem.from_dense(np.asarray(topology.fully_connected(
                16, dist="binary", seed=0)), device="cpu")
            anneal(p, SAConfig(n_sweeps=30, n_replicas=4,
                               use_kernel="never", seed=0))
            pt_run(p, PTConfig(n_replicas=4, n_sweeps=20,
                               exchange_interval=10, use_kernel="never",
                               seed=0))
            me.publish_rl_metrics(1234.5, -3.0)
            body = urllib.request.urlopen(
                f"http://127.0.0.1:{srv.port}/metrics", timeout=5
            ).read().decode()
            assert 'spinglass_solver_flips_per_sec{solver="sa"}' in body
            assert 'spinglass_solver_best_energy{solver="pt"}' in body
            assert 'spinglass_solver_exchange_rate_mean{solver="pt"}' in body
            assert "spinglass_rl_env_steps_per_sec 1234.5" in body
        finally:
            srv.stop()
            me._global_server = None


# -- the port's own checks -----------------------------------------------------

def test_registry_renders_the_jax_text():
    """The same calls on the port's and the JAX registry render the same
    Prometheus text."""
    from spinglass_tpu.utils.metrics_exporter import MetricsRegistry as JReg

    from spinglass_tpu_torch.utils.metrics_exporter import MetricsRegistry

    texts = []
    for reg in (MetricsRegistry(), JReg()):
        reg.counter_inc("sweeps_total", 5, labels={"algo": "sa"},
                        help_="total sweeps")
        reg.counter_inc("sweeps_total", 2.5, labels={"algo": "pt"})
        reg.gauge_set("replicas", 256, help_="replicas")
        for v in (0.005, 0.05, 3.0, 30.0):
            reg.observe("solve_seconds", v)
        m = mon.PerformanceMonitor()
        m.record("kernel_launches", 7)
        reg.sync_from_monitor(m)
        texts.append(reg.render())
    assert texts[0] == texts[1]


@pytest.mark.parametrize("driver", ["sa", "pt", "ppo"])
def test_drivers_publish_their_results(driver, monkeypatch):
    """The port's ``anneal`` and ``pt.run`` call ``publish_anneal_result``
    with their result, and ``ppo.train`` calls ``publish_rl_metrics``, at
    the places the JAX drivers do."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.anneal.sa import anneal
    from spinglass_tpu_torch.rl import env as env_mod
    from spinglass_tpu_torch.rl import ppo
    from spinglass_tpu_torch.utils import metrics_exporter as me

    seen = []
    monkeypatch.setattr(me, "publish_anneal_result",
                        lambda res, solver="sa": seen.append((solver, res)))
    monkeypatch.setattr(me, "publish_rl_metrics",
                        lambda rate, e: seen.append(("rl", (rate, e))))
    p = _problems([16])[0]
    if driver == "sa":
        out = anneal(p, SAConfig(n_sweeps=20, n_replicas=4, seed=0))
    elif driver == "pt":
        out = pt.run(p, pt.PTConfig(n_replicas=4, n_sweeps=20,
                                    exchange_interval=10, seed=0))
    else:
        res = ppo.train(p, env_mod.EnvConfig(n_envs=4, sweeps_per_step=1,
                                             max_steps=4),
                        ppo.PPOConfig(n_updates=3, rollout_len=2, n_epochs=1,
                                      n_minibatches=1, hidden_sizes=(8,)))
        out = (res["env_steps_per_second"], res["final_mean_best_energy"])
    assert seen == [("rl" if driver == "ppo" else driver, out)]


def test_device_memory_stats_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mon.device_memory_stats() == {}


def test_validate_device_count_counts_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValidationError, match="need 1 devices, have 0"):
        V.validate_device_count(1)
    assert V.validate_device_count(0) == 0


def test_problem_fingerprint_equals_jax():
    """The same J and h hash alike in both packages (one host read)."""
    from spinglass_tpu.core.problem import IsingProblem as JaxProblem
    from spinglass_tpu.utils import cache as JC

    j = topology.fully_connected(20, dist="gaussian", seed=3)
    h = np.random.default_rng(3).normal(size=20)
    tp = IsingProblem.from_dense(j, h, device="cpu")
    jp = JaxProblem.from_dense(j, h)
    assert C.problem_fingerprint(tp) == JC.problem_fingerprint(jp)
    assert C.problem_fingerprint(tp, FAST) != C.problem_fingerprint(tp)
    assert C.anneal_cache_stats(C.LRUCache(max_size=3)) == {
        "size": 0, "max_size": 3, "hits": 0, "misses": 0, "hit_rate": 0.0}
    assert not hasattr(C, "enable_persistent_compile_cache")


def test_device_trace_writes_a_chrome_trace(tmp_path):
    from spinglass_tpu_torch.utils.profiling import device_trace

    with device_trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace.json").read_text())
    assert trace["traceEvents"] and prof is not None


@pytest.mark.parametrize("plot", ["result", "schedules", "gantt"])
def test_plots_render(plot, tmp_path):
    """The JAX plotting tests' surfaces on the port's types."""
    import os

    from spinglass_tpu_torch.anneal.result import AnnealResult
    from spinglass_tpu_torch.anneal.schedules import (ScheduleConfig,
                                                      ScheduleType)
    from spinglass_tpu_torch.problems.base import ProblemSolution
    from spinglass_tpu_torch.utils import plotting

    if plot == "result":
        res = AnnealResult(
            best_spins=np.ones(4), best_energy=-2.0,
            replica_best_energy=np.array([-2.0]),
            energy_history=np.linspace(0, -2, 20),
            mean_energy_history=np.linspace(1, -1, 20),
            temperature_history=np.geomspace(5, 0.01, 20),
            acceptance_history=np.linspace(0.9, 0.1, 20))
        path = plotting.plot_result(res, str(tmp_path / "r.png"))
    elif plot == "schedules":
        path = plotting.plot_schedules(
            [ScheduleConfig(t, initial_temp=5.0, final_temp=0.01)
             for t in (ScheduleType.GEOMETRIC, ScheduleType.LINEAR)],
            n_sweeps=50, path=str(tmp_path / "s.png"))
    else:
        sol = ProblemSolution(
            objective_value=5.0,
            variables={"assignments": {0: {"agent": 0, "start": 0, "end": 2},
                                       1: {"agent": 1, "start": 1, "end": 3}},
                       "makespan": 3})
        path = plotting.plot_gantt(sol, str(tmp_path / "g.png"))
    assert os.path.getsize(path) > 1000


def test_runner_results_and_summary_keys_equal_jax():
    """One case of the standard suite through both runners (SA and PT):
    the same result fields and the same summary keys; the port's problems
    on the CPU."""
    from spinglass_tpu.benchmarks import runner as JR

    from spinglass_tpu_torch.benchmarks import runner as R

    port = R.BenchmarkRunner(n_sweeps=30, n_replicas=8, n_trials=1,
                             device="cpu")
    port.run_suite(R.standard_suite((8,), device="cpu")[:1])
    ref = JR.BenchmarkRunner(n_sweeps=30, n_replicas=8, n_trials=1,
                             use_pallas="never")
    ref.run_suite(JR.standard_suite((8,))[:1])
    assert [r.name for r in port.results] == [r.name for r in ref.results]
    assert ([set(r.to_dict()) for r in port.results]
            == [set(r.to_dict()) for r in ref.results])
    ps, rs = port.summary(), ref.summary()
    assert set(ps) == set(rs) == {"maxcut/sa", "maxcut/pt"}
    for k in ps:
        assert set(ps[k]) == set(rs[k])
        assert ps[k]["feasibility_rate"] == 1.0
    assert all(r.peak_memory_bytes == 0 for r in port.results)
