"""The port's last operations modules against the JAX package's unit tests'
expectations: the job coordinator, the work-stealing pool, edge
orchestration, the deployment config and global infrastructure, the quality
gates and ``sgt-torch quality-gates``, the interactive helper and the
multi-process scaling worker. Every problem is built on the CPU."""

import json
import os
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from click.testing import CliRunner  # noqa: E402

from spinglass_tpu_torch import cli  # noqa: E402
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal  # noqa: E402
from spinglass_tpu_torch.cli_interactive import InteractiveOptimizer  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.deployment import (Environment,  # noqa: E402
                                            ProductionConfig)
from spinglass_tpu_torch.distributed.coordinator import (JobCoordinator,  # noqa: E402
                                                         JobStatus)
from spinglass_tpu_torch.distributed.edge import (EdgeNode,  # noqa: E402
                                                  EdgeOrchestrator)
from spinglass_tpu_torch.distributed.workpool import WorkerPool  # noqa: E402


def _pm_j(n, seed=0):
    return IsingProblem.from_dense(
        topology.fully_connected(n, dist="binary", seed=seed), device="cpu")


# -- coordinator ---------------------------------------------------------

class TestCoordinator:
    def test_submit_and_collect(self):
        c = JobCoordinator(n_workers=2).start()
        for i in range(5):
            c.submit(f"sq_{i}", lambda i=i: i * i)
        assert c.wait(timeout=10)
        assert c.results() == {f"sq_{i}": i * i for i in range(5)}
        c.shutdown()

    def test_retry_then_success(self):
        c = JobCoordinator(n_workers=1).start()
        calls = {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise RuntimeError("flake")
            return "done"

        c.submit("flaky", flaky, max_retries=3)
        assert c.wait(timeout=10)
        assert c.results()["flaky"] == "done"
        assert c.jobs["flaky"].attempts == 3
        c.shutdown()

    def test_failure_after_retries(self):
        c = JobCoordinator(n_workers=1).start()

        def broken():
            raise ValueError("always")

        c.submit("bad", broken, max_retries=1)
        assert not c.wait(timeout=10)
        assert c.jobs["bad"].status == JobStatus.FAILED
        assert "always" in c.jobs["bad"].error
        c.shutdown()

    def test_duplicate_id_rejected(self):
        c = JobCoordinator().start()
        c.submit("x", lambda: 1)
        with pytest.raises(ValueError):
            c.submit("x", lambda: 2)
        c.shutdown()

    def test_map_and_progress(self):
        c = JobCoordinator(n_workers=2).start()
        ids = c.map(lambda x: x + 1, [10, 20, 30], prefix="inc")
        assert c.wait(timeout=10)
        assert [c.results()[i] for i in ids] == [11, 21, 31]
        assert c.progress() == {"completed": 3}
        c.shutdown()

    def test_anneal_jobs_on_two_workers_equal_sequential_calls(self):
        """A seed sweep of anneals through two worker threads: each equals
        the same seed's call made alone (the drivers' lock orders them)."""
        p = _pm_j(12)

        def job(seed):
            return anneal(p, SAConfig(n_sweeps=40, n_replicas=4, seed=seed))

        c = JobCoordinator(n_workers=2).start()
        ids = c.map(job, [1, 2, 3, 4], prefix="seed")
        assert c.wait(timeout=120)
        for seed, jid in zip([1, 2, 3, 4], ids):
            got, ref = c.results()[jid], job(seed)
            assert got.best_energy == ref.best_energy
            np.testing.assert_array_equal(got.energy_history,
                                          ref.energy_history)
        c.shutdown()


# -- work-stealing pool ------------------------------------------------------

class TestWorkPool:
    def test_map_runs_all_and_steals(self):
        def make(i):
            def fn():
                if i % 7 == 0:
                    time.sleep(0.02)  # imbalance -> stealing
                return i * i
            return fn

        pool = WorkerPool(n_workers=4)
        items = pool.map([make(i) for i in range(40)], timeout=30)
        assert [it.result for it in items] == [i * i for i in range(40)]
        assert sum(pool.report()["executed"]) == 40

    def test_errors_captured_not_raised(self):
        def boom():
            raise ValueError("nope")

        items = WorkerPool(2).map([boom, lambda: 1], timeout=10)
        assert items[0].error and "ValueError" in items[0].error
        assert items[1].result == 1

    def test_anneals_on_four_workers_equal_sequential_calls(self):
        p = _pm_j(16, 1)

        def job(seed):
            return anneal(p, SAConfig(n_sweeps=30, n_replicas=4, seed=seed))

        items = WorkerPool(4).map([lambda s=s: job(s) for s in range(6)],
                                  timeout=120)
        for s, it in enumerate(items):
            assert it.error is None, it.error
            assert it.result.best_energy == job(s).best_energy


# -- edge orchestration -------------------------------------------------------

class TestEdge:
    def test_dispatch_picks_the_quickest_node_and_runs_every_backend(self):
        p = _pm_j(12, 2)
        orch = EdgeOrchestrator(n_sweeps=40, n_replicas=4, seed=0)
        out = orch.submit(p)   # small problem: latency decides
        assert out.node == "edge-cpu-0" and out.backend == "sa"
        for backend in ("sa", "pt", "sqa"):
            res = orch.submit(p, prefer_backend=backend)
            assert res.backend == backend and np.isfinite(res.best_energy)
        rep = orch.report()
        assert rep["n_jobs"] == 4 and rep["by_node"]["edge-cpu-0"] == 2
        assert all(n.busy == 0 for n in orch.nodes)

    def test_unknown_backend_and_missing_node(self):
        with pytest.raises(ValueError):
            EdgeOrchestrator([EdgeNode("x", "qpu")])
        orch = EdgeOrchestrator([EdgeNode("a", "sa")], n_sweeps=10)
        with pytest.raises(RuntimeError):
            orch.pick_node(_pm_j(8), prefer_backend="pt")

    def test_submit_from_threads_keeps_the_counts(self):
        from spinglass_tpu_torch.distributed.workpool import WorkerPool

        p = _pm_j(12, 3)
        orch = EdgeOrchestrator([EdgeNode("a", "sa", capacity=2)],
                                n_sweeps=20, n_replicas=2)
        items = WorkerPool(3).map([lambda: orch.submit(p)] * 6, timeout=120)
        assert all(it.error is None for it in items)
        assert orch.report()["n_jobs"] == 6 and orch.nodes[0].busy == 0
        energies = {it.result.best_energy for it in items}
        assert len(energies) == 1   # one seed: every solve is the same


# -- deployment ------------------------------------------------------------

class TestDeploymentConfig:
    def test_environment_presets(self):
        dev = ProductionConfig.from_environment("development")
        prod = ProductionConfig.from_environment("production")
        assert dev.environment == Environment.DEVELOPMENT
        assert not dev.observability.log_json
        assert prod.service.validation_level == "strict"
        assert prod.observability.log_level == "WARNING"
        assert dev.compute.platform == "cuda"
        assert dev.compute.use_kernel == "auto"
        assert not hasattr(dev.compute, "use_pallas")

    def test_env_var_override(self, monkeypatch):
        monkeypatch.setenv("SGT_COMPUTE_N_REPLICAS", "512")
        monkeypatch.setenv("SGT_COMPUTE_USE_KERNEL", "never")
        monkeypatch.setenv("SGT_COMPUTE_PLATFORM", "cpu")
        monkeypatch.setenv("SGT_OBSERVABILITY_LOG_JSON", "false")
        cfg = ProductionConfig.from_environment("staging")
        assert cfg.compute.n_replicas == 512
        assert cfg.compute.use_kernel == "never"
        assert cfg.compute.platform == "cpu"
        assert cfg.observability.log_json is False

    def test_save_roundtrip(self, tmp_path):
        cfg = ProductionConfig.from_environment("production")
        path = str(tmp_path / "cfg.json")
        cfg.save(path)
        loaded = json.load(open(path))
        assert loaded["environment"] == "production"
        assert loaded["compute"]["platform"] == "cuda"


class TestGlobalInfra:
    def test_i18n_fallback_and_locales(self):
        from spinglass_tpu_torch.deployment.global_infra import I18nManager

        i = I18nManager("ja")
        assert i.t("solve.done") == "最適化が完了しました"
        assert i.t("no.such.key") == "no.such.key"
        with pytest.raises(ValueError):
            i.set_locale("xx")

    def test_compliance_consent_and_transfer(self):
        from spinglass_tpu_torch.deployment.global_infra import (
            ComplianceManager)

        c = ComplianceManager("GDPR")
        assert not c.can_process("u1")
        c.record_consent("u1")
        assert c.can_process("u1")
        assert not c.can_transfer("europe-west4", "us-central1")
        assert ComplianceManager("CCPA").can_transfer("us-central1",
                                                      "europe-west4")

    def test_retention_and_scrub(self):
        from spinglass_tpu_torch.deployment.global_infra import (
            ComplianceManager)

        c = ComplianceManager("GDPR")
        assert c.retention_expired(0.0, now=100 * 86400)
        rec = c.scrub({"user_email": "a@b.c", "energy": -3.0})
        assert rec["user_email"] == "<redacted>" and rec["energy"] == -3.0

    def test_region_placement_respects_residency(self):
        from spinglass_tpu_torch.deployment.global_infra import (
            GlobalInfrastructureManager)

        g = GlobalInfrastructureManager(home_region="europe-west4")
        assert g.place(tpu_type="v5e",
                       data_origin="europe-west4").name == "europe-west4"
        g2 = GlobalInfrastructureManager(home_region="us-central1")
        assert len(g2.eligible_regions("v5e", "us-central1")) >= 2

    def test_tables_equal_the_jax_modules(self):
        from spinglass_tpu.deployment import global_infra as jg
        from spinglass_tpu_torch.deployment import global_infra as tg

        from dataclasses import asdict

        assert ([asdict(r) for r in tg.DEFAULT_REGIONS]
                == [asdict(r) for r in jg.DEFAULT_REGIONS])
        assert ({k: asdict(v) for k, v in tg.POLICIES.items()}
                == {k: asdict(v) for k, v in jg.POLICIES.items()})
        assert tg._MESSAGES == jg._MESSAGES


# -- quality gates ------------------------------------------------------------

CPU_GATES = ["imports", "energy_invariants", "determinism", "security",
             "graceful_degradation"]


def test_quality_gates_pass_on_the_cpu(tmp_path):
    from spinglass_tpu_torch.benchmarks.quality_gates import (
        DEFAULT_GATES, run_quality_gates)

    out = tmp_path / "gates.json"
    rep = run_quality_gates(CPU_GATES + ["sharded_kernel_cuda",
                                         "headline_paths", "suite_budget"],
                            report_path=str(out), device="cpu")
    assert rep["summary"]["failed"] == 0, rep
    assert json.loads(out.read_text())["summary"]["total"] == 8
    details = {g["name"]: g["detail"] for g in rep["gates"]}
    assert details["sharded_kernel_cuda"].startswith("skipped")
    assert details["suite_budget"].startswith("skipped: already inside")
    from spinglass_tpu.benchmarks.quality_gates import (
        DEFAULT_GATES as JAX_GATES)

    assert set(DEFAULT_GATES) == (set(JAX_GATES) - {"sharded_pallas_tpu"}
                                  | {"sharded_kernel_cuda"})
    with pytest.raises(KeyError):
        run_quality_gates(["no_such_gate"], device="cpu")


def test_perf_targets_are_the_cards_and_not_the_tpus():
    import spinglass_tpu_torch.benchmarks as tb
    from spinglass_tpu_torch.benchmarks.quality_gates import (
        _load_perf_targets)

    with open(os.path.join(os.path.dirname(tb.__file__),
                           "perf_targets.json")) as f:
        doc = json.load(f)
    assert "H100" in doc["card"] and "W" in doc["card"]
    gates = _load_perf_targets()
    m = doc["measured"]
    assert gates["dense_flips_min"] <= m["dense_flips_per_s"]
    assert gates["sparse_flips_min"] <= m["sparse_flips_per_s"]
    assert gates["rl_env_steps_min"] <= m["rl_env_steps_per_s"]
    assert gates["pt10k_wall_max_s"] >= m["pt10k_wall_s"]
    assert gates["ttt_median_max_s"] >= m["ttt_median_s"]
    from spinglass_tpu.benchmarks.quality_gates import (
        _load_perf_targets as jax_targets)

    assert gates != jax_targets()


def test_quality_gates_command():
    res = CliRunner().invoke(cli.main, ["--device", "cpu", "quality-gates",
                                        "--gates", "imports,security"])
    assert res.exit_code == 0, res.output
    assert "PASS imports" in res.output and "2/2 gates passed" in res.output
    bad = CliRunner().invoke(cli.main, ["--device", "cpu", "quality-gates",
                                        "--gates", "nope"])
    assert bad.exit_code != 0


# -- the interactive helper -----------------------------------------------

def test_interactive_quick_solve_raw_matrix(capsys):
    j = topology.fully_connected(12, dist="ferromagnetic", scale=1.0)
    opt = InteractiveOptimizer(n_sweeps=100, n_replicas=8, verbose=True,
                               device="cpu")
    res = opt.quick_solve(j)
    assert res.best_energy == pytest.approx(-0.5 * 12 * 11, rel=1e-4)
    assert len(opt.history()) == 1
    assert "best energy" in capsys.readouterr().out


# -- the multi-process scaling worker ----------------------------------------

def test_multihost_scaling_worker_two_processes(tmp_path):
    """Two gloo ranks run the sharded PT worker: both report the same
    global best energy, the mesh spans both processes, and the report's
    default output is not the JAX package's record."""
    from spinglass_tpu_torch.benchmarks import multihost_scaling as ms
    from spinglass_tpu_torch.distributed import _multihost_worker as w

    reps = ms._run_procs(2, str(tmp_path), 64, timeout=180)
    assert [r["process"] for r in reps] == [0, 1]
    for r in reps:
        assert r["process_count"] == 2 and r["global_devices"] == 2
        assert r["n_replicas"] == 2 * w.REPLICAS_PER_RANK and r["finite"]
    assert reps[0]["best_energy"] == reps[1]["best_energy"]
    assert ms._worker_n_super() == w.N_SUPER == 10
    import inspect

    assert "MULTIHOST_scaling_torch.json" in inspect.getsource(ms.main)
