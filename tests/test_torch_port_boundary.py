"""The port's boundary: it runs without JAX and without spinglass_tpu (the
captured drivers, the host C++ routines of ``native``, the problem
encoders, the command line, a checkpointed
anneal, a PT super-step with cluster moves, a DQN step, the training
pipeline, the gymnasium adapter and a one-rank sharded PT run included), it never launches (or builds) its CUDA kernels for CPU tensors, its builds
target sm_90a and rebuild when a source or a header changes, and the smoke
script refuses to report without a GPU."""

import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.kernels import build  # noqa: E402
from spinglass_tpu_torch.kernels import cluster_cuda as CC  # noqa: E402
from spinglass_tpu_torch.kernels import metropolis_cuda as MC  # noqa: E402
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.kernels import sparse_cuda as SC  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "spinglass_tpu_torch"

_NO_JAX = """
import os
import sys
for name in ("jax", "jaxlib", "flax", "optax", "spinglass_tpu"):
    sys.modules[name] = None          # any import of these now fails
import numpy as np
import torch
torch.set_num_threads(1)
import spinglass_tpu_torch as sgt
from spinglass_tpu_torch.core import topology
p = sgt.IsingProblem.from_dense(topology.fully_connected(12, dist="binary"), device="cpu")
res = sgt.anneal(p, sgt.SAConfig(n_sweeps=2, n_replicas=2, record_interval=1))
assert res.n_sweeps == 2 and np.isfinite(res.best_energy)
from spinglass_tpu_torch.anneal import pt
from spinglass_tpu_torch.benchmarks import planted
from spinglass_tpu_torch.kernels.sparse import EllProblem
ell = EllProblem.from_coo(60, *topology.sparse_random_graph_coo(60, seed=2), device="cpu")
from spinglass_tpu_torch import native
assert native.BACKEND == "native" and native.CALLS[("build_ell", "native")] == 1
assert {path for _, path in native.CALLS} == {"native"}, native.CALLS
sp = sgt.anneal(ell, sgt.SAConfig(n_sweeps=2, n_replicas=2, record_interval=1))
inst = planted.planted_gauge_coo(60, 4.0, seed=1)
ell = EllProblem.from_coo(60, inst.rows, inst.cols, inst.vals, device="cpu")
ptr = pt.run(ell, pt.PTConfig(n_replicas=4, n_sweeps=5, exchange_interval=5))
assert sp.n_sweeps == 2 and ptr.n_sweeps == 5 and np.isfinite(ptr.best_energy)
from spinglass_tpu_torch.anneal import sa
st, hist = sa.anneal_scan(p, sgt.SAConfig(n_sweeps=4, n_replicas=2,
                                          record_interval=2))
assert int(st.sweep) == 4 and hist["best_energy"].shape == (2,)
ttt = planted.time_to_target(ell, -1e9, pt.PTConfig(n_replicas=4,
                                                    exchange_interval=5),
                             max_sweeps=5)
assert ttt["sweeps"] == 5 and not ttt["hit"]
from spinglass_tpu_torch.anneal import twins
from spinglass_tpu_torch.rl import env, evaluate, ppo, rewards
assert rewards.N_NOVELTY_BINS == 256 and evaluate.welch_t([1, 2], [3, 5])["t"] < 0
env_cfg = env.EnvConfig(n_envs=4, sweeps_per_step=1, max_steps=5)
init_fn, update_fn, _ = ppo.make_ppo(p, env_cfg, ppo.PPOConfig(
    rollout_len=2, n_epochs=1, n_minibatches=1, hidden_sizes=(8,)))
state, metrics = update_fn(init_fn())
assert state.update == 1 and np.isfinite(float(metrics["mean_reward"]))
from spinglass_tpu_torch.rl import dqn, gym_adapter, train
dqn_cfg = dqn.DQNConfig(hidden_sizes=(8,), buffer_size=8, batch_size=4)
dinit, dstep, _ = dqn.make_dqn(p, env_cfg, dqn_cfg)
dst, dm = dstep(dinit())
assert int(dst.step) == 1 and np.isfinite(float(dm["loss"]))
pipe = train.RLTrainingPipeline(train.TrainingConfig(agent="dqn", n_updates=2),
                                env_cfg, dqn_cfg=dqn_cfg, problem=p)
assert len(pipe.train()["metrics"]) == 2
genv = gym_adapter.SpinGlassGymEnv(p, env.EnvConfig(n_envs=1, max_steps=2))
obs, _ = genv.reset(seed=0)
assert genv.step(0)[0].shape == obs.shape == (16,)
from spinglass_tpu_torch import problems, cli
tsp = problems.TSPProblem(device="cpu")
tsp.generate_random_instance(n_cities=4, seed=0)
sol = tsp.solve(sgt.SAConfig(n_sweeps=20, n_replicas=2, record_interval=10))
assert tsp.validate_tour(sol.variables["tour"])
from click.testing import CliRunner
out = CliRunner().invoke(cli.main, ["--device", "cpu", "solve", "-s", "3",
                                    "--sweeps", "10", "--replicas", "2"])
assert out.exit_code == 0 and "feasible:  True" in out.output, out.output
import tempfile
ck = tempfile.mkdtemp()
ckr = sgt.anneal(p, sgt.SAConfig(n_sweeps=4, n_replicas=2, record_interval=1),
                 checkpoint_dir=ck, checkpoint_every=2)
again = sgt.anneal(p, sgt.SAConfig(n_sweeps=4, n_replicas=2, record_interval=1),
                   checkpoint_dir=ck, resume=True)
assert again.best_energy == ckr.best_energy and len(os.listdir(ck)) == 2
cm_cfg = pt.PTConfig(n_replicas=4, exchange_interval=2, cluster_moves=1)
from spinglass_tpu_torch.kernels import build
l0 = build.launch_snapshot()
step, _, eng = pt.make_pt_step(ell, cm_cfg)
st, stats = step(pt.init_state(ell, cm_cfg, engine=eng))
assert int(st.sweep) == 2 and np.isfinite(float(stats["best_energy"]))
assert step.sw.last_rounds is not None and build.launches_since(
    l0, ["sw_labels"]) == {"sw_labels": 0}
from spinglass_tpu_torch.kernels import cluster_cuda
assert build.launches_since(l0, ["sw_bonds"]) == {"sw_bonds": 0}
assert cluster_cuda.labels_plan(10112, 16)[1] == 8
from spinglass_tpu_torch.anneal import adaptive, batch
from spinglass_tpu_torch.core import minimal
from spinglass_tpu_torch.benchmarks import runner
import spinglass_tpu_torch.utils as utils
bres = batch.BatchProcessor(sgt.SAConfig(n_sweeps=3, n_replicas=2)).process([p, p])
assert [r.algorithm for r in bres] == ["sa/batched"] * 2
ares = adaptive.adaptive_anneal(p, adaptive.AdaptiveSAConfig(
    base=sgt.SAConfig(n_sweeps=4, n_replicas=4, record_interval=1),
    stagnation_chunks=1))
assert ares.algorithm == "adaptive_sa/blocked"
assert minimal.MinimalAnnealer(n_sweeps=3).anneal(
    minimal.create_test_problem(6))["n_sweeps"] == 3
hl = CliRunner().invoke(cli.main, ["--device", "cpu", "health"])
assert hl.exit_code == 0, hl.output
assert utils.monitoring.device_memory_stats() == {} and utils.global_registry()
assert runner.standard_suite((8,), device="cpu")[0].name == "maxcut_8"
from spinglass_tpu_torch import research
from spinglass_tpu_torch.research import meta_rl
sq = research.simulated_quantum_annealing(p, research.SQAConfig(
    n_trotter=2, n_stages=2, sweeps_per_stage=2, n_replicas=2))
assert sq.algorithm == "sqa" and sq.metadata["captures"] == 1
aq = research.adaptive_quantum_inspired_annealing(p, research.AQIAConfig(
    n_iterations=3, n_replicas=2))
assert aq.algorithm == "aqia" and len(aq.energy_history) == 3
agent = meta_rl.AdaptiveMetaRLAgent(meta_rl.MetaRLConfig(
    n_sweeps=2, n_replicas=4), device="cpu")
assert agent.solve(p)[1]["source"] == "default"
from spinglass_tpu_torch.distributed import multihost, pt_sharded
assert multihost.initialize(device="cpu")["process_count"] == 1
shr = pt_sharded.run(ell, pt.PTConfig(n_replicas=4, n_sweeps=5,
                                      exchange_interval=5))
multihost.shutdown()
assert shr.algorithm == "pt_sharded/sparse_sortedx1", shr.algorithm
assert shr.best_energy == ptr.best_energy
from spinglass_tpu_torch.benchmarks.quality_gates import run_quality_gates
assert run_quality_gates(["imports"], device="cpu")["summary"]["failed"] == 0
loaded = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "spinglass_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("ok", res.algorithm, sp.algorithm, ptr.algorithm, "ppo", state.update,
      "dqn", int(dst.step))
"""


def _run(args, cwd, env_extra=None):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=240)


def test_port_runs_with_jax_unimportable(tmp_path):
    proc = _run([sys.executable, "-c", _NO_JAX], cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip() == ("ok sa/blocked/metropolis "
                                   "sa/sparse_sorted/metropolis pt/metropolis "
                                   "ppo 1 dqn 1")


def test_port_sources_import_no_jax():
    build_dir = pathlib.Path(build.BUILD_DIR).resolve()  # outputs, not sources
    files = [p for p in PKG.rglob("*.py") if build_dir not in p.parents]
    files.append(ROOT / "chip_smoke.py")
    assert len(files) >= 15
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "flax", "optax",
                                   "spinglass_tpu"), (path, name)


NEW_MODULES = (  # the batch, adaptive and operations slice
    "core/minimal.py", "anneal/batch.py", "anneal/adaptive.py",
    "utils/logging.py", "utils/validation.py", "utils/robust.py",
    "utils/security.py", "utils/monitoring.py", "utils/metrics_exporter.py",
    "utils/health.py", "utils/anomaly.py", "utils/autoscale.py",
    "utils/enterprise_security.py", "utils/plotting.py",
    "utils/profiling.py", "utils/cache.py", "benchmarks/runner.py",
    # the research layer
    "research/validation.py", "research/quantum.py",
    "research/novel.py", "research/pareto.py", "research/meta.py",
    "research/federated.py", "research/meta_rl.py", "research/unified.py",
    "research/breakthrough.py", "research/scaling.py",
    # the distributed layer and the last operations modules
    "distributed/multihost.py", "distributed/pt_sharded.py",
    "distributed/model_sharded.py", "distributed/rl_sharded.py",
    "distributed/_multihost_worker.py", "distributed/coordinator.py",
    "distributed/workpool.py", "distributed/edge.py",
    "benchmarks/multihost_scaling.py", "benchmarks/quality_gates.py",
    "deployment/config.py", "deployment/global_infra.py",
    "cli_interactive.py")


@pytest.fixture(scope="module")
def imported_without_jax():
    """The slice's modules imported in one process where jax and
    spinglass_tpu cannot be imported: the names of those that imported."""
    mods = ["spinglass_tpu_torch." + rel[:-3].replace("/", ".")
            for rel in NEW_MODULES]
    code = ("import importlib, sys\nfor n in ('jax', 'spinglass_tpu'):\n"
            "    sys.modules[n] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n    print(m)")
    proc = _run([sys.executable, "-c", code], cwd=ROOT)
    return proc.stdout.split(), proc.stderr


@pytest.mark.parametrize("rel", NEW_MODULES)
def test_slice_modules_stand_at_the_jax_paths_without_jax(
        rel, imported_without_jax):
    """Each module of the slice has its JAX counterpart at the same path,
    imports neither jax nor spinglass_tpu, and imports in a process where
    those cannot be imported."""
    assert (ROOT / "spinglass_tpu" / rel).exists(), rel
    path = PKG / rel
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            for name in names:
                assert name.split(".")[0] not in ("jax", "spinglass_tpu"), (
                    rel, name)
    names, err = imported_without_jax
    assert "spinglass_tpu_torch." + rel[:-3].replace("/", ".") in names, err


def test_stacked_sweep_on_cpu_never_launches_or_builds(monkeypatch):
    """K1's stacked form runs its twin for CPU tensors: no compiler, no
    launches counted, seeds as ints or a CPU slot."""
    def no_subprocess(*a, **k):
        raise AssertionError("a CPU sweep must not invoke a compiler")

    monkeypatch.setattr(build.subprocess, "run", no_subprocess)
    monkeypatch.setattr(build.subprocess, "Popen", no_subprocess)
    j = torch.as_tensor(np.sign(np.random.default_rng(0).normal(
        size=(2, 128, 128))), dtype=torch.float32)
    j = (j + j.transpose(1, 2)) / 2
    j[:, torch.arange(128), torch.arange(128)] = 0.0
    sw = MC.StackedFusedSweep(j, torch.zeros(2, 128), torch.ones(2, 128))
    s = torch.ones(2, 128, 4)
    before = build.launch_snapshot()
    sw(s, torch.ones(2, 4), [1, 2])
    sw(s, 0.5, torch.tensor([3, 4]))
    sw.sweep_with_uniforms(s, 0.5, torch.rand(2, 128, 4))
    assert build.launches_since(before, [MC.KERNEL_NAME]) == {
        MC.KERNEL_NAME: 0} and sw._lib is None
    with pytest.raises(ValueError, match="3 seeds for 2 problems"):
        sw(s, 0.5, [1, 2, 3])


@pytest.mark.parametrize("layer", ["core", "kernels"])
def test_lower_layers_import_no_driver(layer):
    """core and kernels (the random tape included, in core/rng.py) import
    nothing of the drivers above them (anneal, rl, benchmarks) when they
    are imported; core/convert.py's converters into driver states import
    them inside the function that needs them."""
    for path in (PKG / layer).glob("*.py"):
        for node in ast.parse(path.read_text()).body:
            if isinstance(node, ast.ImportFrom) and node.module:
                parts = node.module.split(".")
                if parts[0] == "spinglass_tpu_torch":
                    assert parts[1:2] not in (["anneal"], ["rl"],
                                              ["benchmarks"]), (path, node.module)


def test_fused_sweep_on_cpu_never_launches_or_builds(monkeypatch):
    def no_subprocess(*a, **k):
        raise AssertionError("a CPU sweep must not invoke a compiler")

    monkeypatch.setattr(build.subprocess, "run", no_subprocess)
    j = np.sign(np.random.default_rng(0).normal(size=(30, 30)))
    p = IsingProblem.from_dense(j, device="cpu")
    u = torch.rand(p.n_padded, 8, generator=torch.Generator().manual_seed(0))
    for flags in ({}, dict(pipelined=True), dict(interleave=2),
                  dict(interleave=4), dict(folded=True)):
        fused = MC.FusedSweep(p, **flags)
        s = torch.ones(p.n_padded, 8)
        before = build.launch_snapshot()
        fused(s, torch.ones(8), 1234)
        fused.sweep_with_uniforms(s, 0.5, u)
        assert build.launches_since(before, [fused.kernel_name]) == {
            fused.kernel_name: 0} and fused._lib is None, flags
        assert fused.block_size == 128  # Np = 128: 256 does not divide it


def test_sparse_kernels_on_cpu_never_launch_or_build(monkeypatch):
    """K2, K3 and K4 forced on (accept_kernel="single" or "fused",
    threshold_rng="kernel") run their twins for CPU tensors: no compiler,
    no launches counted. (The problem is built first: from_coo's host C++
    routine, ``native.build_ell``, builds at its first use on any device.)"""
    def no_subprocess(*a, **k):
        raise AssertionError("a CPU sweep must not invoke a compiler")

    coo = topology.sparse_random_graph_coo(100, avg_degree=4.0, seed=1)
    ell = S.EllProblem.from_coo(100, *coo, device="cpu")
    monkeypatch.setattr(build.subprocess, "Popen", no_subprocess)
    monkeypatch.setattr(build.subprocess, "run", no_subprocess)
    gen = torch.Generator().manual_seed(0)
    for kw in (dict(accept_kernel="single"), dict(threshold_rng="kernel"),
               dict(accept_kernel="fused")):
        eng = S.SortedSparseTEngine(ell, **kw)
        s = eng.to_layout(torch.ones(128, ell.n_padded))
        before = build.launch_snapshot()
        for _ in range(2):
            s, _, _ = eng.sweep(s, torch.full((128,), 0.5), gen)
        assert build.launches_since(before, eng.kernel_names) == {
            "sparse_sweep": 0, "sparse_thresholds": 0, "sparse_accept": 0}
        assert eng.kernels._libs is None and eng.kernels._accept_lib is None


def test_nvcc_command_targets_sm90a_and_build_dir_is_ignored():
    cmd = build.nvcc_command("k.cu", "k.so")
    joined = " ".join(cmd)
    assert "arch=compute_90a,code=sm_90a" in joined
    assert "-shared" in cmd and "-O3" in cmd
    assert "--use_fast_math" not in joined and "use_fast_math" not in joined
    lib = build.library_path(MC.KERNEL_NAME)
    assert os.path.dirname(lib) == build.BUILD_DIR
    assert os.path.basename(lib).startswith("metropolis_sweep-")
    assert os.path.exists(os.path.join(build.CSRC_DIR, "metropolis_sweep.cu"))
    ignored = (ROOT / ".gitignore").read_text().split()
    assert "spinglass_tpu_torch/build/" in ignored
    philox = os.path.join(build.CSRC_DIR, "philox.cuh")
    dense = os.path.join(build.CSRC_DIR, "dense_sweep.cuh")
    cluster = os.path.join(build.CSRC_DIR, "cluster_sweep.cuh")
    for name, headers in ((MC.KERNEL_NAME, [cluster, dense, philox]),
                          (SC.SWEEP_KERNEL, [philox]),
                          (SC.THRESHOLD_KERNEL, [philox]),
                          (SC.ACCEPT_KERNEL, [philox]),
                          (MC.PIPELINED_KERNEL, [cluster, dense, philox]),
                          (MC.INTERLEAVED_KERNEL, [cluster, dense, philox]),
                          (MC.FOLDED_KERNEL, [cluster, dense, philox]),
                          (CC.KERNEL_NAME, [philox]),
                          (CC.BONDS_KERNEL, [philox])):
        src = os.path.join(build.CSRC_DIR, f"{name}.cu")
        assert "arch=compute_90a,code=sm_90a" in " ".join(
            build.nvcc_command(src, "x.so"))
        assert os.path.basename(build.library_path(name)).startswith(name + "-")
        assert build.local_headers(src) == headers, name


def test_library_hash_covers_headers_and_builds_run_together(tmp_path,
                                                             monkeypatch):
    """An edited header gives every source that includes it a new library
    path; build_many starts one compiler per missing library and keeps each
    compiler report beside its library."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "common.cuh").write_text("// v1\n")
    for name in ("a", "b"):
        (csrc / f"{name}.cu").write_text('#include "common.cuh"\n')
    monkeypatch.setattr(build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "build"))
    before = build.library_path("a")
    (csrc / "common.cuh").write_text("// v2\n")
    assert build.library_path("a") != before
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\nwhile [ $# -gt 1 ]; do [ \"$1\" = -o ] && "
                    "touch \"$2\"; shift; done\necho ptxas info: 8 registers\n")
    fake.chmod(0o755)
    monkeypatch.setattr(build, "nvcc_path", lambda: str(fake))
    started = []
    real_popen = build.subprocess.Popen
    monkeypatch.setattr(build.subprocess, "Popen",
                        lambda *a, **k: started.append(a[0][-1])
                        or real_popen(*a, **k))
    libs = build.build_many(["a", "b"])
    assert len(started) == 2 and all(os.path.exists(p) for p in libs)
    assert "registers" in open(libs[1] + ".log").read()
    assert build.build_many(["a", "b"]) == libs and len(started) == 2


def test_chip_smoke_refuses_without_gpu(tmp_path):
    """No CUDA device here: exit non-zero and no result line. Alone in a
    directory (no package beside it) it fails as well."""
    proc = _run([sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
                env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    lone = tmp_path / "chip_smoke.py"
    lone.write_text((ROOT / "chip_smoke.py").read_text())
    proc = subprocess.run([sys.executable, str(lone)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=240,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
