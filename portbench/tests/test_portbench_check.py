"""The check that decides ``correct``, driven through the whole harness on
the CPU at tiny sizes: sound runs pass, the lower-precision control and each
fault a cell can have fail, and no run loads JAX or the JAX package."""

import os
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import ROOT, run_tiny

CELLS = ("sk4096.sa", "planted10k.sa", "planted10k.ttt")
TRAINING = ("planted10k.ppo",)


@pytest.mark.parametrize("name", CELLS + TRAINING)
def test_sound_runs_are_correct(bench, name):
    out = run_tiny(bench, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == set(harness.end_to_end_names(bench, name))
    assert all(v["value"] > 0 for v in out["metrics"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_bf16_control_is_not_correct(bench, name):
    out = run_tiny(bench, name, control="reference_bf16")
    assert not out["correct"]
    assert out["checks"]["energy_gap"]["value"] > \
        out["checks"]["energy_gap"]["limit"]


def _faulty(kind):
    """A ``make_engine`` whose engine's sweep has the fault ``kind``."""
    from spinglass_tpu_torch.anneal import engines

    original = engines.make_engine

    def make(*args, **kwargs):
        eng = original(*args, **kwargs)
        sweep = eng.sweep

        def faulty(spins, beta, generator):
            old = spins.clone()
            new, de, cnt = sweep(spins, beta, generator)
            if kind == "unchanged":
                return old, torch.zeros_like(de), torch.zeros_like(cnt)
            if kind == "half":     # the second half of the replicas left out
                out = torch.arange(de.shape[0], device=de.device) >= \
                    de.shape[0] // 2
                keep = out[None, :] if eng.layout == "nr" else out[:, None]
                return (torch.where(keep, old, new),
                        torch.where(out, torch.zeros_like(de), de),
                        torch.where(out, torch.zeros_like(cnt), cnt))
            # an answer altered where it is made: spin 0 of every replica
            s = eng.from_layout(new).clone()
            s[:, 0] = -s[:, 0]
            return eng.to_layout(s), de, cnt

        if kind == "energy":       # an energy altered where it is made
            exact = eng.energy
            eng.energy = lambda spins: exact(spins) + 1.0
        else:
            eng.sweep = faulty
        return eng

    return make


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_faults_are_not_correct(bench, name, fault, monkeypatch):
    from spinglass_tpu_torch.anneal import pt, sa

    monkeypatch.setattr(sa, "make_engine", _faulty(fault))
    monkeypatch.setattr(pt, "make_engine", _faulty(fault))
    out = run_tiny(bench, name)
    assert not out["correct"], out["checks"]


def _training_fault(ppo, kind):
    """``ppo.minibatch_step`` with the fault ``kind``."""
    step, loss = ppo.minibatch_step, ppo.ppo_loss

    def half_loss(cfg, model, params, batch, log_prob, entropy_fn):
        n = batch["adv"].shape[0] // 2     # half the batch, the mean of the rest
        return loss(cfg, model, params,
                    {k: v[:n] for k, v in batch.items()}, log_prob,
                    entropy_fn)

    def faulty(cfg, model, params, opt, batch, log_prob, entropy_fn):
        if kind == "unchanged":            # the step leaves its state as it was
            return {k: v.detach() for k, v in loss(
                cfg, model, params, batch, log_prob, entropy_fn)[1].items()}
        aux = step(cfg, model, params, opt, batch, log_prob, entropy_fn)
        if kind == "altered":              # an answer altered where it is made
            with torch.no_grad():
                params["dense.1.bias"].add_(1e-3)
        return aux

    return faulty, (half_loss if kind == "half" else loss)


def env_fault(kind):
    """(module, name, stand-in) that plants the env fault ``kind``: the
    reward's sign turned, the auto-reset leaving every env as it was, or
    the temperature ladder read one place off."""
    from spinglass_tpu_torch.rl import env, rewards

    if kind == "reward_sign":
        compute = rewards.compute

        def turned(*args, **kwargs):
            reward, state = compute(*args, **kwargs)
            return -reward, state

        return rewards, "compute", turned
    if kind == "no_reset":
        def kept(problem, cfg, state, generator, engine=None, spins=None):
            env._fresh_state(problem, cfg, generator, engine, spins)  # draws
            return state, env.observe(problem, cfg, state, engine)

        return env, "auto_reset", kept
    ladder = env._ladder
    return env, "_ladder", lambda device: torch.roll(ladder(device), 1)


ENV_FAULTS = ("reward_sign", "no_reset", "temp_decode")


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered",
                                   "env_altered") + ENV_FAULTS)
def test_training_faults_are_not_correct(bench, fault, monkeypatch):
    from spinglass_tpu_torch.anneal import engines
    from spinglass_tpu_torch.rl import ppo

    if fault == "env_altered":    # the env's energies altered where made
        monkeypatch.setattr(engines, "make_engine", _faulty("energy"))
    elif fault in ENV_FAULTS:
        monkeypatch.setattr(*env_fault(fault))
    else:
        step, loss = _training_fault(ppo, fault)
        monkeypatch.setattr(ppo, "minibatch_step", step)
        monkeypatch.setattr(ppo, "ppo_loss", loss)
    out = run_tiny(bench, "planted10k.ppo")
    assert not out["correct"], out["checks"]
    if fault in ENV_FAULTS:
        gap = out["checks"]["reward_gap"]
        assert gap["value"] > gap["limit"]


def test_the_training_cells_bf16_control_is_not_correct(bench):
    out = run_tiny(bench, "planted10k.ppo", control="reference_bf16")
    assert not out["correct"], out["checks"]


def test_boundary_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "spinglass_tpu_torch_x", sys)
    assert harness.boundary_check() == []
    monkeypatch.setitem(sys.modules, "spinglass_tpu.core", sys)
    assert harness.boundary_check() == ["spinglass_tpu"]


def test_a_run_loads_no_jax():
    """A whole tiny run in a fresh process: no module whose top-level name
    is jax, jaxlib, flax or spinglass_tpu is loaded at its end."""
    code = ("import sys; sys.path.insert(0, %r)\n"
            "from portbench.tests.conftest import run_tiny\n"
            "from portbench import harness\n"
            "out = run_tiny(harness.benchmark(), 'planted10k.ttt', 0.5)\n"
            "assert out['correct'], out\n"
            "print(harness.boundary_check())\n" % ROOT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.strip().splitlines()[-1] == "[]"


def test_run_refuses_without_a_card(tmp_path):
    res = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "sk4096.sa",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0 and res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr
