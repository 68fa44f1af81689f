"""Port parity for ``core/dynamics_analysis.py`` and ``pt.tune_ladder``,
against ``spinglass_tpu.core.dynamics_analysis`` and
``spinglass_tpu.anneal.pt.tune_ladder``.

The respacing is host numpy in both packages: with both drivers' ``run``
replaced by the same recorded pilot results, the tuned ladders and the
diagnostics agree within 1e-6 relative (float32 temperatures).
"""

import types

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from spinglass_tpu.anneal import pt as jpt  # noqa: E402
from spinglass_tpu.core import dynamics_analysis as jdyn  # noqa: E402
from spinglass_tpu_torch.anneal import graphs, pt  # noqa: E402
from spinglass_tpu_torch.core import dynamics_analysis as dyn  # noqa: E402
from spinglass_tpu_torch.core import topology  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402


def _series(kind, n, seed):
    rng = np.random.default_rng(seed)
    if kind == "ar1":
        x = np.zeros(n)
        for t in range(1, n):
            x[t] = 0.9 * x[t - 1] + rng.normal()
        return x
    if kind == "noise":
        return rng.normal(size=n)
    if kind == "drift":
        return np.linspace(0.0, 5.0, n) + rng.normal(scale=0.1, size=n)
    if kind == "walk":
        return np.cumsum(rng.normal(size=n))
    return np.full(n, 2.5)     # constant


@pytest.mark.parametrize("kind", ["ar1", "noise", "drift", "walk", "const"])
@pytest.mark.parametrize("n", [3, 40, 500])
def test_dynamics_analysis_equals_jax(kind, n):
    x = _series(kind, n, seed=n)
    for lag in (5, 100):
        np.testing.assert_array_equal(dyn.autocorrelation(x, lag),
                                      jdyn.autocorrelation(x, lag))
        assert (dyn.integrated_autocorrelation_time(x, lag)
                == jdyn.integrated_autocorrelation_time(x, lag))
    assert dyn.effective_sample_size(x) == jdyn.effective_sample_size(x)
    for frac, z in ((0.25, 2.0), (0.1, 1.0)):
        assert (dyn.is_equilibrated(x, frac, z)
                == jdyn.is_equilibrated(x, frac, z))


def _fake_run(calls, equilibrated_from):
    """A pilot-run stand-in: slot energies a smooth function of the ladder
    it is given, a cold-slot series that trends until the pilot has
    ``equilibrated_from`` sweeps, exchange rates from the ladder's gaps."""

    def run(problem, cfg, *args, ladder_override=None, **kw):
        temps = np.asarray(ladder_override, np.float64)
        calls.append((cfg.n_sweeps, temps.copy()))
        n_super = cfg.n_sweeps // cfg.exchange_interval
        e_slot = -40.0 * np.tanh(1.5 / temps) - 0.3 * temps
        rng = np.random.default_rng(cfg.n_sweeps)
        hist = e_slot[None, :] + rng.normal(scale=0.2, size=(n_super, len(temps)))
        if cfg.n_sweeps < equilibrated_from:
            hist[:, 0] += np.linspace(5.0, 0.0, n_super)
        rates = np.exp(-np.abs(np.diff(1.0 / temps)) * 10.0)
        return types.SimpleNamespace(metadata={
            "slot_energy_history": hist.astype(np.float32),
            "slot_energy": hist[n_super // 2:].mean(axis=0).tolist(),
            "exchange_rates": rates.tolist()})

    return run


@pytest.mark.parametrize("equilibrated_from,n_iters", [(0, 1), (0, 3),
                                                       (300, 2), (10 ** 6, 2)])
def test_tune_ladder_respacing_equals_jax(monkeypatch, equilibrated_from,
                                          n_iters):
    """Both packages' run replaced by the same recorded pilot results: the
    same pilots are asked for (the doubling gate included: never, once, and
    all three tries), and the tuned ladder and diagnostics agree."""
    tcalls, jcalls = [], []
    monkeypatch.setattr(pt, "run", _fake_run(tcalls, equilibrated_from))
    monkeypatch.setattr(jpt, "run", _fake_run(jcalls, equilibrated_from))
    kw = dict(n_replicas=10, min_temp=0.2, max_temp=6.0, exchange_interval=5,
              seed=3)
    temps, diag = pt.tune_ladder(None, pt.PTConfig(**kw), n_pilot_sweeps=100,
                                 n_iters=n_iters)
    jtemps, jdiag = jpt.tune_ladder(None, jpt.PTConfig(**kw),
                                    n_pilot_sweeps=100, n_iters=n_iters)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls]
    for (_, a), (_, b) in zip(tcalls, jcalls):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert temps.dtype == np.float32 and temps.shape == (10,)
    np.testing.assert_allclose(temps, jtemps, rtol=1e-6)
    assert diag["pilot_sweeps"] == jdiag["pilot_sweeps"]
    for it, jit in zip(diag["iterations"], jdiag["iterations"]):
        np.testing.assert_allclose(it["temps"], jit["temps"], rtol=1e-6)
        np.testing.assert_allclose(it["exchange_rates"],
                                   jit["exchange_rates"], rtol=1e-6)
        assert it["rate_spread"] == pytest.approx(jit["rate_spread"],
                                                  rel=1e-6)
    np.testing.assert_allclose([temps[0], temps[-1]], [0.2, 6.0], rtol=1e-6)


def test_tuned_ladder_reduces_rate_spread():
    """The JAX test's criterion (tests/unit/test_anneal.py
    TestLadderTuning) on the port: on an SK glass the tuned ladder's
    exchange-rate spread is no worse than the geometric ladder's (+0.05),
    the ladder increases strictly and keeps its endpoints; each pilot
    length captures once."""
    n = 48
    j = topology.fully_connected(n, dist="gaussian", scale=1.0 / np.sqrt(n),
                                 seed=9)
    p = IsingProblem.from_dense(j, device="cpu")
    cfg = pt.PTConfig(n_replicas=8, n_sweeps=400, exchange_interval=5,
                      min_temp=0.2, max_temp=8.0, use_kernel="never", seed=0)
    base = pt.run(p, cfg)
    base_rates = np.asarray(base.metadata["exchange_rates"])
    misses = graphs.PT_CACHE.misses
    temps, diag = pt.tune_ladder(p, cfg, n_pilot_sweeps=200, n_iters=2)
    # pilots of 200, 400, ... sweeps up to each iteration's; the 400-sweep
    # pilot shares the base run's configuration, and so its capture
    tried = {200 * 2 ** a for used in diag["pilot_sweeps"]
             for a in range(int(np.log2(used // 200)) + 1)}
    assert graphs.PT_CACHE.misses - misses == len(tried - {cfg.n_sweeps})
    tuned = pt.run(p, cfg, ladder_override=temps)
    tuned_rates = np.asarray(tuned.metadata["exchange_rates"])
    assert temps.shape == (8,) and np.all(np.diff(temps) > 0)
    assert tuned_rates.max() - tuned_rates.min() <= (
        base_rates.max() - base_rates.min()) + 0.05
    np.testing.assert_allclose([temps[0], temps[-1]], [0.2, 8.0], rtol=1e-5)
    np.testing.assert_allclose(tuned.metadata["ladder"], temps, rtol=1e-6)
