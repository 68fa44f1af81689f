#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (spinglass_tpu_torch) on one GPU.

    python3 chip_smoke.py

Builds the port's kernels from csrc/ with nvcc (one process per source, all
at once): K1 (dense sweep), its variants K5 (pipelined), K6 (interleaved)
and K7 (folded), K2 (single-call sparse sweep), K3 (sparse thresholds) and
K4 (fused sparse accept). Holds each against its plain PyTorch twin, drives
the dense SA slice (SK glass, N=4096, R=1024; K1 and each variant) and the
sparse slice (10k spins: SA at R=1024, time-to-target PT at R=128, PT at
R=4096 on K3 and on K4) end to end, and times the kernels against the
twins. Phases:

  1. device and build: nvidia-smi name and power limit, build seconds,
     registers and spills of every kernel;
  2. parity with the twins. +-J couplings with h on a quarter grid make every
     field exact, so spins, dE and counts must be equal bit for bit.
     K1: N=500 padded to 512, R in {1, 37, 256}, both rules, both block
     sizes, host-uniform and Philox sweeps; N=4096, R=1024 at block 128 (the
     size anneal uses) and 256, both rules, both modes; three sweeps of sa.run_chunk through
     make_engine's engine against the same driver with the twin; Gaussian SK
     energy identity (1e-4 relative) and counts within 0.5%.
     K2/K3: sparse N=2000 and the 10k bench graph, R in {128, 256, 1024},
     both rules, K2 on K3's thresholds and in Philox mode, 3 sweeps; K3 at
     [10240, 1024] and [10240, 4096]; two PT super-steps through
     make_engine's engine (K2, R=128) against the same driver with the twin
     on a +-J planted 10k instance (state bitwise); Gaussian 10k energy
     identity (1e-4 relative) on K2 (R=1024) and on K3 + the plain sweep
     (R=4096).
     K5, K6 (2 and 4 chains), K7: each against its own twin and against K1
     on +-J N=500 (R in {1, 37, 256, 1024}, both rules, both blocks,
     host-uniform and Philox sweeps), and at N=4096, R=1024 against its
     twin and K1 (block 128, Philox) and against K1 (block 256, host
     uniforms): spins, dE, counts bitwise.
     K4: one colour against its twin on the 10k +-J graph, int8 and float32
     spins, R in {128, 4096}; one K4-path sweep == one K3-path sweep == one
     K2 sweep at [10240, 1024] under one seed, bitwise;
  3. in-kernel Philox, statistically: a 6-spin system sampled for 400 sweeps
     at beta=0.6 against exact enumeration (TV < 0.05), through K1 and
     through K2; K1's SK acceptance within 1% of the host-uniform sweep's;
  4. the slices: a chunk of sweeps must make no host sync
     (torch.cuda.set_sync_debug_mode("error")), dense and sparse; then
     anneal(SK 4096, R=1024, 500 sweeps) must run K1 500 times and reach
     E/N <= -0.72; anneal(10k sparse, R=1024, 500 sweeps) must run
     SortedSparseTEngine with K2 500 times; time_to_target on the
     ttt_provenance.json instance (hash checked) must hit its threshold for
     seeds 42, 43, 44 within 20000 sweeps; pt.run with R=4096 (32 chains of
     128) must take the threshold path, K3 200 times. Each run's
     best_energy must equal the energy of its best_spins (1e-3 relative).
     Then each dense variant runs the SK anneal's 500 sweeps (its seeds,
     its schedule, sa's sweep step): E/N <= -0.72, energy identity within
     1e-4 relative per 50-sweep chunk; on a +-J N=4096 instance the same
     500 sweeps must end bitwise equal to K1's spins. PT at R=4096 through
     make_pt_step with SortedSparseTEngine(accept_kernel="fused") for 200
     sweeps must equal the K3 path under one seed (spins and slots bitwise,
     energies within 1e-4), with K4 launched and K3 not. The launch counts
     are those of the engine each run builds, so they start at 0 and count
     only that run's launches;
  5. timing: bench_dense (K1) at block 128 and one twin sweep;
     profile_chunk's device breakdown of anneal's loop; bench_sparse (K2),
     K2 alone at R=128, one sweep of K2's twin at R=1024; K3 and its twin
     at [10240, 4096]; the TTT median; bench_pt10k (300 sweeps); the device
     breakdown of a sparse SA chunk and of the TTT loop; K1, K5, K6 (2, 4)
     and K7 at N=4096, R=1024, blocks 128 and 256, in turns, beside the
     twins' sweeps at that shape (timed in phase 2); the K4 path and the K3
     path at R=4096, one run each, and K4 alone against its twin over one
     sweep's colours.

Any failed check exits non-zero. The last line is the JSON status
{"ok": true, "device": {...}}; the line before it lists the kernels.
Without a CUDA device, or without the package beside this file, it exits 1
and prints no result.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
SA_BLOCK = 128  # SAConfig's block_size: the K1 build anneal launches
# kernel (csrc/<name>.cu) -> the Pallas TPU kernel it replaces
KERNELS = {
    "metropolis_sweep": "spinglass_tpu/kernels/metropolis_pallas.py:73",
    "sparse_sweep": "spinglass_tpu/kernels/sparse.py:756",
    "sparse_thresholds": "spinglass_tpu/kernels/sparse.py:523",
    "sparse_accept": "spinglass_tpu/kernels/sparse.py:582",
    "metropolis_pipelined": "spinglass_tpu/kernels/metropolis_pallas.py:400",
    "metropolis_interleaved": "spinglass_tpu/kernels/metropolis_pallas.py:281",
    "metropolis_folded": "spinglass_tpu/kernels/metropolis_pallas.py:179",
}
# FusedSweep flags of the dense variants, by label
VARIANTS = {"K5": dict(pipelined=True), "K6x2": dict(interleave=2),
            "K6x4": dict(interleave=4), "K7": dict(folded=True)}
TF32_NOTE = "torch.backends.cuda.matmul.allow_tf32 = False (full float32 matmuls)"


class CheckFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise CheckFailed(msg)
    print(f"  ok: {msg}")


def pm_j_problem(n: int, seed: int, device):
    """+-1 couplings and h on a quarter grid: every field is exact in f32."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(n, dist="binary", seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return IsingProblem.from_dense(j, h, device=device)


def sk_problem(device):
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem

    j = topology.fully_connected(4096, dist="gaussian", scale=1.0 / 64, seed=42)
    return IsingProblem.from_dense(j, device=device)


def phase_parity(torch, mc, stats):
    """Phase 2: the kernel against the twin on identical inputs."""
    from spinglass_tpu_torch.core.energy import energy_t
    from spinglass_tpu_torch.core.problem import random_spins

    gen = torch.Generator().manual_seed(7)
    worst = 0.0

    def compare(problem, r, rule, block, sweeps, beta, philox):
        nonlocal worst
        fused = mc.FusedSweep(problem, block_size=block, rule=rule)
        s_k = random_spins(gen, (r, problem.n_padded),
                           problem.active_mask).t().contiguous()
        s_p = s_k.clone()
        for k in range(sweeps):
            if philox:
                seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                _, de_k, c_k = fused(s_k, beta, seed)
                u = mc.philox_uniforms(seed, problem.n_padded, r, device="cuda")
            else:
                u = torch.rand(problem.n_padded, r, generator=gen).cuda()
                _, de_k, c_k = fused.sweep_with_uniforms(s_k, beta, u)
            _, de_p, c_p = mc.fused_sweep_reference(
                problem.j, problem.h, problem.active_mask, s_p, beta, u,
                rule, fused.block_size)
            torch.cuda.synchronize()
            worst = max(worst, float((de_k - de_p).abs().max()))
            if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                    and torch.equal(de_k, de_p)):
                raise CheckFailed(
                    f"kernel != twin: N={problem.n_spins} R={r} {rule} "
                    f"block {block} philox={philox} sweep {k}: "
                    f"{int((s_k != s_p).sum())} spins, "
                    f"{int((c_k != c_p).sum())} counts differ")

    small = pm_j_problem(500, 3, "cuda")
    for r, rule, block in itertools.product((1, 37, 256),
                                            ("metropolis", "glauber"),
                                            (128, 256)):
        beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        compare(small, r, rule, block, 3, beta, philox=False)
    check(True, "+-J N=500 (Np=512), R in {1,37,256}, both rules, blocks "
                "128/256, 3 host-uniform sweeps: spins, dE, counts bitwise")
    for r in (37, 256):
        beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        compare(small, r, "metropolis", 256, 3, beta, philox=True)
        compare(small, r, "glauber", 128, 3, beta, philox=True)
    check(True, "+-J N=500, Philox mode vs twin on philox_uniforms: bitwise")
    big = pm_j_problem(4096, 5, "cuda")
    beta = torch.full((1024,), 0.05, device="cuda")
    for rule, block, philox in (("metropolis", 128, False),
                                ("glauber", 128, True),
                                ("metropolis", 256, True)):
        compare(big, 1024, rule, block, 1, beta, philox)
    check(True, "+-J N=4096, R=1024 (the slice's shape): Metropolis at block "
                "128 with host uniforms, Glauber at 128 and Metropolis at 256 "
                "in Philox mode: bitwise")
    driver_parity(torch, mc, big)
    stats["max_abs_err"] = worst

    sk = sk_problem("cuda")
    stats["sk"] = sk
    fused = mc.FusedSweep(sk, block_size=SA_BLOCK)
    s0 = random_spins(gen, (1024, sk.n_padded), sk.active_mask).t().contiguous()
    stats["sk_spins"] = s0
    u = torch.rand(sk.n_padded, 1024, generator=gen).cuda()
    beta = torch.ones(1024, device="cuda")
    e0 = energy_t(sk, s0)
    s_k, de_k, c_k = fused.sweep_with_uniforms(s0.clone(), beta, u)
    e1 = energy_t(sk, s_k)
    s_p, de_p, c_p = mc.fused_sweep_reference(sk.j, sk.h, sk.active_mask,
                                              s0.clone(), beta, u,
                                              block_size=fused.block_size)
    torch.cuda.synchronize()
    rel = float(((e0 + de_k - e1).abs() / e1.abs().clamp(min=1.0)).max())
    check(rel <= 1e-4, f"SK N=4096 R=1024 block {fused.block_size} energy "
                       f"identity E0+dE==E1: "
                       f"max rel err {rel:.3e} <= 1e-4")
    ck, cp = int(c_k.sum()), int(c_p.sum())
    check(abs(ck - cp) <= 0.005 * cp,
          f"SK accept counts kernel {ck} vs twin {cp} (within 0.5%); "
          f"replicas bitwise equal {int((s_k == s_p).all(0).sum())}/1024, "
          f"max |dE_k - dE_twin| {float((de_k - de_p).abs().max()):.3e}")
    stats["host_acc"] = ck / (1024 * 4096)


def driver_parity(torch, mc, problem):
    """Three sweeps of the SA driver through make_engine's engine, against
    the same driver with the kernel swapped for the twin on the kernel's
    Philox stream: every piece of the state must be equal bit for bit."""
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine
    from spinglass_tpu_torch.kernels.sweeps import draw_seed

    class TwinEngine(CudaFusedEngine):
        def sweep(self, spins_t, beta, generator):
            f = self.fused
            u = mc.philox_uniforms(draw_seed(generator), *spins_t.shape,
                                   device=spins_t.device)
            return mc.fused_sweep_reference(
                self.problem.j, self.problem.h, self.problem.active_mask,
                spins_t, beta, u, f.rule, f.block_size)

    cfg = sa.SAConfig(n_sweeps=500, n_replicas=1024)
    engine = sa.make_sweep_engine(problem, cfg)
    check(type(engine) is CudaFusedEngine
          and engine.fused.block_size == SA_BLOCK,
          f"make_engine picks CudaFusedEngine, block {SA_BLOCK}")
    twin = TwinEngine(problem, block_size=cfg.block_size, rule=cfg.update_rule)
    out = []
    for eng in (engine, twin):
        state = sa.init_state(problem, cfg, eng)
        state, _ = sa.run_chunk(problem, cfg, eng, state, 3)
        out.append(state)
    a, b = out
    torch.cuda.synchronize()
    fields = ("spins", "energy", "best_energy", "best_spins", "acc_rate")
    diff = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    if not torch.equal(a.sched.temp, b.sched.temp):
        diff.append("sched.temp")
    check(not diff and engine.launches == {mc.KERNEL_NAME: 3}
          and twin.launches == {mc.KERNEL_NAME: 0},
          f"+-J N=4096 R=1024: 3 sweeps of sa.run_chunk, kernel engine == "
          f"twin engine bitwise in {', '.join(fields)}, sched.temp "
          f"(differ: {diff or 'none'}; acceptance of the last sweep "
          f"{float(a.acc_rate.mean()):.4f})")


def phase_philox(torch, mc, stats):
    """Phase 3: in-kernel Philox against exact enumeration and host uniforms."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins

    n, beta_v, r, sweeps = 6, 0.6, 512, 400
    j = topology.fully_connected(n, dist="gaussian", scale=0.4, seed=11)
    h = np.random.default_rng(11).normal(0, 0.2, n)
    p = IsingProblem.from_dense(j, h, device="cuda")
    states = np.array(list(itertools.product([-1.0, 1.0], repeat=n)))
    energies = np.array([-0.5 * s @ j @ s - h @ s for s in states])
    logw = -beta_v * energies
    probs = np.exp(logw - logw.max())
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(1)
    fused = mc.FusedSweep(p)
    s = random_spins(gen, (r, p.n_padded), p.active_mask).t().contiguous()
    beta = torch.full((r,), beta_v, device="cuda")
    trace = []
    for k in range(sweeps):
        s, _, _ = fused(s, beta, int(torch.randint(0, 2 ** 62, (1,), generator=gen)))
        if k >= 100:
            trace.append(s[:n].t().clone())
    samples = torch.cat(trace).cpu().numpy()
    codes = ((samples > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    state_codes = ((states > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    emp = np.bincount(codes, minlength=2 ** n) / len(codes)
    tv = 0.5 * np.abs(emp[state_codes] - probs).sum()
    check(tv < 0.05, f"6-spin Boltzmann, R=512, 400 Philox sweeps, beta=0.6: "
                     f"TV {tv:.4f} < 0.05")

    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    _, _, c = mc.FusedSweep(sk, block_size=SA_BLOCK)(
        stats["sk_spins"].clone(), beta, 12345)
    acc = int(c.sum()) / (1024 * 4096)
    host = stats["host_acc"]
    check(abs(acc - host) <= 0.01 * host,
          f"SK beta=1 mean acceptance Philox {acc:.5f} vs host uniforms "
          f"{host:.5f} (within 1%)")


def phase_slice(torch, mc, stats):
    """Phase 4: the dense SA slice through the user's entry points."""
    from spinglass_tpu_torch import IsingProblem, SAConfig, anneal, energy
    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.core import topology

    j = topology.fully_connected(4096, dist="gaussian", scale=1.0 / 64, seed=42)
    problem = IsingProblem.from_dense(j, device="cuda")
    cfg = SAConfig(n_sweeps=500, n_replicas=1024)
    # inside a chunk nothing may wait for the device (sa.py's contract)
    eng = sa.make_sweep_engine(problem, cfg)
    state = sa.init_state(problem, cfg, eng)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sa.run_chunk(problem, cfg, eng, state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(True, "a chunk of sweeps runs under set_sync_debug_mode('error'): "
                "no host sync inside a chunk")
    # the count is the launch count of the engine anneal builds for this
    # run, so it starts at 0 and holds only the main path's launches
    t0 = time.perf_counter()
    res = anneal(problem, cfg)
    wall = time.perf_counter() - t0
    launches = res.metadata["kernel_launches"].get(mc.KERNEL_NAME, 0)
    stats["launches"] = launches
    print(f"  anneal wall {wall:.3f} s (engine selection and set-up included); "
          f"sweep loop {res.total_time:.3f} s, {res.sweeps_per_second:.1f} "
          f"sweeps/s, {res.spin_flips_per_second:.4e} flips/s")
    check(res.metadata["engine"] == "cuda_fused",
          f"make_engine picked {res.metadata['engine']} (CudaFusedEngine)")
    check(launches == 500, f"K1 launched {launches} times in the run, "
                           f"expected 500")
    e_n = res.best_energy / 4096
    check(e_n <= -0.72, f"best energy per spin {e_n:.5f} <= -0.72 "
                        f"(SK ground state ~ -0.763)")
    s = torch.ones(problem.n_padded, device="cuda")
    s[:4096] = torch.as_tensor(res.best_spins, device="cuda")
    e_best = float(energy(problem, s))
    rel = abs(e_best - res.best_energy) / abs(e_best)
    check(rel <= 1e-3, f"best_energy {res.best_energy:.4f} == energy(best_spins) "
                       f"{e_best:.4f} (rel {rel:.2e} <= 1e-3)")
    check(bool(torch.isfinite(torch.as_tensor(res.energy_history)).all())
          and len(res.energy_history) == 10, "10 finite history records")


def phase_timing(torch, mc, stats, card):
    """Phase 5: K1 through bench_dense (block 256 is timed beside the
    variants), and one sweep of the twin."""
    from spinglass_tpu_torch.benchmarks.headline import bench_dense, profile_chunk

    b = bench_dense(sweeps=200, block_size=SA_BLOCK)
    us_k = b["extras"]["us_per_sweep"]
    print(f"  K1 bench_dense N=4096 R=1024 block {b['extras']['block_size']}: "
          f"{us_k:.1f} us/sweep, {b['value']:.4e} flips/s [{card}]")
    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    u = torch.rand(sk.n_padded, 1024, device="cuda")
    s = stats["sk_spins"].clone()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    mc.fused_sweep_reference(sk.j, sk.h, sk.active_mask, s, beta, u,
                             block_size=SA_BLOCK)
    stop.record()
    stop.synchronize()
    us_p = start.elapsed_time(stop) * 1e3
    print(f"  plain twin, one sweep N=4096 R=1024 block {SA_BLOCK}: "
          f"{us_p:.1f} us/sweep [{card}]")
    prof = profile_chunk(block_size=SA_BLOCK)
    print(f"  profile_chunk (anneal's loop, {prof['sweeps']} sweeps, block "
          f"{SA_BLOCK}): {prof['us_per_sweep']:.1f} us/sweep, profiled "
          f"{prof['profiled_us_per_sweep']:.1f}; kernels "
          f"{prof['device_us_per_sweep']:.1f} us/sweep, device busy "
          f"{100 * prof['device_busy_share']:.1f}% [{card}]")
    for k in prof["kernels"]:
        print(f"    {k['us_per_sweep']:9.2f} us/sweep  {k['calls']:5d} calls  "
              f"{k['name'][:80]}")
    stats["ms"] = us_k / 1e3
    stats["plain_ms"] = us_p / 1e3


# ---------------------------------------------------------------------------
# K1's variants: K5 (pipelined), K6 (interleaved, 2 and 4 chains), K7 (folded)
# ---------------------------------------------------------------------------

def variant_parity(torch, mc, stats):
    """Phase 2 (variants): each against its own twin and against K1 on the
    same inputs, +-J, bit for bit. At the slice's shape the twin's sweep is
    timed (phase 5 reports it)."""
    from spinglass_tpu_torch.core.problem import random_spins

    gen = torch.Generator().manual_seed(23)
    worst = {label: 0.0 for label in VARIANTS}
    twin_us = {}
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def compare(problem, label, r, rule, block, philox, twin=True, beta=None):
        fused = mc.FusedSweep(problem, block_size=block, rule=rule,
                              **VARIANTS[label])
        flat = mc.FusedSweep(problem, block_size=block, rule=rule)
        s_k = random_spins(gen, (r, problem.n_padded),
                           problem.active_mask).t().contiguous()
        s_p, s_1 = s_k.clone(), s_k.clone()
        if beta is None:
            beta = torch.rand(r, generator=gen).cuda() * 2.0 + 0.1
        if philox:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
            _, de_k, c_k = fused(s_k, beta, seed)
            _, de_1, c_1 = flat(s_1, beta, seed)
            u = mc.philox_uniforms(seed, problem.n_padded, r, device="cuda")
        else:
            u = torch.rand(problem.n_padded, r, generator=gen).cuda()
            _, de_k, c_k = fused.sweep_with_uniforms(s_k, beta, u)
            _, de_1, c_1 = flat.sweep_with_uniforms(s_1, beta, u)
        if twin:
            start.record()
            _, de_p, c_p = fused.reference(s_p, beta, u)
            stop.record()
            stop.synchronize()
            twin_us[label] = start.elapsed_time(stop) * 1e3
        else:  # K1 alone is the reference
            s_p, de_p, c_p = s_1, de_1, c_1
        torch.cuda.synchronize()
        worst[label] = max(worst[label], float((de_k - de_p).abs().max()))
        same = (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                and torch.equal(de_k, de_p))
        if not (same and torch.equal(s_k, s_1) and torch.equal(c_k, c_1)
                and torch.equal(de_k, de_1)):
            raise CheckFailed(
                f"{label} ({fused.kernel_name}) != twin or K1: N="
                f"{problem.n_spins} R={r} {rule} block {block} philox="
                f"{philox}: vs twin {int((s_k != s_p).sum())} spins, vs K1 "
                f"{int((s_k != s_1).sum())} spins differ")

    small = pm_j_problem(500, 3, "cuda")
    big = pm_j_problem(4096, 5, "cuda")
    for label in VARIANTS:
        for r, rule, block in ((1, "metropolis", 128), (37, "glauber", 256),
                               (256, "metropolis", 256),
                               (1024, "glauber", 128)):
            for philox in (False, True):
                compare(small, label, r, rule, block, philox)
        # the slice's shape: against the twin (its sweep timed last) and K1
        # in Philox mode at block 128, and against K1 with host uniforms at
        # block 256; beta 0.05 as K1's check there, so replicas flip
        beta = torch.full((1024,), 0.05, device="cuda")
        compare(big, label, 1024, "glauber", 256, False, twin=False, beta=beta)
        compare(big, label, 1024, "metropolis", 128, True, beta=beta)
    check(True, "K5, K6 (2, 4 chains), K7 on +-J N=500, R in {1, 37, 256, "
                "1024}, both rules, blocks 128/256, host-uniform and Philox "
                "sweeps: spins, dE, counts bitwise equal to each variant's "
                "twin and to K1; at N=4096, R=1024 (the slice's shape) "
                "bitwise equal to the twin and K1 at block 128 (Philox) and "
                "to K1 at block 256 (host uniforms)")
    stats["variant_err"] = worst
    stats["variant_twin_us"] = twin_us


def _variant_run(torch, mc, problem, flags, sweeps, chunk):
    """sa's sweep step through CudaFusedEngine(**flags) on the SA config of
    the dense slice (its seeds, its schedule), with the anneal's exact
    resync every ``chunk`` sweeps. Returns (state, engine, worst relative
    error of the tracked energy against the exact one at a resync)."""
    import dataclasses

    from spinglass_tpu_torch.anneal import sa
    from spinglass_tpu_torch.anneal.engines import CudaFusedEngine

    cfg = sa.SAConfig(n_sweeps=sweeps, n_replicas=1024)
    engine = CudaFusedEngine(problem, block_size=cfg.block_size, **flags)
    state = sa.init_state(problem, cfg, engine)
    worst = 0.0
    for _ in range(sweeps // chunk):
        for _ in range(chunk):
            state = sa._one_sweep(problem, cfg, engine, state)
        exact = engine.energy(state.spins)
        worst = max(worst, float(((state.energy - exact).abs()
                                  / exact.abs().clamp(min=1.0)).max()))
        state = dataclasses.replace(state, energy=exact)
    torch.cuda.synchronize()
    return state, engine, worst


def variant_slice(torch, mc, stats):
    """Phase 4 (variants): the dense slice's 500 sweeps through each
    variant, on the SK instance and on a +-J instance against K1."""
    sk = stats["sk"]
    stats["variant_launches"] = {}
    for label, flags in VARIANTS.items():
        state, engine, rel = _variant_run(torch, mc, sk, flags, 500, 50)
        name = engine.fused.kernel_name
        launches = engine.launches[name]
        stats["variant_launches"][name] = (
            stats["variant_launches"].get(name, 0) + launches)
        e_n = float(state.best_energy.min()) / 4096
        check(launches == 500 and e_n <= -0.72 and rel <= 1e-4,
              f"{label} ({name}): SK N=4096 R=1024, 500 sweeps of the SA "
              f"schedule: launched {launches} times, best E/N {e_n:.5f} <= "
              f"-0.72, energy identity max rel err {rel:.3e} <= 1e-4")
    pm = pm_j_problem(4096, 9, "cuda")
    ref, _, _ = _variant_run(torch, mc, pm, {}, 500, 50)
    for label, flags in VARIANTS.items():
        state, engine, _ = _variant_run(torch, mc, pm, flags, 500, 50)
        check(torch.equal(state.spins, ref.spins)
              and torch.equal(state.best_energy, ref.best_energy),
              f"{label}: +-J N=4096 R=1024, 500 Philox sweeps: spins and "
              f"best energies bitwise equal to K1's")


def variant_timing(torch, mc, stats, card):
    """Phase 5 (variants): us/sweep of K1 and each variant in turns; the
    twins' sweeps as phase 2 timed them."""
    sk = stats["sk"]
    beta = torch.ones(1024, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    labels = ["K1"] + list(VARIANTS)
    us = {}
    for block in (128, 256):
        sweeps = {lab: mc.FusedSweep(sk, block_size=block,
                                     **VARIANTS.get(lab, {}))
                  for lab in labels}
        s = stats["sk_spins"].clone()
        for turn in (labels, labels[::-1]):  # in turns: a b c ... c b a
            for lab in turn:
                fused = sweeps[lab]
                fused(s, beta, 1)
                start.record()
                for k in range(20):
                    fused(s, beta, 2 + k)
                stop.record()
                stop.synchronize()
                us.setdefault((lab, block), []).append(
                    start.elapsed_time(stop) * 1e3 / 20)
    for (lab, block), v in sorted(us.items(), key=lambda kv: kv[0][1]):
        print(f"  {lab:5s} N=4096 R=1024 block {block}: "
              f"{' / '.join(f'{x:.1f}' for x in v)} us/sweep [{card}]")
    for lab, t in stats["variant_twin_us"].items():
        print(f"  {lab} twin, one sweep N=4096 R=1024 block 128 (phase 2): "
              f"{t:.1f} us [{card}]")
    stats["variant_us"] = {lab: min(us[(lab, 128)]) for lab in labels}


# ---------------------------------------------------------------------------
# The sparse slice: K2 (single-call sparse sweep) and K3 (thresholds)
# ---------------------------------------------------------------------------

def pm_j_ell(n: int, seed: int):
    """Sparse +-1 couplings (average degree 6) with h on a quarter grid, as an
    EllProblem on the card: every field and dE is exact in float32."""
    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    coo = topology.sparse_random_graph_coo(n, avg_degree=6.0, dist="binary",
                                           seed=seed)
    h = np.random.default_rng(seed).integers(-8, 9, n) / 4.0
    return EllProblem.from_coo(n, *coo, h=h, device="cuda")


def _finite_diff(a, b) -> float:
    """max |a - b| where both are finite; raises unless the infinities agree."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        raise CheckFailed("infinite entries differ")
    return float((a[fa] - b[fb]).abs().max()) if bool(fa.any()) else 0.0


def sparse_parity(torch, stats):
    """Phase 2 (sparse): K2 and K3 against their twins on identical inputs."""
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    gen = torch.Generator().manual_seed(17)
    worst = {"k2": 0.0, "k3": 0.0}
    for n in (2000, 10000):
        ell = pm_j_ell(n, 42 if n == 10000 else 5)
        for rule in ("metropolis", "glauber"):
            eng = SortedSparseTEngine(ell, rule=rule, accept_kernel="single")
            for r in (128, 256, 1024):
                s_k = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                                 ell.active_mask))
                s_p = s_k.clone()
                beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
                for k in range(3):
                    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen))
                    th_k = eng.kernels.thresholds(beta, seed, r)      # K3
                    th = sc.thresholds_reference(eng.mask_col, beta, seed, r,
                                                 rule)
                    worst["k3"] = max(worst["k3"], _finite_diff(th_k, th))
                    if not torch.equal(th_k, th):
                        raise CheckFailed(f"K3 != twin at [{eng.n_sorted}, {r}]")
                    if k == 0:   # host-threshold mode on K3's output
                        _, de_k, c_k = eng.kernels.single_sweep(s_k, beta, th=th_k)
                    else:        # in-kernel Philox mode: K2(seed)
                        _, de_k, c_k = eng.kernels.single_sweep(s_k, beta, seed=seed)
                    # the twin on K3(seed)
                    _, de_p, c_p = sc.single_sweep_reference(eng.groups, s_p, th_k)
                    torch.cuda.synchronize()
                    worst["k2"] = max(worst["k2"], float((de_k - de_p).abs().max()))
                    if not (torch.equal(s_k, s_p) and torch.equal(c_k, c_p)
                            and torch.equal(de_k, de_p)):
                        raise CheckFailed(
                            f"K2 != twin: N={n} R={r} {rule} sweep {k}: "
                            f"{int((s_k != s_p).sum())} spins, "
                            f"{int((c_k != c_p).sum())} counts differ")
    check(True, "+-J sparse N=2000 and the 10k bench graph, R in {128, 256, "
                "1024}, both rules, 3 sweeps: K2 on K3(seed) and K2(seed) in "
                "Philox mode == the plain sweep on K3(seed), spins, dE, counts "
                "bitwise; K3(seed) == its twin")
    ell = pm_j_ell(10000, 42)
    eng = SortedSparseTEngine(ell, accept_kernel="single")
    for r in (1024, 4096):
        beta = torch.linspace(0.05, 3.0, r, device="cuda")
        th_k = eng.kernels.thresholds(beta, 2 ** 63 + r, r)
        th_p = sc.thresholds_reference(eng.mask_col, beta, 2 ** 63 + r, r,
                                       "metropolis")
        torch.cuda.synchronize()
        check(torch.equal(th_k, th_p), f"K3 == twin bitwise at "
                                       f"[{eng.n_sorted}, {r}] (64-bit seed)")
    stats["k2_max_abs_err"], stats["k3_max_abs_err"] = worst["k2"], worst["k3"]
    pt_driver_parity(torch)
    gaussian_identity(torch)


def pt_driver_parity(torch):
    """Two super-steps of pt.run's step through make_engine's engine (K2 at
    the TTT shape, R=128) against the same driver whose engine runs the twin
    on the kernel's Philox stream: the state must be equal bit for bit."""
    from spinglass_tpu_torch.anneal import pt
    from spinglass_tpu_torch.benchmarks import planted
    from spinglass_tpu_torch.benchmarks.headline import ttt_config
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import EllProblem, SortedSparseTEngine
    from spinglass_tpu_torch.kernels.sweeps import draw_seed

    class TwinEngine(SortedSparseTEngine):
        def sweep(self, spins_t, beta, generator):
            th = sc.thresholds_reference(self.mask_col, beta, draw_seed(generator),
                                         spins_t.shape[1], self.rule)
            return sc.single_sweep_reference(self.groups, spins_t, th)

    inst = planted.planted_gauge_coo(10000, 6.0, seed=42, frustration=0.3,
                                     magnitude="ones")
    ell = EllProblem.from_coo(inst.n_spins, inst.rows, inst.cols, inst.vals,
                              device="cuda")
    cfg = ttt_config()
    step, _, engine = pt.make_pt_step(ell, cfg)
    check(type(engine) is SortedSparseTEngine and engine._takes_single(128),
          "make_engine picks SortedSparseTEngine (K2 path) for the 128-replica PT")
    twin = TwinEngine(ell)
    twin_step, _, _ = pt.make_pt_step(ell, cfg, engine=twin)
    out = []
    for st_fn, eng in ((step, engine), (twin_step, twin)):
        state = pt.init_state(ell, cfg, torch.Generator().manual_seed(3), eng)
        for _ in range(2):
            state, _ = st_fn(state)
        out.append(state)
    a, b = out
    torch.cuda.synchronize()
    fields = ("spins", "slot", "energy", "best_energy", "best_spins",
              "exch_attempts", "exch_accepts", "acc_rate")
    diff = [k for k in fields if not torch.equal(getattr(a, k), getattr(b, k))]
    check(not diff and engine.launches["sparse_sweep"] == 20
          and twin.launches["sparse_sweep"] == 0
          and engine.launches["sparse_accept"] == 0,
          f"+-J planted 10k, 128 replicas: 2 super-steps of pt's step, kernel "
          f"engine == twin engine bitwise in {', '.join(fields)} (differ: "
          f"{diff or 'none'}; exchanges accepted {int(a.exch_accepts.sum())})")


def gaussian_identity(torch):
    """Gaussian couplings: E0 + dE == E1 after one sweep, on K2 (R=1024) and
    on the threshold path (K3 + the plain sweep, R=4096)."""
    from spinglass_tpu_torch.anneal.engines import make_engine
    from spinglass_tpu_torch.benchmarks.headline import sparse_bench_problem
    from spinglass_tpu_torch.core.problem import random_spins

    ell = sparse_bench_problem()
    eng = make_engine(ell, r_hint=1024)
    gen = torch.Generator().manual_seed(5)
    for r, path in ((1024, "K2"), (4096, "K3 + plain sweep")):
        s = eng.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
        e0 = eng.energy(s)
        before = dict(eng.launches)
        s, de, cnt = eng.sweep(s, torch.full((r,), 1.0, device="cuda"), gen)
        e1 = eng.energy(s)
        torch.cuda.synchronize()
        rel = float(((e0 + de - e1).abs() / e1.abs().clamp(min=1.0)).max())
        key = "sparse_sweep" if r == 1024 else "sparse_thresholds"
        check(rel <= 1e-4 and eng.launches[key] == before[key] + 1,
              f"Gaussian 10k R={r} ({path}): E0 + dE == E1, max rel err "
              f"{rel:.3e} <= 1e-4; acceptance {float(cnt.sum()) / (r * 1e4):.4f}")


def sparse_philox(torch):
    """Phase 3 (sparse): K2's Philox stream against exact enumeration."""
    import itertools as it

    import numpy as np

    from spinglass_tpu_torch.core import topology
    from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
    from spinglass_tpu_torch.kernels.sparse import EllProblem, SortedSparseTEngine

    n, beta_v, r, sweeps = 6, 0.6, 512, 400
    j = topology.fully_connected(n, dist="gaussian", scale=0.4, seed=11)
    h = np.random.default_rng(11).normal(0, 0.2, n)
    ell = EllProblem.from_problem(IsingProblem.from_dense(j, h, device="cuda"))
    eng = SortedSparseTEngine(ell)
    states = np.array(list(it.product([-1.0, 1.0], repeat=n)))
    logw = -beta_v * np.array([-0.5 * s @ j @ s - h @ s for s in states])
    probs = np.exp(logw - logw.max())
    probs /= probs.sum()
    gen = torch.Generator().manual_seed(1)
    s = eng.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
    beta = torch.full((r,), beta_v, device="cuda")
    trace = []
    for k in range(sweeps):
        s, _, _ = eng.sweep(s, beta, gen)
        if k >= 100:
            trace.append(eng.from_layout(s)[:, :n].clone())
    samples = torch.cat(trace).cpu().numpy()
    codes = ((samples > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    state_codes = ((states > 0) * (2 ** np.arange(n))).sum(axis=1).astype(int)
    emp = np.bincount(codes, minlength=2 ** n) / len(codes)
    tv = 0.5 * np.abs(emp[state_codes] - probs).sum()
    check(tv < 0.05 and eng.launches["sparse_sweep"] == sweeps,
          f"6-spin EllProblem ({eng.n_colors} colours), R=512, 400 K2 Philox "
          f"sweeps, beta=0.6: TV {tv:.4f} < 0.05")


def sparse_slice(torch, stats):
    """Phase 4 (sparse): sparse SA, time-to-target and the K3 path of PT,
    through the user's entry points."""
    import numpy as np

    from spinglass_tpu_torch import SAConfig, anneal
    from spinglass_tpu_torch.anneal import pt, sa
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.benchmarks.planted import time_to_target
    from spinglass_tpu_torch.kernels.sparse import sparse_energy

    ell = headline.sparse_bench_problem()
    cfg = SAConfig(n_sweeps=500, n_replicas=1024)
    eng = sa.make_sweep_engine(ell, cfg)
    state = sa.init_state(ell, cfg, eng)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        sa.run_chunk(ell, cfg, eng, state, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check(True, "a chunk of sparse sweeps (K2) runs under "
                "set_sync_debug_mode('error'): no host sync inside a chunk")

    def best_check(res, what):
        s = torch.ones(1, ell.n_padded, device="cuda")
        s[0, :ell.n_spins] = torch.as_tensor(res.best_spins, device="cuda")
        e = float(sparse_energy(ell, s)[0])
        rel = abs(e - res.best_energy) / abs(e)
        check(rel <= 1e-3 and np.isfinite(res.energy_history).all(),
              f"{what}: best_energy {res.best_energy:.4f} == energy(best_spins) "
              f"{e:.4f} (rel {rel:.2e} <= 1e-3), finite history")

    # the counts are those of the engine each run builds: they start at 0
    t0 = time.perf_counter()
    res = anneal(ell, cfg)
    wall = time.perf_counter() - t0
    k2 = res.metadata["kernel_launches"].get("sparse_sweep", 0)
    stats["k2_launches"] = k2
    print(f"  sparse anneal wall {wall:.3f} s (set-up included); sweep loop "
          f"{res.total_time:.3f} s, {res.sweeps_per_second:.1f} sweeps/s, "
          f"{res.spin_flips_per_second:.4e} flips/s, E/N "
          f"{res.best_energy / ell.n_spins:.5f}")
    check(res.metadata["engine"] == "sparse_sorted_t" and k2 == 500,
          f"anneal(10k sparse, R=1024, 500 sweeps) ran SortedSparseTEngine, "
          f"K2 launched {k2} times (500 expected), K3 "
          f"{res.metadata['kernel_launches'].get('sparse_thresholds')}")
    best_check(res, "sparse anneal")

    ttt = headline.bench_ttt(max_sweeps=20000)
    stats["ttt"] = ttt
    ex = ttt["extras"]
    for run in ex["per_seed"]:
        print(f"    seed run: {run['seconds']:.4f} s, {run['sweeps']} sweeps, "
              f"best {run['best_energy']:.3f}, hit {run['hit']}")
    check(ex["all_hit"] and ex["engine"] == "sparse_sorted_t",
          f"time_to_target on the provenance instance (hash checked), 3 seeds, "
          f"<= 20000 sweeps: all hit threshold {ex['threshold']:.3f}; median "
          f"{ttt['value']:.4f} s")

    cfg = pt.PTConfig(n_replicas=128, n_chains=32, n_sweeps=200,
                      exchange_interval=10, min_temp=0.05, max_temp=3.0)
    res = pt.run(ell, cfg)
    k3 = res.metadata["kernel_launches"]
    stats["k3_launches"] = k3.get("sparse_thresholds", 0)
    print(f"  PT R=4096: {res.total_time:.3f} s for 200 sweeps, "
          f"{res.spin_flips_per_second:.4e} flips/s, exchange rate "
          f"{pt.exchange_rate_summary(res)['mean_exchange_rate']:.3f}")
    check(res.metadata["engine"] == "sparse_sorted_t"
          and k3 == {"sparse_sweep": 0, "sparse_thresholds": 200,
                     "sparse_accept": 0},
          f"pt.run(n_chains=32, R=4096, 200 sweeps) took the threshold path: "
          f"launches {k3}")
    best_check(res, "PT R=4096")


def sparse_timing(torch, stats, card):
    """Phase 5 (sparse): K2, K3 and their twins; TTT; bench_pt10k."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse_cuda as sc
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    b = headline.bench_sparse(sweeps=1000)
    us_k2 = b["extras"]["us_per_sweep"]
    print(f"  K2 bench_sparse 10k R=1024: {us_k2:.1f} us/sweep, "
          f"{b['value']:.4e} flips/s, engine {b['extras']['engine']} [{card}]")
    ell = headline.sparse_bench_problem()
    eng = SortedSparseTEngine(ell, accept_kernel="single")
    gen = torch.Generator().manual_seed(9)
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def timed(fn, reps):
        fn()
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3 / reps

    s = eng.to_layout(random_spins(gen, (128, ell.n_padded), ell.active_mask))
    beta = torch.ones(128, device="cuda")
    us_128 = timed(lambda: eng.kernels.single_sweep(s, beta, seed=7), 200)
    s = eng.to_layout(random_spins(gen, (1024, ell.n_padded), ell.active_mask))
    beta = torch.ones(1024, device="cuda")
    th = eng.kernels.thresholds(beta, 7, 1024)
    us_twin = timed(lambda: sc.single_sweep_reference(eng.groups, s, th), 5)
    print(f"  K2 alone at R=128 (the TTT shape): {us_128:.1f} us/sweep; twin "
          f"(per-colour sweep) at R=1024: {us_twin:.1f} us/sweep [{card}]")
    beta = torch.ones(4096, device="cuda")
    us_k3 = timed(lambda: eng.kernels.thresholds(beta, 11, 4096), 50)
    us_k3_twin = timed(lambda: sc.thresholds_reference(eng.mask_col, beta, 11,
                                                       4096, "metropolis"), 5)
    print(f"  K3 [{eng.n_sorted}, 4096]: {us_k3:.1f} us/call; twin "
          f"{us_k3_twin:.1f} us/call [{card}]")
    ttt = stats["ttt"]
    print(f"  TTT median {ttt['value']:.4f} s (min {ttt['extras']['seconds_min']:.4f},"
          f" max {ttt['extras']['seconds_max']:.4f}) [{card}]")
    p = headline.bench_pt10k(sweeps=300)
    print(f"  bench_pt10k (16 replicas, 300 sweeps, {p['extras']['engine']}): "
          f"{p['value']:.4f} s, best {p['extras']['best_energy']:.3f} [{card}]")
    for name, prof in (("sparse SA chunk (R=1024)", headline.profile_sparse_chunk()),
                       ("TTT loop (R=128, 20 super-steps)", headline.profile_ttt())):
        print(f"  profile {name}: {prof['us_per_sweep']:.1f} us/sweep, kernels "
              f"{prof['device_us_per_sweep']:.1f} us/sweep, device busy "
              f"{100 * prof['device_busy_share']:.1f}% [{card}]")
        for k in prof["kernels"][:4]:
            print(f"    {k['us_per_sweep']:9.2f} us/sweep  {k['calls']:5d} calls  "
                  f"{k['name'][:80]}")
    stats.update(k2_ms=us_k2 / 1e3, k2_plain_ms=us_twin / 1e3,
                 k3_ms=us_k3 / 1e3, k3_plain_ms=us_k3_twin / 1e3)


# ---------------------------------------------------------------------------
# K4: the fused sparse accept, on the threshold path at R=4096
# ---------------------------------------------------------------------------

def accept_parity(torch, stats):
    """Phase 2 (K4): one colour against its twin, and one K4-path sweep
    against one K3-path sweep and one K2 sweep under one seed."""
    import numpy as np

    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels import sparse_cuda as sc

    gen = torch.Generator().manual_seed(29)
    ell = pm_j_ell(10000, 42)
    worst = 0.0
    for dtype in (torch.int8, torch.float32):
        for rule in ("metropolis", "glauber"):
            eng = sp.SortedSparseTEngine(ell, rule=rule, spin_dtype=dtype,
                                         accept_kernel="fused")
            for r in (128, 4096):
                s = eng.to_layout(random_spins(gen, (r, ell.n_padded),
                                               ell.active_mask))
                beta = (torch.rand(r, generator=gen) * 2.0 + 0.1).cuda()
                for off, mc_, bs in eng.groups[:2]:
                    f = sp._colour_fields(s, bs)
                    s_k, s_p = s.clone(), s.clone()
                    out = [(torch.zeros(r, device="cuda"),
                            torch.zeros(r, dtype=torch.int32, device="cuda"))
                           for _ in range(2)]
                    eng.kernels.accept(f, s_k, off, beta, 77 + off, *out[0])
                    sc.accept_reference(f, s_p, off, eng.mask_col, beta,
                                        77 + off, rule, *out[1])
                    torch.cuda.synchronize()
                    worst = max(worst, float((out[0][0] - out[1][0]).abs().max()))
                    if not (torch.equal(s_k, s_p)
                            and torch.equal(out[0][1], out[1][1])
                            and torch.equal(out[0][0], out[1][0])):
                        raise CheckFailed(
                            f"K4 != twin: {dtype} {rule} R={r} colour at "
                            f"{off}+{mc_}: {int((s_k != s_p).sum())} spins "
                            f"differ")
    check(True, "K4 on two colours of the 10k +-J graph, int8 and float32 "
                "spins, both rules, R in {128, 4096}: spins, dE, counts "
                "bitwise equal to accept_reference")
    stats["k4_max_abs_err"] = worst
    r, seed = 1024, 2 ** 63 + 5
    fused = sp.SortedSparseTEngine(ell, accept_kernel="fused")
    single = sp.SortedSparseTEngine(ell, accept_kernel="single")
    check(np.array_equal(fused.perm, single.perm),
          "the K4, K3 and K2 engines share one colour-sorted layout")
    s_rn = random_spins(gen, (r, ell.n_padded), ell.active_mask)
    beta = torch.linspace(0.05, 3.0, r, device="cuda")
    s4 = fused.to_layout(s_rn)
    s3, s2 = single.to_layout(s_rn), single.to_layout(s_rn)
    _, de4, c4 = fused._sweep_fused(s4, beta, seed)
    th = single.kernels.thresholds(beta, seed, r)
    _, de3, c3 = sp.make_sorted_t_sweep(single.groups)(s3, th)
    _, de2, c2 = single.kernels.single_sweep(s2, beta, seed=seed)
    torch.cuda.synchronize()
    check(s4.dtype == torch.int8 and torch.equal(s4.float(), s3)
          and torch.equal(s3, s2) and torch.equal(c4, c3)
          and torch.equal(c3, c2) and torch.equal(de4, de3)
          and torch.equal(de3, de2),
          f"+-J 10k, [{fused.n_sorted}, {r}], one seed: K4 path (int8) == "
          f"K3 path == K2, spins, dE and counts bitwise (acceptance "
          f"{float(c4.sum()) / (r * 1e4):.4f})")


def _pt_run(torch, ell, cfg, engine, gen_seed, n_super):
    """n_super super-steps of pt's step through ``engine`` from a fresh
    state; returns (state, seconds of the super-steps)."""
    from spinglass_tpu_torch.anneal import pt

    step, _, _ = pt.make_pt_step(ell, cfg, engine=engine)
    state = pt.init_state(ell, cfg, torch.Generator().manual_seed(gen_seed),
                          engine)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_super):
        state, _ = step(state)
    torch.cuda.synchronize()
    return state, time.perf_counter() - t0


def pt_accept_config():
    from spinglass_tpu_torch.anneal import pt

    return pt.PTConfig(n_replicas=128, n_chains=32, n_sweeps=200,
                       exchange_interval=10, min_temp=0.05, max_temp=3.0)


def accept_slice(torch, stats):
    """Phase 4 (K4): PT at R=4096 through make_pt_step with the fused
    engine, against the K3 path under the same generator seed."""
    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.kernels.sparse import SortedSparseTEngine

    ell = headline.sparse_bench_problem()
    cfg = pt_accept_config()
    # new engines: their launch counts start at 0 and hold only this run's
    eng4 = SortedSparseTEngine(ell, accept_kernel="fused")
    eng3 = SortedSparseTEngine(ell)
    a, sec4 = _pt_run(torch, ell, cfg, eng4, cfg.seed, 20)
    b, sec3 = _pt_run(torch, ell, cfg, eng3, cfg.seed, 20)
    stats["k4_launches"] = eng4.launches["sparse_accept"]
    stats["pt_wide"] = ell, {"K3 path": eng3, "K4 path": eng4}
    rel = float(((a.best_energy - b.best_energy).abs()
                 / b.best_energy.abs().clamp(min=1.0)).max())
    rel_e = float(((a.energy - b.energy).abs()
                   / b.energy.abs().clamp(min=1.0)).max())
    print(f"  PT R=4096, 200 sweeps: K4 path {sec4:.3f} s, K3 path "
          f"{sec3:.3f} s; best E/N {float(a.best_energy.min()) / ell.n_spins:.5f}")
    # the K3 path carries float32 spins (the engine built K2's tables, which
    # R=4096 exceeds), the K4 path int8
    check(a.spins.dtype == torch.int8 and torch.equal(a.spins.float(), b.spins)
          and torch.equal(a.slot, b.slot) and rel <= 1e-4 and rel_e <= 1e-4,
          f"make_pt_step(SortedSparseTEngine(accept_kernel='fused')), 32 "
          f"chains x 128, 200 sweeps == the K3 path under one seed: spins and "
          f"slots bitwise, energies within {max(rel, rel_e):.2e} <= 1e-4")
    l4, l3 = eng4.launches, eng3.launches
    check(l4["sparse_accept"] == 200 * len(eng4.groups)
          and l4["sparse_thresholds"] == 0 and l4["sparse_sweep"] == 0
          and l3["sparse_thresholds"] == 200 and l3["sparse_accept"] == 0,
          f"launches: K4 path {l4}, K3 path {l3}")


def accept_timing(torch, stats, card):
    """Phase 5 (K4): the K4 path against the K3 path at R=4096, one run
    each (headline.profile_pt_wide has their device breakdowns); K4 alone
    against its twin over one sweep's colours."""
    from spinglass_tpu_torch.core.problem import random_spins
    from spinglass_tpu_torch.kernels import sparse as sp
    from spinglass_tpu_torch.kernels import sparse_cuda as sc

    ell, engines = stats["pt_wide"]
    cfg = pt_accept_config()
    for label in ("K3 path", "K4 path"):
        _, sec = _pt_run(torch, ell, cfg, engines[label], 7, 5)
        print(f"  {label} PT R=4096 (5 super-steps): {sec / 50 * 1e3:.3f} "
              f"ms/sweep [{card}]")
    eng = engines["K4 path"]
    r = 4096
    gen = torch.Generator().manual_seed(3)
    s = eng.to_layout(random_spins(gen, (r, ell.n_padded), ell.active_mask))
    beta = torch.ones(r, device="cuda")
    fields = [(off, sp._colour_fields(s, bs)) for off, _, bs in eng.groups]
    de = torch.zeros(r, device="cuda")
    cnt = torch.zeros(r, dtype=torch.int32, device="cuda")
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))

    def one_sweep(fn):
        start.record()
        for off, f in fields:
            fn(f, s, off, beta, 11, de, cnt)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) * 1e3

    one_sweep(eng.kernels.accept)
    us_k4 = min(one_sweep(eng.kernels.accept) for _ in range(5))
    us_twin = one_sweep(lambda f, s_, off, b, seed, d, c: sc.accept_reference(
        f, s_, off, eng.mask_col, b, seed, "metropolis", d, c))
    print(f"  K4 alone over one sweep's {len(fields)} colours at "
          f"[{eng.n_sorted}, {r}] (fields precomputed): {us_k4:.1f} us; twin "
          f"{us_twin:.1f} us [{card}]")
    stats.update(k4_ms=us_k4 / 1e3, k4_plain_ms=us_twin / 1e3)


def main() -> int:
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, "spinglass_tpu_torch")):
        print("FAIL: spinglass_tpu_torch/ not found beside chip_smoke.py",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    stats: dict = {}
    t_start = time.perf_counter()
    try:
        from spinglass_tpu_torch.benchmarks.headline import device_description
        from spinglass_tpu_torch.kernels import build
        from spinglass_tpu_torch.kernels import metropolis_cuda as mc
        from spinglass_tpu_torch.kernels import sparse_cuda as sc

        card = device_description()
        print(card)
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; {TF32_NOTE}")
        print("phase 1: build (one nvcc per source, all at once)")
        t0 = time.perf_counter()
        libs = build.build_many(list(KERNELS))
        print(f"  built {len(libs)} libraries in {time.perf_counter() - t0:.2f} s")
        for lib in libs:
            print(f"  {os.path.relpath(lib, HERE)}")
            with open(lib + ".log") as f:
                for line in f:
                    if "registers" in line or "spill" in line or "seconds" in line:
                        print("    " + line.strip())
        for name in (mc.KERNEL_NAME, mc.PIPELINED_KERNEL, mc.INTERLEAVED_KERNEL,
                     mc.FOLDED_KERNEL):
            mc.load_kernel(name)
        sc.load_kernels()
        sc.load_accept_kernel()
        for name, phase in (
                ("phase 2: parity with the twins (K1)", lambda: phase_parity(torch, mc, stats)),
                ("phase 2: parity with the twins (K2, K3)", lambda: sparse_parity(torch, stats)),
                ("phase 2: parity with the twins and K1 (K5, K6, K7)",
                 lambda: variant_parity(torch, mc, stats)),
                ("phase 2: parity with the twin, K3 and K2 (K4)", lambda: accept_parity(torch, stats)),
                ("phase 3: in-kernel Philox (K1)", lambda: phase_philox(torch, mc, stats)),
                ("phase 3: in-kernel Philox (K2)", lambda: sparse_philox(torch)),
                ("phase 4: dense SA slice", lambda: phase_slice(torch, mc, stats)),
                ("phase 4: sparse SA, TTT and PT slice", lambda: sparse_slice(torch, stats)),
                ("phase 4: dense SA slice through K5, K6, K7",
                 lambda: variant_slice(torch, mc, stats)),
                ("phase 4: PT at R=4096 through K4", lambda: accept_slice(torch, stats)),
                ("phase 5: timing (K1)", lambda: phase_timing(torch, mc, stats, card)),
                ("phase 5: timing (K2, K3)", lambda: sparse_timing(torch, stats, card)),
                ("phase 5: timing (K5, K6, K7)", lambda: variant_timing(torch, mc, stats, card)),
                ("phase 5: timing (K4)", lambda: accept_timing(torch, stats, card))):
            print(name)
            t0 = time.perf_counter()
            phase()
            print(f"  ({time.perf_counter() - t0:.1f} s)")
    except Exception:  # report any failure of any phase, then exit non-zero
        traceback.print_exc()
        print("FAIL", file=sys.stderr)
        return 1
    rows = [(mc.KERNEL_NAME, stats["launches"], stats["max_abs_err"],
             stats["ms"], stats["plain_ms"]),
            ("sparse_sweep", stats["k2_launches"], stats["k2_max_abs_err"],
             stats["k2_ms"], stats["k2_plain_ms"]),
            ("sparse_thresholds", stats["k3_launches"], stats["k3_max_abs_err"],
             stats["k3_ms"], stats["k3_plain_ms"]),
            ("sparse_accept", stats["k4_launches"], stats["k4_max_abs_err"],
             stats["k4_ms"], stats["k4_plain_ms"])]
    err, us, twin_us = (stats["variant_err"], stats["variant_us"],
                        stats["variant_twin_us"])
    for name, labels in ((mc.PIPELINED_KERNEL, ("K5",)),
                         (mc.INTERLEAVED_KERNEL, ("K6x2", "K6x4")),
                         (mc.FOLDED_KERNEL, ("K7",))):
        # K6's times are those of 2 chains; its launches are both runs'
        rows.append((name, stats["variant_launches"][name],
                     max(err[lab] for lab in labels), us[labels[0]] / 1e3,
                     twin_us[labels[0]] / 1e3))
    print(f"total {time.perf_counter() - t_start:.1f} s (build included)")
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda",
        "source": f"spinglass_tpu_torch/csrc/{name}.cu",
        "replaces": KERNELS[name], "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms}
        for name, launches, err, ms, plain_ms in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
