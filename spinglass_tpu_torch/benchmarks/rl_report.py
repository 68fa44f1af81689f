"""Does the trained RL controller beat the fixed schedules? ``learning_report``
on the card at the RL bench's width and on the planted 10k instance.

    python -m spinglass_tpu_torch.benchmarks.rl_report [--updates 512]
        [--seeds 5] [--out chiprun_out/rl_report.json] [--only sk|planted]

Two runs of ``rl.evaluate.learning_report`` (PPO trained through its
captured update, then the trained greedy controller, the geometric schedule
and the uniform random controller rolled out at an equal sweep budget over
``--seeds`` seeds, with Welch-t p-values):

  * ``sk``: the SK glass at N=512 with 256 envs (``headline.rl_bench_setup``:
    10 sweeps per env step through K1, episodes of 50 steps from a
    log-uniform start temperature in [0.1, 20], rollouts of 8);
  * ``planted``: the planted 10k instance of
    ``spinglass_tpu/benchmarks/ttt_provenance.json`` (``headline
    .ttt_instance``, hash checked) with 128 envs, the same env and PPO
    settings: its sweeps run through K2.

Prints one JSON line per run (per-seed mean best energies, the p-values,
the training's env steps/s, the engine and its launches, the card) and
writes them all to ``--out``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def run(name: str, updates: int, seeds: int) -> dict:
    import torch

    from spinglass_tpu_torch.benchmarks import headline
    from spinglass_tpu_torch.kernels import build
    from spinglass_tpu_torch.rl import env as env_mod
    from spinglass_tpu_torch.rl import evaluate

    problem, env_cfg, ppo_cfg = headline.rl_bench_setup(n_updates=updates)
    best_known = None
    if name == "planted":
        problem, prov = headline.ttt_instance()
        env_cfg = dataclasses.replace(env_cfg, n_envs=128)
        best_known = prov["best_known_energy"]
    engine = env_mod.default_engine(problem, env_cfg)
    launches0 = build.launch_snapshot()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    report = evaluate.learning_report(problem, env_cfg, ppo_cfg,
                                      n_seeds=seeds, engine=engine)
    torch.cuda.synchronize()
    curve = report.pop("learning_curve")
    return {"run": name, "n_spins": problem.n_spins,
            "n_envs": env_cfg.n_envs, "n_updates": report["n_updates"],
            "seconds": time.perf_counter() - t0,
            "sweeps_per_episode": env_cfg.max_steps * env_cfg.sweeps_per_step,
            "learning_curve_per_spin": [
                curve[i] / problem.n_spins
                for i in sorted({0, len(curve) // 4, len(curve) // 2,
                                 len(curve) - 1})],
            "best_known_energy": best_known,
            "engine": engine.name, "kernel_launches": build.launches_since(
                launches0, engine.kernel_names),
            "nvidia_smi": headline.device_description(), **report}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--updates", type=int, default=512)
    ap.add_argument("--seeds", type=int, default=5)
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "rl_report.json"))
    ap.add_argument("--only", choices=("sk", "planted"), default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    out = []
    for name in ("sk", "planted"):
        if args.only in (None, name):
            out.append(run(name, args.updates, args.seeds))
            print(json.dumps(out[-1]), flush=True)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
