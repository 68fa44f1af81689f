"""One rank of the 2-rank gloo group that tests/test_torch_distributed.py
spawns (not a test module: pytest does not collect it). Imports the port
only, never JAX.

    python tests/torch_dist_child.py RANK WORLD PORT DIR

Reads DIR/in.npz and DIR/spec.json (written by the test module), runs each
case on its shard and writes DIR/rank{RANK}.npz: the sharded PT super-steps
on given uniforms (dense through the blocked engine, sparse through the
transposed engine), ``pt_sharded.run`` on its own draws, the model-sharded
sweeps, two sharded PPO updates, and the multihost helpers' answers.
"""

import dataclasses
import json
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from spinglass_tpu_torch.anneal import pt  # noqa: E402
from spinglass_tpu_torch.anneal.engines import BlockedEngine  # noqa: E402
from spinglass_tpu_torch.core.problem import IsingProblem  # noqa: E402
from spinglass_tpu_torch.distributed import (model_sharded, multihost,  # noqa: E402
                                             pt_sharded, rl_sharded)
from spinglass_tpu_torch.kernels import sparse as S  # noqa: E402
from spinglass_tpu_torch.rl import env as env_mod  # noqa: E402
from spinglass_tpu_torch.rl import ppo as ppo_mod  # noqa: E402


class GivenSharded(pt_sharded.ShardedEngine):
    """The sharded wrapper sweeping on the next given uniforms of all R
    replicas (its slice taken by ``sweep_with_uniforms``)."""

    def __init__(self, engine, mesh, queue):
        super().__init__(engine, mesh)
        self.queue = queue

    def sweep(self, spins, beta, generator):
        return self.sweep_with_uniforms(spins, beta,
                                        torch.as_tensor(self.queue.pop(0)))


def problem_of(z, p, spec):
    if spec["kind"] == "dense":
        return IsingProblem.from_dense(z[p + "j"], z[p + "h"], device="cpu")
    return S.EllProblem.from_coo(int(spec["n"]), z[p + "rows"], z[p + "cols"],
                                 z[p + "vals"], device="cpu")


def pt_given(z, p, spec, mesh, rank, world):
    """Super-steps on the JAX key chain's uniforms from the JAX start
    state: this rank's state after each, and the stats."""
    prob = problem_of(z, p, spec)
    cfg = pt.PTConfig(**spec["cfg"])
    inner = (BlockedEngine(prob, block_size=cfg.block_size)
             if spec["kind"] == "dense" else S.SortedSparseTEngine(prob))
    queue = [z[p + "u"][i] for i in range(z[p + "u"].shape[0])]
    ex_u = [z[p + "xu"][i] for i in range(z[p + "xu"].shape[0])]
    eng = GivenSharded(inner, mesh, queue)
    step, _, _, eng, shard = pt_sharded.make_sharded_pt_step(prob, cfg, mesh,
                                                             engine=eng)
    d = eng.replica_dim

    def local(x):
        return torch.as_tensor(np.ascontiguousarray(
            np.take(x, range(shard.start, shard.stop), axis=d)))

    dtype = torch.int8 if spec["kind"] == "sparse" else torch.float32
    state = pt.PTState(
        spins=local(z[p + "spins"]).to(dtype),
        slot=torch.as_tensor(z[p + "slot"][shard]),
        energy=torch.as_tensor(z[p + "energy"][shard]),
        best_energy=torch.as_tensor(z[p + "energy"][shard]),
        best_spins=local(z[p + "spins"]).to(dtype),
        generator=torch.Generator().manual_seed(0), sweep=0,
        exch_attempts=torch.as_tensor(z[p + "att"]),
        exch_accepts=torch.as_tensor(z[p + "acc"]),
        acc_rate=torch.zeros(shard.stop - shard.start))
    orig = pt._exchange_draws
    pt._exchange_draws = lambda cfg, gen, dev: (None, torch.as_tensor(
        ex_u.pop(0)))
    out = {}
    try:
        for k in range(spec["steps"]):
            state, stats = step(state)
            for name in ("spins", "slot", "energy", "best_energy",
                         "best_spins", "acc_rate", "exch_attempts",
                         "exch_accepts"):
                out[f"{p}s{k}_{name}"] = getattr(state, name).numpy().copy()
            for name, v in stats.items():
                out[f"{p}s{k}_stat_{name}"] = v.numpy().copy()
    finally:
        pt._exchange_draws = orig
    assert not queue and not ex_u
    return out


def pt_run(z, p, spec, mesh):
    """``pt_sharded.run`` on its own draws (seed ``cfg.seed``)."""
    prob = problem_of(z, p, spec)
    res = pt_sharded.run(prob, pt.PTConfig(**spec["cfg"]), mesh)
    return {p + "best_spins": res.best_spins,
            p + "best_energy": np.float64(res.best_energy),
            p + "replica_best": res.replica_best_energy,
            p + "energy_history": res.energy_history,
            p + "mean_energy_history": res.mean_energy_history,
            p + "acceptance_history": res.acceptance_history,
            p + "slot_trajectory": res.metadata["slot_trajectory"],
            p + "exchange_rates": np.asarray(res.metadata["exchange_rates"]),
            p + "n_devices": np.int64(res.metadata["n_devices"]),
            p + "algorithm": np.asarray(res.algorithm)}


def model(z, mesh, rank, world):
    out = {}
    prob = IsingProblem.from_dense(z["mb_j"], z["mb_h"], device="cpu")
    s, de, cnt = model_sharded.blocked_sweep_sharded(
        prob, mesh, torch.as_tensor(z["mb_spins"]), float(z["mb_beta"]),
        torch.as_tensor(z["mb_u"]), block_size=128)
    out.update(mb_spins=s.numpy(), mb_de=de.numpy(), mb_cnt=cnt.numpy())
    # the same sweep again on the same shard (the cached row shard)
    s2, _, _ = model_sharded.blocked_sweep_sharded(
        prob, mesh, torch.as_tensor(z["mb_spins"]), float(z["mb_beta"]),
        torch.as_tensor(z["mb_u"]), block_size=128)
    out["mb_repeat_equal"] = np.bool_(torch.equal(s, s2))
    prob_c = IsingProblem.from_dense(z["mc_j"], device="cpu")
    shard = model_sharded.shard_problem_cols(prob_c, mesh)
    cols = lambda x: model_sharded.local_columns(torch.as_tensor(x), mesh)
    s, de, cnt = model_sharded.colored_sweep_sharded(
        shard, mesh, torch.as_tensor(z["mc_masks"]), cols(z["mc_spins"]),
        float(z["mc_beta"]), cols(z["mc_u"]))
    out.update(mc_spins=s.numpy(), mc_de=de.numpy(), mc_cnt=cnt.numpy())
    small = IsingProblem.from_dense(z["mb_j"][:32, :32], device="cpu")
    try:   # padded 128 over 2 ranks: 64 rows < block 128
        model_sharded.blocked_sweep_sharded(
            small, mesh, torch.ones(2, small.n_padded), 1.0,
            torch.zeros(2, small.n_padded), block_size=128)
        out["mb_raised"] = np.bool_(False)
    except ValueError:
        out["mb_raised"] = np.bool_(True)
    return out


def ppo_case(z, spec, mesh, rank):
    prob = IsingProblem.from_dense(z["ppo_j"], device="cpu")
    env_cfg = env_mod.EnvConfig(**spec["env"])
    cfg = ppo_mod.PPOConfig(**spec["ppo"])
    init_fn, update_fn, _, _ = rl_sharded.make_sharded_ppo(prob, env_cfg, cfg,
                                                           mesh)
    actions, rewards = [], []
    orig = env_mod.step

    def recording(problem, cfg_, state, action, *a, **k):
        out = orig(problem, cfg_, state, action, *a, **k)
        actions.append(action.numpy().copy())
        rewards.append(out[2].numpy().copy())
        return out

    env_mod.step = recording
    out = {}
    try:
        state = init_fn()
        for u in range(spec["updates"]):
            state, metrics = update_fn(state)
            for k, v in metrics.items():
                out[f"ppo_u{u}_{k}"] = v.numpy().copy()
    finally:
        env_mod.step = orig
    out["ppo_actions"] = np.stack(actions)
    out["ppo_rewards"] = np.stack(rewards)
    for name, v in state.params.items():
        out["ppo_param_" + name] = v.detach().numpy().copy()
    out["ppo_update"] = np.int64(state.update)
    try:
        rl_sharded.make_sharded_ppo(prob, dataclasses.replace(env_cfg,
                                                              n_envs=5),
                                    cfg, mesh)
        out["ppo_raised"] = np.bool_(False)
    except ValueError:
        out["ppo_raised"] = np.bool_(True)
    return out


def helpers(info, rank):
    mesh = multihost.replica_mesh("cpu")
    hyb = multihost.hybrid_mesh("cpu")
    sl = multihost.local_replica_slice(64)
    return {"mh_process_count": np.int64(info["process_count"]),
            "mh_process_index": np.int64(info["process_index"]),
            "mh_global_devices": np.int64(info["global_devices"]),
            "mh_backend": np.asarray(info["backend"]),
            "mh_axes": np.asarray(mesh.mesh_dim_names),
            "mh_hybrid_axes": np.asarray(hyb.mesh_dim_names),
            "mh_hybrid_shape": np.asarray(tuple(hyb.shape)),
            "mh_slice": np.asarray([sl.start, sl.stop])}


def main() -> None:
    rank, world, port, d = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                            sys.argv[4])
    info = multihost.initialize(f"localhost:{port}", world, rank,
                                device="cpu")
    with open(os.path.join(d, "spec.json")) as f:
        spec = json.load(f)
    z = np.load(os.path.join(d, "in.npz"))
    out = {}
    try:
        mesh = pt_sharded.make_mesh("cpu")
        out.update(helpers(info, rank))
        for p, s in spec["pt_given"].items():
            out.update(pt_given(z, p, s, mesh, rank, world))
        for p, s in spec["pt_run"].items():
            out.update(pt_run(z, p, s, mesh))
        out.update(model(z, model_sharded.make_mesh("cpu"), rank, world))
        out.update(ppo_case(z, spec["ppo"], rl_sharded.make_mesh("cpu"),
                            rank))
    finally:
        multihost.shutdown()
    np.savez(os.path.join(d, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main()
