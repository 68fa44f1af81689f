"""The planted time-to-target instance, frozen with the benchmark.

A copy of the program's gauge-planting generator and its hash, kept here so
that no later change to the program can move the instance: the same
parameters give the same COO arrays and the same sha256 as the record in
``data/ttt_provenance.json``. Plain numpy.

Gauge planting: a random connected graph with positive coupling magnitudes
and a random planted state s*; J_ij = |J_ij| s*_i s*_j satisfies every bond
at s*. ``frustration`` flips that fraction of bond signs afterwards, so the
instance is a glass and the planted state's energy only an upper bound on
the ground energy.
"""

from __future__ import annotations

import hashlib
import json
import os

import numpy as np

PROVENANCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data",
                          "ttt_provenance.json")


def planted_gauge_coo(n_spins: int, avg_degree: float, seed: int,
                      frustration: float, magnitude: str):
    """(rows, cols, vals): a symmetric COO, each edge in both directions.
    ``magnitude`` "uniform" draws |J| ~ U(0.5, 1.5), "ones" |J| = 1."""
    rng = np.random.default_rng(seed)
    m = int(n_spins * avg_degree / 2)
    # m random edges plus a chain backbone, so no spin floats free
    backbone = np.stack([np.arange(n_spins - 1), np.arange(1, n_spins)], 1)
    extra = rng.integers(0, n_spins, size=(m, 2))
    extra = extra[extra[:, 0] != extra[:, 1]]
    edges = np.concatenate([backbone, extra])
    edges = np.unique(np.sort(edges, axis=1), axis=0)
    if magnitude == "uniform":
        mag = rng.uniform(0.5, 1.5, size=len(edges))
    elif magnitude == "ones":
        mag = np.ones(len(edges))
    else:
        raise ValueError(magnitude)
    s_star = rng.choice([-1.0, 1.0], size=n_spins)
    vals = mag * s_star[edges[:, 0]] * s_star[edges[:, 1]]
    if frustration > 0:
        flip = rng.random(len(edges)) < frustration
        vals = np.where(flip, -vals, vals)
    rows = np.concatenate([edges[:, 0], edges[:, 1]])
    cols = np.concatenate([edges[:, 1], edges[:, 0]])
    return rows, cols, np.concatenate([vals, vals])


def instance_hash(rows, cols, vals) -> str:
    """sha256 over rows as int64, cols as int64 and vals as float64 bytes."""
    h = hashlib.sha256()
    h.update(np.ascontiguousarray(np.asarray(rows).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(cols).astype(np.int64)).tobytes())
    h.update(np.ascontiguousarray(np.asarray(vals).astype(np.float64)).tobytes())
    return h.hexdigest()


def provenance() -> dict:
    with open(PROVENANCE) as f:
        return json.load(f)


def build(cfg: dict, seed: int, device) -> dict:
    """The instance a configuration names: the COO arrays of its spec, hash
    checked where the spec records one. The instance is fixed: ``seed``
    drives only the chains, never the couplings."""
    del seed, device
    spec = cfg["instance"]
    rows, cols, vals = planted_gauge_coo(
        spec["n_spins"], spec["avg_degree"], spec["seed"],
        spec["frustration"], spec["magnitude"])
    want = spec.get("sha256")
    if want is not None:
        got = instance_hash(rows, cols, vals)
        if got != want:
            raise RuntimeError(f"planted instance hash {got} differs from the "
                               f"record's {want}")
    out = {"kind": "coo", "n": int(spec["n_spins"]), "rows": rows,
           "cols": cols, "vals": vals}
    prov = provenance()
    if want is not None and want == prov["instance"]["sha256"]:
        # the record's instance: its best-known energy stands for the
        # ground energy, and its target lies rel_gap above it
        spec = {**spec, **{k: prov[k] for k in
                           ("best_known_energy", "rel_gap", "max_sweeps")}}
    if "best_known_energy" in spec:
        out.update(ground_energy=spec["best_known_energy"],
                   target={"energy": spec["best_known_energy"],
                           "rel_gap": spec["rel_gap"],
                           "max_sweeps": spec["max_sweeps"]})
    return out
