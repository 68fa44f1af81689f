"""K2's share of its bound: the instance's own couplings and spins once
through HBM, an FMA per coupling and a compare per spin, each per replica
(``reference.bounds.sparse_sweep``); the replicas are the workload's
``replicas_param`` (an env is a replica of the sweep in the RL cell)."""

from portbench.readings import nnz, replicas, roofline_pct
from portbench.reference import bounds


def read(x):
    least, _ = bounds.sparse_sweep(x.instance["n"], nnz(x), replicas(x))
    return roofline_pct(x, least)
