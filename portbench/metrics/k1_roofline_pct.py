"""K1's share of its bound: 2 N^2 R operations per sweep on the bf16 tensor
cores against J, the spins and the vectors once through HBM
(``reference.bounds.dense_sweep``)."""

from portbench.readings import replicas, roofline_pct
from portbench.reference import bounds


def read(x):
    least, _ = bounds.dense_sweep(x.instance["n"], replicas(x))
    return roofline_pct(x, least)
