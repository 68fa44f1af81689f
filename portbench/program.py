"""The benchmark's bridge to the program under test, ``spinglass_tpu_torch``
(the PyTorch and CUDA port): the problem object that the program's public
constructors build from an instance as the benchmark made it."""

from __future__ import annotations


def problem(instance: dict, device):
    """A dense ``IsingProblem`` (``from_dense`` takes host arrays: J goes
    to the host once and back) or a sparse ``EllProblem`` on ``device``."""
    if instance["kind"] == "dense":
        from spinglass_tpu_torch.core.problem import IsingProblem

        return IsingProblem.from_dense(instance["j"].cpu().numpy(),
                                       device=device)
    from spinglass_tpu_torch.kernels.sparse import EllProblem

    return EllProblem.from_coo(instance["n"], instance["rows"],
                               instance["cols"], instance["vals"],
                               device=device)


def free_captured() -> None:
    """Drop every captured step the program keeps (graphs and static
    state) and hand their memory back, before the reference runs."""
    import torch

    from spinglass_tpu_torch.anneal import graphs

    graphs.clear_caches()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
