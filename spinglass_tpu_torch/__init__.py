"""spinglass_tpu_torch — the PyTorch/CUDA port of ``spinglass_tpu``.

The same problems, encoders, sweeps and annealing drivers, on PyTorch
tensors. Module paths and public names mirror the JAX package (the problem
classes live in ``spinglass_tpu_torch.problems``). Dense sweeps on a CUDA device
run a hand-written Hopper kernel (``kernels/metropolis_cuda.py``, source in
``csrc/``); on the CPU the same functions run in plain PyTorch. The package
imports ``torch`` and numpy, never JAX or ``spinglass_tpu``.
"""

__version__ = "0.1.0"

from spinglass_tpu_torch.core.problem import IsingProblem, random_spins
from spinglass_tpu_torch.core.energy import (
    energy, local_fields, delta_energy, magnetization,
)
from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
from spinglass_tpu_torch.anneal.schedules import ScheduleConfig, ScheduleType
from spinglass_tpu_torch.anneal.result import AnnealResult

__all__ = [
    "IsingProblem", "random_spins", "energy", "local_fields", "delta_energy",
    "magnetization", "SAConfig", "anneal", "ScheduleConfig", "ScheduleType",
    "AnnealResult",
]
