"""Combinatorial problems encoded as Ising models, the counterpart of
``spinglass_tpu.problems``: each template encodes an instance into an
``IsingProblem`` on its device (the card unless ``device=`` names one),
solves it with the port's annealers and decodes the best spins.
``PROBLEM_REGISTRY`` maps the command line's problem names to the classes."""

from spinglass_tpu_torch.problems.base import ProblemTemplate, ProblemSolution
from spinglass_tpu_torch.problems.maxcut import MaxCutProblem
from spinglass_tpu_torch.problems.routing import (TSPProblem, VRPProblem,
                                            VRPArcProblem, distance_matrix)
from spinglass_tpu_torch.problems.scheduling import (
    SchedulingProblem, JobShopScheduling, Task, Agent,
)
from spinglass_tpu_torch.problems.resource import (
    ResourceAllocationProblem, Resource, Demand,
)
from spinglass_tpu_torch.problems.coordination import (
    CoordinationProblem, CoordAgent, CoordTask,
)
from spinglass_tpu_torch.problems.qap import QuadraticAssignmentProblem
from spinglass_tpu_torch.problems.simple_scheduler import SimpleScheduler

PROBLEM_REGISTRY = {
    "maxcut": MaxCutProblem,
    "tsp": TSPProblem,
    "vrp": VRPProblem,
    "vrp_arc": VRPArcProblem,
    "scheduling": SchedulingProblem,
    "jobshop": JobShopScheduling,
    "resource": ResourceAllocationProblem,
    "coordination": CoordinationProblem,
    "qap": QuadraticAssignmentProblem,
    "simple_scheduler": SimpleScheduler,
}
