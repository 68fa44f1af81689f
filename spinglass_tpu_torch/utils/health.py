"""Health checks (reference utils/health_checks.py:40-638): system resources,
device compute probe, model validity, micro-anneal, dependency audit.

The counterpart of ``spinglass_tpu.utils.health``. The device probe runs a
small product on the card; the micro-anneal runs the port's ``anneal`` with
its default kernel selection, so on the card it goes through K1 and a K1
that does not build or launch makes the check unhealthy. (The JAX package
asks for ``use_pallas="never"`` there only because Pallas off a TPU is
interpret mode; the port's kernel has no such slow mode.) ``device=None``
is the card, as for every entry point of the port (``resolve_device``):
without a card both checks report unhealthy unless the CPU is asked for.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from enum import Enum
from typing import Callable, List, Optional


class HealthStatus(Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    UNHEALTHY = "unhealthy"


@dataclass
class CheckResult:
    name: str
    status: HealthStatus
    message: str = ""
    duration: float = 0.0
    details: dict = field(default_factory=dict)


def check_system_resources(min_free_mem_gb: float = 0.5) -> CheckResult:
    """Reference SystemResourceCheck (health_checks.py:83-149)."""
    t0 = time.perf_counter()
    try:
        import psutil

        vm = psutil.virtual_memory()
        free_gb = vm.available / 1e9
        status = (HealthStatus.HEALTHY if free_gb >= min_free_mem_gb
                  else HealthStatus.DEGRADED)
        return CheckResult("system_resources", status,
                           f"{free_gb:.1f} GB free host memory",
                           time.perf_counter() - t0,
                           {"free_gb": free_gb, "percent": vm.percent})
    except ImportError:
        return CheckResult("system_resources", HealthStatus.DEGRADED,
                           "psutil unavailable", time.perf_counter() - t0)


def check_device_compute(device=None) -> CheckResult:
    """A 128 x 128 product on the device (reference CUDAHealthCheck,
    health_checks.py:150-224); the message names the device."""
    t0 = time.perf_counter()
    try:
        import torch

        from spinglass_tpu_torch.core.problem import resolve_device

        dev = resolve_device(device)
        x = torch.ones(128, 128, device=dev)
        ok = bool(torch.isclose(torch.matmul(x, x)[0, 0],
                                torch.tensor(128.0, device=dev)))
        name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "cpu")
        n = torch.cuda.device_count() if dev.type == "cuda" else 1
        return CheckResult(
            "device_compute",
            HealthStatus.HEALTHY if ok else HealthStatus.UNHEALTHY,
            f"device={dev} name={name} devices={n}",
            time.perf_counter() - t0,
            {"device": str(dev), "name": name, "n_devices": n})
    except Exception as e:
        return CheckResult("device_compute", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_model(problem) -> CheckResult:
    """Reference SpinGlassModelCheck (health_checks.py:225-296)."""
    t0 = time.perf_counter()
    try:
        from spinglass_tpu_torch.utils.validation import validate_problem

        validate_problem(problem)
        return CheckResult("model", HealthStatus.HEALTHY,
                           f"{problem.n_spins} spins valid",
                           time.perf_counter() - t0)
    except Exception as e:
        return CheckResult("model", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_annealer(device=None) -> CheckResult:
    """Micro-anneal end-to-end (reference AnnealerHealthCheck,
    health_checks.py:297-366): 50 sweeps of 4 replicas on a 16-spin
    ferromagnet through the port's default engine; ``details`` holds the
    engine and its kernel launches. The JAX check anneals 8 spins, whose
    complete graph the default selection sweeps by its 8 colours; 16 spins
    need 16 > ``max_colors_for_colored``, so the default engine here is the
    blocked sweep: K1 on the card."""
    t0 = time.perf_counter()
    try:
        import numpy as np

        from spinglass_tpu_torch.anneal.sa import SAConfig, anneal
        from spinglass_tpu_torch.core import topology
        from spinglass_tpu_torch.core.problem import IsingProblem

        j = topology.fully_connected(16, dist="ferromagnetic", scale=1.0)
        res = anneal(IsingProblem.from_dense(j, device=device),
                     SAConfig(n_sweeps=50, n_replicas=4,
                              enable_early_stop=False))
        ok = np.isfinite(res.best_energy) and res.best_energy <= 0
        return CheckResult(
            "annealer", HealthStatus.HEALTHY if ok else HealthStatus.UNHEALTHY,
            f"micro-anneal best={res.best_energy:.2f} "
            f"engine={res.metadata['engine']}",
            time.perf_counter() - t0,
            {"engine": res.metadata["engine"],
             "kernel_launches": res.metadata["kernel_launches"]})
    except Exception as e:
        return CheckResult("annealer", HealthStatus.UNHEALTHY, str(e),
                           time.perf_counter() - t0)


def check_dependencies() -> CheckResult:
    """Reference DependencyCheck (health_checks.py:367-431): the port's
    own dependencies."""
    t0 = time.perf_counter()
    missing = []
    for mod in ("torch", "numpy", "click"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    status = HealthStatus.HEALTHY if not missing else HealthStatus.UNHEALTHY
    return CheckResult("dependencies", status,
                       "all present" if not missing else f"missing: {missing}",
                       time.perf_counter() - t0)


DEFAULT_CHECKS: List[Callable[[], CheckResult]] = [
    check_system_resources, check_device_compute, check_annealer,
    check_dependencies,
]


def device_checks(device=None) -> List[Callable[[], CheckResult]]:
    """``DEFAULT_CHECKS`` with the device probe and the micro-anneal on
    ``device`` (None: the card)."""
    return [check_system_resources,
            lambda: check_device_compute(device),
            lambda: check_annealer(device),
            check_dependencies]


class HealthMonitor:
    """Run all checks, aggregate (reference HealthMonitor,
    health_checks.py:432-560)."""

    def __init__(self, checks: Optional[list] = None):
        self.checks = checks or list(DEFAULT_CHECKS)

    def run(self) -> dict:
        results = [c() for c in self.checks]
        worst = HealthStatus.HEALTHY
        for r in results:
            if r.status == HealthStatus.UNHEALTHY:
                worst = HealthStatus.UNHEALTHY
                break
            if r.status == HealthStatus.DEGRADED:
                worst = HealthStatus.DEGRADED
        return {
            "status": worst.value,
            "checks": {r.name: {"status": r.status.value, "message": r.message,
                                "duration": r.duration} for r in results},
        }
