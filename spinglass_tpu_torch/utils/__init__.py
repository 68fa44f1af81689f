"""The port's utilities, re-exported as ``spinglass_tpu.utils`` does (its
persistent compile cache has no counterpart here)."""

from spinglass_tpu_torch.utils.exceptions import (
    SpinGlassError, ModelError, AnnealingError, DeviceError, ValidationError,
    ConvergenceError, CheckpointError,
)
from spinglass_tpu_torch.utils.logging import (
    setup_logger, get_logger, PerformanceLogger, ProgressLogger,
)
from spinglass_tpu_torch.utils import validation, monitoring, health, checkpoint
from spinglass_tpu_torch.utils.robust import robust_operation
from spinglass_tpu_torch.utils import security, cache, profiling
from spinglass_tpu_torch.utils import enterprise_security
from spinglass_tpu_torch.utils import anomaly, autoscale, metrics_exporter
from spinglass_tpu_torch.utils.anomaly import (
    AnomalyDetector, SelfHealingSystem, AdaptiveMonitoringSystem,
)
from spinglass_tpu_torch.utils.autoscale import (
    AdaptiveScaler, MultiObjectiveScaler, WorkloadPredictor,
    AutoScalingManager,
)
from spinglass_tpu_torch.utils.metrics_exporter import (
    MetricsRegistry, MetricsServer, global_registry,
)
