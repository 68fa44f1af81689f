from spinglass_tpu_torch.deployment.config import (
    ProductionConfig, ComputeConfig, ServiceConfig, ObservabilityConfig,
    CheckpointingConfig, Environment,
)
from spinglass_tpu_torch.deployment.global_infra import (
    I18nManager, ComplianceManager, GlobalInfrastructureManager, Region,
    CompliancePolicy, POLICIES, SUPPORTED_LOCALES,
)
