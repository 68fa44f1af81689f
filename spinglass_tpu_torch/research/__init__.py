"""The research layer of the port: quantum-inspired annealing (SQA, PIMC),
the novel annealers (AQIA, MSHO, LESD, QEC), validation statistics, Pareto
optimisation, federated rounds, meta-optimisation, meta-RL, the unified and
breakthrough frameworks and scaling fits, with the JAX package's
``spinglass_tpu.research`` exports. Every method that anneals goes through
the port's ``sa.anneal`` / ``pt.run`` / ``adaptive_anneal``: K1 on the
card."""

from spinglass_tpu_torch.research.quantum import (
    SQAConfig, PIMCConfig, simulated_quantum_annealing,
    path_integral_monte_carlo, trotterize, j_perp,
)
from spinglass_tpu_torch.research.novel import (
    AQIAConfig, MSHOConfig, LESDConfig,
    adaptive_quantum_inspired_annealing, multi_scale_optimization,
    learning_enhanced_dynamics, compare_algorithms, ALGORITHM_REGISTRY,
)
from spinglass_tpu_torch.research.validation import (
    ExperimentalValidation, welch_t, cohens_d, bootstrap_ci,
)
from spinglass_tpu_torch.research.pareto import (
    ParetoArchive, MultiObjectiveConfig, optimize as pareto_optimize,
    dominates,
)
from spinglass_tpu_torch.research.federated import (
    FederatedAnnealingServer, FederatedConfig, ClientReport,
)
from spinglass_tpu_torch.research.meta import (
    MetaOptimizer, ScheduleMemory, characterize, select_algorithm,
)
from spinglass_tpu_torch.research.federated import (
    FederatedQuantumHybridOptimizer,
)
from spinglass_tpu_torch.research.unified import (
    ProblemAnalyzer, AlgorithmSelector, UnifiedResearchFramework,
    ProblemAnalysis,
)
from spinglass_tpu_torch.research.breakthrough import (
    AdaptiveNeuralAnnealer, BreakthroughConfig, BreakthroughResearchFramework,
    FederatedOptimizationNetwork, QuantumErrorCorrectedAnnealer,
)
from spinglass_tpu_torch.research.meta_rl import (
    AdaptiveMetaRLAgent, EpisodicMemory, MetaLearningNetwork, MetaRLConfig,
    NeuralArchitectureSearch, ProblemCharacterizer, fit_meta_network,
)
