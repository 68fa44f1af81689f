"""Global deployment infrastructure: i18n, compliance, multi-region.

Rebuilds the reference's global-first tier (deployment/global_infrastructure
.py:79-937 — I18nManager, ComplianceManager, CrossPlatformManager,
GlobalInfrastructureManager): message catalogs for user-facing strings,
data-handling policies per regulation, and a region registry that maps
deployment regions to accelerator availability + data-residency rules. The
JAX package's module, copied: its region table is placement data and names
TPU types, which the port keeps as they are.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

SUPPORTED_LOCALES = ("en", "es", "fr", "de", "ja", "zh")

_MESSAGES: Dict[str, Dict[str, str]] = {
    "solve.start": {
        "en": "Starting optimization",
        "es": "Iniciando optimización",
        "fr": "Démarrage de l'optimisation",
        "de": "Optimierung wird gestartet",
        "ja": "最適化を開始します",
        "zh": "开始优化",
    },
    "solve.done": {
        "en": "Optimization complete",
        "es": "Optimización completada",
        "fr": "Optimisation terminée",
        "de": "Optimierung abgeschlossen",
        "ja": "最適化が完了しました",
        "zh": "优化完成",
    },
    "solve.best_energy": {
        "en": "Best energy",
        "es": "Mejor energía",
        "fr": "Meilleure énergie",
        "de": "Beste Energie",
        "ja": "最良エネルギー",
        "zh": "最佳能量",
    },
    "error.infeasible": {
        "en": "No feasible solution found",
        "es": "No se encontró una solución factible",
        "fr": "Aucune solution réalisable trouvée",
        "de": "Keine zulässige Lösung gefunden",
        "ja": "実行可能な解が見つかりませんでした",
        "zh": "未找到可行解",
    },
    "health.ok": {
        "en": "All health checks passed",
        "es": "Todas las comprobaciones pasaron",
        "fr": "Tous les contrôles de santé ont réussi",
        "de": "Alle Prüfungen bestanden",
        "ja": "すべてのヘルスチェックに合格しました",
        "zh": "所有健康检查均已通过",
    },
}


class I18nManager:
    """Message catalog with locale fallback (reference I18nManager,
    global_infrastructure.py:79-260)."""

    def __init__(self, locale: str = "en"):
        self.locale = locale if locale in SUPPORTED_LOCALES else "en"

    def set_locale(self, locale: str) -> None:
        if locale not in SUPPORTED_LOCALES:
            raise ValueError(
                f"unsupported locale {locale!r}; one of {SUPPORTED_LOCALES}")
        self.locale = locale

    def t(self, key: str, **fmt) -> str:
        entry = _MESSAGES.get(key)
        if entry is None:
            return key
        msg = entry.get(self.locale, entry["en"])
        return msg.format(**fmt) if fmt else msg


@dataclass(frozen=True)
class CompliancePolicy:
    regulation: str               # GDPR | CCPA | PDPA
    data_retention_days: int
    requires_consent: bool
    allows_cross_border: bool
    anonymize_logs: bool


POLICIES: Dict[str, CompliancePolicy] = {
    "GDPR": CompliancePolicy("GDPR", data_retention_days=30,
                             requires_consent=True,
                             allows_cross_border=False, anonymize_logs=True),
    "CCPA": CompliancePolicy("CCPA", data_retention_days=365,
                             requires_consent=False,
                             allows_cross_border=True, anonymize_logs=True),
    "PDPA": CompliancePolicy("PDPA", data_retention_days=90,
                             requires_consent=True,
                             allows_cross_border=False, anonymize_logs=True),
}


class ComplianceManager:
    """Policy checks + consent ledger (reference ComplianceManager,
    global_infrastructure.py:261-520)."""

    def __init__(self, regulation: str = "GDPR"):
        if regulation not in POLICIES:
            raise ValueError(f"unknown regulation {regulation!r}")
        self.policy = POLICIES[regulation]
        self.consents: Dict[str, float] = {}
        self.audit: List[dict] = []

    def record_consent(self, subject_id: str) -> None:
        self.consents[subject_id] = time.time()
        self.audit.append({"event": "consent", "subject": subject_id,
                           "ts": self.consents[subject_id]})

    def can_process(self, subject_id: Optional[str] = None) -> bool:
        if not self.policy.requires_consent:
            return True
        return subject_id in self.consents

    def can_transfer(self, src_region: str, dst_region: str) -> bool:
        if src_region == dst_region:
            return True
        return self.policy.allows_cross_border

    def retention_expired(self, created_ts: float,
                          now: Optional[float] = None) -> bool:
        now = time.time() if now is None else now
        return now - created_ts > self.policy.data_retention_days * 86400

    def scrub(self, record: dict) -> dict:
        """Drop/mask PII-ish keys per policy (reference :450-520)."""
        if not self.policy.anonymize_logs:
            return dict(record)
        masked = {}
        for k, v in record.items():
            if any(t in k.lower() for t in ("user", "email", "ip", "name",
                                            "subject")):
                masked[k] = "<redacted>"
            else:
                masked[k] = v
        return masked


@dataclass(frozen=True)
class Region:
    name: str                     # e.g. us-central1
    tpu_types: tuple              # available accelerators
    jurisdiction: str             # GDPR | CCPA | PDPA
    dns_suffix: str = ""


DEFAULT_REGIONS = (
    Region("us-central1", ("v5e", "v5p"), "CCPA"),
    Region("us-east5", ("v5p",), "CCPA"),
    Region("europe-west4", ("v5e",), "GDPR"),
    Region("asia-northeast1", ("v5e",), "PDPA"),
)


class GlobalInfrastructureManager:
    """Region selection honoring residency + accelerator needs (reference
    GlobalInfrastructureManager, global_infrastructure.py:576-937)."""

    def __init__(self, regions=DEFAULT_REGIONS, home_region: str =
                 "us-central1", locale: str = "en"):
        self.regions = {r.name: r for r in regions}
        if home_region not in self.regions:
            raise ValueError(f"unknown home region {home_region!r}")
        self.home = self.regions[home_region]
        self.i18n = I18nManager(locale)
        self.compliance = ComplianceManager(self.home.jurisdiction)

    def eligible_regions(self, tpu_type: str = "v5e",
                         data_origin: Optional[str] = None) -> List[Region]:
        """Regions with the accelerator, filtered by the ORIGIN region's
        cross-border policy."""
        origin = self.regions.get(data_origin or self.home.name, self.home)
        origin_policy = POLICIES[origin.jurisdiction]
        out = []
        for r in self.regions.values():
            if tpu_type not in r.tpu_types:
                continue
            if r.name != origin.name and not origin_policy.allows_cross_border:
                continue
            out.append(r)
        return out

    def place(self, tpu_type: str = "v5e",
              data_origin: Optional[str] = None) -> Region:
        elig = self.eligible_regions(tpu_type, data_origin)
        if not elig:
            raise RuntimeError(
                f"no eligible region for tpu={tpu_type} origin={data_origin}")
        # prefer the origin region itself, else the first eligible
        origin_name = data_origin or self.home.name
        for r in elig:
            if r.name == origin_name:
                return r
        return elig[0]

    def describe(self) -> dict:
        return {
            "home": self.home.name,
            "locale": self.i18n.locale,
            "regulation": self.compliance.policy.regulation,
            "regions": sorted(self.regions),
        }
