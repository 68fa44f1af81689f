"""Security utilities: path sanitization, audit logging, input size limits.

Copied from ``spinglass_tpu.utils.security``: the port imports nothing of
the JAX package.

Rebuilds the reference's security layer at the scope a solver library
actually needs (utils/security.py:17-73 sanitize+audit;
security/input_validation.py:27-453 levels/limits). The reference's RBAC/
crypto demos (enterprise_security.py, advanced_security_framework.py) are
simulated enterprise scaffolding; here the real attack surfaces are file
paths from the CLI and untrusted problem payloads."""

from __future__ import annotations

import hmac
import json
import os
import secrets
import time
from dataclasses import dataclass
from enum import Enum
from typing import Optional

import numpy as np

from spinglass_tpu_torch.utils.exceptions import ValidationError


class ValidationLevel(Enum):
    PERMISSIVE = "permissive"
    STANDARD = "standard"
    STRICT = "strict"


_LIMITS = {
    ValidationLevel.PERMISSIVE: dict(max_spins=1_000_000, max_file_mb=4096),
    ValidationLevel.STANDARD: dict(max_spins=200_000, max_file_mb=512),
    ValidationLevel.STRICT: dict(max_spins=20_000, max_file_mb=64),
}


def sanitize_path(path: str, base_dir: Optional[str] = None,
                  allowed_suffixes=(".npz", ".json", ".npy")) -> str:
    """Resolve + confine a user-supplied path (reference
    utils/security.py:17-49): no traversal outside base_dir, no unexpected
    suffixes, no special files."""
    if "\x00" in path:
        raise ValidationError("path contains NUL byte")
    resolved = os.path.realpath(path)
    if base_dir is not None:
        base = os.path.realpath(base_dir)
        if not (resolved == base or resolved.startswith(base + os.sep)):
            raise ValidationError(
                f"path {path!r} escapes base directory {base_dir!r}")
    if allowed_suffixes and not resolved.endswith(tuple(allowed_suffixes)):
        raise ValidationError(
            f"path {path!r} must end with one of {allowed_suffixes}")
    return resolved


def validate_problem_payload(j: np.ndarray, h: Optional[np.ndarray] = None,
                             level: ValidationLevel = ValidationLevel.STANDARD
                             ) -> None:
    """Bound + sanity-check an untrusted problem (reference
    input_validation.py:101-235)."""
    limits = _LIMITS[level]
    j = np.asarray(j)
    if j.ndim != 2 or j.shape[0] != j.shape[1]:
        raise ValidationError(f"J must be square, got {j.shape}")
    if j.shape[0] > limits["max_spins"]:
        raise ValidationError(
            f"{j.shape[0]} spins exceeds {level.value} limit "
            f"{limits['max_spins']}")
    if not np.all(np.isfinite(j)):
        raise ValidationError("J contains non-finite entries")
    if h is not None:
        h = np.asarray(h)
        if h.shape != (j.shape[0],):
            raise ValidationError(f"h shape {h.shape} != ({j.shape[0]},)")
        if not np.all(np.isfinite(h)):
            raise ValidationError("h contains non-finite entries")


def check_file_size(path: str,
                    level: ValidationLevel = ValidationLevel.STANDARD) -> None:
    limit = _LIMITS[level]["max_file_mb"] * 1024 * 1024
    size = os.path.getsize(path)
    if size > limit:
        raise ValidationError(
            f"file {path!r} is {size / 1e6:.0f} MB, exceeds "
            f"{level.value} limit")


@dataclass
class AuditLogger:
    """Append-only JSON-lines audit log (reference utils/security.py:50-73)."""

    path: str

    def log(self, action: str, **details) -> None:
        record = {
            "ts": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "pid": os.getpid(),
            "action": action,
            **{k: str(v) for k, v in details.items()},
        }
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def entries(self) -> list:
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


@dataclass
class TokenAuthenticator:
    """Minimal role-based bearer-token gate (the real-world core of the
    reference's simulated enterprise tier, security/enterprise_security.py:
    78-1089: API keys + RBAC + audit — without the simulation theater).

    tokens: {token: role}; require(token, role) checks membership with a
    constant-time comparison and writes an audit record when a logger is
    attached. Roles form a simple hierarchy: admin > writer > reader."""

    tokens: dict
    audit: Optional["AuditLogger"] = None

    _ROLE_RANK = {"reader": 0, "writer": 1, "admin": 2}

    def check(self, token: Optional[str], required_role: str = "reader"
              ) -> bool:
        ok = False
        granted = None
        if token:
            for t, role in self.tokens.items():
                # constant-time comparison on every candidate (no
                # early-exit timing side channel on token identity)
                if hmac.compare_digest(str(t), str(token)):
                    granted = role
            if granted is not None:
                ok = (self._ROLE_RANK.get(granted, -1)
                      >= self._ROLE_RANK.get(required_role, 0))
        if self.audit is not None:
            self.audit.log("auth_check", granted=bool(ok),
                           role=granted or "none",
                           required=required_role)
        return ok

    def issue(self, role: str = "reader") -> str:
        """Generate and register a new random token for ``role``."""
        token = secrets.token_urlsafe(32)
        self.tokens[token] = role
        if self.audit is not None:
            self.audit.log("token_issued", role=role)
        return token

    def revoke(self, token: str) -> bool:
        found = token in self.tokens
        self.tokens.pop(token, None)
        if self.audit is not None:
            self.audit.log("token_revoked", found=found)
        return found
