"""Enterprise security tier: key lifecycle, RBAC sessions, DP, secret sharing.

Copied from ``spinglass_tpu.utils.enterprise_security``: the port imports nothing of
the JAX package.

Parity with the reference's security demos (enterprise_security.py:78-1089
SecureKeyManager/RoleBasedAccessControl, advanced_security_framework.py:52-804
CryptographicProtocols/DifferentialPrivacy/SecureMultipartyComputation),
rebuilt on honest stdlib primitives:

* the reference "encrypts" with a repeating-XOR of the key
  (advanced_security_framework.py:85-90 — trivially breakable); here
  encryption is a counter-mode HMAC-SHA256 keystream (a real PRF-based
  stream cipher) with an encrypt-then-MAC integrity tag;
* key derivation is HKDF-style HMAC expansion with per-purpose info strings
  and versioned rotation;
* RBAC carries expiring, scope-limited session tokens checked with
  constant-time comparison, layered on the same role hierarchy as
  utils.security.TokenAuthenticator (which gates the metrics server);
* differential privacy implements the Laplace/Gaussian mechanisms with an
  epsilon-budget accountant over numpy arrays (spins/energies);
* secret sharing is additive n-of-n over int64 with modular arithmetic —
  exact reconstruction, unlike the reference's float noise shares
  (advanced_security_framework.py:230-251, which only *approximately*
  reconstruct).

This is a host-side subsystem (no torch): it protects artifacts and APIs
around the solver, not the XLA computation itself.
"""

from __future__ import annotations

import hashlib
import hmac
import json
import secrets
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from spinglass_tpu_torch.utils.security import AuditLogger  # noqa: F401 (re-export
# for callers that want the file-backed JSONL audit sink)


class MemoryAudit:
    """In-memory audit sink with the AuditLogger interface (log/entries).
    Default for the security objects; pass an AuditLogger(path=...) for a
    persistent JSONL trail."""

    def __init__(self):
        self._entries: List[Dict[str, Any]] = []

    def log(self, action: str, **details) -> None:
        self._entries.append({"ts": time.time(), "action": action,
                              **{k: str(v) for k, v in details.items()}})

    def entries(self) -> list:
        return list(self._entries)


# ---------------------------------------------------------------------------
# Key lifecycle
# ---------------------------------------------------------------------------

@dataclass
class _KeyRecord:
    key: bytes
    version: int
    created: float
    retired: Optional[float] = None


class KeyManager:
    """Master-key + per-purpose derived keys with versioned rotation.

    derive: HKDF-expand style — HMAC(master, purpose || version). Old
    versions stay decryptable until ``purge_retired``; new encryptions
    always use the latest version (reference SecureKeyManager.rotate_key,
    enterprise_security.py:183-199, which silently re-derived and lost
    decryptability of old data)."""

    def __init__(self, master_key: Optional[bytes] = None,
                 audit=None):
        self._master = master_key or secrets.token_bytes(32)
        self._purposes: Dict[str, List[_KeyRecord]] = {}
        self.audit = audit or MemoryAudit()

    def _derive(self, purpose: str, version: int) -> bytes:
        info = f"{purpose}|v{version}".encode()
        return hmac.new(self._master, info, hashlib.sha256).digest()

    def current(self, purpose: str) -> Tuple[bytes, int]:
        recs = self._purposes.setdefault(purpose, [])
        if not recs:
            recs.append(_KeyRecord(self._derive(purpose, 1), 1, time.time()))
            self.audit.log("key_created", purpose=purpose, version=1)
        rec = recs[-1]
        return rec.key, rec.version

    def by_version(self, purpose: str, version: int) -> bytes:
        for rec in self._purposes.get(purpose, []):
            if rec.version == version:
                return rec.key
        raise KeyError(f"no key version {version} for purpose {purpose!r}")

    def rotate(self, purpose: str) -> int:
        _, ver = self.current(purpose)
        recs = self._purposes[purpose]
        recs[-1].retired = time.time()
        new = _KeyRecord(self._derive(purpose, ver + 1), ver + 1, time.time())
        recs.append(new)
        self.audit.log("key_rotated", purpose=purpose, version=new.version)
        return new.version

    def purge_retired(self, purpose: str, older_than_seconds: float = 0.0
                      ) -> int:
        recs = self._purposes.get(purpose, [])
        cutoff = time.time() - older_than_seconds
        keep = [r for r in recs
                if r.retired is None or r.retired > cutoff]
        purged = len(recs) - len(keep)
        self._purposes[purpose] = keep
        if purged:
            self.audit.log("keys_purged", purpose=purpose, count=purged)
        return purged


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    """Counter-mode PRF keystream: HMAC-SHA256(key, nonce || counter)."""
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(key, nonce + counter.to_bytes(8, "big"),
                        hashlib.sha256).digest()
        counter += 1
    return bytes(out[:n])


def encrypt_array(arr: np.ndarray, key_manager: KeyManager,
                  purpose: str = "arrays") -> Dict[str, Any]:
    """Encrypt-then-MAC a numpy array (spins, couplings, results)."""
    key, version = key_manager.current(purpose)
    nonce = secrets.token_bytes(16)
    raw = np.ascontiguousarray(arr).tobytes()
    ks = _keystream(key, nonce, len(raw))
    ct = bytes(a ^ b for a, b in zip(raw, ks))
    tag = hmac.new(key, nonce + ct, hashlib.sha256).hexdigest()
    return {
        "ciphertext": ct,
        "nonce": nonce,
        "tag": tag,
        "purpose": purpose,
        "key_version": version,
        "dtype": str(arr.dtype),
        "shape": list(arr.shape),
    }


def decrypt_array(blob: Dict[str, Any], key_manager: KeyManager
                  ) -> np.ndarray:
    key = key_manager.by_version(blob["purpose"], blob["key_version"])
    nonce, ct = blob["nonce"], blob["ciphertext"]
    expect = hmac.new(key, nonce + ct, hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, blob["tag"]):
        raise ValueError("integrity check failed (wrong key or tampered)")
    ks = _keystream(key, nonce, len(ct))
    raw = bytes(a ^ b for a, b in zip(ct, ks))
    return np.frombuffer(raw, dtype=np.dtype(blob["dtype"])).reshape(
        blob["shape"]).copy()


# ---------------------------------------------------------------------------
# RBAC with expiring sessions
# ---------------------------------------------------------------------------

@dataclass
class Role:
    name: str
    # permissions: resource pattern -> allowed actions ("*" wildcards)
    permissions: Dict[str, List[str]] = field(default_factory=dict)


@dataclass
class Session:
    token: str
    user_id: str
    expires: float
    scope: List[str] = field(default_factory=list)   # empty = full role scope


DEFAULT_ROLES = {
    "admin": Role("admin", {"*": ["*"]}),
    "researcher": Role("researcher", {
        "problems/*": ["read", "write", "solve"],
        "results/*": ["read", "write"],
        "models/*": ["read", "write"],
    }),
    "operator": Role("operator", {
        "problems/*": ["read", "solve"],
        "results/*": ["read"],
        "metrics/*": ["read"],
    }),
    "viewer": Role("viewer", {
        "results/*": ["read"],
        "metrics/*": ["read"],
    }),
}


class RBAC:
    """Role-based access control + expiring session tokens (reference
    RoleBasedAccessControl, enterprise_security.py:366-569)."""

    def __init__(self, roles: Optional[Dict[str, Role]] = None,
                 audit=None):
        self.roles = dict(roles or DEFAULT_ROLES)
        self.user_roles: Dict[str, List[str]] = {}
        self.sessions: Dict[str, Session] = {}
        self.audit = audit or MemoryAudit()

    def add_role(self, role: Role) -> None:
        self.roles[role.name] = role

    def assign(self, user_id: str, role_name: str) -> None:
        if role_name not in self.roles:
            raise KeyError(f"unknown role {role_name!r}")
        self.user_roles.setdefault(user_id, [])
        if role_name not in self.user_roles[user_id]:
            self.user_roles[user_id].append(role_name)
        self.audit.log("role_assigned", user=user_id, role=role_name)

    def revoke(self, user_id: str, role_name: str) -> None:
        if role_name in self.user_roles.get(user_id, []):
            self.user_roles[user_id].remove(role_name)
            self.audit.log("role_revoked", user=user_id, role=role_name)

    def create_session(self, user_id: str, duration_seconds: float = 8 * 3600,
                       scope: Optional[Sequence[str]] = None) -> str:
        token = secrets.token_urlsafe(32)
        self.sessions[token] = Session(
            token=token, user_id=user_id,
            expires=time.time() + duration_seconds,
            scope=list(scope or []))
        self.audit.log("session_created", user=user_id,
                       scoped=bool(scope))
        return token

    def validate_session(self, token: str) -> Optional[Session]:
        for stored, sess in self.sessions.items():
            if hmac.compare_digest(stored, token):
                if time.time() > sess.expires:
                    del self.sessions[stored]
                    self.audit.log("session_expired", user=sess.user_id)
                    return None
                return sess
        return None

    @staticmethod
    def _match(pattern: str, value: str) -> bool:
        if pattern == "*":
            return True
        if pattern.endswith("/*"):
            return value.startswith(pattern[:-1]) or value == pattern[:-2]
        return pattern == value

    def has_permission(self, user_id: str, resource: str, action: str,
                       token: Optional[str] = None) -> bool:
        """Role check; with ``token`` also enforces session validity and
        scope (a scoped session can only touch its listed resources)."""
        if token is not None:
            sess = self.validate_session(token)
            ok_sess = (sess is not None and sess.user_id == user_id
                       and (not sess.scope or any(
                           self._match(s, resource) for s in sess.scope)))
            if not ok_sess:
                self.audit.log("access_denied", user=user_id,
                               resource=resource, op=action,
                               reason="session")
                return False
        for role_name in self.user_roles.get(user_id, []):
            role = self.roles.get(role_name)
            if role is None:
                continue
            for pattern, actions in role.permissions.items():
                if self._match(pattern, resource) and (
                        "*" in actions or action in actions):
                    self.audit.log("access_granted", user=user_id,
                                   resource=resource, op=action,
                                   role=role_name)
                    return True
        self.audit.log("access_denied", user=user_id, resource=resource,
                       op=action, reason="role")
        return False


# ---------------------------------------------------------------------------
# Differential privacy
# ---------------------------------------------------------------------------

class DifferentialPrivacy:
    """Laplace/Gaussian mechanisms with an epsilon-budget accountant
    (reference DifferentialPrivacy, advanced_security_framework.py:150-211).
    Noise is drawn host-side with numpy; arrays may be energies, per-seed
    statistics, or aggregated spins."""

    def __init__(self, epsilon: float = 1.0, delta: float = 1e-5,
                 seed: Optional[int] = None):
        if epsilon <= 0:
            raise ValueError("epsilon must be positive")
        self.epsilon = float(epsilon)
        self.delta = float(delta)
        self.spent = 0.0
        self._rng = np.random.default_rng(seed)

    def _charge(self, eps: float) -> None:
        if self.spent + eps > self.epsilon + 1e-12:
            raise RuntimeError(
                f"privacy budget exhausted: spent {self.spent:.3f} + "
                f"{eps:.3f} > epsilon {self.epsilon:.3f}")
        self.spent += eps

    def remaining_budget(self) -> float:
        return max(self.epsilon - self.spent, 0.0)

    def laplace(self, arr: np.ndarray, sensitivity: float = 1.0,
                eps: Optional[float] = None) -> np.ndarray:
        eps = float(eps if eps is not None else self.epsilon / 10)
        self._charge(eps)
        scale = sensitivity / eps
        return np.asarray(arr, float) + self._rng.laplace(
            0.0, scale, np.shape(arr))

    def gaussian(self, arr: np.ndarray, sensitivity: float = 1.0,
                 eps: Optional[float] = None) -> np.ndarray:
        eps = float(eps if eps is not None else self.epsilon / 10)
        self._charge(eps)
        # analytic Gaussian mechanism calibration for (eps, delta)
        sigma = sensitivity * np.sqrt(2.0 * np.log(1.25 / self.delta)) / eps
        return np.asarray(arr, float) + self._rng.normal(
            0.0, sigma, np.shape(arr))

    def private_mean(self, arrays: Sequence[np.ndarray],
                     sensitivity: float = 1.0,
                     eps: Optional[float] = None) -> np.ndarray:
        """DP aggregation across parties: mean then one noise draw (the
        aggregate's sensitivity is sensitivity / n_parties)."""
        stack = np.stack([np.asarray(a, float) for a in arrays])
        return self.laplace(stack.mean(axis=0),
                            sensitivity=sensitivity / len(arrays), eps=eps)


# ---------------------------------------------------------------------------
# Additive secret sharing (n-of-n, exact)
# ---------------------------------------------------------------------------

_MOD = np.int64(2) ** 62


class SecretSharing:
    """Additive secret sharing over fixed-point int64 mod 2^62.

    Unlike the reference's float-noise shares
    (advanced_security_framework.py:230-261), reconstruction is EXACT up to
    the fixed-point resolution, and any n-1 shares are information-
    theoretically independent of the secret."""

    def __init__(self, n_parties: int, scale: float = 2.0 ** 20,
                 seed: Optional[int] = None):
        if n_parties < 2:
            raise ValueError("need >= 2 parties")
        self.n = int(n_parties)
        self.scale = float(scale)
        self._rng = np.random.default_rng(seed)

    def _encode(self, arr: np.ndarray) -> np.ndarray:
        fx = np.round(np.asarray(arr, float) * self.scale).astype(np.int64)
        return np.mod(fx, _MOD)

    def _decode(self, fx: np.ndarray) -> np.ndarray:
        centered = np.where(fx > _MOD // 2, fx - _MOD, fx)
        return centered.astype(float) / self.scale

    def share(self, secret: np.ndarray) -> List[np.ndarray]:
        enc = self._encode(secret)
        shares = [self._rng.integers(0, _MOD, size=enc.shape,
                                     dtype=np.int64)
                  for _ in range(self.n - 1)]
        last = np.mod(enc - np.mod(sum(shares), _MOD), _MOD)
        return shares + [last]

    def reconstruct(self, shares: Sequence[np.ndarray]) -> np.ndarray:
        total = np.mod(sum(np.asarray(s, np.int64) for s in shares), _MOD)
        return self._decode(total)

    def secure_sum(self, party_secrets: Sequence[np.ndarray]
                   ) -> np.ndarray:
        """Each party shares its input; sums of shares reconstruct the SUM
        without any party revealing its input (the aggregation the
        federated tier uses, research/federated.py)."""
        all_shares = [self.share(s) for s in party_secrets]
        summed = [np.mod(sum(np.asarray(sh[i], np.int64)
                             for sh in all_shares), _MOD)
                  for i in range(self.n)]
        return self.reconstruct(summed)


def security_report(rbac: RBAC, km: KeyManager) -> Dict[str, Any]:
    """Summary for audits (reference get_security_summary,
    enterprise_security.py:684-727)."""
    denied = [e for e in rbac.audit.entries()
              if e.get("action") == "access_denied"]
    return {
        "n_roles": len(rbac.roles),
        "n_users": len(rbac.user_roles),
        "n_active_sessions": len(rbac.sessions),
        "n_denied": len(denied),
        "key_purposes": {p: len(recs) for p, recs in km._purposes.items()},
        "generated": time.time(),
    }
