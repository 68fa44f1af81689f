"""Monte-Carlo sweeps in plain PyTorch: the port's CPU path.

The counterpart of ``spinglass_tpu.kernels.sweeps``, function for function.
Two exact strategies, batched over a replica axis [R, Np]:

1. **Colored sweep**: a proper colouring has no same-colour couplings, so a
   colour class updates all its spins at once (one matmul per colour).
2. **Blocked-sequential sweep**: exact sequential-equivalent Metropolis for
   dense J. A block's fields come from one matmul, then its B spins update in
   order with a rank-1 correction H += ds * J[j, block] after each decision.

Both consume caller-supplied uniforms u[R, Np] (spin i consumes u[:, i]), so
they make the same decisions as the JAX functions given the same uniforms.

Update rules:
  metropolis: accept with prob min(1, exp(-beta dE))
  glauber:    flip with prob sigmoid(-beta dE)   (== heat-bath for Ising spins)
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spinglass_tpu_torch.core.problem import IsingProblem

UPDATE_RULES = ("metropolis", "glauber", "heat_bath")


def canonical_rule(rule: str) -> str:
    """Normalise an update-rule name; ``heat_bath`` is Glauber for Ising spins."""
    if rule == "heat_bath":
        return "glauber"
    if rule not in UPDATE_RULES:
        raise ValueError(
            f"unknown update rule {rule!r}; expected one of {UPDATE_RULES}")
    return rule


def accept_prob(delta_e: torch.Tensor, beta, rule: str) -> torch.Tensor:
    rule = canonical_rule(rule)
    if rule == "metropolis":
        # clamp the exponent at 0: dE<0 is always accepted and exp stays finite
        return torch.exp(-beta * torch.clamp(delta_e, min=0.0))
    return torch.sigmoid(-beta * delta_e)


def accept_threshold(uniforms: torch.Tensor, beta, rule: str) -> torch.Tensor:
    """Exp-free acceptance: accept <=> s_i*f_i < th  (i.e. dE/2 < th).

      metropolis: u < e^{-b*dE+}  <=>  dE < -ln(u)/b
      glauber:    u < sigma(-b*dE) <=>  dE < -logit(u)/b
    Thresholds are halved so callers compare s*f = dE/2 directly. u >= 1 (the
    padding sentinel) maps to -inf (never accept). No clamp on u, as in the
    JAX function; the fused kernel's twin clamps (kernels/metropolis_cuda.py).
    """
    rule = canonical_rule(rule)
    nib = -0.5 / beta
    if rule == "metropolis":
        th = torch.log(uniforms) * nib
    else:
        th = (torch.log(uniforms) - torch.log1p(-uniforms)) * nib
    return torch.where(uniforms < 1.0, th, torch.full_like(th, -torch.inf))


def _as_replica_beta(beta, r: int, device) -> torch.Tensor:
    beta = torch.as_tensor(beta, dtype=torch.float32, device=device)
    if beta.ndim == 0:
        beta = beta.expand(r)
    return beta


# ---------------------------------------------------------------------------
# Colored sweep
# ---------------------------------------------------------------------------

def color_masks_from_colors(colors, n_padded: int, device=None) -> torch.Tensor:
    """[N_logical] int colours -> [C, Np] float masks (padding excluded)."""
    colors = np.asarray(colors)
    c = int(colors.max()) + 1 if colors.size else 1
    masks = np.zeros((c, n_padded), dtype=np.float32)
    for ci in range(c):
        masks[ci, : len(colors)] = (colors == ci).astype(np.float32)
    return torch.as_tensor(masks, device=device)


def colored_sweep(
    problem: IsingProblem,
    color_masks: torch.Tensor,  # [C, Np] float {0,1}
    spins: torch.Tensor,        # [R, Np] float +-1
    beta,                       # [] or [R]
    uniforms: torch.Tensor,     # [R, Np] in [0,1)
    rule: str = "metropolis",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One full sweep (every spin proposed once); returns new spins.
    Returns (spins, dE_sum[R], n_accepted[R])."""
    r = spins.shape[0]
    beta = _as_replica_beta(beta, r, spins.device)
    active = problem.active_mask > 0
    th = accept_threshold(uniforms, beta[:, None], rule)
    de_acc = torch.zeros(r, dtype=torch.float32, device=spins.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=spins.device)
    for mask in color_masks:
        f = torch.matmul(spins, problem.j) + problem.h
        sf = spins * f
        acc = (sf < th) & (mask > 0)[None, :] & active[None, :]
        spins = torch.where(acc, -spins, spins)
        de_acc = de_acc + torch.sum(torch.where(acc, 2.0 * sf, 0.0), dim=-1)
        cnt = cnt + torch.sum(acc, dim=-1, dtype=torch.int32)
    return spins, de_acc, cnt


# ---------------------------------------------------------------------------
# Blocked-sequential sweep (dense J)
# ---------------------------------------------------------------------------

def blocked_sweep(
    problem: IsingProblem,
    spins: torch.Tensor,     # [R, Np]
    beta,                    # [] or [R]
    uniforms: torch.Tensor,  # [R, Np]
    block_size: int = 128,
    rule: str = "metropolis",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact sequential-equivalent Metropolis sweep over dense J, in
    spin order 0..N-1; returns new spins (the input is not modified).
    Returns (spins, dE_sum[R], n_accepted[R])."""
    r, n_pad = spins.shape
    if n_pad % block_size != 0:
        raise ValueError(f"padded N={n_pad} not divisible by block_size={block_size}")
    beta = _as_replica_beta(beta, r, spins.device)
    spins = spins.clone()
    de_acc = torch.zeros(r, dtype=torch.float32, device=spins.device)
    cnt = torch.zeros(r, dtype=torch.int32, device=spins.device)
    for i0 in range(0, n_pad, block_size):
        i1 = i0 + block_size
        hblk = torch.matmul(spins, problem.j[:, i0:i1]) + problem.h[i0:i1]
        jbb = problem.j[i0:i1, i0:i1]
        de_acc, cnt = decide_block(
            spins[:, i0:i1], hblk, jbb,
            accept_threshold(uniforms[:, i0:i1], beta[:, None], rule),
            problem.active_mask[i0:i1] > 0, de_acc, cnt)
    return spins, de_acc, cnt


def decide_block(sblk, hblk, jbb, thblk, mblk, de_acc, cnt):
    """The B sequential decisions of one block: spin i of the block flips
    where s_i * f_i < th_i (and the mask allows), ``sblk`` [R, B] (a view of
    the spins) is updated in place and the block's later fields move by
    the flip through ``jbb`` [B, B]. Returns (dE sum, counts) with this
    block's added."""
    for i in range(sblk.shape[1]):
        s_j = sblk[:, i]
        sf = s_j * hblk[:, i]
        acc = (sf < thblk[:, i]) & mblk[i]
        ds = torch.where(acc, -2.0 * s_j, 0.0)
        sblk[:, i] = s_j + ds
        hblk = hblk + ds[:, None] * jbb[i][None, :]
        de_acc = de_acc + torch.where(acc, 2.0 * sf, 0.0)
        cnt = cnt + acc.to(torch.int32)
    return de_acc, cnt


# ---------------------------------------------------------------------------
# Host-side sequential oracle (tests only)
# ---------------------------------------------------------------------------

def sequential_sweep_oracle(j, h, spins, beta, uniforms, rule="metropolis"):
    """Numpy float64 single-replica sequential sweep, spin order 0..N-1.

    Ground truth for the blocked sweeps and the fused kernel's twin; its
    Glauber threshold clamps u at 0.999999999 like the JAX oracle.
    """
    s = np.asarray(spins, dtype=np.float64).copy()
    j = np.asarray(j, dtype=np.float64)
    h = np.asarray(h, dtype=np.float64)
    u = np.asarray(uniforms, dtype=np.float64)
    n = s.shape[-1]
    de_sum, cnt = 0.0, 0
    with np.errstate(divide="ignore"):
        if rule == "metropolis":
            th = np.log(u) * (-0.5 / beta)
        else:
            th = (np.log(u) - np.log1p(-np.minimum(u, 0.999999999))) * (
                -0.5 / beta)
        th = np.where(u < 1.0, th, -np.inf)
    for i in range(n):
        f = float(j[i] @ s + h[i])
        de = 2.0 * s[i] * f
        if s[i] * f < th[i]:
            s[i] = -s[i]
            de_sum += de
            cnt += 1
    return s, de_sum, cnt
