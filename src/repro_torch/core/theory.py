"""Theorem 1 / Theorem 2 closed-form bounds (paper §3).

The port of ``repro.core.theory``: the quantities the simulated runs
are validated against, written for a *diagonal* Σ = 𝔼xxᵀ (the paper's
numerical setting).  ``rho`` matches the footnote
``(I − 2εΣ_x)ᵀ Σ_x (I − 2εΣ_x) ⪯ ρ Σ_x`` with Σ_x = Σ/2.  Arguments may
be floats, sequences or tensors (on any device); results are fp32
tensors, except :func:`stable_eps_range`'s float.
"""
from __future__ import annotations

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def rho(eps: float, sigma_diag) -> torch.Tensor:
    """ρ = max_i (1 − ε λ_i(𝔼xxᵀ))² — contraction factor of Thm 1."""
    return ((1.0 - eps * _f32(sigma_diag)) ** 2).max()


def stable_eps_range(sigma_diag) -> float:
    """Stepsizes with ρ < 1: 0 < ε < 2/λ_max(𝔼xxᵀ)."""
    return float(2.0 / _f32(sigma_diag).max())


def gradient_covariance_trace(sigma_diag, w, w_star, noise_std, n_samples):
    """Tr(Σ_x G) for the Gaussian model, Σ_x = Σ/2, with G the
    covariance of the N-sample empirical gradient.  Diagonal case:
    Var(g_j) = (1/N)[Σ_jj (δᵀΣδ) + Σ_jj² δ_j² + σ² Σ_jj], δ = w − w*."""
    sig = _f32(sigma_diag)
    d = _f32(w) - _f32(w_star)
    quad = (sig * d * d).sum()
    var_g = (sig * quad + sig ** 2 * d ** 2 + noise_std ** 2 * sig) / n_samples
    return (0.5 * sig * var_g).sum()


def thm1_bound(J0, J_star, eps, sigma_diag, trace_sig_G, lam,
               expected_silence, N):
    """Eq. (12) with 𝔼(1−α) summarized by ``expected_silence`` per step
    (a scalar or an ``(N,)`` sequence of (Σᵢ 𝔼(1−α_ℓ^i))/m per step ℓ)."""
    r = rho(eps, sigma_diag)
    silence = torch.broadcast_to(_f32(expected_silence).to(r.device), (N,))
    powers = r ** torch.arange(N, 0, -1, device=r.device)  # ρ^{N-ℓ}
    tail = lam * (powers * silence).sum()
    return (r ** N * J0
            + (1 - r ** N) * (J_star + eps ** 2 * trace_sig_G / (1 - r))
            + tail)


def steady_state_bound(J_star, eps, sigma_diag, trace_sig_G, lam):
    """Eq. (23): limsup 𝔼J ≤ J* + (λ + ε²Tr(Σ_x G))/(1 − ρ)."""
    r = rho(eps, sigma_diag)
    return J_star + (lam + eps ** 2 * trace_sig_G) / (1 - r)


def thm2_comm_bound(J0, J_star, lam):
    """Eq. (24): Σ_k max_i α_k^i ≤ (J(w₀) − J(w*))/λ, almost surely."""
    return (J0 - J_star) / lam
