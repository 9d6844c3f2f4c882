"""Adaptive per-atom cutoffs on the NEF layout.

Counterpart of ``metatrain_tpu/models/pet/adaptive.py``. Two methods:

- ``get_adaptive_cutoffs`` (the ``solver`` method): the smoothed
  neighbor count is a masked sum over the neighbor axis; a bracketed
  Newton-bisection of a fixed 30 iterations runs on detached distances,
  and one implicit-function step on the live distances attaches the
  gradient, so the forces of an adaptive model are the derivative of its
  energy, and a training step's second derivative goes through the step.
- ``get_probe_adaptive_cutoffs`` (the ``probe`` method): a Gaussian-
  weighted mean over a grid of probe cutoffs, differentiable end to end.

No edge is dropped: the adapted cutoff enters only through the smooth
cutoff factors, which vanish beyond it, so every shape stays static.
"""

from __future__ import annotations

import math

import torch

MIN_PROBE_CUTOFF = 0.5
NEWTON_ITERATIONS = 30


def _smooth_count_and_derivative(r, distances, mask, cutoff_width, max_cutoff, n_target):
    """``n_total(r) = sum_j bump(d_j, r, w) + n_target * (r / r_max)^3`` and
    its analytic derivative in r."""
    scaled = (distances - (r[:, None] - cutoff_width)) / cutoff_width
    active = (scaled > 0.0) & (scaled < 1.0) & mask
    below = (scaled <= 0.0) & mask

    safe = torch.clamp(scaled, 1e-6, 1.0 - 1e-6)
    s = math.pi * safe
    sin_s = torch.sin(s)
    cot_s = torch.cos(s) / sin_s
    tanh_cot = torch.tanh(cot_s)

    f = torch.where(active, 0.5 * (1.0 + tanh_cot), below.to(scaled.dtype))
    sech_sq = 1.0 - tanh_cot * tanh_cot
    df_dr = torch.where(active, (0.5 * math.pi / cutoff_width) * sech_sq / (sin_s * sin_s), 0.0)

    x = r / max_cutoff
    n = torch.sum(f, dim=1) + n_target * x**3
    dn = torch.sum(df_dr, dim=1) + 3.0 * n_target * x**2 / max_cutoff
    return n, dn


def get_adaptive_cutoffs(distances: torch.Tensor, mask: torch.Tensor, n_target: float,
                         max_cutoff: float, cutoff_width: float = 1.0) -> torch.Tensor:
    """Per-atom cutoff r* (A,) whose smoothed neighbor count is
    ``n_target``, differentiable through ``distances``.

    The cubic baseline makes ``n_total`` strictly increasing on
    ``[0, max_cutoff]`` with ``n_total(max_cutoff) >= n_target``, so the
    bracketed Newton always converges.
    """
    d = distances.detach()
    A = distances.shape[0]
    lo = torch.full((A,), MIN_PROBE_CUTOFF, dtype=distances.dtype, device=distances.device)
    hi = torch.full((A,), float(max_cutoff), dtype=distances.dtype, device=distances.device)
    r = 0.5 * (lo + hi)
    with torch.no_grad():
        for _ in range(NEWTON_ITERATIONS):
            n, dn = _smooth_count_and_derivative(r, d, mask, cutoff_width, max_cutoff, n_target)
            residual = n - n_target
            lo = torch.where(residual < 0.0, r, lo)
            hi = torch.where(residual >= 0.0, r, hi)
            newton = r - residual / torch.clamp_min(dn, 1e-10)
            inside = (newton > lo) & (newton < hi)
            r = torch.where(inside, newton, 0.5 * (lo + hi))
        # the implicit-function step: r and dn held constant, the residual
        # live in the distances
        _, dn0 = _smooth_count_and_derivative(r, d, mask, cutoff_width, max_cutoff, n_target)
    n_diff, _ = _smooth_count_and_derivative(r, distances, mask, cutoff_width, max_cutoff,
                                             n_target)
    return r - (n_diff - n_target) / torch.clamp_min(dn0, 1e-10)


def get_probe_adaptive_cutoffs(distances: torch.Tensor, mask: torch.Tensor, n_target: float,
                               max_cutoff: float, cutoff_width: float = 1.0) -> torch.Tensor:
    """SPACE's probe-grid adaptive cutoff, (A,): each atom's smooth count
    at a grid of probe cutoffs plus the cubic uniform-density baseline,
    probes weighted by a Gaussian centred at ``n_target`` (width from the
    numerical gradient along the probes), the weighted mean probe."""
    from .modules import cutoff_func_bump

    spacing = cutoff_width / 4.0
    n_probes = max(1, int((max_cutoff - MIN_PROBE_CUTOFF) / spacing))
    probes = torch.linspace(MIN_PROBE_CUTOFF, max_cutoff - spacing, n_probes,
                            dtype=distances.dtype, device=distances.device)

    # (A, M, P) probe weights -> per-atom effective counts (A, P); the bump
    # clamps its argument, so edges fully inside need 1 and fully outside 0
    f = cutoff_func_bump(distances[:, :, None], probes[None, None, :], cutoff_width)
    scaled = (distances[:, :, None] - (probes[None, None, :] - cutoff_width)) / cutoff_width
    f = torch.where(scaled <= 0.0, 1.0, torch.where(scaled >= 1.0, 0.0, f))
    f = torch.where(mask[:, :, None], f, 0.0)
    counts = torch.sum(f, dim=1)

    x = torch.linspace(0.0, 1.0, n_probes, dtype=distances.dtype, device=distances.device)
    diff = counts - n_target + n_target * x[None, :] ** 3

    if n_probes > 1:
        width_t = torch.clamp_min(torch.abs(torch.gradient(diff, dim=-1)[0]), 1e-12)
    else:
        width_t = torch.abs(diff) * 0.5 + 1e-12

    logw = -0.5 * (diff / width_t) ** 2
    logw = logw - torch.max(logw, dim=-1, keepdim=True).values
    w = torch.exp(logw)
    w = w / torch.sum(w, dim=-1, keepdim=True)
    return w @ probes
