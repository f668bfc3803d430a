"""Prior log-densities for covariance parameters, in PyTorch.

Port of ``spamtree_tpu/model/priors.py``.  The reference computes
``calc_prior_logratio`` but omits it from the MH acceptance ratio
(reference: src/mh_adapt.h:204-254, src/spamtree_fit.cpp:239-246); here an
informative prior is usable through ``make_theta_prior``, and the default
(None) reproduces the reference's flat-prior behaviour.
"""

from __future__ import annotations

import math

import torch


def lognormal_logdens(x, mu, sigma):
    lx = torch.log(x)
    return (-torch.log(x * sigma) - 0.5 * math.log(2.0 * math.pi)
            - 0.5 * ((lx - mu) / sigma) ** 2)


def _lgamma(x, a):
    return torch.lgamma(torch.as_tensor(a, dtype=x.dtype, device=x.device))


def gamma_logdens(x, a, b):
    """Shape a, rate b."""
    return (a * math.log(b) - _lgamma(x, a) + (a - 1.0) * torch.log(x)
            - b * x)


def invgamma_logdens(x, a, b):
    return (a * math.log(b) - _lgamma(x, a) - (a + 1.0) * torch.log(x)
            - b / x)


def beta_logdens(x, a, b):
    lbeta = _lgamma(x, a) + _lgamma(x, b) - _lgamma(x, a + b)
    return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log(1.0 - x) - lbeta


_FAMILIES = {
    "lognormal": lognormal_logdens,
    "gamma": gamma_logdens,
    "invgamma": invgamma_logdens,
    "beta": beta_logdens,
}


def make_theta_prior(spec):
    """Build ``logp(theta) -> scalar`` from a per-dimension spec; a
    (C, n_theta) theta gives one log-density per chain.

    ``spec`` is a callable (returned unchanged) or a sequence with one entry
    per theta dimension: ``None`` (flat) or ``(family, a, b)`` with family in
    {lognormal, gamma, invgamma, beta}."""
    if spec is None:
        return None
    if callable(spec):
        # a user's function of one theta: chains evaluate it row by row
        return lambda theta: (spec(theta) if theta.dim() == 1 else
                              torch.stack([spec(t) for t in theta.unbind(0)]))
    entries = []
    for i, s in enumerate(spec):
        if s is None:
            continue
        fam, a, b = s
        if fam not in _FAMILIES:
            raise ValueError(f"unknown prior family {fam!r} for theta[{i}]")
        entries.append((i, _FAMILIES[fam], float(a), float(b)))

    def logp(theta):
        total = theta.new_zeros(theta.shape[:-1])
        for i, fn, a, b in entries:
            total = total + fn(theta[..., i], a, b)
        return total

    return logp
