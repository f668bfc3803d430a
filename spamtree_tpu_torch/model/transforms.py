"""Bounded-support parameter transforms and MH jacobian, in PyTorch.

Port of ``spamtree_tpu/model/transforms.py``: ``par_huvtransf_fwd/back``
(reference: src/mh_adapt.cpp:3-15), ``logit``/``logistic``
(src/mh_adapt.h:150-156), ``unif_bounds`` clamping (src/mh_adapt.h:188-202)
and ``calc_jacobian`` (src/mh_adapt.h:230-239).  Each works on (n,) or
on (C, n) with a chain axis; ``bounds`` is (n, 2) either way.
"""

from __future__ import annotations

import torch


def logit(x, lo, hi):
    return -torch.log((hi - lo) / (x - lo) - 1.0)


def logistic(x, lo, hi):
    return lo + (hi - lo) / (1.0 + torch.exp(-x))


def transf_fwd(par, bounds):
    """Elementwise logit to unconstrained space; bounds is (n, 2)."""
    return logit(par, bounds[:, 0], bounds[:, 1])


def transf_back(par, bounds):
    """Elementwise logistic back to the support box."""
    return logistic(par, bounds[:, 0], bounds[:, 1])


def clamp_bounds(par, bounds):
    """Clamp to the open box; returns (clamped, was_out_of_bounds).

    The margin is dtype-aware: the reference's absolute 1e-10 underflows in
    float32 at toplim ~ 1e3, leaving saturated proposals exactly on the
    bound where the jacobian is +/-inf."""
    eps = torch.finfo(par.dtype).eps
    margin = torch.clamp(8.0 * eps * (bounds[:, 1] - bounds[:, 0]), min=1e-10)
    lo = bounds[:, 0] + margin
    hi = bounds[:, 1] - margin
    out = torch.any((par < bounds[:, 0]) | (par > bounds[:, 1]), dim=-1)
    return torch.minimum(torch.maximum(par, lo), hi), out


def _normal_proposal_logitscale(x, lo, hi):
    return -torch.log(hi - x) - torch.log(x - lo)


def calc_jacobian(new_param, param, bounds):
    """Log-jacobian of the logit change of variables for the MH ratio; one
    per chain for (C, n) parameters."""
    lo, hi = bounds[:, 0], bounds[:, 1]
    return torch.sum(_normal_proposal_logitscale(param, lo, hi)
                     - _normal_proposal_logitscale(new_param, lo, hi), dim=-1)
