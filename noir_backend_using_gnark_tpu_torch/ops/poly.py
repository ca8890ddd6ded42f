"""Polynomial primitives over Fr on (8, ..., n) coefficient tensors.

Counterpart of ``noir_backend_using_gnark_tpu/ops/poly.py``. Horner
evaluation and synthetic division by X - z are one suffix scan over the
affine maps m_i(x) = f_i + z * x, which compose associatively:
(p1, a1) o (p2, a2) = (p1 * p2, a1 + p1 * a2). The scan is the log-depth
one of :mod:`.scan_utils` over kernel K3.
"""

from __future__ import annotations

import torch

from . import field as F
from . import scan_utils

FR = F.FR


def _compose_right_first(left, right):
    """Scan combine for the flipped sequence: the element on the right
    of the flipped axis is applied first, (g o f) for left = f."""
    pf, af = left
    pg, ag = right
    return F.mont_mul(pg, pf, FR), F.add(ag, F.mont_mul(pg, af, FR), FR)


def horner_states(coeffs: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """s_i = f_i + z*f_{i+1} + z^2*f_{i+2} + ... for every i.

    ``coeffs``: (8, ..., n), extra axes a batch of polynomials evaluated
    at the same single element ``z``. s_0 is f(z); s_1.. are the quotient
    coefficients of (f(X) - f(z)) / (X - z)."""
    zz = z.reshape((8,) + (1,) * (coeffs.ndim - 1)).expand(coeffs.shape)
    flipped = (torch.flip(zz, dims=(-1,)), torch.flip(coeffs, dims=(-1,)))
    _, adds = scan_utils.inclusive_scan(_compose_right_first, flipped)
    return torch.flip(adds, dims=(-1,))


def _stack_padded(polys) -> torch.Tensor:
    n = max(p.shape[-1] for p in polys)
    return torch.stack([torch.nn.functional.pad(p, (0, n - p.shape[-1])) for p in polys], dim=1)


def eval_many(polys: list, z: torch.Tensor) -> torch.Tensor:
    """[f_i(z)] for polynomials of possibly different lengths, as one
    (8, P) tensor."""
    return horner_states(_stack_padded(polys), z)[:, :, 0]


def divide_by_linear(coeffs: torch.Tensor, z: torch.Tensor):
    """(quotient, remainder) of f(X) / (X - z): (8, n-1) and (8, 1)."""
    s = horner_states(coeffs, z)
    return s[:, 1:], s[:, :1]


def _lincomb_stacked(stacked: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum over axis 1 of stacked (8, P, n) * weights (8, P, 1)."""
    prods = F.mont_mul(stacked, weights, FR)
    acc = prods[:, 0]
    for i in range(1, prods.shape[1]):
        acc = F.add(acc, prods[:, i], FR)
    return acc


def linear_combination(polys: list, weight_ints: list) -> torch.Tensor:
    """sum_i weight_ints[i] * polys[i] with host-int weights."""
    stacked = _stack_padded(polys)
    w = F.from_ints(weight_ints, FR, device=stacked.device).reshape(8, len(polys), 1)
    return _lincomb_stacked(stacked, w)
