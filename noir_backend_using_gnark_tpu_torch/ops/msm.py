"""Pippenger multi-scalar multiplication over BN254 G1 on torch tensors.

Counterpart of ``noir_backend_using_gnark_tpu/ops/msm.py``, on the path
the JAX package takes on a TPU at these sizes (``msm_pallas``):

  1. signed c-bit digit recoding (:func:`.msm_kernels.signed_digits`);
  2. bucket accumulation, kernel K1 (:func:`.msm_kernels.accumulate_buckets`);
  3. the weighted bucket reduction T_w = sum_b b * S_b, two log-depth
     suffix scans of complete additions (plain code over kernel K3);
  4. the window join, kernel K2 (:func:`.msm_kernels.join_windows`).

The window width is c = 6 (W = 43 windows, B = 33 buckets). An MSM has
one result, so the window width never changes the bytes of a proof.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import curve as C
from . import field as F
from . import msm_kernels as MK

FR = F.FR
FQ = F.FQ

#: Window width of every MSM of the port.
WINDOW_BITS = 6

num_windows = MK.num_windows


class AffineBatch(NamedTuple):
    """Affine G1 points: x, y (8, N) Fq Montgomery; inf (N,) bool."""

    x: torch.Tensor
    y: torch.Tensor
    inf: torch.Tensor

    @property
    def n(self) -> int:
        return self.x.shape[-1]

    def prefix(self, count: int) -> "AffineBatch":
        return AffineBatch(self.x[:, :count], self.y[:, :count], self.inf[:count])


def affine_from_ints(points, device="cpu") -> AffineBatch:
    jac = C.from_affine_ints(points, device)
    return AffineBatch(jac.x, jac.y, F.is_zero(jac.z))


def _suffix_scan_points(p: C.JacobianPoint) -> C.JacobianPoint:
    """Inclusive suffix scan (self and everything to the right) along
    the last batch axis: Hillis-Steele doubling, log2 n steps."""
    n = p.x.shape[-1]
    d = 1
    while d < n:
        combined = C.add(p.map(lambda a: a[..., : n - d]), p.map(lambda a: a[..., d:]))
        p = C.JacobianPoint(*(torch.cat([c, a[..., n - d :]], dim=-1) for c, a in zip(combined, p)))
        d *= 2
    return p


def _weighted_bucket_reduce(buckets: C.JacobianPoint) -> C.JacobianPoint:
    """T_w = sum_{b>=1} b * S_b for bucket tables with batch (..., B):
    U = suffix(S) gives U_j = sum_{b>=j} S_b, and sum_{j>=1} U_j is
    element 1 of suffix(U)."""
    v = _suffix_scan_points(_suffix_scan_points(buckets))
    return v.map(lambda a: a[..., 1])


def msm(points: AffineBatch, scalars: torch.Tensor, c: int = WINDOW_BITS) -> C.JacobianPoint:
    """sum_i scalars[i] * points[i]. ``scalars``: canonical (8, N).
    Returns one Jacobian point (batch shape ())."""
    if scalars.shape[-1] != points.n:
        raise ValueError("points/scalars length mismatch")
    buckets = MK.accumulate_buckets(points.x, points.y, points.inf, scalars, c)
    totals = _weighted_bucket_reduce(buckets)  # batch (W,)
    return MK.join_windows(totals, c)


def msm_ints(points, scalars, c: int = WINDOW_BITS, device="cpu"):
    """Host-convenience MSM: python points / ints -> affine int result."""
    batch = affine_from_ints(points, device)
    sc = F.from_ints([s % FR.modulus for s in scalars], FR, to_mont=False, device=device)
    out = msm(batch, sc, c)
    return C.to_affine_ints(out.map(lambda a: a.reshape(F.NUM_LIMBS, 1)))[0]
