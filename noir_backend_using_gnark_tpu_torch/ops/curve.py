"""Batched BN254 G1 arithmetic in Jacobian coordinates on torch tensors.

Counterpart of ``noir_backend_using_gnark_tpu/ops/curve.py``: the same
complete formulas (both the addition and the doubling results are
computed and lane-selected, so identity, equal and opposite inputs need
no branch), built on the field wrappers of :mod:`.field` and therefore
on kernel K3 when the tensors lie on the card.

  * A batch of points is a :class:`JacobianPoint` of three ``(8, *batch)``
    int32 tensors over Fq, Montgomery form.
  * Infinity is Z == 0 (X, Y arbitrary).
  * Jacobian coordinates are not unique: compare points through
    :func:`to_affine` / :func:`to_affine_ints`, never as raw limbs.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from . import field as F

FQ = F.FQ


class JacobianPoint(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    z: torch.Tensor

    @property
    def batch_shape(self):
        return tuple(self.x.shape[1:])

    def map(self, fn) -> "JacobianPoint":
        return JacobianPoint(fn(self.x), fn(self.y), fn(self.z))


def infinity(batch_shape=(), device="cpu") -> JacobianPoint:
    one = F.one_mont(FQ, batch_shape, device)
    return JacobianPoint(one, one, F.zeros(batch_shape, device))


def is_infinity(p: JacobianPoint) -> torch.Tensor:
    return F.is_zero(p.z)


def select_point(cond, p: JacobianPoint, q: JacobianPoint) -> JacobianPoint:
    return JacobianPoint(F.select(cond, p.x, q.x), F.select(cond, p.y, q.y), F.select(cond, p.z, q.z))


class FieldOps(NamedTuple):
    """The Fq operations a formula is evaluated with."""

    mul: Callable
    add: Callable
    sub: Callable
    neg: Callable


#: The field wrappers (kernel K3 on the card): the main path's choice.
KERNEL = FieldOps(
    lambda a, b: F.mont_mul(a, b, FQ),
    lambda a, b: F.add(a, b, FQ),
    lambda a, b: F.sub(a, b, FQ),
    lambda a: F.neg(a, FQ),
)
#: The plain PyTorch field versions on any device: the plain versions of
#: the MSM kernels evaluate the same formulas with these, so on the card
#: they stay independent of K3.
PLAIN = FieldOps(
    lambda a, b: F._mont_mul_plain(a, b, FQ),
    lambda a, b: F._add_plain(a, b, FQ),
    lambda a, b: F._sub_plain(a, b, FQ),
    lambda a: F._neg_plain(a, FQ),
)


def _dbl_parts(x, y, z, fo: FieldOps):
    """dbl-2009-l (a = 0): returns (x3, y3, z3). Infinity stays at
    infinity through Z3 = 2YZ."""
    _mul, _add, _sub = fo.mul, fo.add, fo.sub
    xx = _mul(x, x)
    yy = _mul(y, y)
    c = _mul(yy, yy)
    x_yy = _add(x, yy)
    d = _sub(_sub(_mul(x_yy, x_yy), xx), c)
    d = _add(d, d)
    e = _add(_add(xx, xx), xx)
    x3 = _sub(_mul(e, e), _add(d, d))
    c8 = _add(c, c)
    c8 = _add(c8, c8)
    c8 = _add(c8, c8)
    y3 = _sub(_mul(e, _sub(d, x3)), c8)
    yz = _mul(y, z)
    return x3, y3, _add(yz, yz)


def double(p: JacobianPoint, fo: FieldOps = KERNEL) -> JacobianPoint:
    return JacobianPoint(*_dbl_parts(p.x, p.y, p.z, fo))


def add(p: JacobianPoint, q: JacobianPoint, fo: FieldOps = KERNEL) -> JacobianPoint:
    """Complete P + Q (both Jacobian)."""
    _mul, _add, _sub = fo.mul, fo.add, fo.sub
    x1, y1, z1 = p
    x2, y2, z2 = q
    z1z1 = _mul(z1, z1)
    z2z2 = _mul(z2, z2)
    u1 = _mul(x1, z2z2)
    u2 = _mul(x2, z1z1)
    s1 = _mul(y1, _mul(z2, z2z2))
    s2 = _mul(y2, _mul(z1, z1z1))
    h = _sub(u2, u1)
    r = _sub(s2, s1)
    hh = _mul(h, h)
    hhh = _mul(h, hh)
    v = _mul(u1, hh)
    x3 = _sub(_sub(_mul(r, r), hhh), _add(v, v))
    y3 = _sub(_mul(r, _sub(v, x3)), _mul(s1, hhh))
    z3 = _mul(_mul(z1, z2), h)
    added = JacobianPoint(x3, y3, z3)
    dbl = double(p, fo)

    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r)
    p_inf = is_infinity(p)
    q_inf = is_infinity(q)
    out = select_point(h_zero & r_zero, dbl, added)
    out = select_point(h_zero & ~r_zero & ~p_inf & ~q_inf, infinity(out.batch_shape, x1.device), out)
    out = select_point(q_inf, p.map(lambda a: a.expand_as(out.x)), out)
    out = select_point(p_inf, q.map(lambda a: a.expand_as(out.x)), out)
    return out


def add_mixed(p: JacobianPoint, qx, qy, q_inf, fo: FieldOps = KERNEL) -> JacobianPoint:
    """Complete P + Q with Q affine (Z = 1); ``q_inf`` marks the affine
    slots that hold the identity."""
    _mul, _add, _sub = fo.mul, fo.add, fo.sub
    x1, y1, z1 = p
    z1z1 = _mul(z1, z1)
    u2 = _mul(qx, z1z1)
    s2 = _mul(qy, _mul(z1, z1z1))
    h = _sub(u2, x1)
    r = _sub(s2, y1)
    hh = _mul(h, h)
    hhh = _mul(h, hh)
    v = _mul(x1, hh)
    x3 = _sub(_sub(_mul(r, r), hhh), _add(v, v))
    y3 = _sub(_mul(r, _sub(v, x3)), _mul(y1, hhh))
    z3 = _mul(z1, h)
    added = JacobianPoint(x3, y3, z3)
    dbl = double(p, fo)

    h_zero = F.is_zero(h)
    r_zero = F.is_zero(r)
    p_inf = is_infinity(p)
    shape = added.batch_shape
    out = select_point(h_zero & r_zero, dbl, added)
    out = select_point(h_zero & ~r_zero & ~p_inf, infinity(shape, x1.device), out)
    q_jac = JacobianPoint(qx.expand_as(x3), qy.expand_as(x3), F.one_mont(FQ, shape, x1.device))
    q_inf = q_inf.expand(shape)
    out = select_point(q_inf, p.map(lambda a: a.expand_as(x3)), out)
    out = select_point(p_inf & ~q_inf, q_jac, out)
    return out


# ---------------------------------------------------------------------------
# Affine conversion / host IO
# ---------------------------------------------------------------------------


def to_affine(p: JacobianPoint):
    """Batch-normalize to affine; returns (x, y, inf_mask) with x, y in
    Montgomery form (0 where the point is at infinity)."""
    shape = p.batch_shape
    zinv = F.batch_inv(p.z.reshape(F.NUM_LIMBS, -1), FQ).reshape(p.z.shape)
    zinv2 = F.mont_mul(zinv, zinv, FQ)
    zinv3 = F.mont_mul(zinv, zinv2, FQ)
    ax = F.mont_mul(p.x.expand((F.NUM_LIMBS, *shape)), zinv2, FQ)
    ay = F.mont_mul(p.y.expand((F.NUM_LIMBS, *shape)), zinv3, FQ)
    return ax, ay, is_infinity(p)


def _to_affine_packed(p: JacobianPoint) -> torch.Tensor:
    """Affine-normalize and pack canonical x limbs, y limbs and the
    infinity flag into one (17, n) int32 tensor: one host readback."""
    ax, ay, inf = to_affine(p)
    ax = F.from_mont(ax.reshape(F.NUM_LIMBS, -1), FQ)
    ay = F.from_mont(ay.reshape(F.NUM_LIMBS, -1), FQ)
    return torch.cat([ax, ay, inf.reshape(1, -1).to(torch.int32)], dim=0)


def unpack_affine_ints(packed) -> list:
    """(17, n) packed affine limbs -> host affine tuples / None."""
    packed = packed.cpu() if isinstance(packed, torch.Tensor) else packed
    xs = F.limbs_to_ints(packed[: F.NUM_LIMBS])
    ys = F.limbs_to_ints(packed[F.NUM_LIMBS : 2 * F.NUM_LIMBS])
    infs = [bool(v) for v in packed[2 * F.NUM_LIMBS].tolist()]
    return [None if i else (x, y) for x, y, i in zip(xs, ys, infs)]


def to_affine_ints(p: JacobianPoint) -> list:
    """Device batch (flattened) -> host list of affine tuples / None."""
    return unpack_affine_ints(_to_affine_packed(p))


def from_affine_ints(points, device="cpu") -> JacobianPoint:
    """Host affine (x, y) tuples / None -> Jacobian batch."""
    xs, ys, zs = [], [], []
    for pt in points:
        if pt is None:
            xs.append(1)
            ys.append(1)
            zs.append(0)
        else:
            xs.append(pt[0])
            ys.append(pt[1])
            zs.append(1)
    return JacobianPoint(
        F.from_ints(xs, FQ, device=device),
        F.from_ints(ys, FQ, device=device),
        F.from_ints(zs, FQ, device=device),
    )


# ---------------------------------------------------------------------------
# Fixed-base scalar multiplication (SRS generation)
# ---------------------------------------------------------------------------


def scalar_bits(scalars: torch.Tensor, nbits: int = 256) -> torch.Tensor:
    """Canonical limb scalars (8, N) -> bits (nbits, N) as bool."""
    s64 = scalars.to(torch.int64) & 0xFFFFFFFF
    idx = torch.arange(nbits, device=scalars.device)
    limb = s64[idx // 32]  # (nbits, N)
    shift = (idx % 32).reshape(nbits, *([1] * (scalars.ndim - 1)))
    return ((limb >> shift) & 1).bool()


def generator_powers_table(nbits: int = 256, device="cpu"):
    """Host-computed [2^i]G affine table as (8, nbits) tensors (x, y)."""
    from ..utils import hostcurve

    pts = []
    g = hostcurve.g1_generator()
    for _ in range(nbits):
        pts.append(g)
        g = hostcurve.g1_add(g, g)
    xs = F.from_ints([p[0] for p in pts], FQ, device=device)
    ys = F.from_ints([p[1] for p in pts], FQ, device=device)
    return xs, ys


def fixed_base_mul(table_x: torch.Tensor, table_y: torch.Tensor, scalars: torch.Tensor) -> JacobianPoint:
    """out[i] = scalars[i] * G from a [2^j]G table: one lane-parallel
    complete mixed add per scalar bit. ``scalars``: canonical (8, N)."""
    nbits = table_x.shape[-1]
    bits = scalar_bits(scalars, nbits)
    n = scalars.shape[-1]
    acc = infinity((n,), scalars.device)
    never = torch.zeros((n,), dtype=torch.bool, device=scalars.device)
    for j in range(nbits):
        stepped = add_mixed(acc, table_x[:, j : j + 1], table_y[:, j : j + 1], never)
        acc = select_point(bits[j], stepped, acc)
    return acc
