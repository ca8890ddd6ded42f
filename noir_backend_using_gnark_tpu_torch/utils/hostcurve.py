"""Host-side (pure Python int) BN254 reference implementation.

A host copy of ``noir_backend_using_gnark_tpu/utils/hostcurve.py``: the
ground truth the device kernels are tested against, and the
implementation of the cheap host-side pieces of the proof system:

  * affine/Jacobian G1 and G2 group law (used to cross-check
    :mod:`..ops.curve` and to finish tiny tail computations),
  * the Fq2/Fq12 tower and the optimal-ate pairing (used by KZG / PLONK /
    Groth16 *verification*, which is O(1) pairings and not worth a device
    kernel — the reference delegates this to gnark's ``plonk.Verify``,
    gnark_backend_ffi/backend/plonk/plonk.go:29-51).

Everything here is scalar Python; the hot batched paths live in
``ops/`` on torch tensors and CUDA kernels.

Attribution: the pairing section (FQP tower construction, the
``twist``/line-function/Miller-loop structure and the BN254 ate loop
count) is derived from the Ethereum Foundation's ``py_ecc`` bn128
module (MIT license, https://github.com/ethereum/py_ecc) — a public
reference implementation, independent of the reference backend this
repo reimplements. The group law, codecs and everything outside the
pairing are original.
"""

from __future__ import annotations

from .bigint import (
    FQ_MODULUS,
    FR_MODULUS,
    G1_GENERATOR,
    G2_GENERATOR_X,
    G2_GENERATOR_Y,
)

Q = FQ_MODULUS
R = FR_MODULUS

# ---------------------------------------------------------------------------
# Fq / G1 (affine, None = point at infinity)
# ---------------------------------------------------------------------------


def fq_inv(a: int) -> int:
    a %= Q
    # Native extended-gcd inverse (~12 us) instead of a Fermat modpow
    # (~80 us); 0 maps to 0 like the Fermat form did.
    return pow(a, -1, Q) if a else 0


def g1_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - 3) % Q == 0


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % Q == 0:
            return None
        lam = (3 * x1 * x1) * fq_inv(2 * y1) % Q
    else:
        lam = (y2 - y1) * fq_inv(x2 - x1) % Q
    x3 = (lam * lam - x1 - x2) % Q
    y3 = (lam * (x1 - x3) - y1) % Q
    return (x3, y3)


def g1_neg(pt):
    if pt is None:
        return None
    x, y = pt
    return (x, (-y) % Q)


def _g1_jdbl(P):
    X, Y, Z = P
    A = X * X % Q
    B = Y * Y % Q
    C = B * B % Q
    D = 2 * ((X + B) * (X + B) - A - C) % Q
    E = 3 * A % Q
    F = E * E % Q
    X3 = (F - 2 * D) % Q
    Y3 = (E * (D - X3) - 8 * C) % Q
    Z3 = 2 * Y * Z % Q
    return (X3, Y3, Z3)


def _g1_jmixed(P, x2, y2):
    if P is None:
        return (x2, y2, 1)
    X1, Y1, Z1 = P
    Z1Z1 = Z1 * Z1 % Q
    U2 = x2 * Z1Z1 % Q
    S2 = y2 * Z1 % Q * Z1Z1 % Q
    H = (U2 - X1) % Q
    r = (S2 - Y1) % Q
    if H == 0:
        return _g1_jdbl(P) if r == 0 else None
    HH = H * H % Q
    HHH = H * HH % Q
    V = X1 * HH % Q
    X3 = (r * r - HHH - 2 * V) % Q
    Y3 = (r * (V - X3) - Y1 * HHH) % Q
    Z3 = Z1 * H % Q
    return (X3, Y3, Z3)


def g1_mul(pt, k: int):
    """k * pt by Jacobian double-and-add (ONE final inversion), exact
    for any integer k.

    Deliberately does NOT reduce k mod r: for points outside the
    r-torsion (possible on the twist; G1 itself has cofactor 1),
    ``mul(pt, r)`` must compute the true multiple so subgroup checks
    like ``g2_mul(pt, R) is None`` are meaningful. Callers with
    in-subgroup points may pre-reduce for speed. (The former affine
    ladder paid a field inversion PER BIT — ~46 ms per multiply, which
    dominated the gnark-protocol prover's host digest combinations.)
    """
    if k < 0:
        return g1_neg(g1_mul(pt, -k))
    if pt is None or k == 0:
        return None
    x, y = pt
    acc = None
    for bit in bin(k)[2:]:
        if acc is not None:
            acc = _g1_jdbl(acc)
        if bit == "1":
            acc = _g1_jmixed(acc, x, y)
    if acc is None or acc[2] % Q == 0:
        return None
    X, Y, Z = acc
    zi = pow(Z, -1, Q)
    zi2 = zi * zi % Q
    return (X * zi2 % Q, Y * zi2 % Q * zi % Q)


def g1_generator():
    return G1_GENERATOR


def g1_msm(points, scalars):
    """Naive host MSM — test oracle for ops/msm.py."""
    acc = None
    for p, s in zip(points, scalars):
        acc = g1_add(acc, g1_mul(p, s))
    return acc


# ---------------------------------------------------------------------------
# Extension towers: generic polynomial field FQP, with FQ2 and FQ12
# ---------------------------------------------------------------------------


class FQP:
    """Element of Fq[x]/(modulus_coeffs + x^deg). Coefficients are ints mod q."""

    __slots__ = ("coeffs",)
    degree = 0
    modulus_coeffs: tuple = ()

    def __init__(self, coeffs):
        if len(coeffs) != self.degree:
            raise ValueError(f"expected {self.degree} coeffs")
        self.coeffs = tuple(c % Q for c in coeffs)

    # -- ring ops ----------------------------------------------------------
    def __add__(self, other):
        return type(self)([a + b for a, b in zip(self.coeffs, other.coeffs)])

    def __sub__(self, other):
        return type(self)([a - b for a, b in zip(self.coeffs, other.coeffs)])

    def __neg__(self):
        return type(self)([-a for a in self.coeffs])

    def __mul__(self, other):
        if isinstance(other, int):
            return type(self)([a * other for a in self.coeffs])
        deg = self.degree
        tmp = [0] * (2 * deg - 1)
        for i, a in enumerate(self.coeffs):
            if a:
                for j, b in enumerate(other.coeffs):
                    tmp[i + j] += a * b
        # reduce x^(deg+k) = -modulus_coeffs * x^k
        for i in range(2 * deg - 2, deg - 1, -1):
            top = tmp[i] % Q
            if top:
                for j, mc in enumerate(self.modulus_coeffs):
                    tmp[i - deg + j] -= top * mc
            tmp[i] = 0
        return type(self)(tmp[:deg])

    __rmul__ = __mul__

    def __pow__(self, n: int):
        result = type(self).one()
        base = self
        n = int(n)
        while n:
            if n & 1:
                result = result * base
            base = base * base
            n >>= 1
        return result

    def inv(self):
        """Extended Euclid over Fq[x]."""
        deg = self.degree
        lm, hm = [1] + [0] * deg, [0] * (deg + 1)
        low = list(self.coeffs) + [0]
        high = list(self.modulus_coeffs) + [1]

        def poly_deg(p):
            d = len(p) - 1
            while d and p[d] % Q == 0:
                d -= 1
            return d

        while poly_deg(low):
            r_ = [0] * (deg + 1)
            dl, dh = poly_deg(low), poly_deg(high)
            if dh >= dl:
                quot = high[:]  # divide high by low
                inv_lead = pow(low[dl], Q - 2, Q)
                for i in range(dh - dl, -1, -1):
                    factor = quot[dl + i] * inv_lead % Q
                    r_[i] = factor
                    for j in range(dl + 1):
                        quot[i + j] = (quot[i + j] - factor * low[j]) % Q
                new_h = quot
            else:
                new_h = high[:]
            nm = hm[:]
            for i in range(deg + 1):
                for j in range(deg + 1 - i):
                    nm[i + j] -= lm[i] * r_[j]
            nm = [c % Q for c in nm]
            lm, low, hm, high = nm, [c % Q for c in new_h], lm, low
        inv_lead = pow(low[0], Q - 2, Q)
        return type(self)([c * inv_lead % Q for c in lm[:deg]])

    def __truediv__(self, other):
        if isinstance(other, int):
            return self * pow(other, Q - 2, Q)
        return self * other.inv()

    def __eq__(self, other):
        return type(self) is type(other) and self.coeffs == other.coeffs

    def __hash__(self):
        return hash(self.coeffs)

    def __repr__(self):
        return f"{type(self).__name__}{self.coeffs}"

    @classmethod
    def one(cls):
        return cls([1] + [0] * (cls.degree - 1))

    @classmethod
    def zero(cls):
        return cls([0] * cls.degree)

    def is_zero(self):
        return all(c == 0 for c in self.coeffs)


class FQ2(FQP):
    """Fq[u]/(u^2+1)."""

    degree = 2
    modulus_coeffs = (1, 0)  # u^2 = -1


class FQ12(FQP):
    """Fq[w]/(w^12 - 18 w^6 + 82); note u = w^6 - 9, v = w^2."""

    degree = 12
    modulus_coeffs = (82, 0, 0, 0, 0, 0, -18, 0, 0, 0, 0, 0)


# xi = 9 + u, the sextic-twist non-residue.
FQ2_XI = FQ2([9, 1])


# ---------------------------------------------------------------------------
# G2 (affine over FQ2, None = infinity). Twisted curve: y^2 = x^3 + 3/xi.
# ---------------------------------------------------------------------------

G2_B = FQ2([3, 0]) / FQ2_XI


def g2_generator():
    return (FQ2(list(G2_GENERATOR_X)), FQ2(list(G2_GENERATOR_Y)))


def g2_is_on_curve(pt) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - G2_B).is_zero()


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (3 * (x1 * x1)) / (2 * y1)
    else:
        lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def g2_neg(pt):
    if pt is None:
        return None
    return (pt[0], -pt[1])


def g2_mul(pt, k: int):
    """k * pt by double-and-add, exact for any integer k.

    No ``k %= R``: E'(Fq2) has a large cofactor, so scalar reduction
    mod r is only valid for r-torsion points. Reducing here made
    ``g2_mul(pt, R)`` vacuously None for EVERY point and turned the
    r-torsion membership checks in artifacts/formats into no-ops
    (round-2 security bug) — any on-curve twist point, including
    small-subgroup points, was accepted into pairing inputs.
    """
    if k < 0:
        return g2_neg(g2_mul(pt, -k))
    if pt is None or k == 0:
        return None
    x, y = pt
    acc = None  # Jacobian over FQ2, None = infinity
    for bit in bin(k)[2:]:
        if acc is not None:
            X, Y, Z = acc
            A = X * X
            B = Y * Y
            C = B * B
            D = ((X + B) * (X + B) - A - C) * 2
            E = A * 3
            X3 = E * E - D * 2
            Y3 = E * (D - X3) - C * 8
            Z3 = Y * Z * 2
            acc = (X3, Y3, Z3)
        if bit == "1":
            if acc is None:
                acc = (x, y, FQ2.one())
            else:
                X1, Y1, Z1 = acc
                Z1Z1 = Z1 * Z1
                U2 = x * Z1Z1
                S2 = y * Z1 * Z1Z1
                H = U2 - X1
                r = S2 - Y1
                if H.is_zero():
                    if r.is_zero():
                        A = X1 * X1
                        B = Y1 * Y1
                        C = B * B
                        D = ((X1 + B) * (X1 + B) - A - C) * 2
                        E = A * 3
                        X3 = E * E - D * 2
                        Y3 = E * (D - X3) - C * 8
                        Z3 = Y1 * Z1 * 2
                        acc = (X3, Y3, Z3)
                    else:
                        acc = None
                else:
                    HH = H * H
                    HHH = H * HH
                    V = X1 * HH
                    X3 = r * r - HHH - V * 2
                    Y3 = r * (V - X3) - Y1 * HHH
                    Z3 = Z1 * H
                    acc = (X3, Y3, Z3)
    if acc is None or acc[2].is_zero():
        return None
    X, Y, Z = acc
    zi = Z.inv()
    zi2 = zi * zi
    return (X * zi2, Y * zi2 * zi)


def g2_in_subgroup(pt) -> bool:
    """r-torsion membership on the twist: on-curve and r*pt == O.

    Matches gnark's deserialization semantics (gnark G2 ``ReadFrom``
    subgroup-checks; reference consumes it via
    gnark_backend_ffi/internal/backend/helpers.go:49-73).
    """
    return g2_is_on_curve(pt) and g2_mul(pt, R) is None


# ---------------------------------------------------------------------------
# Pairing (optimal ate on BN254)
# ---------------------------------------------------------------------------

# BN parameter t with q = 36t^4+36t^3+24t^2+6t+1; ate loop count = 6t+2.
BN_T = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_T + 2  # 29793968203157093288
LOG_ATE_LOOP_COUNT = ATE_LOOP_COUNT.bit_length() - 2  # 63

W = FQ12([0, 1] + [0] * 10)
W2 = W * W
W3 = W2 * W


def twist(pt):
    """Map a point on E'(Fq2) into E(Fq12).

    Uses the isomorphism u = w^6 - 9: an Fq2 element a+bu becomes
    (a - 9b) + b w^6, then coordinates are scaled by w^2 / w^3.
    """
    if pt is None:
        return None
    x, y = pt
    xc = [x.coeffs[0] - 9 * x.coeffs[1], x.coeffs[1]]
    yc = [y.coeffs[0] - 9 * y.coeffs[1], y.coeffs[1]]
    nx = FQ12([xc[0]] + [0] * 5 + [xc[1]] + [0] * 5)
    ny = FQ12([yc[0]] + [0] * 5 + [yc[1]] + [0] * 5)
    return (nx * W2, ny * W3)


def cast_g1_to_fq12(pt):
    if pt is None:
        return None
    x, y = pt
    return (FQ12([x] + [0] * 11), FQ12([y] + [0] * 11))


def _fq12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2).is_zero():
            return None
        lam = (3 * (x1 * x1)) / (2 * y1)
    else:
        lam = (y2 - y1) / (x2 - x1)
    x3 = lam * lam - x1 - x2
    y3 = lam * (x1 - x3) - y1
    return (x3, y3)


def _linefunc(p1, p2, t):
    """Evaluate the line through p1,p2 (or tangent if equal) at point t."""
    x1, y1 = p1
    x2, y2 = p2
    xt, yt = t
    if x1 == x2 and y1 == y2:
        m = (3 * (x1 * x1)) / (2 * y1)
        return m * (xt - x1) - (yt - y1)
    if x1 == x2:
        return xt - x1
    m = (y2 - y1) / (x2 - x1)
    return m * (xt - x1) - (yt - y1)


def miller_loop(q_pt, p_pt, final_exp: bool = True):
    """Optimal-ate Miller loop f_{6t+2,Q}(P) with the two frobenius lines."""
    if q_pt is None or p_pt is None:
        return FQ12.one()
    r_pt = q_pt
    f = FQ12.one()
    for i in range(LOG_ATE_LOOP_COUNT, -1, -1):
        f = f * f * _linefunc(r_pt, r_pt, p_pt)
        r_pt = _fq12_add(r_pt, r_pt)
        if ATE_LOOP_COUNT & (2**i):
            f = f * _linefunc(r_pt, q_pt, p_pt)
            r_pt = _fq12_add(r_pt, q_pt)
    q1 = (q_pt[0] ** Q, q_pt[1] ** Q)
    nq2 = (q1[0] ** Q, -(q1[1] ** Q))
    f = f * _linefunc(r_pt, q1, p_pt)
    r_pt = _fq12_add(r_pt, q1)
    f = f * _linefunc(r_pt, nq2, p_pt)
    if final_exp:
        f = final_exponentiation(f)
    return f


def final_exponentiation(f: FQ12) -> FQ12:
    """f^((q^12-1)/r): easy part via conjugation/frobenius, hard part by
    a plain square-and-multiply (host-side, O(1) per verification)."""
    # Easy part: f^(q^6-1) = conj(f)/f, then ^(q^2+1).
    conj = FQ12([c if i % 2 == 0 else -c for i, c in enumerate(_to_w6_pairs(f))])
    f1 = conj / f
    f2 = frobenius_fq12(frobenius_fq12(f1)) * f1
    # Hard part: exponent (q^4 - q^2 + 1)/r.
    hard = (Q**4 - Q**2 + 1) // R
    return f2**hard


def _to_w6_pairs(f: FQ12):
    """Coefficients of f; conj in Fq12/Fq6 means negating odd powers of w."""
    return f.coeffs


def frobenius_fq12(f: FQ12) -> FQ12:
    return f**Q


def pairing(p_pt, q_pt) -> FQ12:
    """e(P, Q) for P in G1(Fq), Q in G2(Fq2)."""
    if p_pt is None or q_pt is None:
        return FQ12.one()
    assert g1_is_on_curve(p_pt), "P not on G1"
    assert g2_is_on_curve(q_pt), "Q not on G2"
    return miller_loop(twist(q_pt), cast_g1_to_fq12(p_pt))


def pairing_product_is_one(pairs) -> bool:
    """Check prod e(P_i, Q_i) == 1 with a single shared final exponentiation."""
    f = FQ12.one()
    for p_pt, q_pt in pairs:
        if p_pt is None or q_pt is None:
            continue
        f = f * miller_loop(twist(q_pt), cast_g1_to_fq12(p_pt), final_exp=False)
    return final_exponentiation(f) == FQ12.one()
