"""KZG polynomial commitments over BN254: commit and open on the device,
verify on the host.

Counterpart of ``noir_backend_using_gnark_tpu/kzg/kzg.py``. A commitment
is a Pippenger MSM over the SRS powers (:mod:`..ops.msm`); K commitments
of one prover round share one weighted bucket reduction and one window
join (kernel K2), as ``commit_many_ints`` does in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import curve as C
from ..ops import field as F
from ..ops import msm as M
from ..ops import msm_kernels as MK
from ..ops import poly as P
from ..utils import bigint, hostcurve

FR = F.FR
FQ = F.FQ


@dataclass
class SRS:
    """Structured reference string: g1_powers is a device AffineBatch
    of [alpha^i]G1, g2_gen / g2_alpha the host G2 pair of the verifier."""

    g1_powers: M.AffineBatch
    g2_gen: tuple
    g2_alpha: tuple

    @property
    def size(self) -> int:
        return self.g1_powers.n

    @property
    def device(self):
        return self.g1_powers.x.device

    def g1_ints(self, count: int | None = None) -> list:
        """Host affine ints of the first ``count`` powers."""
        batch = self.g1_powers if count is None else self.g1_powers.prefix(count)
        packed = torch.cat([
            F.from_mont(batch.x, FQ),
            F.from_mont(batch.y, FQ),
            batch.inf.reshape(1, -1).to(torch.int32),
        ])
        return C.unpack_affine_ints(packed)


def generate_srs(size: int, alpha: int, device="cpu") -> SRS:
    """Powers-of-alpha SRS: host power chain for the scalars, then one
    batched fixed-base multiply on the device."""
    alpha %= bigint.FR_MODULUS
    r = bigint.FR_MODULUS
    vals, acc = [], 1
    for _ in range(size):
        vals.append(acc)
        acc = acc * alpha % r
    scalars = F.from_ints(vals, FR, to_mont=False, device=device)
    table_x, table_y = C.generator_powers_table(256, device)
    jac = C.fixed_base_mul(table_x, table_y, scalars)
    ax, ay, inf = C.to_affine(jac)
    g2_gen = hostcurve.g2_generator()
    return SRS(M.AffineBatch(ax, ay, inf), g2_gen, hostcurve.g2_mul(g2_gen, alpha))


def _size_class(srs: SRS, n: int) -> int:
    """Pad to a power-of-two size class (zero scalars add nothing)."""
    return min(srs.size, max(64, 1 << (n - 1).bit_length()))


def commit_many_ints(srs: SRS, coeff_list: list, c: int = M.WINDOW_BITS) -> list:
    """[f_k(alpha)]G1 for K Montgomery coefficient tensors (8, n_k), as
    host affine ints: K bucket accumulations (K1), one batched weighted
    reduction, joins of up to 8 MSMs per launch (K2), one readback."""
    n_max = max(co.shape[-1] for co in coeff_list)
    if n_max > srs.size:
        raise ValueError(f"polynomial degree {n_max - 1} exceeds SRS size {srs.size}")
    n_class = _size_class(srs, n_max)
    points = srs.g1_powers.prefix(n_class)
    buckets = []
    for co in coeff_list:
        co = torch.nn.functional.pad(co, (0, n_class - co.shape[-1]))
        sc = F.from_mont(co, FR)
        buckets.append(MK.accumulate_buckets(points.x, points.y, points.inf, sc, c))
    stacked = C.JacobianPoint(*(torch.stack(xs, dim=1) for xs in zip(*buckets)))  # (K, W, B)
    totals = M._weighted_bucket_reduce(stacked)  # (K, W)
    joined = [
        MK.join_windows(totals.map(lambda a: a[:, i : i + 8]), c)
        for i in range(0, len(coeff_list), 8)
    ]
    joined = C.JacobianPoint(*(torch.cat(xs, dim=1) for xs in zip(*joined)))
    return C.to_affine_ints(joined)


def commit_ints(srs: SRS, coeffs: torch.Tensor):
    return commit_many_ints(srs, [coeffs])[0]


def batch_open_at(srs: SRS, polys: list, z: int, gamma: int):
    """Batched opening at one point z: fold the polynomials with powers
    of gamma, divide by (X - z), commit. Returns (proof affine ints,
    [f_i(z)] host ints)."""
    r = FR.modulus
    device = polys[0].device
    zd = F.from_ints([z], FR, device=device)
    values = F.to_ints(P.eval_many(polys, zd), FR)
    folded = P.linear_combination(polys, [pow(gamma, i, r) for i in range(len(polys))])
    q, _ = P.divide_by_linear(folded, zd)
    return commit_ints(srs, q), values


def verify_open(commitment, z: int, value: int, proof, g2_gen, g2_alpha) -> bool:
    """Host pairing check e(C - [v]G1 + z*W, G2) * e(-W, [alpha]G2) == 1.
    Missing G2 inputs fail closed."""
    if g2_gen is None or g2_alpha is None:
        return False
    g1 = hostcurve.g1_generator()
    lhs = hostcurve.g1_add(commitment, hostcurve.g1_neg(hostcurve.g1_mul(g1, value)))
    lhs = hostcurve.g1_add(lhs, hostcurve.g1_mul(proof, z))
    return hostcurve.pairing_product_is_one(
        [(lhs, g2_gen), (hostcurve.g1_neg(proof), g2_alpha)]
    )


def verify_batch_open(commitments: list, z: int, values: list, proof, gamma: int, g2_gen, g2_alpha) -> bool:
    """Fold commitments and values with gamma powers on the host, then
    one pairing check."""
    r = bigint.FR_MODULUS
    folded_c = None
    folded_v = 0
    for i, (c, v) in enumerate(zip(commitments, values)):
        w = pow(gamma, i, r)
        folded_c = hostcurve.g1_add(folded_c, hostcurve.g1_mul(c, w) if c else None)
        folded_v = (folded_v + w * v) % r
    return verify_open(folded_c, z, folded_v, proof, g2_gen, g2_alpha)
