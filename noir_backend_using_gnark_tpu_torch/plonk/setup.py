"""PLONK Setup: constraint table -> proving/verifying keys.

Counterpart of ``noir_backend_using_gnark_tpu/plonk/setup.py`` (gnark's
``plonk.Setup`` as driven by the reference's ``Preprocess``): build the
selector and permutation polynomials from the lowered gate table,
commit to them with KZG, and package the keys.

Row layout (gnark v0.8 public placeholder rows):
  * rows 0..l-1: one gate per public input, qL = -1, wires a = b = c =
    variable i; the prover completes qk with +pub_i on these rows;
  * rows l..l+g-1: the lowered ACIR gates;
  * padding rows to the next power of two: zero selectors, wires at
    variable 0.
"""

from __future__ import annotations

import numpy as np

from ..acir.lowering import PlonkCircuit
from ..kzg import kzg
from ..ops import field as F
from ..ops import ntt as N
from ..utils import bigint
from .keys import ProvingKey, VerifyingKey

FR = F.FR
R = bigint.FR_MODULUS

# Coset multipliers of the b and c wire columns (5 is a non-residue
# whose order does not divide 2^28, so 5H and 25H are disjoint from H
# and from each other).
K1 = 5
K2 = 25


def _check_cosets(n: int):
    if pow(K1, n, R) == 1 or pow(K2, n, R) == 1 or pow(K2 * pow(K1, -1, R) % R, n, R) == 1:
        raise ValueError(f"coset multipliers collide with the domain of size {n}")


def domain_size_for(pc: PlonkCircuit) -> int:
    """Smallest power-of-two domain (at least 8) covering the rows."""
    rows = pc.nb_public + pc.n_gates
    n = 8
    while n < rows:
        n *= 2
    return n


def build_tables(pc: PlonkCircuit):
    """Full-row selector vectors (host ints) and wire index vectors."""
    n = domain_size_for(pc)
    l = pc.nb_public
    g = pc.n_gates
    sel = [[0] * n for _ in range(5)]
    wires = [np.zeros(n, np.int32) for _ in range(3)]
    for i in range(l):
        sel[0][i] = R - 1  # gnark's qL = -1 placeholder
        for w in wires:
            w[i] = i
    for name, col in zip(("q_l", "q_r", "q_o", "q_m", "q_c"), sel):
        col[l : l + g] = [v % R for v in getattr(pc, name)]
    for src, w in zip((pc.wire_a, pc.wire_b, pc.wire_c), wires):
        w[l : l + g] = src
    return n, tuple(sel), tuple(wires)


def build_sigma(n: int, wires, domain: N.Domain):
    """Permutation evaluations: slot (col, row) carries eta_col *
    omega^row; sigma sends each slot to the next slot of its variable's
    occurrence cycle. Returns three length-n int lists."""
    omega_pows = [1] * n
    for i in range(1, n):
        omega_pows[i] = omega_pows[i - 1] * domain.w_int % R
    eta = (1, K1, K2)

    occurrences: dict[int, list] = {}
    for col, w in enumerate(wires):
        for row, var in enumerate(w.tolist()):
            occurrences.setdefault(var, []).append((col, row))

    sigma = [[0] * n for _ in range(3)]
    for slots in occurrences.values():
        m = len(slots)
        for idx, (col, row) in enumerate(slots):
            ncol, nrow = slots[(idx + 1) % m]
            sigma[col][row] = eta[ncol] * omega_pows[nrow] % R
    return sigma


def setup(pc: PlonkCircuit, srs: kzg.SRS) -> tuple[ProvingKey, VerifyingKey]:
    n, selectors, wires = build_tables(pc)
    _check_cosets(n)
    domain = N.Domain.get(n)
    sigma = build_sigma(n, wires, domain)
    if srs.size < n + 8:
        raise ValueError(f"SRS size {srs.size} too small for domain {n} (+blinding)")
    device = srs.device

    # All 8 evaluation vectors through one batched INTT.
    evals = F.from_ints([v for col in selectors + tuple(sigma) for v in col], FR, device=device)
    evals = evals.reshape(F.NUM_LIMBS, 8, n)
    coeffs = N.intt(evals, domain)
    polys = [coeffs[:, i].contiguous() for i in range(8)]
    sig_evals = [evals[:, 5 + i].contiguous() for i in range(3)]

    commitments = kzg.commit_many_ints(srs, polys)

    vk = VerifyingKey(
        n=n,
        nb_public=pc.nb_public,
        generator=domain.w_int,
        k1=K1,
        k2=K2,
        q_l=commitments[0],
        q_r=commitments[1],
        q_o=commitments[2],
        q_m=commitments[3],
        q_c=commitments[4],
        s1=commitments[5],
        s2=commitments[6],
        s3=commitments[7],
        g2_gen=srs.g2_gen,
        g2_alpha=srs.g2_alpha,
    )
    pk = ProvingKey(
        n=n,
        nb_public=pc.nb_public,
        nb_vars=pc.nb_vars,
        k1=K1,
        k2=K2,
        wire_a=wires[0],
        wire_b=wires[1],
        wire_c=wires[2],
        ql=polys[0],
        qr=polys[1],
        qo=polys[2],
        qm=polys[3],
        qc=polys[4],
        s1=polys[5],
        s2=polys[6],
        s3=polys[7],
        s1_evals=sig_evals[0],
        s2_evals=sig_evals[1],
        s3_evals=sig_evals[2],
        vk=vk,
        srs=srs,
    )
    return pk, vk
