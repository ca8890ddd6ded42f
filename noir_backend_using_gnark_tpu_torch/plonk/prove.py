"""PLONK prover on torch tensors, in both proof layouts.

Counterpart of ``noir_backend_using_gnark_tpu/plonk/prove.py``: every
polynomial-sized step runs on the proving key's device (NTTs through
kernel K4, commitments through K1 and K2, all field algebra through
K3); the host does O(1) work: transcript hashing and a few scalar field
operations. Rounds 1-3 are shared; the protocols differ in the
transcript and in rounds 4-5:

  * ``"gnark"``: gnark v0.8's transcript and linearized openings
    (gnark_protocol.py), a :class:`..formats.gnark.GnarkProof`;
  * ``"expanded"``: the SHA-256 transcript of transcript.py and the
    15 openings of ``keys.ZETA_OPENING_LABELS``, a :class:`keys.Proof`.

The blinding values are SHA-256 of the seed and a counter, drawn in the
same order as the JAX package (three wires two each, then three for
z; both protocols draw the same nine), so a seed gives the same proof
bytes in both packages.
"""

from __future__ import annotations

import hashlib
import os
import time

import numpy as np
import torch

from ..errors import ProvingError
from ..kzg import kzg
from ..ops import field as F
from ..ops import ntt as N
from ..ops import poly as P
from ..ops import scan_utils
from ..utils import bigint
from . import gnark_protocol as GP
from .keys import ZETA_OPENING_LABELS, Proof, ProvingKey
from .setup import K1, K2
from .transcript import expanded_transcript

FR = F.FR
R = bigint.FR_MODULUS

#: Coset shift of the 4n quotient-evaluation domain.
QUOTIENT_SHIFT = bigint.FR_MULTIPLICATIVE_GENERATOR


def _sparse_poly(shape_batch: tuple, length: int, entries: list, device) -> torch.Tensor:
    """(8, *shape_batch, length) zero tensor with a few host-int entries
    (Montgomery form); ``entries``: (batch index tuple, position, value)."""
    arr = np.zeros((F.NUM_LIMBS, *shape_batch, length), np.int32)
    for bidx, pos, val in entries:
        arr[(slice(None), *bidx, pos)] = F.ints_to_limbs([val % R * F.R_INT % R])[:, 0]
    return torch.from_numpy(arr).to(device)


def _blind(coeffs: torch.Tensor, n: int, blinds: list) -> torch.Tensor:
    """coeffs (8, *batch, n) + (sum_i b_i X^i) * (X^n - 1) per polynomial;
    ``blinds`` holds one list of values per polynomial of the batch."""
    batch = tuple(coeffs.shape[1:-1])
    k = len(blinds[0])
    entries = []
    for flat, bl in enumerate(blinds):
        bidx = np.unravel_index(flat, batch) if batch else ()
        for i, b in enumerate(bl):
            entries.append((tuple(bidx), i, -b))
            entries.append((tuple(bidx), n + i, b))
    sparse = _sparse_poly(batch, n + k, entries, coeffs.device)
    return F.add(torch.nn.functional.pad(coeffs, (0, k)), sparse, FR)


def _col(values, device) -> torch.Tensor:
    """Host ints -> (8, len) Montgomery tensor of scalars."""
    return F.from_ints(values, FR, device=device)


def _z_evals(wa_e, wb_e, wc_e, xs, s1e, s2e, s3e, beta: int, gamma: int) -> torch.Tensor:
    """Round 2's grand product ratio and its prefix product (the JAX
    package's _z_evals_kernel): z_0 = 1, z_{i+1} = z_i * num_i / den_i."""
    device = wa_e.device
    bg = _col([beta, gamma, K1, K2], device)
    beta_d, gamma_d, k1_d, k2_d = (bg[:, i : i + 1] for i in range(4))

    def lin(w_e, ids):
        return F.add(F.add(w_e, F.mont_mul(ids, beta_d, FR), FR), gamma_d, FR)

    num = F.mont_mul(
        F.mont_mul(lin(wa_e, xs), lin(wb_e, F.mont_mul(xs, k1_d, FR)), FR),
        lin(wc_e, F.mont_mul(xs, k2_d, FR)),
        FR,
    )
    den = F.mont_mul(F.mont_mul(lin(wa_e, s1e), lin(wb_e, s2e), FR), lin(wc_e, s3e), FR)
    ratio = F.mont_mul(num, F.batch_inv(den, FR), FR)
    prefix = scan_utils.rolled_scan(lambda a, b: F.mont_mul(a, b, FR), ratio)
    one = F.one_mont(FR, (1,), device)
    return torch.cat([one, prefix[:, :-1]], dim=1)


def _quotient(ev4, x_pows4, beta: int, gamma: int, alpha: int, zh_pat: list, n: int):
    """Round 3's coset algebra (the JAX package's _quotient_kernel):
    t4 = (gate + alpha * (Z(wX) g - Z(X) f) + alpha^2 L1 (Z - 1)) / Z_H
    on the 4n coset, gnark's sign convention."""
    device = ev4.device
    ch = _col([beta, gamma, K1, K2, alpha, alpha * alpha % R, QUOTIENT_SHIFT], device)
    beta_d, gamma_d, k1_d, k2_d, alpha_d, alpha2_d, shift_d = (ch[:, i : i + 1] for i in range(7))
    a4, b4, c4, z4, ql4, qr4, qo4, qm4, qc4, s14, s24, s34, pi4, l04 = (
        ev4[:, i] for i in range(14)
    )
    zw4 = torch.roll(z4, -4, dims=-1)  # z(omega * x) on the coset (omega = w4^4)
    xs4 = F.mont_mul(x_pows4, shift_d, FR)

    def mul(a, b):
        return F.mont_mul(a, b, FR)

    def add(a, b):
        return F.add(a, b, FR)

    def lin4(w4_, ids4):
        return add(add(w4_, mul(ids4, beta_d)), gamma_d)

    gate = add(
        add(add(mul(ql4, a4), mul(qr4, b4)), add(mul(qo4, c4), mul(qm4, mul(a4, b4)))),
        add(qc4, pi4),
    )
    perm_pos = mul(
        mul(mul(lin4(a4, xs4), lin4(b4, mul(xs4, k1_d))), lin4(c4, mul(xs4, k2_d))), z4
    )
    perm_neg = mul(mul(mul(lin4(a4, s14), lin4(b4, s24)), lin4(c4, s34)), zw4)
    one4 = F.one_mont(FR, (a4.shape[-1],), device)
    l1term = mul(mul(l04, F.sub(z4, one4, FR)), alpha2_d)
    numer = add(gate, add(mul(F.sub(perm_neg, perm_pos, FR), alpha_d), l1term))
    zh_inv4 = _col(zh_pat, device).repeat(1, n)  # period-4 Z_H^-1 pattern
    return mul(numer, zh_inv4)


def _stack_padded(polys, length: int) -> torch.Tensor:
    return torch.stack([torch.nn.functional.pad(p, (0, length - p.shape[-1])) for p in polys], dim=1)


def evals_pack(polys, zeta: int, zeta_omega: int, z_poly) -> list:
    """[f_i(zeta) for each poly] + [z(zeta * omega)] as host ints, one
    readback."""
    device = z_poly.device
    zz = _col([zeta, zeta_omega], device)
    stacked = _stack_padded(polys, max(p.shape[-1] for p in polys))
    evals = P.horner_states(stacked, zz[:, 0:1])[:, :, 0]
    zwv = P.horner_states(z_poly, zz[:, 1:2])[:, :1]
    return F.to_ints(torch.cat([evals, zwv], dim=1), FR)


def open_quotients(polys, weight_ints, zeta: int, zeta_omega: int, z_poly):
    """Round 5's device tail: fold the opened polynomials with the
    challenge powers, divide by (X - zeta) and z by (X - zeta*omega)."""
    zz = _col([zeta, zeta_omega], z_poly.device)
    folded = P.linear_combination(list(polys), weight_ints)
    q_fold = P.horner_states(folded, zz[:, 0:1])[:, 1:]
    q_zw = P.horner_states(z_poly, zz[:, 1:2])[:, 1:]
    return q_fold, q_zw


def _coset_evals(coeffs_list, big_n: int, domain4: N.Domain) -> torch.Tensor:
    return N.coset_ntt(_stack_padded(coeffs_list, big_n), QUOTIENT_SHIFT, domain4)


def prove(pk: ProvingKey, assignment_ints: list, rng_seed: bytes | None = None,
          timings: dict | None = None, protocol: str = "gnark"):
    """A PLONK proof for the cs-variable assignment.

    ``assignment_ints``: host ints, publics first (lowering order).
    ``rng_seed``: 32 bytes for deterministic blinding (None draws fresh
    randomness). ``timings``: when given, receives the wall seconds of
    each round (rounds end on a commitment readback, so the times are
    complete). ``protocol``: ``"gnark"`` (a GnarkProof) or
    ``"expanded"`` (a keys.Proof).
    """
    if protocol not in ("gnark", "expanded"):
        raise ProvingError(f"unknown proof protocol {protocol!r}")
    if pk.vk is None:
        raise ProvingError(f"{protocol} protocol requires pk.vk (public data binding)")
    n = pk.n
    domain = N.Domain.get(n)
    big_n = 4 * n
    domain4 = N.Domain.get(big_n)
    device = pk.ql.device
    t_start = time.perf_counter()
    marks = {}

    if len(assignment_ints) != pk.nb_vars:
        raise ProvingError(f"assignment length {len(assignment_ints)} != nb_vars {pk.nb_vars}")
    publics = [v % R for v in assignment_ints[: pk.nb_public]]

    seed = rng_seed if rng_seed is not None else os.urandom(32)
    counter = [0]

    def draw_blind():
        counter[0] += 1
        digest = hashlib.sha256(seed + counter[0].to_bytes(4, "big")).digest()
        return int.from_bytes(digest, "big") % R

    def commit_many(polys):
        return kzg.commit_many_ints(pk.srs, polys)

    assignment = F.from_ints(assignment_ints, FR, device=device)

    # ---- Round 1: wire polynomials ------------------------------------
    wires_idx = torch.from_numpy(np.stack([pk.wire_a, pk.wire_b, pk.wire_c]).astype(np.int64))
    wires_e = assignment[:, wires_idx.to(device)]  # (8, 3, n)
    wa_e, wb_e, wc_e = (wires_e[:, i] for i in range(3))
    wires_c = N.intt(wires_e, domain)
    # Draw order a1, a2, b1, b2, c1, c2 (the JAX package's order).
    wires_b = _blind(wires_c, n, [[draw_blind(), draw_blind()] for _ in range(3)])
    a_c, b_c, c_c = (wires_b[:, i].contiguous() for i in range(3))
    com_a, com_b, com_c = commit_many([a_c, b_c, c_c])
    marks["round1"] = time.perf_counter()

    if protocol == "gnark":
        gts = GP.GnarkTranscript(("gamma", "beta", "alpha", "zeta"))
        GP.bind_public_data(gts, "gamma", pk.vk, publics)
        gamma = GP.derive_randomness(gts, "gamma", (com_a, com_b, com_c))
        beta = GP.derive_randomness(gts, "beta")
    else:
        ts = expanded_transcript(pk.vk, publics)
        for label, com in zip((b"a", b"b", b"c"), (com_a, com_b, com_c)):
            ts.absorb_point(label, com)
        beta = ts.challenge(b"beta")
        gamma = ts.challenge(b"gamma")

    # ---- Round 2: permutation grand product ---------------------------
    z_evals = _z_evals(
        wa_e, wb_e, wc_e, domain.x_powers(device), pk.s1_evals, pk.s2_evals, pk.s3_evals,
        beta, gamma,
    )
    z_c = _blind(N.intt(z_evals, domain), n, [[draw_blind(), draw_blind(), draw_blind()]])
    (com_z,) = commit_many([z_c])
    marks["round2"] = time.perf_counter()
    if protocol == "gnark":
        alpha = GP.derive_randomness(gts, "alpha", (com_z,))
    else:
        ts.absorb_point(b"z", com_z)
        alpha = ts.challenge(b"alpha")

    # ---- Round 3: quotient --------------------------------------------
    # PI polynomial: +pub_i at row i (gnark's completed qk).
    pi_c = N.intt(F.from_ints(publics + [0] * (n - len(publics)), FR, device=device), domain)
    l0_c = F.const(pow(n, -1, R), FR, device, (n,))  # L0 = (1/n) sum X^j
    ev4 = _coset_evals(
        [a_c, b_c, c_c, z_c, pk.ql, pk.qr, pk.qo, pk.qm, pk.qc, pk.s1, pk.s2, pk.s3, pi_c, l0_c],
        big_n,
        domain4,
    )
    g_n = pow(QUOTIENT_SHIFT, n, R)
    i4 = pow(domain4.w_int, n, R)
    zh_pat = []
    for j in range(4):
        v = (g_n * pow(i4, j, R) - 1) % R
        if v == 0:
            raise ProvingError("quotient coset intersects the domain")
        zh_pat.append(pow(v, -1, R))
    t4 = _quotient(ev4, domain4.x_powers(device), beta, gamma, alpha, zh_pat, n)
    t_c = N.coset_intt(t4, QUOTIENT_SHIFT, domain4)  # degree <= 3n + 5
    chunk = n + 2
    t_chunks = tuple(t_c[:, i * chunk : (i + 1) * chunk].contiguous() for i in range(3))
    com_t = commit_many(list(t_chunks))
    marks["round3"] = time.perf_counter()
    if protocol == "gnark":
        zeta = GP.derive_randomness(gts, "zeta", com_t)
        proof = GP.finish_prove(
            pk, commit_many, publics, beta, gamma, alpha, zeta,
            com_a, com_b, com_c, com_z, com_t, a_c, b_c, c_c, z_c, t_chunks,
        )
    else:
        for label, com in zip((b"t0", b"t1", b"t2"), com_t):
            ts.absorb_point(label, com)
        zeta = ts.challenge(b"zeta")
        proof = _finish_expanded(
            pk, commit_many, ts, zeta, com_a, com_b, com_c, com_z, com_t, a_c, b_c, c_c, z_c, t_chunks,
        )
    marks["round45"] = time.perf_counter()
    if timings is not None:
        prev = t_start
        for name, t in marks.items():
            timings[name] = t - prev
            prev = t
    return proof


def _finish_expanded(pk, commit_many, ts, zeta: int, com_a, com_b, com_c, com_z, com_t,
                     a_c, b_c, c_c, z_c, t_chunks) -> Proof:
    """Rounds 4-5 of the expanded protocol: the 15 zeta openings of
    ZETA_OPENING_LABELS and z(zeta*omega), absorbed in that order; then
    the batched opening with weights nu^i and the shifted opening of z."""
    zeta_omega = zeta * N.Domain.get(pk.n).w_int % R
    opened = {
        "a": a_c, "b": b_c, "c": c_c, "z": z_c,
        "s1": pk.s1, "s2": pk.s2, "s3": pk.s3,
        "ql": pk.ql, "qr": pk.qr, "qo": pk.qo, "qm": pk.qm, "qc": pk.qc,
        "t0": t_chunks[0], "t1": t_chunks[1], "t2": t_chunks[2],
    }
    polys = [opened[k] for k in ZETA_OPENING_LABELS]
    all_vals = evals_pack(polys, zeta, zeta_omega, z_c)
    evals, z_omega_val = all_vals[:-1], all_vals[-1]
    for label, v in zip(ZETA_OPENING_LABELS, evals):
        ts.absorb_felt(label.encode(), v)
    ts.absorb_felt(b"z_omega", z_omega_val)
    nu = ts.challenge(b"nu")
    q_fold, q_zw = open_quotients(polys, [pow(nu, i, R) for i in range(len(polys))], zeta, zeta_omega, z_c)
    w_zeta, w_zeta_omega = commit_many([q_fold, q_zw])
    t0, t1, t2 = com_t
    return Proof(a=com_a, b=com_b, c=com_c, z=com_z, t0=t0, t1=t1, t2=t2, evals=evals,
                 z_omega=z_omega_val, w_zeta=w_zeta, w_zeta_omega=w_zeta_omega)
