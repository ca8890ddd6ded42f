"""gnark v0.8 PLONK protocol strategy: linearized openings + gnark
Fiat-Shamir transcript.

The reference's proofs are gnark `WriteTo` blobs whose entire shape is
fixed by gnark v0.8's prover (reference consumes them via
gnark_backend_ffi/internal/backend/helpers.go:75-94 and
backend/plonk/plonk.go:29-73). That protocol differs from the JAX
package's "expanded" layout (its plonk/keys.py; not part of this port)
in two ways:

  1. **Linearized openings.** Instead of opening every selector/sigma/
     quotient chunk at zeta (15 claimed values), the prover sends SEVEN
     zeta openings — the folded quotient H(X) = h0 + X^{n+2} h1 +
     X^{2(n+2)} h2 evaluated-by-commitment at zeta, the linearization
     polynomial r(X), and l, r, o, s1, s2 — plus the shifted opening
     z(omega*zeta). The verifier reconstructs the digests of H and
     r(X) as G1 combinations and checks the scalar identity

       r(z) + PI(z) + alpha*(lb+beta*s1b+gamma)(rb+beta*s2b+gamma)
                          *(ob+gamma)*z_omega - alpha^2*L1(z)
         == Z_H(z) * H(z)

     with r(X) = lb*rb*Qm + lb*Ql + rb*Qr + ob*Qo + Qk
               + [alpha^2*L1(z)
                  - alpha*(lb+beta*z+gamma)(rb+beta*k1*z+gamma)
                         (ob+beta*k2*z+gamma)]*Z(X)
               + alpha*beta*z_omega*(lb+beta*s1b+gamma)
                        (rb+beta*s2b+gamma)*S3(X).

     Signs follow gnark v0.8 exactly (quotient numerator
     gate + alpha*(Z(wX)*g - Z(X)*f) + alpha^2*L1*(Z-1); the verifier
     ADDS the sigma-side constant and PI(z) = +sum pub_i*L_i(z),
     matching the qL=-1 public placeholder rows of plonk/setup.py).

     (Derivation in this module's verify(); matches gnark v0.8
     internal/backend/bn254/plonk/{prove,verify}.go. Earlier
     CONFORMANCE notes counted 6 claimed values; the folded-H opening
     makes it 7 — the container codec is count-prefixed either way.)

  2. **gnark transcript.** Challenges come from gnark-crypto v0.9.1's
     ``fiat-shamir.Transcript`` over SHA-256 with challenge sequence
     gamma -> beta -> alpha -> zeta (note: gamma FIRST — the expanded
     protocol derives beta first), where gamma is bound to the public
     data (S1,S2,S3,Ql,Qr,Qm,Qo,Qk digests + public inputs) and the
     L,R,O commitments; beta has no extra bindings (chains off gamma);
     alpha binds Z; zeta binds H0,H1,H2. The KZG batch-fold challenge
     is gnark-crypto kzg's deriveGamma: SHA-256(zeta || digests...).

Byte-level validation against a live gnark build is impossible in this
environment (no Go toolchain, zero egress — CONFORMANCE.md §4); the
reconstruction is from the gnark v0.8 / gnark-crypto v0.9.1 protocol
structure and is explicitly versioned here so byte vectors can be
dropped into tests/fixtures/gnark/ later. Known reconstruction
uncertainties are marked UNVERIFIED in comments.
"""

from __future__ import annotations

import hashlib

from ..formats.gnark import GnarkProof
from ..kzg import kzg
from ..ops import poly as P
from ..utils import bigint, hostcurve

R = bigint.FR_MODULUS


# ---------------------------------------------------------------------------
# Marshaling (gnark-crypto bn254 marshal.go conventions)
# ---------------------------------------------------------------------------


def g1_raw_bytes(pt) -> bytes:
    """G1Affine.RawBytes(): 64-byte uncompressed x||y big-endian.

    Finite bn254 coordinates are < 2^254, so the two flag MSBs are
    naturally 00 (= "uncompressed"); infinity carries the 0b01 flag in
    the top bits of an otherwise-zero buffer (gnark-crypto marshal.go
    flag scheme, see formats/gnark.py).
    """
    if pt is None:
        out = bytearray(64)
        out[0] = 0b01 << 6
        return bytes(out)
    x, y = pt
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


def fr_marshal(v: int) -> bytes:
    """fr.Element.Marshal(): canonical 32-byte big-endian."""
    return (v % R).to_bytes(32, "big")


def fr_set_bytes(b: bytes) -> int:
    """fr.Element.SetBytes(): big-endian bytes reduced mod r."""
    return int.from_bytes(b, "big") % R


# ---------------------------------------------------------------------------
# gnark-crypto std/fiat-shamir Transcript (v0.9.1)
# ---------------------------------------------------------------------------


class GnarkTranscript:
    """Named-challenge transcript: challenge_i = H(id_i || prev_value
    || bindings...), challenges computed in declaration order.

    UNVERIFIED detail: whether gnark-crypto v0.9.1 writes the
    challengeID into the hash (we do). Everything else (previous-value
    chaining, binding order, SetBytes reduction) follows the
    transcript.go structure.
    """

    def __init__(self, challenge_ids):
        self._ids = list(challenge_ids)
        self._bindings: dict = {cid: [] for cid in self._ids}
        self._values: dict = {}

    def bind(self, cid: str, data: bytes) -> None:
        if cid in self._values:
            raise ValueError(f"challenge {cid} already computed")
        self._bindings[cid].append(bytes(data))

    def compute_challenge(self, cid: str) -> bytes:
        if cid in self._values:
            return self._values[cid]
        pos = self._ids.index(cid)
        h = hashlib.sha256()
        h.update(cid.encode())
        if pos > 0:
            prev_id = self._ids[pos - 1]
            if prev_id not in self._values:
                raise ValueError(f"previous challenge {prev_id} not computed")
            h.update(self._values[prev_id])
        for b in self._bindings[cid]:
            h.update(b)
        v = h.digest()
        self._values[cid] = v
        return v


def bind_public_data(ts: GnarkTranscript, cid: str, vk, publics) -> None:
    """plonk.bindPublicData: S1,S2,S3 then Ql,Qr,Qm,Qo,Qk digests
    (uncompressed) then each public input (fr.Marshal)."""
    for pt in (vk.s1, vk.s2, vk.s3, vk.q_l, vk.q_r, vk.q_m, vk.q_o, vk.q_c):
        ts.bind(cid, g1_raw_bytes(pt))
    for p in publics:
        ts.bind(cid, fr_marshal(p))


def derive_randomness(ts: GnarkTranscript, cid: str, points=()) -> int:
    """plonk.deriveRandomness: bind each point's RawBytes, compute, map
    to Fr via SetBytes."""
    for pt in points:
        ts.bind(cid, g1_raw_bytes(pt))
    return fr_set_bytes(ts.compute_challenge(cid))


def derive_kzg_fold_gamma(zeta: int, digests) -> int:
    """gnark-crypto v0.9.1 kzg.deriveGamma: a one-challenge
    fiatshamir.NewTranscript(sha256, "gamma") bound to point.Marshal()
    then each digest.Marshal() — i.e. SHA-256("gamma" || zeta ||
    digests...) reduced into Fr (the transcript writes the challenge
    ID first; first challenge, so no previous-value chaining)."""
    h = hashlib.sha256()
    h.update(b"gamma")
    h.update(fr_marshal(zeta))
    for d in digests:
        h.update(g1_raw_bytes(d))
    return fr_set_bytes(h.digest())


# ---------------------------------------------------------------------------
# Shared scalar helpers
# ---------------------------------------------------------------------------


def _lagrange_one(n: int, omega: int, zeta: int, zh: int) -> int:
    """L1(zeta) for the Lagrange basis at the domain point 1 (w^0):
    Z_H(zeta) / (n * (zeta - 1))."""
    return zh * pow(n * (zeta - 1) % R, -1, R) % R


def _pi_at(publics, n: int, omega: int, zeta: int, zh: int) -> int:
    """PI(zeta) = sum_i +pub_i * L_i(zeta) — gnark's completed-qk
    contribution (the qL=-1 placeholder rows carry -pub_i through the
    wire; the prover's PI polynomial in plonk/prove.py matches)."""
    acc = 0
    for i, p in enumerate(publics):
        w_i = pow(omega, i, R)
        l_i = zh * w_i % R * pow(n * (zeta - w_i) % R, -1, R) % R
        acc = (acc + p * l_i) % R
    return acc


def _lin_terms(k1, k2, beta, gamma, zeta, evals):
    """The two permutation products shared by prover and verifier:

    a_term = (lb+beta*zeta+gamma)(rb+beta*k1*zeta+gamma)
             (ob+beta*k2*zeta+gamma)   — the Z(X) coefficient core;
    c_term = (lb+beta*s1b+gamma)(rb+beta*s2b+gamma) — the S3/const core.
    """
    lb, rb, ob, s1b, s2b = evals
    a_term = (
        (lb + beta * zeta + gamma)
        * (rb + beta * k1 * zeta + gamma)
        % R
        * (ob + beta * k2 * zeta + gamma)
        % R
    )
    c_term = (lb + beta * s1b + gamma) * (rb + beta * s2b + gamma) % R
    return a_term, c_term


# ---------------------------------------------------------------------------
# Prover tail (rounds 4-5 under the gnark protocol)
# ---------------------------------------------------------------------------


def finish_prove(
    pk,
    commit_many,
    publics,
    beta: int,
    gamma: int,
    alpha: int,
    zeta: int,
    com_a,
    com_b,
    com_c,
    com_z,
    com_t,
    a_c,
    b_c,
    c_c,
    z_c,
    t_chunks,
) -> GnarkProof:
    """Rounds 4-5: evaluations, linearization poly, batched opening.

    ``com_t``/``t_chunks``: the 3 quotient commitments/coefficient
    tensors; ``commit_many``: the prover's batched commit
    (kzg.commit_many_ints over pk.srs).
    """
    from .prove import evals_pack, open_quotients

    n = pk.n
    omega = pk.vk.generator
    zeta_omega = zeta * omega % R

    lb, rb, ob, s1b, s2b, z_omega_val = evals_pack(
        (a_c, b_c, c_c, pk.s1, pk.s2), zeta, zeta_omega, z_c
    )

    zh = (pow(zeta, n, R) - 1) % R
    l1 = _lagrange_one(n, omega, zeta, zh)
    a_term, c_term = _lin_terms(
        pk.k1, pk.k2, beta, gamma, zeta, (lb, rb, ob, s1b, s2b)
    )
    # gnark v0.8 linearization coefficients: Z(X) gets
    # alpha^2*L1 - alpha*f(zeta); S3(X) gets +alpha*beta*g(zeta)*z(wz).
    wz = (alpha * alpha % R * l1 - alpha * a_term) % R
    ws3 = alpha * beta % R * c_term % R * z_omega_val % R
    weights = [lb * rb % R, lb, rb, ob, 1, wz, ws3]

    # ---- linearization polynomial + folded quotient ------------------
    lin_c = P.linear_combination(
        [pk.qm, pk.ql, pk.qr, pk.qo, pk.qc, z_c, pk.s3], weights
    )
    chunk = n + 2
    zc1 = pow(zeta, chunk, R)
    zc2 = zc1 * zc1 % R
    foldedh_c = P.linear_combination(list(t_chunks), [1, zc1, zc2])

    # ---- digests for the fold challenge (host G1, O(1) points) --------
    lin_digest = _lin_digest(pk.vk, com_z, weights)
    foldedh_digest = _foldedh_digest(com_t, zc1, zc2)
    digests = [
        foldedh_digest,
        lin_digest,
        com_a,
        com_b,
        com_c,
        pk.vk.s1,
        pk.vk.s2,
    ]
    fold_gamma = derive_kzg_fold_gamma(zeta, digests)

    # ---- batched opening at zeta + shifted opening of z ---------------
    polys = (foldedh_c, lin_c, a_c, b_c, c_c, pk.s1, pk.s2)
    claimed = evals_pack(polys, zeta, zeta_omega, z_c)[:-1]
    q_fold, q_zw = open_quotients(
        polys, [pow(fold_gamma, i, R) for i in range(len(polys))], zeta, zeta_omega, z_c
    )
    w_zeta, w_zeta_omega = commit_many([q_fold, q_zw])

    return GnarkProof(
        lro=(com_a, com_b, com_c),
        z=com_z,
        h=tuple(com_t),
        batched_h=w_zeta,
        claimed_values=[v % R for v in claimed],
        shifted_h=w_zeta_omega,
        z_shifted_value=z_omega_val,
    )


def _lin_digest(vk, com_z, weights):
    """[r(X)] as a G1 combination of Qm,Ql,Qr,Qo,Qk,Z,S3 digests."""
    pts = (vk.q_m, vk.q_l, vk.q_r, vk.q_o, vk.q_c, com_z, vk.s3)
    acc = None
    for pt, w in zip(pts, weights):
        if pt is None or w % R == 0:
            continue
        acc = hostcurve.g1_add(acc, hostcurve.g1_mul(pt, w % R))
    return acc


def _foldedh_digest(com_t, zc1, zc2):
    acc = com_t[0]
    acc = hostcurve.g1_add(acc, hostcurve.g1_mul(com_t[1], zc1))
    acc = hostcurve.g1_add(acc, hostcurve.g1_mul(com_t[2], zc2))
    return acc


# ---------------------------------------------------------------------------
# Verifier
# ---------------------------------------------------------------------------


def replay_challenges(vk, publics, proof: GnarkProof):
    ts = GnarkTranscript(("gamma", "beta", "alpha", "zeta"))
    bind_public_data(ts, "gamma", vk, publics)
    gamma = derive_randomness(ts, "gamma", proof.lro)
    beta = derive_randomness(ts, "beta")
    alpha = derive_randomness(ts, "alpha", (proof.z,))
    zeta = derive_randomness(ts, "zeta", proof.h)
    return gamma, beta, alpha, zeta


def verify(vk, proof: GnarkProof, public_inputs) -> bool:
    """gnark v0.8-shape verification: scalar identity + 2 KZG checks."""
    n = vk.n
    omega = vk.generator
    publics = [p % R for p in public_inputs]
    if len(publics) != vk.nb_public or len(proof.claimed_values) != 7:
        return False

    gamma, beta, alpha, zeta = replay_challenges(vk, publics, proof)

    zh = (pow(zeta, n, R) - 1) % R
    if zh == 0:
        return False
    l1 = _lagrange_one(n, omega, zeta, zh)
    pi = _pi_at(publics, n, omega, zeta, zh)

    fh_z, lin_z, lb, rb, ob, s1b, s2b = (v % R for v in proof.claimed_values)
    z_omega_val = proof.z_shifted_value % R

    a_term, c_term = _lin_terms(
        vk.k1, vk.k2, beta, gamma, zeta, (lb, rb, ob, s1b, s2b)
    )
    # Scalar identity (see module docstring; derivation: substitute the
    # linearization split into gnark's quotient identity at zeta).
    lhs = (
        lin_z
        + pi
        + alpha * c_term % R * ((ob + gamma) % R) % R * z_omega_val
        - alpha * alpha % R * l1
    ) % R
    if lhs != zh * fh_z % R:
        return False

    # Rebuild digests exactly as the prover derived them.
    wz = (alpha * alpha % R * l1 - alpha * a_term) % R
    ws3 = alpha * beta % R * c_term % R * z_omega_val % R
    weights = [lb * rb % R, lb, rb, ob, 1, wz, ws3]
    lin_digest = _lin_digest(vk, proof.z, weights)
    chunk = n + 2
    zc1 = pow(zeta, chunk, R)
    foldedh_digest = _foldedh_digest(proof.h, zc1, zc1 * zc1 % R)
    digests = [
        foldedh_digest,
        lin_digest,
        proof.lro[0],
        proof.lro[1],
        proof.lro[2],
        vk.s1,
        vk.s2,
    ]
    fold_gamma = derive_kzg_fold_gamma(zeta, digests)
    claimed = [fh_z, lin_z, lb, rb, ob, s1b, s2b]
    if not kzg.verify_batch_open(
        digests, zeta, claimed, proof.batched_h, fold_gamma, vk.g2_gen, vk.g2_alpha
    ):
        return False
    if not kzg.verify_open(
        proof.z,
        zeta * omega % R,
        z_omega_val,
        proof.shifted_h,
        vk.g2_gen,
        vk.g2_alpha,
    ):
        return False
    return True
