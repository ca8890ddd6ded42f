"""PLONK verifier (host-side — O(1) scalar math + two pairing checks): a
host copy of ``noir_backend_using_gnark_tpu/plonk/verify.py``.

Our replacement for gnark's ``plonk.Verify`` as driven by the
reference's ``VerifyWithVK`` (backend/plonk/plonk.go:29-51). With the
expanded-opening proof layout (plonk/keys.py), verification is:

  1. replay the Fiat-Shamir transcript to recover beta, gamma, alpha,
     zeta, nu;
  2. check the PLONK identity *numerically* at zeta using the claimed
     evaluations (selectors/sigmas included — they're KZG-verified);
  3. verify the batched KZG opening at zeta and the z opening at
     zeta*omega (two pairing products, utils/hostcurve.py).
"""

from __future__ import annotations

from ..kzg import kzg
from ..utils import bigint
from .keys import Proof, VerifyingKey, ZETA_OPENING_LABELS
from .transcript import expanded_transcript

R = bigint.FR_MODULUS


def verify(vk: VerifyingKey, proof, public_inputs: list) -> bool:
    """Verify either proof layout: expanded (keys.Proof) or gnark v0.8
    linearized (formats.gnark.GnarkProof) — dispatched on type."""
    from ..formats.gnark import GnarkProof

    if isinstance(proof, GnarkProof):
        from . import gnark_protocol

        return gnark_protocol.verify(vk, proof, public_inputs)
    return _verify_expanded(vk, proof, public_inputs)


def _verify_expanded(vk: VerifyingKey, proof: Proof, public_inputs: list) -> bool:
    n = vk.n
    omega = vk.generator
    publics = [p % R for p in public_inputs]
    if len(publics) != vk.nb_public:
        return False
    if len(proof.evals) != len(ZETA_OPENING_LABELS):
        return False

    # ---- Replay transcript --------------------------------------------
    ts = expanded_transcript(vk, publics)
    ts.absorb_point(b"a", proof.a)
    ts.absorb_point(b"b", proof.b)
    ts.absorb_point(b"c", proof.c)
    beta = ts.challenge(b"beta")
    gamma = ts.challenge(b"gamma")
    ts.absorb_point(b"z", proof.z)
    alpha = ts.challenge(b"alpha")
    ts.absorb_point(b"t0", proof.t0)
    ts.absorb_point(b"t1", proof.t1)
    ts.absorb_point(b"t2", proof.t2)
    zeta = ts.challenge(b"zeta")
    for label, v in zip(ZETA_OPENING_LABELS, proof.evals):
        ts.absorb_felt(label.encode(), v)
    ts.absorb_felt(b"z_omega", proof.z_omega)
    nu = ts.challenge(b"nu")

    ev = dict(zip(ZETA_OPENING_LABELS, (v % R for v in proof.evals)))
    z_omega = proof.z_omega % R

    # ---- Identity at zeta ---------------------------------------------
    zh = (pow(zeta, n, R) - 1) % R
    if zh == 0:
        return False  # zeta landed in H (cryptographically impossible)
    # L_0(zeta) = Z_H(zeta) / (n * (zeta - 1)).
    def lagrange_at(i: int) -> int:
        w_i = pow(omega, i, R)
        return zh * w_i % R * pow(n * (zeta - w_i) % R, -1, R) % R

    l0 = lagrange_at(0)
    # PI(zeta) = +sum pub_i * L_i(zeta): gnark's completed-qk term (the
    # qL=-1 placeholder rows carry -pub_i through the wire, setup.py).
    pi_zeta = sum(p * lagrange_at(i) % R for i, p in enumerate(publics)) % R

    gate = (
        ev["ql"] * ev["a"]
        + ev["qr"] * ev["b"]
        + ev["qo"] * ev["c"]
        + ev["qm"] * ev["a"] * ev["b"]
        + ev["qc"]
        + pi_zeta
    ) % R
    perm_pos = (
        (ev["a"] + beta * zeta + gamma)
        * (ev["b"] + beta * vk.k1 * zeta + gamma)
        % R
        * (ev["c"] + beta * vk.k2 * zeta + gamma)
        % R
        * ev["z"]
        % R
    )
    perm_neg = (
        (ev["a"] + beta * ev["s1"] + gamma)
        * (ev["b"] + beta * ev["s2"] + gamma)
        % R
        * (ev["c"] + beta * ev["s3"] + gamma)
        % R
        * z_omega
        % R
    )
    l1term = alpha * alpha % R * l0 % R * ((ev["z"] - 1) % R) % R
    # gnark sign convention: + alpha*(perm_neg - perm_pos).
    lhs = (gate + alpha * (perm_neg - perm_pos) + l1term) % R

    chunk = n + 2
    t_bar = (
        ev["t0"]
        + pow(zeta, chunk, R) * ev["t1"]
        + pow(zeta, 2 * chunk, R) * ev["t2"]
    ) % R
    if lhs != zh * t_bar % R:
        return False

    # ---- KZG opening checks -------------------------------------------
    commitments = {
        "a": proof.a,
        "b": proof.b,
        "c": proof.c,
        "z": proof.z,
        "s1": vk.s1,
        "s2": vk.s2,
        "s3": vk.s3,
        "ql": vk.q_l,
        "qr": vk.q_r,
        "qo": vk.q_o,
        "qm": vk.q_m,
        "qc": vk.q_c,
        "t0": proof.t0,
        "t1": proof.t1,
        "t2": proof.t2,
    }
    com_list = [commitments[k] for k in ZETA_OPENING_LABELS]
    val_list = [ev[k] for k in ZETA_OPENING_LABELS]
    if not kzg.verify_batch_open(
        com_list, zeta, val_list, proof.w_zeta, nu, vk.g2_gen, vk.g2_alpha
    ):
        return False
    if not kzg.verify_open(
        proof.z, zeta * omega % R, z_omega, proof.w_zeta_omega, vk.g2_gen, vk.g2_alpha
    ):
        return False
    return True
