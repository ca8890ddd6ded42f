"""Fiat-Shamir transcript of the expanded PLONK layout: a host copy of
``noir_backend_using_gnark_tpu/plonk/transcript.py``.

SHA-256 sponge with labeled absorption. The reference delegates its
transcript to gnark's internal fiat-shamir (invisible behind
``plonk.Prove``, backend/plonk/plonk.go:69); ours is specified here so
that proofs are verifiable by any reimplementation:

  * ``absorb(label, data)`` appends ``len(label) || label || len(data)
    || data`` (4-byte BE lengths) into a running SHA-256;
  * ``challenge(name)`` forks the state with the name, reduces the
    digest big-endian mod r, and absorbs the drawn value (so later
    challenges depend on earlier ones).

Deterministic given the same absorbed artifacts. Byte-compatibility
with gnark v0.8's transcript is NOT claimed (cannot be validated
in-environment; tracked as a conformance gap in README).
"""

from __future__ import annotations

import hashlib

from ..utils import bigint

FR = bigint.FR_MODULUS


class Transcript:
    def __init__(self, protocol: str):
        self._h = hashlib.sha256()
        self.absorb(b"protocol", protocol.encode())

    def absorb(self, label: bytes, data: bytes) -> None:
        self._h.update(len(label).to_bytes(4, "big"))
        self._h.update(label)
        self._h.update(len(data).to_bytes(4, "big"))
        self._h.update(data)

    def absorb_felt(self, label: bytes, value: int) -> None:
        self.absorb(label, bigint.felt_to_bytes_be(value))

    def absorb_point(self, label: bytes, point) -> None:
        """Affine G1 point as 64 bytes (x||y BE), infinity as zeros."""
        if point is None:
            self.absorb(label, b"\x00" * 64)
        else:
            x, y = point
            self.absorb(label, x.to_bytes(32, "big") + y.to_bytes(32, "big"))

    def challenge(self, name: bytes) -> int:
        fork = self._h.copy()
        fork.update(b"challenge:" + name)
        value = int.from_bytes(fork.digest(), "big") % FR
        self.absorb(b"drawn:" + name, bigint.felt_to_bytes_be(value))
        return value


#: Labels of the eight vk commitments, in vk.commitment_list() order.
_VK_LABELS = (b"vk_ql", b"vk_qr", b"vk_qo", b"vk_qm", b"vk_qc", b"vk_s1", b"vk_s2", b"vk_s3")


def expanded_transcript(vk, publics) -> Transcript:
    """The expanded PLONK protocol's transcript up to its first
    commitments: bound to the domain size, the vk's selector and sigma
    commitments (as gnark's bindPublicData binds them) and the public
    values. The prover and the verifier both start from it."""
    ts = Transcript("noirtpu-plonk-v2")
    ts.absorb(b"n", vk.n.to_bytes(8, "big"))
    for label, pt in zip(_VK_LABELS, vk.commitment_list()):
        ts.absorb_point(label, pt)
    for p in publics:
        ts.absorb_felt(b"public", p)
    return ts
