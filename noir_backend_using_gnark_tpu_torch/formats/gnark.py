"""gnark v0.8 / gnark-crypto v0.9 artifact byte layouts (BN254): a host
copy of ``noir_backend_using_gnark_tpu/formats/gnark.py``.

The reference persists proofs, keys and the SRS as hex-encoded gnark
``WriteTo`` blobs (gnark_backend_ffi/internal/backend/helpers.go:35-94,
backend/common.go:86-125). Layouts:

  * **points**: gnark-crypto's flag scheme (top two bits of the first
    byte: ``10``/``11`` compressed with the smallest/largest y, ``01``
    infinity). G1 compressed is 32 bytes; G2 compressed is 64 bytes
    (x.A1 || x.A0, big-endian), the y sign chosen by lexicographic
    order on (A1, A0) (gnark-crypto ecc/bn254/marshal.go);
  * **kzg.SRS** (gnark-crypto kzg/marshal.go): G2[0], G2[1] (compressed)
    then ``u32 BE count`` and the compressed G1 points;
  * **plonk.VerifyingKey** (gnark backend/plonk/bn254/marshal.go):
    Size u64 || SizeInv fr || Generator fr || NbPublicVariables u64 ||
    CosetShift fr || S[3] || Ql || Qr || Qm || Qo || Qk;
  * **plonk.Proof** (same file): LRO[3] || Z || H[3] ||
    BatchedProof.H || ClaimedValues (u32-count fr slice) ||
    ZShiftedOpening.H || ClaimedValue fr.

fr elements are 32-byte big-endian. The SRS's G1 points are packed and
unpacked in one batch (artifacts.g1_batch_compress and
g1_batch_decompress: the square roots of decompression come from one
batched exponentiation on the SRS's device).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from ..artifacts import g1_batch_compress, g1_batch_decompress, g1_compress, g1_decompress
from ..errors import DeserializeKeyError, DeserializeProofError
from ..utils import bigint

Q = bigint.FQ_MODULUS
R = bigint.FR_MODULUS

_MASK = 0b11 << 6
_COMPRESSED_SMALLEST = 0b10 << 6
_COMPRESSED_LARGEST = 0b11 << 6
_COMPRESSED_INFINITY = 0b01 << 6

#: G1 points are 32 compressed bytes in gnark's layouts too.
g1_bytes = g1_compress


def fr_bytes(v: int) -> bytes:
    return (v % R).to_bytes(32, "big")


def fr_read(data: bytes, off: int) -> tuple[int, int]:
    v = int.from_bytes(data[off : off + 32], "big")
    if v >= R:
        raise ValueError("fr element out of range")
    return v, off + 32


def g1_read(data: bytes, off: int):
    return g1_decompress(data[off : off + 32]), off + 32


# ---------------------------------------------------------------------------
# G2 (64-byte compressed)
# ---------------------------------------------------------------------------


def _fq2_lex_larger(a: tuple[int, int], b: tuple[int, int]) -> bool:
    """gnark's lexicographic order on FQ2 (A1 first, then A0)."""
    if a[1] != b[1]:
        return a[1] > b[1]
    return a[0] > b[0]


def g2_bytes_compressed(point) -> bytes:
    """G2 affine (pair of hostcurve.FQ2) -> 64 bytes."""
    if point is None:
        out = bytearray(64)
        out[0] = _COMPRESSED_INFINITY
        return bytes(out)
    x, y = point
    xa0, xa1 = int(x.coeffs[0]), int(x.coeffs[1])
    ya0, ya1 = int(y.coeffs[0]), int(y.coeffs[1])
    na0, na1 = (Q - ya0) % Q, (Q - ya1) % Q
    out = bytearray(xa1.to_bytes(32, "big") + xa0.to_bytes(32, "big"))
    out[0] |= _COMPRESSED_LARGEST if _fq2_lex_larger((ya0, ya1), (na0, na1)) else _COMPRESSED_SMALLEST
    return bytes(out)


def _fq2_sqrt(a):
    """Square root in FQ2 = Fq[u]/(u^2 + 1) by the complex method
    (q = 3 mod 4), or None when ``a`` is not a square."""
    from ..utils import hostcurve as H

    a0, a1 = int(a.coeffs[0]), int(a.coeffs[1])
    if a1 == 0:
        s = pow(a0, (Q + 1) // 4, Q)
        if s * s % Q == a0:
            return H.FQ2([s, 0])
        # a0 is a non-residue: sqrt = u * sqrt(-a0)
        s = pow((Q - a0) % Q, (Q + 1) // 4, Q)
        if s * s % Q != (Q - a0) % Q:
            return None
        return H.FQ2([0, s])
    # Norm n = a0^2 + a1^2 with s = sqrt(n) in Fq; x0 = sqrt((a0 + s)/2)
    # for one of the two signs of s, and x1 = a1 / (2 x0).
    n = (a0 * a0 + a1 * a1) % Q
    s = pow(n, (Q + 1) // 4, Q)
    if s * s % Q != n:
        return None
    half = pow(2, -1, Q)
    for sign in (1, Q - 1):
        x0sq = (a0 + s * sign % Q) * half % Q
        x0 = pow(x0sq, (Q + 1) // 4, Q)
        if x0 == 0 or x0 * x0 % Q != x0sq:
            continue
        cand = H.FQ2([x0, a1 * pow(2 * x0 % Q, -1, Q) % Q])
        if cand * cand == a:
            return cand
    return None


def g2_read_compressed(data: bytes, off: int):
    """64 compressed bytes at ``off`` -> (G2 affine point or None, next
    offset), with the curve and r-torsion checks."""
    from ..utils import hostcurve as H

    raw = data[off : off + 64]
    if len(raw) != 64:
        raise ValueError("truncated G2 point")
    flag = raw[0] & _MASK
    if flag == _COMPRESSED_INFINITY:
        if any(raw[1:]) or (raw[0] & ~_MASK):
            raise ValueError("nonzero payload on G2 infinity")
        return None, off + 64
    if flag not in (_COMPRESSED_SMALLEST, _COMPRESSED_LARGEST):
        raise ValueError(f"bad G2 compression flag {flag:#x}")
    xa1 = int.from_bytes(bytes([raw[0] & ~_MASK]) + raw[1:32], "big")
    xa0 = int.from_bytes(raw[32:64], "big")
    if xa0 >= Q or xa1 >= Q:
        raise ValueError("G2 x-coordinate out of range")
    x = H.FQ2([xa0, xa1])
    y = _fq2_sqrt(x * x * x + H.G2_B)  # y^2 = x^3 + b' on the twist
    if y is None:
        raise ValueError("G2 x not on the twist")
    ya0, ya1 = int(y.coeffs[0]), int(y.coeffs[1])
    na0, na1 = (Q - ya0) % Q, (Q - ya1) % Q
    if _fq2_lex_larger((ya0, ya1), (na0, na1)) != (flag == _COMPRESSED_LARGEST):
        y = H.FQ2([na0, na1])
    pt = (x, y)
    if H.g2_mul(pt, R) is not None:
        raise ValueError("G2 point not in the r-torsion subgroup")
    return pt, off + 64


# ---------------------------------------------------------------------------
# kzg.SRS (gnark-crypto kzg/marshal.go)
# ---------------------------------------------------------------------------


def srs_to_gnark_bytes(srs) -> bytes:
    """Our kzg.SRS -> gnark-crypto kzg.SRS WriteTo stream."""
    pts = g1_batch_compress(srs.g1_powers)
    return b"".join([
        g2_bytes_compressed(srs.g2_gen), g2_bytes_compressed(srs.g2_alpha),
        struct.pack(">I", pts.shape[0]), pts.tobytes(),
    ])


def srs_from_gnark_bytes(data: bytes, device="cpu"):
    """gnark-crypto kzg.SRS stream -> our kzg.SRS, its G1 powers on
    ``device`` (decompressed there in one batch)."""
    from ..kzg.kzg import SRS

    try:
        g2_gen, off = g2_read_compressed(data, 0)
        g2_alpha, off = g2_read_compressed(data, off)
        (count,) = struct.unpack(">I", data[off : off + 4])
        off += 4
        if len(data) < off + 32 * count:
            raise ValueError("truncated point section")
        raw = np.frombuffer(data, np.uint8, count=32 * count, offset=off).reshape(count, 32)
        g1 = g1_batch_decompress(raw, device)
        return SRS(g1_powers=g1, g2_gen=g2_gen, g2_alpha=g2_alpha)
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeKeyError(f"gnark SRS: {e}") from e


# ---------------------------------------------------------------------------
# plonk.VerifyingKey (gnark backend/plonk/bn254/marshal.go)
# ---------------------------------------------------------------------------


def vk_to_gnark_bytes(vk) -> bytes:
    """Our plonk VerifyingKey -> gnark VerifyingKey WriteTo stream.

    Size = n, SizeInv = 1/n mod r, Generator = omega, NbPublicVariables,
    CosetShift = k1 (gnark derives the second coset as CosetShift^2, and
    our k2 = k1^2 = 25), S[0..2], then Ql Qr Qm Qo Qk with Qk = our q_c.
    """
    return b"".join([
        struct.pack(">Q", vk.n), fr_bytes(pow(vk.n, -1, R)), fr_bytes(vk.generator),
        struct.pack(">Q", vk.nb_public), fr_bytes(vk.k1),
        *(g1_bytes(pt) for pt in (vk.s1, vk.s2, vk.s3, vk.q_l, vk.q_r, vk.q_m, vk.q_o, vk.q_c)),
    ])


def vk_init_kzg(vk, srs):
    """Attach an SRS's G2 pair to a vk read from gnark bytes (gnark's
    ``vk.InitKZG``, backend/plonk/plonk.go:34-40). Returns the vk."""
    vk.g2_gen = srs.g2_gen
    vk.g2_alpha = srs.g2_alpha
    return vk


def vk_from_gnark_bytes(data: bytes, g2_gen=None, g2_alpha=None, srs=None):
    """gnark VerifyingKey stream -> our VerifyingKey.

    gnark's vk does not hold the KZG G2 points; pass them directly, via
    ``srs``, or later with :func:`vk_init_kzg`. Without them the pairing
    checks of verify fail closed.
    """
    from ..plonk.keys import VerifyingKey

    if srs is not None:
        g2_gen, g2_alpha = srs.g2_gen, srs.g2_alpha
    try:
        (n,) = struct.unpack(">Q", data[0:8])
        size_inv, off = fr_read(data, 8)
        generator, off = fr_read(data, off)
        (nb_public,) = struct.unpack(">Q", data[off : off + 8])
        k1, off = fr_read(data, off + 8)
        if n and size_inv != pow(n, -1, R):
            raise ValueError("SizeInv inconsistent with Size")
        pts = []
        for _ in range(8):
            p, off = g1_read(data, off)
            pts.append(p)
        s1, s2, s3, q_l, q_r, q_m, q_o, q_c = pts
        return VerifyingKey(
            n=n, nb_public=nb_public, generator=generator, k1=k1, k2=k1 * k1 % R,
            q_l=q_l, q_r=q_r, q_o=q_o, q_m=q_m, q_c=q_c, s1=s1, s2=s2, s3=s3,
            g2_gen=g2_gen, g2_alpha=g2_alpha,
        )
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeKeyError(f"gnark vk: {e}") from e


# ---------------------------------------------------------------------------
# plonk.Proof (gnark backend/plonk/bn254/marshal.go)
# ---------------------------------------------------------------------------


@dataclass
class GnarkProof:
    """gnark v0.8's proof shape: 7 commitments + batched opening at
    zeta (H + claimed values: linearized poly, l, r, o, s1, s2) +
    the shifted opening of Z at omega*zeta."""

    lro: tuple  # 3 G1 points
    z: object
    h: tuple  # 3 G1 points
    batched_h: object
    claimed_values: list = field(default_factory=list)
    shifted_h: object = None
    z_shifted_value: int = 0


def proof_to_gnark_bytes(p: GnarkProof) -> bytes:
    out = [g1_compress(pt) for pt in (*p.lro, p.z, *p.h, p.batched_h)]
    out.append(struct.pack(">I", len(p.claimed_values)))
    out.extend(fr_bytes(v) for v in p.claimed_values)
    out.append(g1_compress(p.shifted_h))
    out.append(fr_bytes(p.z_shifted_value))
    return b"".join(out)


def proof_from_gnark_bytes(data: bytes) -> GnarkProof:
    try:
        off = 0
        pts = []
        for _ in range(8):
            p, off = g1_read(data, off)
            pts.append(p)
        (count,) = struct.unpack(">I", data[off : off + 4])
        off += 4
        vals = []
        for _ in range(count):
            v, off = fr_read(data, off)
            vals.append(v)
        shifted_h, off = g1_read(data, off)
        zval, off = fr_read(data, off)
        if off != len(data):
            raise ValueError("trailing bytes after gnark proof")
        return GnarkProof(
            lro=(pts[0], pts[1], pts[2]),
            z=pts[3],
            h=(pts[4], pts[5], pts[6]),
            batched_h=pts[7],
            claimed_values=vals,
            shifted_h=shifted_h,
            z_shifted_value=zval,
        )
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeProofError(f"gnark proof: {e}") from e
