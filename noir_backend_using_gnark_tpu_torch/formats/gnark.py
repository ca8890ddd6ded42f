"""gnark v0.8 proof bytes (BN254): a host copy of the proof codec of
``noir_backend_using_gnark_tpu/formats/gnark.py``.

The reference persists proofs as hex-encoded gnark ``WriteTo`` blobs
(gnark_backend_ffi/internal/backend/helpers.go:75-94). The layout of
``plonk.Proof`` (gnark backend/plonk/bn254/marshal.go): LRO[3] || Z ||
H[3] || BatchedProof.H || ClaimedValues (u32-count fr slice) ||
ZShiftedOpening.H || ClaimedValue fr. Points use gnark-crypto's flag
scheme (top two bits of the first byte: 10/11 compressed with the
smallest/largest y, 01 infinity); fr elements are 32-byte big-endian.
The gnark-layout SRS and vk codecs of the JAX module are not part of
this port yet.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

from ..artifacts import g1_compress, g1_decompress
from ..errors import DeserializeProofError
from ..utils import bigint

R = bigint.FR_MODULUS


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
