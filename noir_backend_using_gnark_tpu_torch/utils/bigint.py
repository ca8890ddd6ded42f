"""Host-side big-integer utilities: BN254 constants and the felt codecs.

A host copy of ``noir_backend_using_gnark_tpu/utils/bigint.py`` without
its 16-bit limb helpers (the port's limb layout lives in ops/field.py).

Wire-format notes (kept byte-compatible with the reference backend):
  * A field element ("felt") crosses the reference's FFI as a 32-byte
    big-endian blob, hex-encoded (reference: src/gnark_backend_wrapper/
    serialize.rs:10-17 reverses arkworks' LE serialization into BE, and
    gnark decodes it with ``Element.SetBytes`` which is BE —
    gnark_backend_ffi/internal/backend/helpers.go:13-22).
  * A felt *vector* is ``u32 BE count || 32B-BE felts``, hex-encoded
    (serialize.rs:33-47 / ``Vector.UnmarshalBinary`` helpers.go:24-33).
"""

from __future__ import annotations

# ---------------------------------------------------------------------------
# BN254 constants
# ---------------------------------------------------------------------------

# Scalar field modulus r (the "Fr" the prover works over; coefficients of
# ACIR gates are elements of this field — see the p-1 coefficient
# 0x30644e72...f0000000 in the reference's inline ACIR fixtures,
# gnark_backend_ffi/main.go:233-246).
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617

# Base field modulus q (coordinates of BN254 points).
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# BN254 curve: y^2 = x^3 + 3 over Fq; generator of G1.
G1_GENERATOR = (1, 2)

# Fr multiplicative-subgroup facts used by the NTT: r - 1 = 2^28 * odd.
FR_TWO_ADICITY = 28
# 5 generates (a superset of) the 2^28-torsion: ROOT_OF_UNITY has exact
# order 2^28 (verified in tests/test_field.py).
FR_MULTIPLICATIVE_GENERATOR = 5
FR_ROOT_OF_UNITY = pow(5, (FR_MODULUS - 1) >> FR_TWO_ADICITY, FR_MODULUS)

# G2 over Fq2 = Fq[u]/(u^2+1): y^2 = x^3 + 3/(9+u). Generator (c0, c1) pairs.
G2_GENERATOR_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GENERATOR_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# ---------------------------------------------------------------------------
# Wire-format codecs (reference-compatible)
# ---------------------------------------------------------------------------

def felt_to_bytes_be(x: int) -> bytes:
    """Serialize a felt as the reference does: 32 bytes big-endian.

    Mirrors serialize.rs:10-17 (ark LE reversed to BE) == gnark
    ``Element.Bytes()``.
    """
    return int(x).to_bytes(32, "big")


def felt_from_bytes_be(b: bytes, modulus: int = FR_MODULUS) -> int:
    """Deserialize like gnark ``Element.SetBytes`` (helpers.go:13-22):
    interpret big-endian and reduce mod the field."""
    return int.from_bytes(b, "big") % modulus


def encode_felts(felts) -> str:
    """``u32 BE count || 32B-BE felts``, hex-encoded (serialize.rs:33-47):
    the witness wire format of ``target/witness.hex``."""
    felts = list(felts)
    return (len(felts).to_bytes(4, "big") + b"".join(felt_to_bytes_be(f) for f in felts)).hex()


def decode_felts(encoded: str, modulus: int = FR_MODULUS) -> list[int]:
    """Inverse of :func:`encode_felts` (helpers.go:24-33 /
    ``Vector.UnmarshalBinary``)."""
    raw = bytes.fromhex(encoded)
    if len(raw) < 4:
        raise ValueError("encoded felts shorter than the u32 count prefix")
    n = int.from_bytes(raw[:4], "big")
    body = raw[4:]
    if len(body) != 32 * n:
        raise ValueError(f"encoded felts: expected {32*n} body bytes, got {len(body)}")
    return [felt_from_bytes_be(body[32 * i : 32 * i + 32], modulus) for i in range(n)]


def decode_felt_hex(encoded: str, modulus: int = FR_MODULUS) -> int:
    """Hex string -> felt, the coefficient format inside ACIR JSON
    (helpers.go:13-22; fixtures main.go:233-246)."""
    return felt_from_bytes_be(bytes.fromhex(encoded), modulus)


def encode_felt_hex(x: int) -> str:
    return felt_to_bytes_be(x).hex()
