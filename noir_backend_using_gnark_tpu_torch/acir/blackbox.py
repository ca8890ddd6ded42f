"""Black-box function solvers (witness generation side).

Mirrors the reference's ``solve_black_box_function_call``
(src/backend.rs:109-170): the 7 supported functions are solved here,
everything else raises UnsupportedBlackBoxFuncError. These run on host
(scalar data, a handful of bytes per call — not device work).
"""

from __future__ import annotations

import hashlib

from ..errors import OpcodeResolutionError, UnsupportedBlackBoxFuncError
from ..utils import bigint
from . import model

FR = bigint.FR_MODULUS


def fetch_nearest_bytes(value: int, num_bits: int) -> bytes:
    """Field value -> ceil(num_bits/8) big-endian bytes (acvm
    ``FieldElement::fetch_nearest_bytes`` semantics, used by the hash
    solvers — src/backend.rs:148)."""
    num_bytes = (num_bits + 7) // 8
    return (value % FR).to_bytes(32, "big")[32 - num_bytes :]


# ---------------------------------------------------------------------------
# secp256k1 (host-side ECDSA verification)
# ---------------------------------------------------------------------------

_SECP_P = 2**256 - 2**32 - 977
_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


def _secp_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % _SECP_P == 0:
            return None
        lam = (3 * x1 * x1) * pow(2 * y1, -1, _SECP_P) % _SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, _SECP_P) % _SECP_P
    x3 = (lam * lam - x1 - x2) % _SECP_P
    y3 = (lam * (x1 - x3) - y1) % _SECP_P
    return (x3, y3)


def _secp_mul(pt, k):
    acc = None
    add = pt
    k %= _SECP_N
    while k:
        if k & 1:
            acc = _secp_add(acc, add)
        add = _secp_add(add, add)
        k >>= 1
    return acc


def ecdsa_secp256k1_verify(pub_x: bytes, pub_y: bytes, sig: bytes, msg_hash: bytes) -> bool:
    """Standard prehashed ECDSA verification (acvm ``secp256k1_prehashed``)."""
    x = int.from_bytes(pub_x, "big")
    y = int.from_bytes(pub_y, "big")
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:64], "big")
    z = int.from_bytes(msg_hash, "big")
    if not (1 <= r < _SECP_N and 1 <= s < _SECP_N):
        return False
    if (y * y - x * x * x - 7) % _SECP_P != 0:
        return False
    w = pow(s, -1, _SECP_N)
    u1 = z * w % _SECP_N
    u2 = r * w % _SECP_N
    pt = _secp_add(_secp_mul(_SECP_G, u1), _secp_mul((x, y), u2))
    if pt is None:
        return False
    return pt[0] % _SECP_N == r


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------


def solve_black_box(call: model.BlackBoxFuncCall, witness: dict) -> None:
    """Solve one black-box call in place over the witness map
    (1-based ACIR witness index -> field int). Raises if inputs are
    missing (the solver loop retries later) or the function is
    unsupported (src/backend.rs error arms)."""

    def get(w: int) -> int:
        if w not in witness:
            raise KeyError(w)
        return witness[w]

    name = call.name
    if name in (model.BlackBoxFunc.AND, model.BlackBoxFunc.XOR):
        # solve_logic_opcode: bitwise over num_bits (src/backend.rs:117).
        a_in, b_in = call.inputs[0], call.inputs[1]
        mask = (1 << a_in.num_bits) - 1
        a, b = get(a_in.witness) & mask, get(b_in.witness) & mask
        out = (a & b) if name == model.BlackBoxFunc.AND else (a ^ b)
        witness[call.outputs[0]] = out
    elif name == model.BlackBoxFunc.RANGE:
        # solve_range_opcode: constraint check only, no outputs.
        inp = call.inputs[0]
        v = get(inp.witness)
        if v >= (1 << inp.num_bits):
            raise OpcodeResolutionError(
                f"RANGE check failed: witness {inp.witness} value has more than "
                f"{inp.num_bits} bits"
            )
    elif name in (model.BlackBoxFunc.SHA256, model.BlackBoxFunc.BLAKE2S):
        data = b"".join(fetch_nearest_bytes(get(i.witness), i.num_bits) for i in call.inputs)
        if name == model.BlackBoxFunc.SHA256:
            digest = hashlib.sha256(data).digest()
        else:
            digest = hashlib.blake2s(data).digest()
        if len(call.outputs) != len(digest):
            raise OpcodeResolutionError(
                f"{name.value}: expected {len(digest)} outputs, got {len(call.outputs)}"
            )
        for out_w, byte in zip(call.outputs, digest):
            witness[out_w] = byte
    elif name == model.BlackBoxFunc.HASH_TO_FIELD_128_SECURITY:
        # blake2s then reduce big-endian mod r (src/backend.rs:137-160).
        data = b"".join(fetch_nearest_bytes(get(i.witness), i.num_bits) for i in call.inputs)
        digest = hashlib.blake2s(data).digest()
        if len(call.outputs) != 1:
            raise OpcodeResolutionError("HashToField128Security expects exactly 1 output")
        witness[call.outputs[0]] = int.from_bytes(digest, "big") % FR
    elif name == model.BlackBoxFunc.ECDSA_SECP256K1:
        # Input layout (acvm secp256k1_prehashed): 32B pub_x, 32B pub_y,
        # 64B signature, then the hashed message bytes; one bool output.
        if len(call.inputs) < 128:
            raise OpcodeResolutionError("EcdsaSecp256k1: expected >= 128 byte inputs")
        vals = [get(i.witness) & 0xFF for i in call.inputs]
        pub_x = bytes(vals[0:32])
        pub_y = bytes(vals[32:64])
        sig = bytes(vals[64:128])
        msg = bytes(vals[128:])
        ok = ecdsa_secp256k1_verify(pub_x, pub_y, sig, msg)
        if call.outputs:
            witness[call.outputs[0]] = 1 if ok else 0
        elif not ok:
            raise OpcodeResolutionError("EcdsaSecp256k1: invalid signature")
    else:
        raise UnsupportedBlackBoxFuncError(f"unsupported black box function {name.value}")
