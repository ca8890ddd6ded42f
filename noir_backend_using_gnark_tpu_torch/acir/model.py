"""ACIR circuit model: the dataclasses mirroring acvm 0.5's serde JSON.

Reference formats (ground truth = the three inline fixtures in
gnark_backend_ffi/main.go:223-248):

  * ``ACIR``: ``{"current_witness_index": u32, "opcodes": [...],
    "public_inputs": [u32]}`` (acir/acir.go:11-75),
  * opcodes are a tagged union on the JSON key: ``"Arithmetic"``,
    ``"BlackBoxFuncCall"`` or ``"Directive"`` (opcode.go:13-36 tries in
    order; we dispatch on the key, which is equivalent and stricter),
  * ``Arithmetic``: ``{"mul_terms": [[coeffHex, u32, u32]],
    "linear_combinations": [[coeffHex, u32]], "q_c": coeffHex}``
    (arithmetic_opcode.go:19-83, term/mul_term.go:21-62 tuple format),
  * ``BlackBoxFuncCall``: ``{"name": str, "inputs": [{"witness": u32,
    "num_bits": u32}], "outputs": [u32]}``
    (black_box_function_call_opcode.go:47-122),
  * ``Directive``: any object with a ``"Directive"`` key; the payload
    carries the directive kind (e.g. ``{"Invert": {"x": u32,
    "result": u32}}``) which our witness solver interprets
    (directive_opcode.go:9-28 ignores the payload; the reference's
    solver lives in acvm — src/backend.rs:109-170 only handles black
    boxes).

Coefficients are 32-byte big-endian hex felts reduced mod Fr
(helpers.go:13-22).

Witness indices are 1-based: the dense values vector that crosses the
API is indexed 1..current_witness_index-1 (src/backend.rs:24-33).
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import Any, Union


class BlackBoxFunc(Enum):
    """The 13 ACIR black-box functions (black_box_function_call_opcode.go:11-27)."""

    AES = "AES"
    AND = "AND"
    XOR = "XOR"
    RANGE = "RANGE"
    SHA256 = "SHA256"
    BLAKE2S = "Blake2s"
    MERKLE_MEMBERSHIP = "MerkleMembership"
    SCHNORR_VERIFY = "SchnorrVerify"
    PEDERSEN = "Pedersen"
    HASH_TO_FIELD_128_SECURITY = "HashToField128Security"
    ECDSA_SECP256K1 = "EcdsaSecp256k1"
    FIXED_BASE_SCALAR_MUL = "FixedBaseScalarMul"
    KECCAK256 = "Keccak256"


#: Mirror of the reference's support matrix (src/backend.rs:40-56).
SUPPORTED_BLACK_BOX = {
    BlackBoxFunc.AND: True,
    BlackBoxFunc.XOR: True,
    BlackBoxFunc.RANGE: True,
    BlackBoxFunc.SHA256: True,
    BlackBoxFunc.BLAKE2S: True,
    BlackBoxFunc.HASH_TO_FIELD_128_SECURITY: True,
    BlackBoxFunc.ECDSA_SECP256K1: True,
    BlackBoxFunc.AES: False,
    BlackBoxFunc.MERKLE_MEMBERSHIP: False,
    BlackBoxFunc.SCHNORR_VERIFY: False,
    BlackBoxFunc.PEDERSEN: False,
    BlackBoxFunc.FIXED_BASE_SCALAR_MUL: False,
    BlackBoxFunc.KECCAK256: False,
}


@dataclass(frozen=True)
class MulTerm:
    """coefficient * w[multiplicand] * w[multiplier] (mul_term.go:16-20)."""

    coefficient: int
    multiplicand: int
    multiplier: int


@dataclass(frozen=True)
class SimpleTerm:
    """coefficient * w[variable] (simple_term.go:16-19)."""

    coefficient: int
    variable: int


@dataclass(frozen=True)
class ArithmeticOpcode:
    """PLONK-shaped gate: sum mul_terms + sum linear_combinations + q_c == 0
    (README.md:73-87 of the reference)."""

    mul_terms: tuple[MulTerm, ...]
    linear_combinations: tuple[SimpleTerm, ...]
    q_c: int


@dataclass(frozen=True)
class FunctionInput:
    witness: int
    num_bits: int


@dataclass(frozen=True)
class BlackBoxFuncCall:
    name: BlackBoxFunc
    inputs: tuple[FunctionInput, ...]
    outputs: tuple[int, ...]


@dataclass(frozen=True)
class Directive:
    """Directive opcode; ``kind`` is e.g. "Invert" and ``payload`` its body.

    The reference skips these during lowering (sparse_r1cs.go:36-37);
    our witness solver executes the kinds acvm 0.5 defines.
    """

    kind: str
    payload: Any


Opcode = Union[ArithmeticOpcode, BlackBoxFuncCall, Directive]


@dataclass(frozen=True)
class Circuit:
    """An ACIR circuit (acir/acir.go:11-15)."""

    current_witness_index: int
    opcodes: tuple[Opcode, ...]
    public_inputs: tuple[int, ...]

    @property
    def num_vars(self) -> int:
        """acvm ``Circuit::num_vars`` = current_witness_index + 1 (witness
        ids are 0-based but id 0 is never used by the backend)."""
        return self.current_witness_index + 1

    @property
    def dense_values_len(self) -> int:
        """Length of the dense witness-values vector crossing the API:
        indices 1..=current_witness_index (src/backend.rs:24-33 iterates
        ``1..num_vars``; the main.go:233 fixture has
        current_witness_index=6 and a 6-element values vector)."""
        return self.current_witness_index

    def circuit_size(self) -> int:
        """The reference's circuit-size formula: #opcodes + per arithmetic
        opcode (num_mul_terms + 1) (src/gnark_backend_wrapper/mod.rs:56-73).

        Like the reference, raises on black-box opcodes (only Arithmetic
        and Directive are counted; mod.rs:67-69 errors on anything else).
        """
        total = len(self.opcodes)
        for op in self.opcodes:
            if isinstance(op, ArithmeticOpcode):
                total += len(op.mul_terms) + 1
            elif isinstance(op, Directive):
                pass
            else:
                from ..errors import UnsupportedOpcodeError

                raise UnsupportedOpcodeError(
                    f"circuit_size: unsupported opcode {type(op).__name__}"
                )
        return total
