"""ACIR JSON codec (acvm 0.5 serde format): a host copy of
``noir_backend_using_gnark_tpu/acir/parse.py``.

Decodes the exact wire format exercised by the reference's inline
fixtures (gnark_backend_ffi/main.go:233-246) and unit helpers; encoding
is the inverse (used by tests and the CLI's artifact store).

Dispatch is a *tagged union on the key name* — stricter than the
reference's try-each-type-in-order decode (acir/opcode/opcode.go:13-36)
but accepts the same documents; unknown keys are a parse error instead
of silently passing as a Directive.
"""

from __future__ import annotations

import json
from typing import Any

from ..errors import CircuitParseError
from ..utils import bigint
from . import model


def _felt(hex_str: Any) -> int:
    if not isinstance(hex_str, str):
        raise CircuitParseError(f"felt must be a hex string, got {type(hex_str).__name__}")
    try:
        return bigint.decode_felt_hex(hex_str)
    except ValueError as e:
        raise CircuitParseError(f"bad felt hex: {e}") from e


def _u32(v: Any, what: str) -> int:
    if isinstance(v, bool) or not isinstance(v, (int, float)) or int(v) != v or v < 0:
        raise CircuitParseError(f"{what} must be a non-negative integer, got {v!r}")
    return int(v)


def _parse_mul_term(t: Any) -> model.MulTerm:
    # Tuple format [coeffHex, u32, u32] (term/mul_term.go:21-62).
    if not isinstance(t, list) or len(t) != 3:
        raise CircuitParseError(f"mul term must be [coeff, i, j], got {t!r}")
    return model.MulTerm(_felt(t[0]), _u32(t[1], "multiplicand"), _u32(t[2], "multiplier"))


def _parse_simple_term(t: Any) -> model.SimpleTerm:
    # Tuple format [coeffHex, u32] (term/simple_term.go:20-51).
    if not isinstance(t, list) or len(t) != 2:
        raise CircuitParseError(f"linear term must be [coeff, i], got {t!r}")
    return model.SimpleTerm(_felt(t[0]), _u32(t[1], "variable"))


def _parse_arithmetic(body: Any) -> model.ArithmeticOpcode:
    if not isinstance(body, dict):
        raise CircuitParseError("Arithmetic body must be an object")
    try:
        mul_terms = tuple(_parse_mul_term(t) for t in body["mul_terms"])
        lin = tuple(_parse_simple_term(t) for t in body["linear_combinations"])
        q_c = _felt(body["q_c"])
    except KeyError as e:
        raise CircuitParseError(f"Arithmetic missing key {e}") from e
    return model.ArithmeticOpcode(mul_terms, lin, q_c)


def _parse_black_box(body: Any) -> model.BlackBoxFuncCall:
    if not isinstance(body, dict):
        raise CircuitParseError("BlackBoxFuncCall body must be an object")
    try:
        name = model.BlackBoxFunc(body["name"])
    except (KeyError, ValueError) as e:
        raise CircuitParseError(f"unknown black box function: {body.get('name')!r}") from e
    inputs = tuple(
        model.FunctionInput(_u32(i["witness"], "witness"), _u32(i["num_bits"], "num_bits"))
        for i in body.get("inputs", [])
    )
    outputs = tuple(_u32(o, "output") for o in body.get("outputs", []))
    return model.BlackBoxFuncCall(name, inputs, outputs)


def _parse_directive(body: Any) -> model.Directive:
    # Reference accepts any object with a "Directive" key
    # (directive_opcode.go:16-28); we keep the payload for the solver.
    if isinstance(body, dict) and len(body) == 1:
        kind, payload = next(iter(body.items()))
        return model.Directive(str(kind), payload)
    return model.Directive("", body)


def parse_opcode(obj: Any) -> model.Opcode:
    if not isinstance(obj, dict) or len(obj) != 1:
        raise CircuitParseError(f"opcode must be a single-key object, got {obj!r}")
    key, body = next(iter(obj.items()))
    if key == "Arithmetic":
        return _parse_arithmetic(body)
    if key == "BlackBoxFuncCall":
        return _parse_black_box(body)
    if key == "Directive":
        return _parse_directive(body)
    raise CircuitParseError(f"unknown opcode kind {key!r}")


def parse_circuit(doc: str | bytes | dict) -> model.Circuit:
    """ACIR JSON document -> :class:`model.Circuit` (acir/acir.go:17-75)."""
    if isinstance(doc, (str, bytes)):
        try:
            doc = json.loads(doc)
        except json.JSONDecodeError as e:
            raise CircuitParseError(f"invalid JSON: {e}") from e
    if not isinstance(doc, dict):
        raise CircuitParseError("ACIR document must be a JSON object")
    for key in ("opcodes", "public_inputs", "current_witness_index"):
        if key not in doc:
            raise CircuitParseError(f"ACIR missing key {key!r}")
    opcodes = tuple(parse_opcode(o) for o in doc["opcodes"])
    public_inputs = tuple(_u32(w, "public input") for w in doc["public_inputs"])
    cwi = _u32(doc["current_witness_index"], "current_witness_index")
    return model.Circuit(cwi, opcodes, public_inputs)


# ---------------------------------------------------------------------------
# Encoding (inverse codec)
# ---------------------------------------------------------------------------


def opcode_to_json(op: model.Opcode) -> dict:
    if isinstance(op, model.ArithmeticOpcode):
        return {
            "Arithmetic": {
                "mul_terms": [
                    [bigint.encode_felt_hex(t.coefficient), t.multiplicand, t.multiplier]
                    for t in op.mul_terms
                ],
                "linear_combinations": [
                    [bigint.encode_felt_hex(t.coefficient), t.variable]
                    for t in op.linear_combinations
                ],
                "q_c": bigint.encode_felt_hex(op.q_c),
            }
        }
    if isinstance(op, model.BlackBoxFuncCall):
        return {
            "BlackBoxFuncCall": {
                "name": op.name.value,
                "inputs": [{"witness": i.witness, "num_bits": i.num_bits} for i in op.inputs],
                "outputs": list(op.outputs),
            }
        }
    if isinstance(op, model.Directive):
        return {"Directive": {op.kind: op.payload} if op.kind else op.payload}
    raise TypeError(f"unknown opcode type {type(op)}")


def circuit_to_json(c: model.Circuit) -> str:
    return json.dumps(
        {
            "current_witness_index": c.current_witness_index,
            "opcodes": [opcode_to_json(o) for o in c.opcodes],
            "public_inputs": list(c.public_inputs),
        },
        separators=(",", ":"),
    )
