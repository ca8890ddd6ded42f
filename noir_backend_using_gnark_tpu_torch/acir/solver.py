"""Partial witness generator (the acvm pwg loop).

The reference delegates arithmetic/directive solving to acvm's default
loop and only implements black boxes (src/backend.rs:109-170; SURVEY.md
§3.4). Here the whole loop is ours:

  * arithmetic opcodes are solved by the standard expression solver —
    when every term but one (linear) unknown is determined, solve for
    it; fully-determined gates are checked;
  * ``Invert`` directives compute field inverses (0 -> 0), matching
    acvm's Directive::Invert semantics used by the x != y test circuits
    (main.go:233 fixture opcode 2);
  * black boxes dispatch to :mod:`.blackbox`.

Iterates to a fixed point; anything still unsolved is reported.
"""

from __future__ import annotations

from ..errors import OpcodeResolutionError
from ..utils import bigint
from . import blackbox, model

FR = bigint.FR_MODULUS


def _solve_arithmetic(op: model.ArithmeticOpcode, witness: dict) -> bool:
    """Try to solve one gate; returns True if it made progress or is
    fully satisfied, False if stuck. Raises on contradiction."""
    const = op.q_c % FR
    unknown_coeff: dict[int, int] = {}
    stuck = False

    for mt in op.mul_terms:
        a_known = mt.multiplicand in witness
        b_known = mt.multiplier in witness
        if a_known and b_known:
            const = (const + mt.coefficient * witness[mt.multiplicand] * witness[mt.multiplier]) % FR
        elif a_known:
            c = mt.coefficient * witness[mt.multiplicand] % FR
            unknown_coeff[mt.multiplier] = (unknown_coeff.get(mt.multiplier, 0) + c) % FR
        elif b_known:
            c = mt.coefficient * witness[mt.multiplier] % FR
            unknown_coeff[mt.multiplicand] = (unknown_coeff.get(mt.multiplicand, 0) + c) % FR
        else:
            stuck = True

    for st in op.linear_combinations:
        if st.variable in witness:
            const = (const + st.coefficient * witness[st.variable]) % FR
        else:
            unknown_coeff[st.variable] = (unknown_coeff.get(st.variable, 0) + st.coefficient) % FR

    unknowns = {v: c for v, c in unknown_coeff.items() if c != 0}
    if stuck:
        return False
    if not unknowns:
        # Variables whose net coefficient cancelled to zero are
        # unconstrained by this gate; the residual must vanish.
        if unknown_coeff and any(v not in witness for v in unknown_coeff):
            # still indeterminate vars with zero coefficient: gate is
            # satisfied iff residual is zero regardless of them.
            pass
        if const % FR != 0:
            raise OpcodeResolutionError(f"unsatisfied arithmetic constraint: residual {const}")
        return True
    if len(unknowns) == 1:
        (var, coeff), = unknowns.items()
        witness[var] = (-const) * pow(coeff, -1, FR) % FR
        return True
    return False


def _solve_directive(d: model.Directive, witness: dict) -> bool:
    if d.kind == "Invert":
        x = d.payload.get("x")
        result = d.payload.get("result")
        if x is None or result is None:
            raise OpcodeResolutionError(f"malformed Invert directive: {d.payload!r}")
        if x not in witness:
            return False
        v = witness[x]
        witness[result] = 0 if v % FR == 0 else pow(v, -1, FR)
        return True
    if d.kind == "Quotient":
        # Integer division of field values: a = q*b + r over the integers.
        p = d.payload
        a_w, b_w = p.get("a"), p.get("b")
        if isinstance(a_w, int) and isinstance(b_w, int):
            if a_w not in witness or b_w not in witness:
                return False
            a_v, b_v = witness[a_w], witness[b_w]
            if b_v == 0:
                raise OpcodeResolutionError("Quotient directive: division by zero")
            witness[p["q"]] = a_v // b_v
            witness[p["r"]] = a_v % b_v
            return True
        raise OpcodeResolutionError("Quotient directive with expression operands unsupported")
    raise OpcodeResolutionError(f"unsupported directive kind {d.kind!r}")


def solve(circuit: model.Circuit, initial_witness: dict) -> dict:
    """Run the pwg loop to a fixed point.

    ``initial_witness``: 1-based ACIR witness index -> field int (the
    Prover.toml inputs). Returns the completed witness map. Raises
    OpcodeResolutionError if the circuit cannot be fully solved.
    """
    return _solve_python(circuit, initial_witness)


def _solve_python(circuit: model.Circuit, initial_witness: dict) -> dict:
    witness = {k: v % FR for k, v in initial_witness.items()}
    pending = list(circuit.opcodes)

    progress = True
    while pending and progress:
        progress = False
        still = []
        for op in pending:
            if isinstance(op, model.ArithmeticOpcode):
                if _solve_arithmetic(op, witness):
                    progress = True
                else:
                    still.append(op)
            elif isinstance(op, model.Directive):
                if _solve_directive(op, witness):
                    progress = True
                else:
                    still.append(op)
            elif isinstance(op, model.BlackBoxFuncCall):
                try:
                    blackbox.solve_black_box(op, witness)
                    progress = True
                except KeyError:
                    still.append(op)  # inputs not ready yet
            else:
                raise OpcodeResolutionError(f"unknown opcode {type(op).__name__}")
        pending = still

    if pending:
        raise OpcodeResolutionError(
            f"witness solving stuck with {len(pending)} unsolved opcodes"
        )
    return witness


def dense_values(circuit: model.Circuit, witness: dict) -> list:
    """Witness map -> dense values vector (1..=current_witness_index,
    missing entries 0) — get_values_from_witness_tree
    (src/backend.rs:24-33)."""
    return [witness.get(i, 0) % FR for i in range(1, circuit.dense_values_len + 1)]
