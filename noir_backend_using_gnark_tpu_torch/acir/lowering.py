"""ACIR lowering to the PLONK gate table (a host copy of the JAX package's).

PLONK lowering mirrors the reference's
``BuildSparseR1CS``/``handleArithmeticOpcode``
(gnark_backend_ffi/backend/plonk/sparse_r1cs.go:18-107) including its
deliberate quirks, so that circuits accepted there produce equivalent
constraint systems here:

  * only ``mul_terms[0]`` is used — the lowering assumes at most one mul
    term per gate (README.md:82 of the reference);
  * the gate's (xa, xb) wires come from the mul term, but are
    *overwritten* by the first two linear terms when 2 or 3 linear
    combinations are present (sparse_r1cs.go:63-90) — i.e. the mul term
    is assumed to multiply exactly those wires;
  * 1 linear term binds (qO, xc); 2 bind (qL,xa),(qR,xb); 3 bind all;
  * unset wire slots point at cs variable 0 with coefficient 0;
  * black-box function opcodes emit NO constraints (components.go:1-41
    stubs — support is witness-side only) and directives are skipped
    (sparse_r1cs.go:36-37).

Variable registration mirrors ``HandleValues``
(backend/common.go:45-76): walk the dense 1-based values vector, first
registering the public inputs (in values order), then the rest as
secrets. The reference's duplicate-secret bug for >1 public inputs
(common.go:59-74 appends a secret once per non-matching public input) is
FIXED here — for the <=1-public-input programs the suites exercise the
two are identical; for >1 publics the reference would build a
nonsensical witness.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..errors import UnsupportedOpcodeError
from . import model

@dataclass
class PlonkCircuit:
    """A lowered PLONK constraint system over Fr.

    Selectors are host ints (converted to device arrays by
    plonk.setup/prove); wires are cs-variable indices. The gate equation
    is qL*a + qR*b + qO*c + qM*(a*b) + qC == 0 per gate.
    """

    nb_public: int
    nb_vars: int  # total cs variables (publics then secrets)
    q_l: list
    q_r: list
    q_o: list
    q_m: list
    q_c: list
    wire_a: np.ndarray  # int32 (n_gates,)
    wire_b: np.ndarray
    wire_c: np.ndarray
    index_map: dict  # ACIR witness index (1-based) -> cs variable index
    public_witness_indices: list  # ACIR witness index per public var, in order

    @property
    def n_gates(self) -> int:
        return len(self.q_l)


def register_variables(circuit: model.Circuit):
    """Mirror of HandleValues' registration order (common.go:45-76).

    Returns (index_map, public_witness_indices, nb_vars). Walks the
    1-based dense positions 1..=current_witness_index: publics first (in
    position order), then everything else as secrets.
    """
    n = circuit.dense_values_len
    publics = set(circuit.public_inputs)
    index_map: dict[int, int] = {}
    public_witness_indices: list[int] = []
    next_idx = 0
    for i in range(1, n + 1):
        if i in publics:
            index_map[i] = next_idx
            public_witness_indices.append(i)
            next_idx += 1
    for i in range(1, n + 1):
        if i not in publics:
            index_map[i] = next_idx
            next_idx += 1
    return index_map, public_witness_indices, next_idx


def lower_to_plonk(circuit: model.Circuit) -> PlonkCircuit:
    """ACIR -> PLONK gate table (BuildSparseR1CS equivalent): one
    pass over the opcodes in Python (the JAX package's C++ fast path is
    not part of this port)."""
    index_map, public_witness_indices, nb_vars = register_variables(circuit)

    q_l, q_r, q_o, q_m, q_c = [], [], [], [], []
    wa, wb, wc = [], [], []

    for op in circuit.opcodes:
        if isinstance(op, model.ArithmeticOpcode):
            xa = xb = xc = 0
            ql = qr = qo = qm = 0

            if op.mul_terms:
                # Only mul_terms[0]; qM1=coeff, qM2=1 (sparse_r1cs.go:49-55).
                mt = op.mul_terms[0]
                qm = mt.coefficient
                xa = index_map.get(mt.multiplicand, 0)
                xb = index_map.get(mt.multiplier, 0)

            lin = op.linear_combinations
            if len(lin) == 1:
                qo = lin[0].coefficient
                xc = index_map.get(lin[0].variable, 0)
            elif len(lin) == 2:
                ql = lin[0].coefficient
                xa = index_map.get(lin[0].variable, 0)
                qr = lin[1].coefficient
                xb = index_map.get(lin[1].variable, 0)
            elif len(lin) == 3:
                ql = lin[0].coefficient
                xa = index_map.get(lin[0].variable, 0)
                qr = lin[1].coefficient
                xb = index_map.get(lin[1].variable, 0)
                qo = lin[2].coefficient
                xc = index_map.get(lin[2].variable, 0)
            elif len(lin) > 3:
                raise UnsupportedOpcodeError(
                    f"arithmetic opcode with {len(lin)} linear terms exceeds PLONK width 3"
                )

            q_l.append(ql)
            q_r.append(qr)
            q_o.append(qo)
            q_m.append(qm)
            q_c.append(op.q_c)
            wa.append(xa)
            wb.append(xb)
            wc.append(xc)
        elif isinstance(op, model.BlackBoxFuncCall):
            # No constraints emitted — witness-side only (components.go stubs).
            continue
        elif isinstance(op, model.Directive):
            continue
        else:
            raise UnsupportedOpcodeError(f"unknown opcode type {type(op).__name__}")

    return PlonkCircuit(
        nb_public=len(public_witness_indices),
        nb_vars=nb_vars,
        q_l=q_l,
        q_r=q_r,
        q_o=q_o,
        q_m=q_m,
        q_c=q_c,
        wire_a=np.asarray(wa, np.int32),
        wire_b=np.asarray(wb, np.int32),
        wire_c=np.asarray(wc, np.int32),
        index_map=index_map,
        public_witness_indices=public_witness_indices,
    )


def build_assignment(pc: PlonkCircuit, values: list) -> list:
    """Dense ACIR values (1-based, length current_witness_index) -> cs
    variable assignment [publics..., secrets...] (BuildWitnesses order,
    common.go:22-43)."""
    out = [0] * pc.nb_vars
    for wit_idx, var_idx in pc.index_map.items():
        if wit_idx - 1 < len(values):
            out[var_idx] = values[wit_idx - 1]
    return out
