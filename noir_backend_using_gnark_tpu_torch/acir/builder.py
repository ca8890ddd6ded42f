"""Programmatic ACIR circuit construction.

A small gate-level builder used (a) by tests/fixtures to reconstruct
the reference's 15 Noir test programs as ACIR (no Noir compiler ships
in this environment — the reference drives a forked nargo binary,
tests/tests.rs:88-99), and (b) as a user-facing API for building
circuits without Noir.

The gadgets mirror the patterns the real Noir->ACIR compiler emits, as
evidenced by the reference's inline fixtures (main.go:233-246): e.g.
``assert_neq`` produces exactly the 5-opcode diff/Invert/flag pattern
of the x != y fixture.
"""

from __future__ import annotations

from ..utils import bigint
from . import model

R = bigint.FR_MODULUS
MINUS_ONE = R - 1


class CircuitBuilder:
    def __init__(self):
        self._next = 0
        self.opcodes: list[model.Opcode] = []
        self.public: list[int] = []
        self._const_cache: dict[int, int] = {}

    # -- witnesses -------------------------------------------------------

    def witness(self, public: bool = False) -> int:
        self._next += 1
        if public:
            self.public.append(self._next)
        return self._next

    def witnesses(self, n: int, public: bool = False) -> list[int]:
        return [self.witness(public) for _ in range(n)]

    def constant(self, value: int) -> int:
        """A witness pinned to a constant by a gate w - value == 0."""
        value %= R
        if value in self._const_cache:
            return self._const_cache[value]
        w = self.witness()
        self.gate(linear=[(1, w)], q_c=(-value) % R)
        self._const_cache[value] = w
        return w

    # -- raw gates -------------------------------------------------------

    def gate(self, mul=(), linear=(), q_c: int = 0):
        """sum mul (c,i,j) + sum linear (c,i) + q_c == 0."""
        self.opcodes.append(
            model.ArithmeticOpcode(
                tuple(model.MulTerm(c % R, i, j) for c, i, j in mul),
                tuple(model.SimpleTerm(c % R, i) for c, i in linear),
                q_c % R,
            )
        )

    def directive_invert(self, x: int, result: int):
        self.opcodes.append(model.Directive("Invert", {"x": x, "result": result}))

    def black_box(self, name: model.BlackBoxFunc, inputs, outputs):
        self.opcodes.append(
            model.BlackBoxFuncCall(
                name,
                tuple(model.FunctionInput(w, b) for w, b in inputs),
                tuple(outputs),
            )
        )

    # -- arithmetic gadgets ---------------------------------------------

    def add(self, x: int, y: int) -> int:
        z = self.witness()
        self.gate(linear=[(1, x), (1, y), (MINUS_ONE, z)])
        return z

    def sub(self, x: int, y: int) -> int:
        z = self.witness()
        self.gate(linear=[(1, x), (MINUS_ONE, y), (MINUS_ONE, z)])
        return z

    def mul(self, x: int, y: int) -> int:
        z = self.witness()
        self.gate(mul=[(1, x, y)], linear=[(MINUS_ONE, z)])
        return z

    def assert_eq_const(self, x: int, value: int):
        self.gate(linear=[(1, x)], q_c=(-value) % R)

    def assert_eq(self, x: int, y: int):
        self.gate(linear=[(1, x), (MINUS_ONE, y)])

    def assert_bool(self, x: int):
        """x * x == x."""
        self.gate(mul=[(1, x, x)], linear=[(MINUS_ONE, x)])

    def is_nonzero(self, x: int) -> int:
        """Flag = 1 if x != 0 else 0 — the Invert pattern of the
        reference fixture (main.go:233, opcodes 1-3)."""
        inv = self.witness()
        self.directive_invert(x, inv)
        flag = self.witness()
        self.gate(mul=[(1, x, inv)], linear=[(MINUS_ONE, flag)])
        self.gate(mul=[(1, x, flag)], linear=[(MINUS_ONE, x)])
        return flag

    def assert_neq(self, x: int, y: int):
        diff = self.sub(x, y)
        flag = self.is_nonzero(diff)
        self.gate(linear=[(MINUS_ONE, flag)], q_c=1)  # flag == 1

    def is_eq(self, x: int, y: int) -> int:
        """Boolean witness z = (x == y)."""
        diff = self.sub(x, y)
        nz = self.is_nonzero(diff)
        z = self.witness()
        self.gate(linear=[(1, nz), (1, z)], q_c=MINUS_ONE)  # z = 1 - nz
        return z

    # -- boolean gadgets -------------------------------------------------

    def bool_not(self, x: int) -> int:
        z = self.witness()
        self.gate(linear=[(1, x), (1, z)], q_c=MINUS_ONE)  # z = 1 - x
        return z

    def bool_or(self, x: int, y: int) -> int:
        """z = x + y - x*y."""
        z = self.witness()
        self.gate(mul=[(MINUS_ONE, x, y)], linear=[(1, x), (1, y), (MINUS_ONE, z)])
        return z

    def bool_and(self, x: int, y: int) -> int:
        z = self.witness()
        self.gate(mul=[(1, x, y)], linear=[(MINUS_ONE, z)])
        return z

    def assert_arrays_neq(self, xs: list[int], ys: list[int]):
        """constrain a != b for arrays: some element differs."""
        flags = [self.is_nonzero(self.sub(x, y)) for x, y in zip(xs, ys)]
        total = flags[0]
        for f in flags[1:]:
            total = self.add(total, f)
        self.assert_neq(total, self.constant(0))

    def range_check(self, x: int, bits: int):
        self.black_box(model.BlackBoxFunc.RANGE, [(x, bits)], [])

    # -- finalize --------------------------------------------------------

    def build(self) -> model.Circuit:
        return model.Circuit(
            current_witness_index=self._next,
            opcodes=tuple(self.opcodes),
            public_inputs=tuple(self.public),
        )
