"""Recursion-facing surface: in-circuit gate-constraint evaluation.

Every plonky2 gate implements `eval_unfiltered_circuit` alongside
`eval_unfiltered` (reference: src/gates/mul_nonnative.rs:132-166 evaluates the
convolution constraints over `ExtensionTarget<D>` with builder ops) so that a
*verifier circuit* can re-evaluate the constraint polynomials at zeta —
the building block of recursive proof composition.

In this framework the same capability falls out of the algebra-adapter design
(circuit/algebra.py): gate constraints are written once against an abstract
algebra, so `CircuitExtAlgebra` — whose elements are PAIRS of circuit targets
holding the two GF(p^2) = GF(p)[x]/(x^2 - 7) coordinates and whose ops emit
builder rows — gives every gate in the inventory an in-circuit evaluation
path at once.  `Gate.eval_circuit` (installed below) is the
`eval_unfiltered_circuit` analogue; `tests/test_recursion_surface.py` is the
in-circuit half of plonky2's `test_eval_fns` harness
(src/gates/mul_nonnative.rs:565-578).
"""

from __future__ import annotations

from ..fields.goldilocks import P

# Quadratic non-residue defining the extension: GF(p^2) = GF(p)[x]/(x^2 - W)
# (fields/goldilocks.py ext_mul uses the same W).
W = 7


class ExtTarget(tuple):
    """An extension-field element in-circuit: (c0, c1) target pair.

    plonky2 `ExtensionTarget<2>` equivalent (SURVEY.md §2.9 wire/target
    model)."""

    __slots__ = ()

    def __new__(cls, c0: int, c1: int):
        return super().__new__(cls, (c0, c1))


def add_virtual_ext(builder) -> ExtTarget:
    return ExtTarget(builder.add_virtual_target(), builder.add_virtual_target())


def connect_ext(builder, a: ExtTarget, b: ExtTarget) -> None:
    builder.connect(a[0], b[0])
    builder.connect(a[1], b[1])


def constant_ext(builder, c0: int, c1: int = 0) -> ExtTarget:
    return ExtTarget(builder.constant(c0 % P), builder.constant(c1 % P))


class CircuitExtAlgebra:
    """Gate-eval algebra whose elements are ExtTarget pairs and whose
    operations emit circuit rows (pooled ArithmeticGate op slots).

    Satisfies exactly the interface gate `eval` bodies consume
    (zero/one/const/add/sub/neg/mul/mul_const/add_const/from_wire), so
    `gate.eval(CircuitExtAlgebra(b), ...)` IS the in-circuit constraint
    evaluation — one definition, three interpreters (coset tensors / zeta
    point / circuit), mirroring the reference's native-vs-circuit eval
    duality."""

    ext = True

    def __init__(self, builder):
        self.b = builder

    # -- constants ----------------------------------------------------------
    def const(self, c: int) -> ExtTarget:
        return ExtTarget(self.b.constant(c % P), self.b.zero())

    def zero(self) -> ExtTarget:
        return ExtTarget(self.b.zero(), self.b.zero())

    def one(self) -> ExtTarget:
        return ExtTarget(self.b.one(), self.b.zero())

    # -- ring ops -----------------------------------------------------------
    def add(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        return ExtTarget(self.b.add(a[0], b[0]), self.b.add(a[1], b[1]))

    def sub(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        return ExtTarget(self.b.sub(a[0], b[0]), self.b.sub(a[1], b[1]))

    def neg(self, a: ExtTarget) -> ExtTarget:
        return ExtTarget(self.b.mul_const(P - 1, a[0]),
                         self.b.mul_const(P - 1, a[1]))

    def mul(self, a: ExtTarget, b: ExtTarget) -> ExtTarget:
        # (a0 + a1 x)(b0 + b1 x) = (a0 b0 + W a1 b1) + (a0 b1 + a1 b0) x
        p11 = self.b.mul(a[1], b[1])
        c0 = self.b.arithmetic(1, W, a[0], b[0], p11)
        p10 = self.b.mul(a[1], b[0])
        c1 = self.b.arithmetic(1, 1, a[0], b[1], p10)
        return ExtTarget(c0, c1)

    def mul_const(self, a: ExtTarget, c: int) -> ExtTarget:
        c %= P
        return ExtTarget(self.b.mul_const(c, a[0]), self.b.mul_const(c, a[1]))

    def add_const(self, a: ExtTarget, c: int) -> ExtTarget:
        return ExtTarget(self.b.add_const(a[0], c % P), a[1])

    def from_wire(self, val):
        return val


# Gate.eval_circuit (the eval_unfiltered_circuit analogue) is defined on the
# Gate base class in circuit/gates.py, delegating to CircuitExtAlgebra here —
# available regardless of whether this module was imported.
