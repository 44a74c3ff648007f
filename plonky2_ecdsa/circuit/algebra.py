"""Field-algebra adapters so gate constraints are written once and evaluated
both over the base field (prover, vectorized on the LDE coset) and over the
quadratic extension (verifier, at the FRI evaluation point zeta).

Equivalent of the reference gates' dual `eval_unfiltered` /
`eval_unfiltered_circuit` pattern (src/gates/mul_nonnative.rs:101-166) — here a
single constraint function runs under either algebra.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl


class BaseAlgebra:
    """Elements are (lo, hi) u32-array pairs (vectorized Goldilocks)."""

    ext = False

    def __init__(self, xp=np, shape=()):
        self.xp = xp
        self.shape = shape

    def const(self, c: int):
        return gl.from_int(c, self.shape, self.xp)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return gl.add(*a, *b)

    def sub(self, a, b):
        return gl.sub(*a, *b)

    def neg(self, a):
        return gl.neg(*a)

    def mul(self, a, b):
        return gl.mul(*a, *b)

    def mul_const(self, a, c: int):
        c %= gl.P
        if c < 1 << 32:
            return gl.mul_small(*a, np.uint32(c))
        return gl.mul(*a, *self.const(c))

    def add_const(self, a, c: int):
        return gl.add(*a, *self.const(c))

    def from_wire(self, lo, hi):
        """Wire column data -> algebra element (identity for base)."""
        return (lo, hi)


class ExtAlgebra:
    """Elements are ((lo,hi),(lo,hi)) pairs — GF(p^2) = GF(p)[x]/(x^2-7)."""

    ext = True

    def __init__(self, xp=np, shape=()):
        self.xp = xp
        self.shape = shape

    def const(self, c: int):
        z = gl.from_int(0, self.shape, self.xp)
        return (gl.from_int(c, self.shape, self.xp), z)

    def zero(self):
        return self.const(0)

    def one(self):
        return self.const(1)

    def add(self, a, b):
        return gl.ext_add(a, b)

    def sub(self, a, b):
        return gl.ext_sub(a, b)

    def neg(self, a):
        return gl.ext_neg(a)

    def mul(self, a, b):
        return gl.ext_mul(a, b)

    def mul_const(self, a, c: int):
        c %= gl.P
        if c < 1 << 32:
            return (gl.mul_small(*a[0], np.uint32(c)), gl.mul_small(*a[1], np.uint32(c)))
        s = gl.from_int(c, self.shape, self.xp)
        return gl.ext_scalar_mul(a, s)

    def add_const(self, a, c: int):
        return (gl.add(*a[0], *gl.from_int(c, self.shape, self.xp)), a[1])

    def from_wire(self, val):
        """val: extension element already."""
        return val
