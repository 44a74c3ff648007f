"""Curve gadget tests vs the native oracle (reference parity:
curve.rs:288-515, curve_windowed_mul.rs:176-257, curve_msm.rs:81-137,
curve_fixed_base.rs:68-117, glv.rs:173-219, ecdsa.rs:80-182)."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.foreign import BITS, base_field, scalar_field
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.gadgets import curve as gc
from plonky2_ecdsa.gadgets import nonnative as gn

N = 9
MASK = (1 << BITS) - 1


def to_limbs(vals, n=N):
    out = np.zeros((len(vals), n), np.uint64)
    for i, v in enumerate(vals):
        for j in range(n):
            out[i, j] = (v >> (BITS * j)) & MASK
    return out


def from_limbs(arr):
    return [sum(int(l) << (BITS * j) for j, l in enumerate(row)) for row in arr]


def virtual_point(b, curve, name):
    p = gc.add_virtual_affine_point(b, curve)
    b.register_input(name + "_x", p.x.limbs)
    b.register_input(name + "_y", p.y.limbs)
    return p


def point_inputs(name, pts):
    return {name + "_x": to_limbs([p.x for p in pts]),
            name + "_y": to_limbs([p.y for p in pts])}


def run(build_fn, inputs, B):
    b = CircuitBuilder(CircuitConfig.test_config())
    build_fn(b)
    c = b.build()
    W = c.generate_witness(inputs, B)
    pis = c.public_input_values()
    assert check_constraints(c, W, pis) == {}
    return c, pis


def rand_point(rng, curve):
    k = int.from_bytes(rng.bytes(40), "little") % curve.n
    return cn.scalar_mul(curve.generator(), k or 1)


@pytest.mark.parametrize("curve", [cn.SECP256K1, cn.P256], ids=lambda c: c.name)
def test_curve_add_double_valid(rng, curve):
    p1s = [rand_point(rng, curve) for _ in range(3)]
    p2s = [rand_point(rng, curve) for _ in range(3)]
    B = 3

    def build(b):
        p1 = virtual_point(b, curve, "p1")
        p2 = virtual_point(b, curve, "p2")
        gc.curve_assert_valid(b, p1)
        s = gc.curve_add(b, p1, p2, True)
        d = gc.curve_double(b, p1, True)
        n = gc.curve_neg(b, p1, True)
        b.register_public_inputs(s.x.limbs + s.y.limbs + d.x.limbs + d.y.limbs
                                 + n.y.limbs)

    inputs = {**point_inputs("p1", p1s), **point_inputs("p2", p2s)}
    c, pis = run(build, inputs, B)
    adds = [a + bb for a, bb in zip(p1s, p2s)]
    dbls = [a.double() for a in p1s]
    assert from_limbs(pis[:, :N]) == [p.x for p in adds]
    assert from_limbs(pis[:, N:2 * N]) == [p.y for p in adds]
    assert from_limbs(pis[:, 2 * N:3 * N]) == [p.x for p in dbls]
    assert from_limbs(pis[:, 3 * N:4 * N]) == [p.y for p in dbls]
    assert from_limbs(pis[:, 4 * N:5 * N]) == [(-p.y) % curve.p for p in p1s]


def test_curve_point_is_not_valid(rng):
    curve = cn.SECP256K1
    p = rand_point(rng, curve)

    def build(b):
        pt = virtual_point(b, curve, "p")
        gc.curve_assert_valid(b, pt)

    bad = cn.Point(curve, p.x, (p.y + 1) % curve.p)
    b = CircuitBuilder(CircuitConfig.test_config())
    build(b)
    c = b.build()
    with pytest.raises(AssertionError):
        W = c.generate_witness(point_inputs("p", [bad]), 1)
        assert check_constraints(c, W, c.public_input_values()) == {}


def test_curve_conditional_ops(rng):
    curve = cn.SECP256K1
    p1s = [rand_point(rng, curve) for _ in range(2)]
    p2s = [rand_point(rng, curve) for _ in range(2)]
    bools = [1, 0]
    B = 2

    def build(b):
        p1 = virtual_point(b, curve, "p1")
        p2 = virtual_point(b, curve, "p2")
        bt = b.add_virtual_target()
        b.register_input("bt", [bt])
        b.assert_bool(bt)
        ca = gc.curve_conditional_add(b, p1, p2, bt, True)
        cng = gc.curve_conditional_neg(b, p1, bt)
        b.register_public_inputs(ca.x.limbs + ca.y.limbs + cng.y.limbs)

    inputs = {**point_inputs("p1", p1s), **point_inputs("p2", p2s),
              "bt": np.array(bools, np.uint64)[:, None]}
    c, pis = run(build, inputs, B)
    want = [a + bb if t else a for a, bb, t in zip(p1s, p2s, bools)]
    assert from_limbs(pis[:, :N]) == [p.x for p in want]
    assert from_limbs(pis[:, N:2 * N]) == [p.y for p in want]
    assert from_limbs(pis[:, 2 * N:3 * N]) == [
        (-a.y) % curve.p if t else a.y for a, t in zip(p1s, bools)]


def test_repeated_double(rng):
    curve = cn.SECP256K1
    pts = [rand_point(rng, curve) for _ in range(2)]
    B = 2

    def build(b):
        p = virtual_point(b, curve, "p")
        d4 = gc.curve_repeated_double(b, p, 4, True)
        b.register_public_inputs(d4.x.limbs + d4.y.limbs)

    c, pis = run(build, point_inputs("p", pts), B)
    want = []
    for p in pts:
        q = p
        for _ in range(4):
            q = q.double()
        want.append(q)
    assert from_limbs(pis[:, :N]) == [p.x for p in want]
    assert from_limbs(pis[:, N:2 * N]) == [p.y for p in want]
