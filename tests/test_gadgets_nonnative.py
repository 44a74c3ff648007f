"""Gadget tests: biguint + nonnative ops, witness-level constraint checking.
Mirrors the reference test inventory (SURVEY.md §4: biguint.rs:550-721,
nonnative.rs:897-1087) with batched random + edge inputs."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit import foreign
from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.gadgets import biguint as gb
from plonky2_ecdsa.gadgets import nonnative as gn

FF = foreign.secp256k1_base()
M = FF.m
BITS = 29
N = 9


def to_limbs(vals, n=N):
    """list of ints -> [B, n] u64 29-bit limb array."""
    out = np.zeros((len(vals), n), np.uint64)
    for i, v in enumerate(vals):
        for j in range(n):
            out[i, j] = (v >> (BITS * j)) & ((1 << BITS) - 1)
    return out


def from_limbs(arr):
    return [sum(int(l) << (BITS * j) for j, l in enumerate(row)) for row in arr]


def build_and_check(build_fn, inputs, B):
    b = CircuitBuilder(CircuitConfig.test_config())
    build_fn(b)
    c = b.build()
    W = c.generate_witness(inputs, B)
    pis = c.public_input_values()
    assert check_constraints(c, W, pis) == {}
    return c, pis


def rand_elems(rng, k):
    vals = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(k)]
    return vals + [0, 1, M - 1, M - 2]


def test_nonnative_mul(rng):
    vals_x = rand_elems(rng, 4)
    vals_y = rand_elems(rng, 4)
    B = len(vals_x)

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        y = gn.add_virtual_nonnative(b, FF)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        z = gn.mul_nonnative(b, x, y, range_check=True)
        b.register_public_inputs(z.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(vals_x), "y": to_limbs(vals_y)}, B)
    got = from_limbs(pis[:, :N])
    assert got == [(u * v) % M for u, v in zip(vals_x, vals_y)]


def test_nonnative_mul_many(rng):
    vals = [rand_elems(rng, 1)[:1] + rand_elems(rng, 1)[:1] + rand_elems(rng, 1)[:1]
            for _ in range(3)]
    xs = [v[0] for v in vals]
    ys = [v[1] for v in vals]
    zs = [v[2] for v in vals]
    B = 3

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        y = gn.add_virtual_nonnative(b, FF)
        z = gn.add_virtual_nonnative(b, FF)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        b.register_input("z", z.limbs)
        w = gn.mul_many_nonnative(b, [x, y, z], range_check=True)
        b.register_public_inputs(w.limbs)

    c, pis = build_and_check(
        build, {"x": to_limbs(xs), "y": to_limbs(ys), "z": to_limbs(zs)}, B)
    got = from_limbs(pis[:, :N])
    assert got == [(u * v * w) % M for u, v, w in zip(xs, ys, zs)]


def test_nonnative_add_sub_neg(rng):
    vx, vy = rand_elems(rng, 4), rand_elems(rng, 4)
    B = len(vx)

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        y = gn.add_virtual_nonnative(b, FF)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        s = gn.add_nonnative(b, x, y, True)
        d = gn.sub_nonnative(b, x, y, True)
        n = gn.neg_nonnative(b, x, True)
        b.register_public_inputs(s.limbs + d.limbs + n.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(vx), "y": to_limbs(vy)}, B)
    assert from_limbs(pis[:, :N]) == [(u + v) % M for u, v in zip(vx, vy)]
    assert from_limbs(pis[:, N:2 * N]) == [(u - v) % M for u, v in zip(vx, vy)]
    assert from_limbs(pis[:, 2 * N:3 * N]) == [(-u) % M for u in vx]


def test_nonnative_add_many(rng):
    cols = [rand_elems(rng, 2) for _ in range(4)]
    B = len(cols[0])

    def build(b):
        ts = []
        for i in range(4):
            t = gn.add_virtual_nonnative(b, FF)
            b.register_input(f"v{i}", t.limbs)
            ts.append(t)
        s = gn.add_many_nonnative(b, ts, True)
        b.register_public_inputs(s.limbs)

    inputs = {f"v{i}": to_limbs(cols[i]) for i in range(4)}
    c, pis = build_and_check(build, inputs, B)
    want = [sum(cols[i][k] for i in range(4)) % M for k in range(B)]
    assert from_limbs(pis[:, :N]) == want


def test_nonnative_inv(rng):
    vx = [v for v in rand_elems(rng, 4) if v != 0]
    B = len(vx)

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        b.register_input("x", x.limbs)
        inv = gn.inv_nonnative(b, x, True)
        b.register_public_inputs(inv.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(vx)}, B)
    got = from_limbs(pis[:, :N])
    for u, iv in zip(vx, got):
        assert (u * iv) % M == 1


def test_nonnative_conditional_ops(rng):
    vx, vy = rand_elems(rng, 2)[:4], rand_elems(rng, 2)[:4]
    bools = [1, 0, 1, 0]
    B = 4

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        y = gn.add_virtual_nonnative(b, FF)
        bt = b.add_virtual_target()
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        b.register_input("bt", [bt])
        b.assert_bool(bt)
        sel = gn.if_nonnative(b, bt, x, y, True)
        cn = gn.nonnative_conditional_neg(b, x, bt, True)
        mb = gn.mul_nonnative_by_bool(b, x, bt)
        b.register_public_inputs(sel.limbs + cn.limbs + mb.limbs)

    inputs = {"x": to_limbs(vx), "y": to_limbs(vy),
              "bt": np.array(bools, np.uint64)[:, None]}
    c, pis = build_and_check(build, inputs, B)
    assert from_limbs(pis[:, :N]) == [u if bb else v for u, v, bb in zip(vx, vy, bools)]
    assert from_limbs(pis[:, N:2 * N]) == [(-u) % M if bb else u for u, bb in zip(vx, bools)]
    assert from_limbs(pis[:, 2 * N:3 * N]) == [u if bb else 0 for u, bb in zip(vx, bools)]


def test_split_to_bits(rng):
    vx = rand_elems(rng, 1)[:2]
    B = 2

    def build(b):
        x = gn.add_virtual_nonnative(b, FF)
        b.register_input("x", x.limbs)
        bits = gn.split_nonnative_to_bits(b, x)
        b.register_public_inputs(bits[:32])

    c, pis = build_and_check(build, {"x": to_limbs(vx)}, B)
    for k, u in enumerate(vx):
        for j in range(32):
            assert int(pis[k, j]) == (u >> j) & 1


# ------------------------------- biguint layer -------------------------------

def test_biguint_add_sub_mul(rng):
    xv = [int.from_bytes(rng.bytes(16), "little") for _ in range(3)]
    yv = [int.from_bytes(rng.bytes(16), "little") for _ in range(3)]
    xv, yv = [max(a, c) for a, c in zip(xv, yv)], [min(a, c) for a, c in zip(xv, yv)]
    L = 5  # 128-bit values in 29-bit limbs
    B = 3

    def build(b):
        x = gb.add_virtual_biguint(b, L)
        y = gb.add_virtual_biguint(b, L)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        s = gb.add_biguint(b, x, y)
        d = gb.sub_biguint(b, x, y)
        p = gb.mul_biguint(b, x, y)
        sq = gb.square_biguint(b, x)
        b.register_public_inputs(s.limbs + d.limbs + p.limbs + sq.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(xv, L), "y": to_limbs(yv, L)}, B)
    o = 0
    s_len, d_len, p_len, sq_len = L + 1, L, 2 * L + 1, 2 * L + 1
    assert from_limbs(pis[:, o:o + s_len]) == [a + c for a, c in zip(xv, yv)]
    o += s_len
    assert from_limbs(pis[:, o:o + d_len]) == [a - c for a, c in zip(xv, yv)]
    o += d_len
    assert from_limbs(pis[:, o:o + p_len]) == [a * c for a, c in zip(xv, yv)]
    o += p_len
    assert from_limbs(pis[:, o:o + sq_len]) == [a * a for a in xv]


def test_biguint_cmp(rng):
    xv = [5, 10, 99, 2**100]
    yv = [5, 11, 7, 2**100 + 1]
    L = 4
    B = 4

    def build(b):
        x = gb.add_virtual_biguint(b, L)
        y = gb.add_virtual_biguint(b, L)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        le = gb.cmp_biguint(b, x, y)
        b.register_public_input(le)

    c, pis = build_and_check(build, {"x": to_limbs(xv, L), "y": to_limbs(yv, L)}, B)
    assert pis[:, 0].tolist() == [int(a <= c) for a, c in zip(xv, yv)]


def test_biguint_div_rem(rng):
    xv = [int.from_bytes(rng.bytes(16), "little") for _ in range(3)]
    yv = [int.from_bytes(rng.bytes(8), "little") | 1 for _ in range(3)]
    La, Lc = 5, 3  # 128-bit dividend, 64-bit divisor (minimal limb counts)
    B = 3

    def build(b):
        x = gb.add_virtual_biguint(b, La)
        y = gb.add_virtual_biguint(b, Lc)
        b.register_input("x", x.limbs)
        b.register_input("y", y.limbs)
        d, r = gb.div_rem_biguint(b, x, y)
        b.register_public_inputs(d.limbs + r.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(xv, La), "y": to_limbs(yv, Lc)}, B)
    d_len = La - Lc + 1
    got_d = from_limbs(pis[:, :d_len])
    got_r = from_limbs(pis[:, d_len:d_len + Lc])
    assert got_d == [a // c for a, c in zip(xv, yv)]
    assert got_r == [a % c for a, c in zip(xv, yv)]


def test_nonnative_reduce(rng):
    # reduce a 10-limb biguint mod the secp base field
    xv = [int.from_bytes(rng.bytes(36), "little") % (1 << 290) for _ in range(2)]
    L = 10
    B = 2

    def build(b):
        x = gb.add_virtual_biguint(b, L)
        b.register_input("x", x.limbs)
        r = gn.reduce_biguint(b, FF, x)
        b.register_public_inputs(r.limbs)

    c, pis = build_and_check(build, {"x": to_limbs(xv, L)}, B)
    assert from_limbs(pis[:, :N]) == [v % M for v in xv]
