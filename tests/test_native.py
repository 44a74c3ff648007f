"""Native (C++) witness executor: bit-identical to the numpy tape closures.

Covers every native opcode (mul/inv/add/sub/add_many nonnative, cmp_const,
range pools, arith, random_access, split, is_equal, scatter) on one circuit
that exercises them all, plus edge inputs (0, 1, m-1).  Skips cleanly when no
C++ toolchain is available (the numpy path is then the production path)."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit import foreign
from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.gadgets import nonnative as gn
from plonky2_ecdsa.native import get_lib

FF = foreign.secp256k1_base()
M = FF.m
BITS = 29
N = 9

needs_native = pytest.mark.skipif(get_lib() is None, reason="no C++ toolchain")


def to_limbs(vals, n=N):
    out = np.zeros((len(vals), n), np.uint64)
    for i, v in enumerate(vals):
        for j in range(n):
            out[i, j] = (v >> (BITS * j)) & ((1 << BITS) - 1)
    return out


def _mixed_circuit():
    b = CircuitBuilder(CircuitConfig.test_config())
    x = gn.add_virtual_nonnative(b, FF)
    y = gn.add_virtual_nonnative(b, FF)
    b.register_input("x", x.limbs)
    b.register_input("y", y.limbs)
    p = gn.mul_nonnative(b, x, y, range_check=True)      # mul_nn + cmp + ranges
    s = gn.add_nonnative(b, x, y, range_check=False)     # add_nn
    d = gn.sub_nonnative(b, p, s, range_check=False)     # sub_nn
    inv = gn.inv_nonnative(b, x, range_check=True)       # inv_nn
    tot = gn.add_many_nonnative(b, [p, s, d, inv], True)  # add_many_nn
    # native-target ops: arith / split / random_access / is_equal
    a = x.limbs[0]
    c = b.mul_add(a, y.limbs[0], x.limbs[1])             # arith
    bits = b.split_le_base2(a, BITS)                     # split gate tape op
    items = [x.limbs[i % N] for i in range(16)]
    idx = b.constant(5)
    out = b.random_access(idx, items)                    # random_access
    eq = b.is_equal(a, y.limbs[0])                       # is_equal
    for t in (c, out, eq):
        b.register_public_input(t)
    b.register_public_inputs(tot.limbs)
    return b.build()


@needs_native
def test_native_matches_numpy_tape(rng):
    c = _mixed_circuit()
    vals_x = [int.from_bytes(rng.bytes(40), "little") % (M - 1) + 1 for _ in range(4)]
    vals_y = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(4)]
    vals_x += [1, M - 1, M - 2, 12345]
    vals_y += [0, 1, M - 1, M - 1]
    B = len(vals_x)
    inputs = {"x": to_limbs(vals_x), "y": to_limbs(vals_y)}
    W_np = c.generate_witness(inputs, B, native=False)
    pis_np = c.public_input_values()
    W_nat = c.generate_witness(inputs, B, native=True)
    pis_nat = c.public_input_values()
    assert np.array_equal(W_np, W_nat)
    assert np.array_equal(pis_np, pis_nat)
    assert check_constraints(c, W_nat, pis_nat) == {}
    # every tape op in this circuit must have a native kernel
    nt = c._native_tape()
    assert nt.n_native == len(c.tape), (nt.n_native, len(c.tape))


@needs_native
def test_native_scatter_pair_matches(rng):
    c = _mixed_circuit()
    vals_x = [int.from_bytes(rng.bytes(40), "little") % (M - 1) + 1 for _ in range(3)]
    vals_y = [int.from_bytes(rng.bytes(40), "little") % M for _ in range(3)]
    B = len(vals_x)
    inputs = {"x": to_limbs(vals_x), "y": to_limbs(vals_y)}
    W = c.generate_witness(inputs, B, native=True)
    lo, hi = c.generate_witness_pair(inputs, B)
    ref = np.ascontiguousarray(np.moveaxis(W, -1, 0))
    rlo, rhi = gl.from_u64(ref)
    assert np.array_equal(lo, rlo)
    assert np.array_equal(hi, rhi)


@needs_native
def test_native_modular_inverse_edge_cases():
    """Binary-xgcd inverse: random + structured values against python pow."""
    from plonky2_ecdsa.circuit import foreign as fr

    for ff in (fr.secp256k1_base(), fr.secp256k1_scalar(),
               fr.p256_base(), fr.p256_scalar()):
        m = ff.m
        cases = [1, 2, m - 1, m - 2, (m + 1) // 2, 3, m // 3, 2**255 % m]
        rng = np.random.default_rng(42)
        cases += [int.from_bytes(rng.bytes(40), "little") % (m - 1) + 1
                  for _ in range(20)]
        # drive through a tiny inv circuit (exercises the C kernel)
        b = CircuitBuilder(CircuitConfig.test_config())
        x = gn.add_virtual_nonnative(b, ff)
        b.register_input("x", x.limbs)
        inv = gn.inv_nonnative(b, x, True)
        b.register_public_inputs(inv.limbs)
        c = b.build()
        B = len(cases)
        c.generate_witness({"x": to_limbs(cases)}, B, native=True)
        got = c.public_input_values()
        for i, v in enumerate(cases):
            want = pow(v, -1, m)
            have = sum(int(l) << (BITS * j) for j, l in enumerate(got[i]))
            assert have == want, (ff.m, v)
