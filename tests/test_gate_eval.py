"""Gate-level tests: stacked (prover) vs per-constraint (verifier) evaluation
equivalence, and constraint-degree conformance — the equivalents of the
reference's test_low_degree / test_eval_fns gate harness
(src/gates/mul_nonnative.rs:549-579)."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit import foreign
from plonky2_ecdsa.circuit.algebra import BaseAlgebra
from plonky2_ecdsa.circuit.gates import (
    ArithmeticGate,
    BaseSum2Gate,
    BigCmpGate,
    ConstantGate,
    MulNonNativeGate,
    NonNativeAddGate,
    NonNativeAddManyGate,
    NonNativeSubGate,
    RandomAccessGate,
    RangeCheckGate,
)
from plonky2_ecdsa.fields import goldilocks as gl

P = gl.P
FF = foreign.secp256k1_base()

GATES = [
    ArithmeticGate(20),
    BaseSum2Gate(2, 29),
    RangeCheckGate(29, 8),
    RangeCheckGate(34, 7),
    MulNonNativeGate(FF),
    NonNativeAddGate(FF),
    NonNativeSubGate(FF),
    NonNativeAddManyGate(FF, 4),
    BigCmpGate(),
    RandomAccessGate(4, 4),
    ConstantGate(2),
]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.gate_id())
def test_eval_stacked_matches_eval(rng, gate):
    shape = (5,)
    wires_u64 = (rng.integers(0, P, size=(gate.num_wires,) + shape, dtype=np.uint64)
                 % np.uint64(P))
    warr = gl.from_u64(wires_u64)
    consts_u64 = rng.integers(0, P, size=(2,) + shape, dtype=np.uint64) % np.uint64(P)
    consts = [gl.from_u64(consts_u64[i]) for i in range(2)]
    alg = BaseAlgebra(np, shape)
    wires = [(warr[0][i], warr[1][i]) for i in range(gate.num_wires)]
    want = gate.eval(alg, wires, consts, {})
    got = gate.eval_stacked(alg, warr, consts, {})
    assert got[0].shape[0] == len(want) == gate.num_constraints
    for s, w in enumerate(want):
        assert np.array_equal(got[0][s], w[0]), f"constraint {s} lo mismatch"
        assert np.array_equal(got[1][s], w[1]), f"constraint {s} hi mismatch"


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.gate_id())
def test_declared_degree_bound(rng, gate):
    """Empirical low-degree test: evaluate each constraint on a univariate
    line through random wire/const points; the result must be a polynomial of
    degree <= gate.degree (checked by exact interpolation).  Equivalent in
    spirit to plonky2's test_low_degree."""
    d = gate.degree
    npts = 2 * d + 3
    # wires(t) = w0 + w1 * t for scalar t
    w0 = rng.integers(0, P, size=gate.num_wires, dtype=np.uint64) % np.uint64(P)
    w1 = rng.integers(0, P, size=gate.num_wires, dtype=np.uint64) % np.uint64(P)
    c0 = rng.integers(0, P, size=2, dtype=np.uint64) % np.uint64(P)
    c1 = rng.integers(0, P, size=2, dtype=np.uint64) % np.uint64(P)
    ts = list(range(npts))
    wires_at = np.zeros((gate.num_wires, npts), np.uint64)
    consts_at = np.zeros((2, npts), np.uint64)
    for j, t in enumerate(ts):
        wires_at[:, j] = (w0.astype(object) + w1.astype(object) * t) % P
        consts_at[:, j] = (c0.astype(object) + c1.astype(object) * t) % P
    alg = BaseAlgebra(np, (npts,))
    wires = [gl.from_u64(wires_at[i]) for i in range(gate.num_wires)]
    consts = [gl.from_u64(consts_at[i]) for i in range(2)]
    cons = gate.eval(alg, wires, consts, {})
    for ci, c in enumerate(cons):
        vals = [int(v) for v in gl.to_u64(*c)]
        # Newton forward differences: degree <= d iff (d+1)-th differences vanish
        diffs = vals[:]
        for _ in range(d + 1):
            diffs = [(diffs[i + 1] - diffs[i]) % P for i in range(len(diffs) - 1)]
        assert all(x == 0 for x in diffs), f"constraint {ci} exceeds degree {d}"
