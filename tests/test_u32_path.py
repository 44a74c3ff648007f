"""u32-pair device-arithmetic path on the CPU backend.

The CPU and GPU backends switch Goldilocks interior math to native u64
(jaxcfg.FIELD_INTERIOR), so the default test suite never compiles the
u32-pair formulation.  These tests force the
u32-pair interior (gl._FORCE_U32 escape hatch) through a REAL jitted
prove+verify on a micro circuit small enough for XLA:CPU to compile in
seconds, and require bit-exact parity with the u64-interior host prover —
any u32-path arithmetic bug breaks the parity assert.
"""

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import make_jit_prover, prove
from plonky2_ecdsa.prover.verifier import verify_strict

P = gl.P


def _micro_config() -> CircuitConfig:
    """Tiny row shape: keeps the u32-pair XLA:CPU module compile-tractable
    (<1 min on a 2-core host) while exercising every prover stage."""
    return CircuitConfig(
        num_wires=16, num_routed_wires=8, num_constant_cols=4,
        range_lookup_limb_bits=3, range_lookup_vals=1,
        num_challenges=1, permutation_chunk_size=4,
        fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                      proof_of_work_bits=4),
    )


def _micro_circuit():
    b = CircuitBuilder(_micro_config())
    x = b.add_virtual_target()
    y = b.add_virtual_target()
    b.register_input("x", [x])
    b.register_input("y", [y])
    z = b.mul(x, y)
    w = b.mul_add(z, z, y)
    eq = b.is_equal(x, y)
    out = b.select(eq, z, w)
    b.range_check(x, 29)
    b.register_public_inputs([z, w, out])
    return b.build()


@pytest.fixture
def forced_u32():
    old = gl._FORCE_U32
    gl._FORCE_U32 = True
    try:
        yield
    finally:
        gl._FORCE_U32 = old


@pytest.mark.slow
def test_u32_forced_jit_prove_verify(rng, forced_u32):
    """Full prove under jit with u32-pair interior ops; proof verifies and
    is bit-identical to the u64-interior host prover's (computed outside the
    fixture's forcing window in the sibling test below via cross-check)."""
    circuit = _micro_circuit()
    B = 2
    xs = rng.integers(0, 1 << 6, size=(B, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    W = circuit.generate_witness({"x": xs, "y": ys}, B)
    pis = circuit.public_input_values()
    data = build_circuit_data(circuit)
    run = make_jit_prover(data)
    proof = run(W, pis)
    verify_strict(data, proof)

    # parity vs the numpy prover ALSO running u32-pair interior (same
    # fixture): validates the jnp u32 path against the np u32 path
    host = prove(data, W, pis)
    assert np.array_equal(np.asarray(proof.wires_cap[0]), host.wires_cap[0])
    assert np.array_equal(np.asarray(proof.zs_cap[0]), host.zs_cap[0])
    assert np.array_equal(np.asarray(proof.quotient_cap[0]), host.quotient_cap[0])
    assert np.array_equal(np.asarray(proof.openings0[0][0]), host.openings0[0][0])


def test_u32_vs_u64_host_paths_bit_identical(rng):
    """The u32-pair and native-u64 interior formulations of the numpy prover
    must be bit-identical on the same witness — a u32 arithmetic bug (carry,
    fold, canonicalization) fails here without any XLA in the loop."""
    circuit = _micro_circuit()
    B = 2
    xs = rng.integers(0, 1 << 6, size=(B, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    W = circuit.generate_witness({"x": xs, "y": ys}, B)
    pis = circuit.public_input_values()
    data = build_circuit_data(circuit)
    p64 = prove(data, W, pis)
    old = gl._FORCE_U32
    gl._FORCE_U32 = True
    try:
        p32 = prove(data, W, pis)
    finally:
        gl._FORCE_U32 = old
    verify_strict(data, p64)
    for a, b in [(p64.wires_cap, p32.wires_cap), (p64.zs_cap, p32.zs_cap),
                 (p64.quotient_cap, p32.quotient_cap)]:
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert np.array_equal(p64.openings0[0][0], p32.openings0[0][0])
    assert np.array_equal(p64.fri_proof.indices, p32.fri_proof.indices)
