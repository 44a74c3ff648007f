"""Gadget-level soundness negatives + malformed-proof robustness.

The reference gets soundness coverage implicitly by FRI-proving every gadget
test (SURVEY.md §4); this repo's gadget tests are constraint-check-only, so
these tests explicitly corrupt witnesses (nonnative q/r/carry wires, range
lookup out-of-range values) and structurally malform proofs, asserting
prove-or-verify rejection."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.examples import (nonnative_mul_chain_circuit,
                                                small_demo_circuit,
                                                small_demo_witness)
from plonky2_ecdsa.circuit.gates import MulNonNativeGate
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.verifier import verify


def _mul_chain_setup(rng):
    b = nonnative_mul_chain_circuit(num_muls=3)
    c = b.build()
    d = build_circuit_data(c)
    x = int.from_bytes(rng.bytes(31), "little")
    y = int.from_bytes(rng.bytes(31), "little")
    from tests.test_gadgets_scalar_mul import to_limbs

    W = c.generate_witness({"x": to_limbs([x]), "y": to_limbs([y])}, 1)
    pis = c.public_input_values()
    return c, d, W, pis


def _mulnn_row_and_gate(c):
    for gi, gate in enumerate(c.gates):
        if isinstance(gate, MulNonNativeGate):
            return int(c.gate_rows[gi][0]), gate
    raise AssertionError("no MulNonNative row")


def test_good_mul_chain_proves(rng):
    c, d, W, pis = _mul_chain_setup(rng)
    assert verify(d, prove(d, W, pis))


@pytest.mark.parametrize("which", ["q", "r", "carry"])
def test_corrupted_nonnative_witness_rejected(rng, which):
    """Corrupting a q/r/carry hint wire of a nonnative mul must yield a
    proof that fails verification (the fused MulNonNative constraint set,
    reference mul_nonnative.rs:101-130,411-427)."""
    c, d, W, pis = _mul_chain_setup(rng)
    row, gate = _mulnn_row_and_gate(c)
    col = {"q": gate.wire_q(0), "r": gate.wire_r(0),
           "carry": gate.wire_b(0)}[which]
    W = W.copy()
    W[col, row, 0] ^= np.uint64(1)
    assert not verify(d, prove(d, W, pis))


def test_out_of_range_lookup_value_rejected(rng):
    """A value >= 2^bits whose limbs recombine correctly must still be
    rejected: the out-of-range limb cannot be matched by any multiplicity
    assignment over the table (the LogUp soundness core)."""
    cfg = CircuitConfig.test_config()
    b = CircuitBuilder(cfg)
    x = b.add_virtual_target()
    b.register_input("x", [x])
    b.range_check(x, 29)
    b.register_public_inputs([x])
    c = b.build()
    d = build_circuit_data(c)
    # in-range value: proves and verifies
    W = c.generate_witness({"x": np.array([[123456]], np.uint64)}, 1)
    assert verify(d, prove(d, W, c.public_input_values()))
    # out-of-range value (2^29): limbs/multiplicities are generated
    # faithfully, so the recombination holds but the lookup cannot
    W = c.generate_witness({"x": np.array([[1 << 29]], np.uint64)}, 1)
    assert not verify(d, prove(d, W, c.public_input_values()))


def test_malformed_proofs_return_false(rng):
    """verify() must return False (not crash) on structurally malformed
    proofs: truncated arrays, wrong dtypes/ranks, dropped fields."""
    import jax

    from plonky2_ecdsa.prover.prover import _register_pytrees

    _register_pytrees()
    c = small_demo_circuit().build()
    d = build_circuit_data(c)
    W, pis = small_demo_witness(c, batch=2)
    p = prove(d, W, pis)
    assert verify(d, p)

    leaves, treedef = jax.tree_util.tree_flatten(p)
    rng_np = np.random.default_rng(0)
    shape_cases = shape_fails = 0
    for i in range(len(leaves)):
        if rng_np.random() > 0.4:  # fuzz a sample of leaves, keep test fast
            continue
        orig = np.asarray(leaves[i])
        for mutate in (
            lambda a: a[..., : max(1, a.shape[-1] // 2)] if a.ndim else a,
            lambda a: a.astype(np.float32) if a.ndim else a,
            lambda a: a.reshape(-1) if a.ndim > 1 else a,
        ):
            mutated = mutate(orig)
            bad = list(leaves)
            bad[i] = mutated
            bad_proof = jax.tree_util.tree_unflatten(treedef, bad)
            res = verify(d, bad_proof)  # the hard requirement: must not raise
            assert res in (True, False)
            if mutated.shape != orig.shape:
                shape_cases += 1
                shape_fails += not res
    # a few leaves survive truncation via numpy broadcasting of identical
    # values (e.g. unused hi words); materially broken shapes must fail
    assert shape_cases > 10
    assert shape_fails / shape_cases >= 0.8, (shape_fails, shape_cases)
