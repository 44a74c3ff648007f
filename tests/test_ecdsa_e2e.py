"""End-to-end secp256k1 ECDSA circuit: FRI-prove + verify in the suite.

Reference parity: every reference gadget test runs data.prove(pw) /
data.verify(proof) (src/gadgets/ecdsa.rs:122-124, SURVEY.md §4); this is the
equivalent for the full n=2^13 ECDSA verification circuit.  Slow-marked:
the numpy prover takes ~7 min for one lane on a 2-core host (bench.py runs
the jitted device path)."""

import numpy as np
import pytest

from plonky2_ecdsa.api import EcdsaProverSystem, random_statements
from plonky2_ecdsa.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa.curve import native as cn
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.verifier import verify, verify_one_exact


@pytest.mark.slow
def test_secp256k1_ecdsa_prove_verify_e2e():
    # reduced FRI query count for CPU wall-time; still a real FRI proof
    cfg = CircuitConfig(fri=FriConfig(rate_bits=2, cap_height=1,
                                      num_query_rounds=6,
                                      proof_of_work_bits=0))
    sysm = EcdsaProverSystem(config=cfg)
    assert sysm.n == 8192  # the LogUp range lookups keep the circuit at 2^13
    stmts = random_statements(cn.SECP256K1, 1, seed=11)
    W, pis = sysm.witness(stmts)
    proof = prove(sysm.data, W, pis)
    assert verify(sysm.data, proof)
    assert verify_one_exact(sysm.data, proof, 0)
    # tampering with the bound statement must break it
    proof.pis = proof.pis.copy()
    proof.pis[0, 0] ^= 1
    assert not verify(sysm.data, proof)


@pytest.mark.slow
def test_p256_ecdsa_prove_verify_e2e():
    """Full P-256 ECDSA verification circuit through FRI (windowed-mul path;
    reference parity: src/gadgets/ecdsa.rs:163-182 proves both curves).
    P-256 gets a real proof, not only a constraint check."""
    cfg = CircuitConfig(fri=FriConfig(rate_bits=2, cap_height=1,
                                      num_query_rounds=6,
                                      proof_of_work_bits=0))
    sysm = EcdsaProverSystem(cn.P256, config=cfg)
    stmts = random_statements(cn.P256, 1, seed=17)
    W, pis = sysm.witness(stmts)
    proof = prove(sysm.data, W, pis)
    assert verify(sysm.data, proof)
    assert verify_one_exact(sysm.data, proof, 0)
    proof.pis = proof.pis.copy()
    proof.pis[0, 0] ^= 1
    assert not verify(sysm.data, proof)
