"""Real recursion: proof-of-a-proof.

The outer circuit re-runs the ENTIRE verifier in-circuit — Fiat-Shamir
transcript via PoseidonGate rows (challenger_circuit.CircuitChallenger),
constraint identity at zeta, FRI PoW response, query-index bit derivation
with canonicity, every Merkle opening, fold consistency, final-poly
agreement — and is then itself proven through the same FRI prover and
verified natively.  Mirrors the role of the reference's gate eval duality
(src/gates/mul_nonnative.rs:132-166 exists exactly so an outer circuit can
re-evaluate constraints; SURVEY.md §2.9 "evaluated both natively and
recursively").
"""

import copy

import numpy as np
import pytest

from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig, FriConfig
from plonky2_ecdsa.circuit.poseidon_gate import PoseidonGate, poseidon_permute
from plonky2_ecdsa.circuit.recursive_verifier import (
    aggregation_inputs, build_aggregation_verifier, build_recursive_verifier,
    recursive_verifier_inputs, split_proof_lanes)
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.hash import poseidon
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.verifier import verify, verify_one_exact

P = gl.P


def _inner_config() -> CircuitConfig:
    """Small inner shape; final_poly_max_degree_bits=2 forces real FRI fold
    layers so the in-circuit fold/layer-Merkle logic is exercised."""
    return CircuitConfig(
        num_wires=16, num_routed_wires=8, num_constant_cols=4,
        range_lookup_limb_bits=3, range_lookup_vals=1,
        num_challenges=1, permutation_chunk_size=4,
        fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                      proof_of_work_bits=4, final_poly_max_degree_bits=2),
    )


def _inner_circuit():
    b = CircuitBuilder(_inner_config())
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


def _outer_config() -> CircuitConfig:
    """PoseidonGate is degree 7 -> blowup-8 row shape
    (standard_recursion_config's rate), scaled-down FRI for CPU tests."""
    return CircuitConfig(
        num_wires=136, num_routed_wires=80, num_constant_cols=2,
        range_lookup_limb_bits=3,
        fri=FriConfig(rate_bits=3, cap_height=1, num_query_rounds=8,
                      proof_of_work_bits=4),
    )


def test_poseidon_gate_matches_hash_oracle():
    """poseidon_permute outputs == hash/poseidon.py permutation; witness
    satisfies the gate constraints; a corrupted stored S-box wire violates
    them (the low-degree storage scheme actually binds every round)."""
    cfg = CircuitConfig.standard_recursion_config()
    b = CircuitBuilder(cfg)
    ins = b.add_virtual_targets(12)
    b.register_input("state", ins)
    outs = poseidon_permute(b, ins)
    b.register_public_inputs(outs)
    c = b.build()
    B = 3
    rng = np.random.default_rng(1)
    sv = rng.integers(0, P, (B, 12), dtype=np.uint64)
    W = c.generate_witness({"state": sv}, B)
    pis = c.public_input_values()
    lo, hi = gl.from_u64(sv.T.copy())
    want = gl.to_u64(*poseidon.permute_stacked(lo, hi)).T
    assert np.array_equal(pis, want)
    check_constraints(c, W, pis)
    gate = next(g for g in c.gates if g.gate_id() == "Poseidon")
    assert gate.num_wires == 130 and gate.num_constraints == 118
    gi = c.gates.index(gate)
    row = c.gate_rows[gi][0]
    W2 = W.copy()
    W2[gate.wire_partial(5), row, 0] ^= 1
    with pytest.raises(AssertionError):
        check_constraints(c, W2, pis)


def test_poseidon_gate_requires_rate8_config():
    """A degree-7 gate under a blowup-4 config must be rejected at
    build_circuit_data (it used to silently produce proofs that
    fail verification with an unrelated-looking FRI/quotient error)."""
    cfg = CircuitConfig(
        num_wires=136, num_routed_wires=80, num_constant_cols=2,
        range_lookup_limb_bits=3,
        fri=FriConfig(rate_bits=2, cap_height=1, num_query_rounds=4,
                      proof_of_work_bits=0))
    b = CircuitBuilder(cfg)
    ins = b.add_virtual_targets(12)
    b.register_input("state", ins)
    outs = poseidon_permute(b, ins)
    b.register_public_inputs(outs[:4])
    c = b.build()
    with pytest.raises(ValueError, match="degree 7 > blowup"):
        build_circuit_data(c)


@pytest.mark.slow
def test_poseidon_gate_proves_through_fri():
    """A chained-permutation circuit proves and verifies through FRI under
    the rate-8 config (degree-7 constraints carried by the real quotient)."""
    cfg = _outer_config()
    b = CircuitBuilder(cfg)
    ins = b.add_virtual_targets(12)
    b.register_input("state", ins)
    outs = poseidon_permute(b, poseidon_permute(b, ins))
    b.register_public_inputs(outs[:4])
    c = b.build()
    B = 2
    rng = np.random.default_rng(5)
    sv = rng.integers(0, P, (B, 12), dtype=np.uint64)
    W = c.generate_witness({"state": sv}, B)
    pis = c.public_input_values()
    d = build_circuit_data(c)
    p = prove(d, W, pis)
    assert verify(d, p)
    assert verify_one_exact(d, p, 0)
    W[70, 1, 0] ^= 1  # corrupt a Poseidon storage wire
    assert not verify(d, prove(d, W, pis))


@pytest.mark.slow
def test_recursive_proof_e2e():
    """The full proof-of-a-proof: prove a demo circuit, build its verifier
    circuit, feed the inner proof as witness, prove the VERIFIER circuit
    through FRI, verify the outer proof natively; outer public inputs ==
    inner public inputs; a tampered inner proof breaks the outer witness."""
    B = 2
    rng = np.random.default_rng(77)
    ic = _inner_circuit()
    xs = rng.integers(0, 1 << 29, size=(B, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    Wi = ic.generate_witness({"x": xs, "y": ys}, B)
    ipis = ic.public_input_values()
    idata = build_circuit_data(ic)
    iproof = prove(idata, Wi, ipis)
    assert verify(idata, iproof)

    ob = CircuitBuilder(_outer_config())
    build_recursive_verifier(ob, idata)
    oc = ob.build()
    counts = {g.gate_id(): len(oc.gate_rows.get(gi, ()))
              for gi, g in enumerate(oc.gates)}
    print("verifier circuit rows:", oc.n, counts)
    assert counts.get("Poseidon", 0) > 100  # the transcript+Merkle sponges

    inputs = recursive_verifier_inputs(idata, iproof)
    Wo = oc.generate_witness(inputs, B)
    opis = oc.public_input_values()
    assert np.array_equal(opis, ipis)  # inner PIs re-exported
    check_constraints(oc, Wo, opis)

    odata = build_circuit_data(oc)
    oproof = prove(odata, Wo, opis)
    assert verify(odata, oproof), "outer proof (proof-of-a-proof) must verify"
    assert verify_one_exact(odata, oproof, 0)

    # negative: tamper the inner proof -> outer constraints must fail
    bad = copy.deepcopy(iproof)
    bad.openings0[0][0][0, 3] ^= np.uint32(1)
    Wb = oc.generate_witness(recursive_verifier_inputs(idata, bad), B)
    fails = check_constraints(oc, Wb, oc.public_input_values(),
                              raise_on_fail=False)
    assert fails, "tampered inner proof still satisfies the outer circuit"


@pytest.mark.slow
def test_recursive_ecdsa_proof():
    """Recursive verification of the PRODUCTION secp256k1 ECDSA proof:
    build the verifier circuit for the n=2^13 / 128-wire / LogUp /
    42-query / 16-PoW-bit circuit, prove an ECDSA batch,
    feed the proof as outer witness, FRI-prove the verifier circuit, verify
    natively, and check the 45 statement limbs are re-exported as outer
    public inputs.  The outer FRI config is reduced for CPU wall-time; the
    production-security outer is CircuitConfig.standard_recursion_config()
    (28 queries x 3 bits + 16 PoW = 100 bits at rate 8), which runs the SAME
    outer circuit — only the outer proving cost differs."""
    import time

    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    B = 1
    t0 = time.time()
    system = api.EcdsaProverSystem(cn.SECP256K1)
    idata = system.data
    stmts = api.random_statements(cn.SECP256K1, B, seed=17)
    W, ipis = system.witness(stmts)
    iproof = prove(idata, W, ipis)
    assert verify(idata, iproof)
    t1 = time.time()
    print(f"inner: n={idata.n} proved in {t1-t0:.0f}s")

    # recursion_ecc_config's circuit shape (136 wires / 128 routed: the
    # verifier's pooled arithmetic packs 32 ops/row -> n=2^14) with a
    # reduced outer FRI for CPU wall-time; the production-security outer
    # (28 queries, 16 PoW bits) runs the IDENTICAL circuit.
    import dataclasses

    prod = CircuitConfig.recursion_ecc_config()
    ob = CircuitBuilder(dataclasses.replace(prod, fri=FriConfig(
        rate_bits=3, cap_height=1, num_query_rounds=4, proof_of_work_bits=4)))
    build_recursive_verifier(ob, idata)
    oc = ob.build()
    counts = {g.gate_id(): len(oc.gate_rows.get(gi, ()))
              for gi, g in enumerate(oc.gates)}
    nrows = int((oc.row_gate_idx >= 0).sum())
    t2 = time.time()
    print(f"production ECDSA verifier circuit: n={oc.n} ({nrows} rows, "
          f"built in {t2-t1:.0f}s) gate histogram: {counts}")

    inputs = recursive_verifier_inputs(idata, iproof)
    Wo = oc.generate_witness(inputs, B)
    opis = oc.public_input_values()
    assert np.array_equal(opis, ipis), "45 statement limbs must re-export"
    check_constraints(oc, Wo, opis)
    t3 = time.time()
    print(f"outer witness+check: {t3-t2:.0f}s")

    odata = build_circuit_data(oc)
    oproof = prove(odata, Wo, opis)
    assert verify(odata, oproof), "recursive ECDSA proof must verify"
    assert verify_one_exact(odata, oproof, 0)
    t4 = time.time()
    print(f"outer: N={odata.N} proved in {t4-t3:.0f}s")

    # negative: tamper one statement limb of the inner proof
    bad = copy.deepcopy(iproof)
    bad.pis[0, 0] ^= np.uint64(1)
    Wb = oc.generate_witness(recursive_verifier_inputs(idata, bad), B)
    fails = check_constraints(oc, Wb, oc.public_input_values(),
                              raise_on_fail=False)
    assert fails, "tampered ECDSA statement still satisfies the verifier"


def _agg_outer_config() -> CircuitConfig:
    """Outer config for aggregation LEVELS: rate-8 (PoseidonGate), minimal
    FRI so the level-2 verifier-of-the-aggregator circuit stays CPU-sized.
    Correctness parameterization for the fold test, not a security one (the
    production outer is CircuitConfig.standard_recursion_config())."""
    return CircuitConfig(
        num_wires=136, num_routed_wires=80, num_constant_cols=2,
        range_lookup_limb_bits=3,
        fri=FriConfig(rate_bits=3, cap_height=1, num_query_rounds=3,
                      proof_of_work_bits=2, final_poly_max_degree_bits=5),
    )


@pytest.mark.slow
def test_aggregation_tree_4_to_1():
    """2-to-1 proof aggregation: one outer circuit
    verifies TWO inner proof lanes and re-exports both statements' public
    inputs; folding 4 demo proofs -> 2 -> 1 through two recursion levels
    yields ONE proof whose public inputs bind all four statements."""
    rng = np.random.default_rng(99)
    ic = _inner_circuit()
    B = 4
    xs = rng.integers(0, 1 << 29, size=(B, 1), dtype=np.uint64)
    ys = rng.integers(0, P, size=(B, 1), dtype=np.uint64) % np.uint64(P)
    Wi = ic.generate_witness({"x": xs, "y": ys}, B)
    ipis = ic.public_input_values()
    idata = build_circuit_data(ic)
    iproof = prove(idata, Wi, ipis)
    assert verify(idata, iproof)

    # ---- level 1: 4 lanes -> 2 outer lanes, each verifying TWO inners -----
    ab = CircuitBuilder(_agg_outer_config())
    build_aggregation_verifier(ab, idata)
    ac = ab.build()
    single = CircuitBuilder(_agg_outer_config())
    build_recursive_verifier(single, idata)
    sc = single.build()
    print(f"aggregation rows: 2-to-1 n={ac.n} "
          f"({int((ac.row_gate_idx >= 0).sum())} rows) vs single-verify "
          f"n={sc.n} ({int((sc.row_gate_idx >= 0).sum())} rows)")

    halves = split_proof_lanes(iproof)   # lanes [0,2] and [1,3]
    W1 = ac.generate_witness(aggregation_inputs(idata, halves), 2)
    apis = ac.public_input_values()
    # outer lane j binds statements of inner lanes 2j and 2j+1
    want = np.concatenate([ipis[0::2], ipis[1::2]], axis=1)
    assert np.array_equal(apis, want)
    adata = build_circuit_data(ac)
    aproof = prove(adata, W1, apis)
    assert verify(adata, aproof)

    # ---- level 2: 2 aggregated lanes -> 1 proof binding all 4 -------------
    ab2 = CircuitBuilder(_agg_outer_config())
    build_aggregation_verifier(ab2, adata)
    ac2 = ab2.build()
    print(f"level-2 aggregator: n={ac2.n} "
          f"({int((ac2.row_gate_idx >= 0).sum())} rows)")
    halves2 = split_proof_lanes(aproof)
    W2 = ac2.generate_witness(aggregation_inputs(adata, halves2), 1)
    apis2 = ac2.public_input_values()
    want2 = np.concatenate([apis[0::2], apis[1::2]], axis=1)
    assert np.array_equal(apis2, want2)
    # the root proof's PIs are exactly the four statements' PIs in lane order
    assert np.array_equal(apis2[0].reshape(B, ipis.shape[1]), ipis)
    adata2 = build_circuit_data(ac2)
    aproof2 = prove(adata2, W2, apis2)
    assert verify(adata2, aproof2), "root aggregation proof must verify"

    # tampering any leaf statement breaks the corresponding level-1 witness
    bad = copy.deepcopy(iproof)
    bad.pis[2, 0] ^= np.uint64(1)
    Wb = ac.generate_witness(aggregation_inputs(idata, split_proof_lanes(bad)), 2)
    fails = check_constraints(ac, Wb, ac.public_input_values(),
                              raise_on_fail=False)
    assert fails, "tampered leaf statement still aggregates"
