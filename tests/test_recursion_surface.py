"""In-circuit gate evaluation (recursion surface): for every gate in the
inventory, evaluating its constraints IN-CIRCUIT over random GF(p^2) openings
must match the native extension-algebra evaluation — the in-circuit half of
plonky2's `test_eval_fns` harness (reference src/gates/mul_nonnative.rs:565-578
checks eval_unfiltered vs eval_unfiltered_circuit the same way)."""

import numpy as np
import pytest

from plonky2_ecdsa.circuit import foreign
from plonky2_ecdsa.circuit.algebra import ExtAlgebra
from plonky2_ecdsa.circuit.builder import CircuitBuilder
from plonky2_ecdsa.circuit.config import CircuitConfig
from plonky2_ecdsa.circuit.gates import (ArithmeticGate, BaseSum2Gate,
                                             BigCmpGate, ConstantGate,
                                             MulNonNativeGate,
                                             NonNativeAddGate,
                                             NonNativeAddManyGate,
                                             NonNativeSubGate,
                                             PublicInputGate,
                                             RandomAccessGate, RangeCheckGate,
                                             RangeLookupGate)
from plonky2_ecdsa.circuit.recursion import add_virtual_ext, constant_ext
from plonky2_ecdsa.circuit.witness import check_constraints
from plonky2_ecdsa.fields import goldilocks as gl

SECP = foreign.secp256k1_base()

GATES = [
    ConstantGate(4),
    PublicInputGate(3),
    ArithmeticGate(2),
    BaseSum2Gate(1, 5),
    RangeCheckGate(8, 2),
    RangeLookupGate(13, 2),
    MulNonNativeGate(SECP),
    NonNativeAddGate(SECP),
    NonNativeSubGate(SECP),
    NonNativeAddManyGate(SECP, 3),
    BigCmpGate(),
    RandomAccessGate(4, 1),
    RandomAccessGate(3, 1),  # unsplit interpolation path
]


def _as_ext_native(pair):
    return (gl.from_int(int(pair[0])), gl.from_int(int(pair[1])))


def _ext_to_ints(e):
    return (int(gl.to_u64(*e[0])), int(gl.to_u64(*e[1])))


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g.gate_id())
def test_eval_circuit_matches_native(rng, gate):
    nw = gate.num_wires
    ncst = max(2, getattr(gate, "num_consts", 0))
    wire_vals = rng.integers(0, gl.P, size=(nw, 2), dtype=np.uint64)
    const_vals = rng.integers(0, gl.P, size=(ncst, 2), dtype=np.uint64)
    npis = gate.num_cols if isinstance(gate, PublicInputGate) else 0
    pi_vals = rng.integers(0, gl.P, size=(npis, 2), dtype=np.uint64)

    # Native evaluation at a "zeta opening" made of random ext elements.
    alg = ExtAlgebra(np, ())
    ctx_n = {}
    if npis:
        ctx_n["pi_vals"] = [_as_ext_native(p) for p in pi_vals]
    expect = gate.eval(alg, [_as_ext_native(w) for w in wire_vals],
                       [_as_ext_native(c) for c in const_vals], ctx_n)
    expect = [_ext_to_ints(e) for e in expect]
    assert len(expect) == gate.num_constraints

    # In-circuit evaluation over ExtTarget openings.
    b = CircuitBuilder(CircuitConfig.test_config())
    wires_c = [add_virtual_ext(b) for _ in range(nw)]
    b.register_input("w", [t for e in wires_c for t in e])
    consts_c = [constant_ext(b, int(c0), int(c1)) for c0, c1 in const_vals]
    ctx_c = {}
    if npis:
        ctx_c["pi_vals"] = [constant_ext(b, int(p0), int(p1))
                            for p0, p1 in pi_vals]
    cons = gate.eval_circuit(b, wires_c, consts_c, ctx_c)
    for e in cons:
        b.register_public_input(e[0])
        b.register_public_input(e[1])
    c = b.build()

    W = c.generate_witness({"w": wire_vals.reshape(1, -1)}, 1)
    pis = c.public_input_values()
    got = [(int(pis[0, 2 * i]), int(pis[0, 2 * i + 1]))
           for i in range(len(cons))]
    assert got == expect
    assert check_constraints(c, W, pis) == {}


def test_standard_recursion_config_preset():
    cfg = CircuitConfig.standard_recursion_config()
    assert cfg.num_routed_wires == 80
    assert cfg.fri.rate_bits == 3
    assert cfg.fri.num_query_rounds == 28


def test_constraint_identity_in_circuit():
    """Full combined constraint identity at zeta, re-evaluated IN-CIRCUIT
    from a real proof's openings: the verifier-circuit
    skeleton must accept the honest proof and reject a tampered opening."""
    from plonky2_ecdsa.circuit.examples import (small_demo_circuit,
                                                    small_demo_witness)
    from plonky2_ecdsa.circuit.recursive_verifier import (
        add_constraint_identity_check, verifier_inputs_from_proof)
    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import prove
    from plonky2_ecdsa.prover.verifier import verify

    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    W, pis = small_demo_witness(circuit, 2)
    proof = prove(data, W, pis)
    assert verify(data, proof)

    vb = CircuitBuilder(CircuitConfig.test_config())
    handles = add_constraint_identity_check(vb, data)
    vc = vb.build()
    inputs = verifier_inputs_from_proof(data, proof)
    assert inputs["open0"].shape[1] == 2 * handles["total"]
    VW = vc.generate_witness(inputs, 2)
    vpis = vc.public_input_values()
    assert check_constraints(vc, VW, vpis) == {}
    # the bound public inputs expose exactly the openings + challenges
    want = np.concatenate([inputs["open0"], inputs["open1"], inputs["zeta"],
                           inputs["alphas"], inputs["betas"],
                           inputs["gammas"], inputs["lk_alphas"],
                           inputs["pis"]], axis=1)
    assert np.array_equal(vpis, want)

    # negative: tamper a wire opening -> the in-circuit identity must break
    bad = {k: np.array(v, copy=True) for k, v in inputs.items()}
    bad["open0"][0, 2] ^= 1
    VW2 = vc.generate_witness(bad, 2)
    failures = check_constraints(vc, VW2, vc.public_input_values(),
                                 raise_on_fail=False)
    assert failures, "tampered opening passed the in-circuit identity"
