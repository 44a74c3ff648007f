"""Circuit-data / proof persistence round-trips (the reference's
serialization checkpoint analogue, SURVEY.md §5)."""

import numpy as np

from plonky2_ecdsa.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.serialize import (
    attach_template,
    load_circuit_data,
    load_proof,
    save_circuit_data,
    save_proof,
)
from plonky2_ecdsa.prover.verifier import verify


def test_circuit_data_roundtrip_proves(tmp_path):
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    path = str(tmp_path / "demo.npz")
    save_circuit_data(data, path)

    loaded = load_circuit_data(path)
    assert loaded.n == data.n and loaded.N == data.N and loaded.g == data.g
    assert np.array_equal(loaded.fixed_values, data.fixed_values)

    # witness from the original template, proof through the LOADED data
    W, pis = small_demo_witness(circuit, batch=2)
    proof = prove(loaded, W, pis)
    assert verify(loaded, proof)
    # and the original data verifies the same proof
    assert verify(data, proof)


def test_attach_template_enables_witness_gen(tmp_path):
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    path = str(tmp_path / "demo.npz")
    save_circuit_data(data, path)
    loaded = load_circuit_data(path)

    rebuilt = small_demo_circuit().build()
    attach_template(loaded, rebuilt)
    W, pis = small_demo_witness(loaded.circuit, batch=2)
    proof = prove(loaded, W, pis)
    assert verify(loaded, proof)


def test_proof_roundtrip(tmp_path):
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    W, pis = small_demo_witness(circuit, batch=2)
    proof = prove(data, W, pis)
    path = str(tmp_path / "proof.pkl")
    save_proof(proof, path)
    loaded = load_proof(path)
    assert verify(data, loaded)
    assert np.array_equal(loaded.pis, proof.pis)
