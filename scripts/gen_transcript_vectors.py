"""Freeze proof-transcript vectors for the small demo circuit
(self-frozen transcript vectors so silent Fiat-Shamir/transcript
drift fails loudly).

Unlike tests/vectors/*.json (independent implementation), these are
SELF-generated: they pin the framework's own deterministic transcript — any
change to Poseidon constants, absorb order, challenge squeezing, FRI fold
schedule, PoW grinding or index sampling changes them and must be a
conscious, regenerated decision.

Run: python scripts/gen_transcript_vectors.py   (rewrites
tests/vectors/transcript_demo.json)
"""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

from plonky2_ecdsa.circuit.examples import small_demo_circuit, small_demo_witness
from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.prover.data import build_circuit_data
from plonky2_ecdsa.prover.prover import prove
from plonky2_ecdsa.prover.verifier import verify

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "vectors", "transcript_demo.json")


def hexs(lo, hi):
    return [hex(int(v)) for v in np.ravel(gl.to_u64(np.asarray(lo), np.asarray(hi)))]


def main():
    circuit = small_demo_circuit().build()
    data = build_circuit_data(circuit)
    W, pis = small_demo_witness(circuit, batch=2, seed=42)
    proof = prove(data, W, pis)
    assert verify(data, proof)
    obj = {
        "circuit": "small_demo_circuit(test_config)", "batch": 2, "seed": 42,
        "n": int(data.n),
        "wires_cap": hexs(*proof.wires_cap)[:16],
        "zs_cap": hexs(*proof.zs_cap)[:16],
        "quotient_cap": hexs(*proof.quotient_cap)[:16],
        "openings0_c0": hexs(*proof.openings0[0])[:16],
        "openings0_c1": hexs(*proof.openings0[1])[:16],
        "fri_final_coeffs_c0": hexs(*proof.fri_proof.final_coeffs[0])[:8],
        "fri_indices": [int(v) for v in np.ravel(proof.fri_proof.indices)[:16]],
        "pow_witness": hexs(*proof.fri_proof.pow_witness)[:2],
    }
    with open(OUT, "w") as f:
        json.dump(obj, f, indent=1)
    print(f"wrote {OUT}")


if __name__ == "__main__":
    main()
