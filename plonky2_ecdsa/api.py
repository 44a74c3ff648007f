"""Top-level batched ECDSA-proving API (SURVEY.md §7 layer 7).

The reference exposes its capability as circuit gadgets embedded in a caller's
CircuitBuilder (src/gadgets/ecdsa.rs:30-78); here the flagship entry point is a
prebuilt circuit *system*: build the verify circuit once per (curve, config)
shape, then prove whole signature batches through the jitted tensor prover —
"build-once / prove-many", the batched replacement for the reference's
build::<C>() + data.prove(pw) flow (src/gadgets/ecdsa.rs:122-124).
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np

from .circuit.builder import CircuitBuilder
from .circuit.config import CircuitConfig
from .circuit.foreign import BITS, base_field, scalar_field
from .circuit.witness import check_constraints
from .curve import native as cn
from .gadgets import ecdsa as ge
from .gadgets import nonnative as gn
from .gadgets.curve import AffinePointTarget
from .prover.data import CircuitData, build_circuit_data
from .prover.prover import Proof, make_jit_prover, prove
from .prover.verifier import verify as verify_proof

MASK = (1 << BITS) - 1


def int_to_limbs(vals, num_limbs: int = 9) -> np.ndarray:
    """[B] python ints -> [B, num_limbs] uint64 29-bit limb rows."""
    out = np.zeros((len(vals), num_limbs), np.uint64)
    for i, v in enumerate(vals):
        v = int(v)
        for j in range(num_limbs):
            out[i, j] = (v >> (BITS * j)) & MASK
    return out


def limbs_to_int(arr) -> list:
    return [sum(int(l) << (BITS * j) for j, l in enumerate(row)) for row in arr]


@dataclass
class EcdsaStatement:
    """One signature-verification instance (native ints)."""
    msg: int
    r: int
    s: int
    pk: cn.Point


class EcdsaProverSystem:
    """Prebuilt ECDSA-verify circuit + prover state for one curve/config.

    Public inputs (in order): pk.x, pk.y, msg, r, s — 45 29-bit limbs — so a
    proof binds the full statement "sig (r,s) on msg verifies under pk"
    (reference embeds them as circuit constants per-signature instead,
    src/gadgets/ecdsa.rs:96-117; virtual + public is the batched equivalent).
    """

    def __init__(self, curve: cn.CurveParams = cn.SECP256K1,
                 config: CircuitConfig | None = None, verbose: bool = False):
        self.curve = curve
        t0 = time.time()
        if config is None:
            config = (CircuitConfig.p256_ecc_config() if curve is cn.P256
                      else CircuitConfig.standard_ecc_config())
        b = CircuitBuilder(config)
        sf = scalar_field(curve)
        msg = gn.add_virtual_nonnative(b, sf)
        r = gn.add_virtual_nonnative(b, sf)
        s = gn.add_virtual_nonnative(b, sf)
        bf = base_field(curve)
        pk = AffinePointTarget(curve, gn.add_virtual_nonnative(b, bf),
                               gn.add_virtual_nonnative(b, bf))
        for name, t in [("msg", msg), ("r", r), ("s", s)]:
            b.register_input(name, t.limbs)
        b.register_input("pk_x", pk.x.limbs)
        b.register_input("pk_y", pk.y.limbs)
        for t in (pk.x, pk.y, msg, r, s):
            b.register_public_inputs(t.limbs)
        sig = ge.ECDSASignatureTarget(r=r, s=s)
        pkt = ge.ECDSAPublicKeyTarget(point=pk)
        if curve is cn.SECP256K1:
            ge.verify_secp256k1_message_circuit(b, msg, sig, pkt)
        elif curve is cn.P256:
            ge.verify_p256_message_circuit(b, msg, sig, pkt)
        else:
            raise ValueError(f"unsupported curve {curve.name}")
        self.circuit = b.build()
        self.build_seconds = time.time() - t0
        if verbose:
            print(f"[api] {curve.name} circuit: {len(b.rows)} rows -> n={self.circuit.n} "
                  f"({self.build_seconds:.1f}s build)")
        self._data: CircuitData | None = None
        self._jit = None

    # ------------------------------------------------------------------ stats
    @property
    def num_rows(self) -> int:
        return int((self.circuit.row_gate_idx >= 0).sum())

    @property
    def n(self) -> int:
        return self.circuit.n

    def gate_counts(self) -> dict:
        """Rows per gate type (the reference's dbg!(num_gates) analogue,
        src/gadgets/ecdsa.rs:121)."""
        out = {}
        for gi, gate in enumerate(self.circuit.gates):
            out[gate.gate_id()] = len(self.circuit.gate_rows.get(gi, ()))
        return out

    # ------------------------------------------------------------------ data
    @property
    def data(self) -> CircuitData:
        if self._data is None:
            self._data = build_circuit_data(self.circuit)
        return self._data

    # --------------------------------------------------------------- witness
    def _inputs(self, stmts: list[EcdsaStatement]) -> dict:
        return {
            "msg": int_to_limbs([st.msg for st in stmts]),
            "r": int_to_limbs([st.r for st in stmts]),
            "s": int_to_limbs([st.s for st in stmts]),
            "pk_x": int_to_limbs([st.pk.x for st in stmts]),
            "pk_y": int_to_limbs([st.pk.y for st in stmts]),
        }

    def witness(self, stmts: list[EcdsaStatement]):
        """Vectorized witness tape over the batch -> (W, pis)."""
        W = self.circuit.generate_witness(self._inputs(stmts), len(stmts))
        return W, self.circuit.public_input_values()

    def witness_pair(self, stmts: list[EcdsaStatement]):
        """Witness directly in the prover's (lo, hi) [B, wires, n] device
        layout (native scatter; see Circuit.generate_witness_pair)."""
        wp = self.circuit.generate_witness_pair(self._inputs(stmts), len(stmts))
        return wp, self.circuit.public_input_values()

    def witness_vals(self, stmts: list[EcdsaStatement]):
        """Witness as the raw tape value table [T, B] u64 — the compact form
        consumed by make_jit_prover(...).run_vals (wires are expanded on
        device via static gather maps; minimal host->device upload)."""
        vals = self.circuit._run_tape(self._inputs(stmts), len(stmts), None)
        return vals, self.circuit.public_input_values()

    def check(self, stmts: list[EcdsaStatement]) -> bool:
        W, pis = self.witness(stmts)
        return check_constraints(self.circuit, W, pis) == {}

    # ----------------------------------------------------------------- prove
    def prove(self, stmts: list[EcdsaStatement], jit: bool = False) -> Proof:
        W, pis = self.witness(stmts)
        if jit:
            if self._jit is None:
                self._jit = make_jit_prover(self.data)
            return self._jit(W, pis)
        return prove(self.data, W, pis)

    def verify(self, proof: Proof) -> bool:
        return verify_proof(self.data, proof)

    def verify_statement(self, proof: Proof, i: int, stmt: EcdsaStatement) -> bool:
        """verify() + check lane i's public inputs bind the given statement."""
        if not verify_proof(self.data, proof):
            return False
        want = np.concatenate([
            int_to_limbs([stmt.pk.x])[0], int_to_limbs([stmt.pk.y])[0],
            int_to_limbs([stmt.msg])[0], int_to_limbs([stmt.r])[0],
            int_to_limbs([stmt.s])[0],
        ])
        return bool(np.array_equal(proof.pis[i], want))


def random_statements(curve: cn.CurveParams, count: int, seed: int = 0) -> list[EcdsaStatement]:
    """Deterministic sign_message-backed instances (native layer as oracle,
    reference src/curve/ecdsa.rs:25-40)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        sk = int.from_bytes(rng.bytes(40), "little") % curve.n or 1
        msg = int.from_bytes(rng.bytes(40), "little") % curve.n
        nonce = int.from_bytes(rng.bytes(40), "little") % curve.n or 1
        _, pk = cn.keygen(curve, sk)
        r, s = cn.sign_message(curve, msg, sk, nonce)
        assert cn.verify_message(curve, msg, r, s, pk)
        out.append(EcdsaStatement(msg=msg, r=r, s=s, pk=pk))
    return out


def prove_ecdsa_batch(system: EcdsaProverSystem, stmts: list[EcdsaStatement],
                      jit: bool = True) -> Proof:
    """One proof object with a batch lane per signature (SURVEY.md §7.7)."""
    return system.prove(stmts, jit=jit)
