"""PoseidonGate: one full width-12 Poseidon2 permutation per gate row.

The in-circuit hash primitive that makes recursive proof composition real:
the recursive verifier re-derives the Fiat-Shamir transcript and checks
Merkle paths inside a circuit, which needs the permutation as constraints.  plonky2's PoseidonGate (consumed by the
reference via PoseidonGoldilocksConfig, SURVEY.md §2.9) is the model: store
the S-box *inputs* of every round past the first as witness wires so each
constraint stays degree 7 (x^7 S-box), and carry the partial-round linear
state SYMBOLICALLY as integer coefficient vectors over the stored-S-box
basis (the mds_partial_layer_fast idea) so the eval emits O(rounds * width)
algebra ops, not O(rounds * width^2) on deep expressions.  The permutation
is the package's Poseidon2 instance (hash/poseidon.py module docstring):
external layer ME = circ(2*M4, M4, M4) (applied once more before round 0),
internal layer MI = ones + diag(mu_i - 1) with round constants only on
lane 0 — the same symbolic machinery applies with ME/MI in place of the
dense MDS matrix.

Wire layout (130 wires; fits the 136-wire standard_recursion_config row —
this gate is degree 7 and therefore REQUIRES a blowup-8 (rate_bits=3)
config; the standard 4x configs top out at degree 4):

    [0..12)    inputs (routed)
    [12..24)   outputs (routed)
    [24..60)   u_r[i], full rounds r=1..3 (S-box inputs; round 0's are
               linear in the inputs and not stored)
    [60..82)   u_p, partial rounds p=0..21 (element 0's S-box input)
    [82..130)  u_r[i], full rounds r=26..29

Constraints (118, all degree <= 7): each stored wire equals the linear
image (MDS + round constant) of the previous round's S-box outputs, where an
S-box output is (stored wire)^7; plus 12 output-binding constraints.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..hash import poseidon as ps
from .gates import Gate
from .witness import gadd, gmul, gmul_const

P = gl.P
W = ps.WIDTH  # 12
HF = ps.HALF_FULL_ROUNDS      # 4
PR = ps.PARTIAL_ROUNDS        # 22
TR = ps.TOTAL_ROUNDS          # 30

# external/internal matrices as explicit ints; _RC is the padded [30][12]
# round-order table (internal rounds: only column 0 nonzero, matching the
# Poseidon2 rule that partial rounds add a constant to lane 0 only)
_ME = [row[:] for row in ps.EXT_MATRIX]
_MI = [row[:] for row in ps.INT_MATRIX]
_RC = [[int(ps._RC_U64[r, i]) for i in range(W)] for r in range(TR)]


class PoseidonGate(Gate):
    IN = 0
    OUT = W
    FULL_A = 2 * W              # u_r for r = 1..HF-1
    PARTIAL = FULL_A + (HF - 1) * W
    FULL_B = PARTIAL + PR       # u_r for r = HF+PR .. TR-1

    def gate_id(self):
        return "Poseidon"

    @property
    def num_wires(self):
        return self.FULL_B + HF * W  # 130

    @property
    def num_constraints(self):
        return (HF - 1) * W + PR + HF * W + W  # 118

    degree = 7

    # ---- wire helpers ------------------------------------------------------
    def wire_in(self, i):
        return self.IN + i

    def wire_out(self, i):
        return self.OUT + i

    def wire_full_a(self, r, i):
        assert 1 <= r < HF
        return self.FULL_A + (r - 1) * W + i

    def wire_partial(self, p):
        assert 0 <= p < PR
        return self.PARTIAL + p

    def wire_full_b(self, r, i):
        assert HF + PR <= r < TR
        return self.FULL_B + (r - HF - PR) * W + i

    # ---- constraint evaluation (all three algebras) ------------------------
    def eval(self, alg, wires, consts, ctx):
        def sbox(x):
            x2 = alg.mul(x, x)
            x4 = alg.mul(x2, x2)
            x3 = alg.mul(x2, x)
            return alg.mul(x4, x3)

        def lincomb(coeffs, terms, const):
            acc = None
            for c, t in zip(coeffs, terms):
                c %= P
                if c == 0:
                    continue
                term = t if c == 1 else alg.mul_const(t, c)
                acc = term if acc is None else alg.add(acc, term)
            if acc is None:
                acc = alg.zero()
            if const % P:
                acc = alg.add_const(acc, const % P)
            return acc

        cons = []
        # round 0: S-box inputs are linear in the input wires — the initial
        # external layer composes with round 0's constants: u = ME*in + rc0
        ins = [wires[self.wire_in(i)] for i in range(W)]
        u = [lincomb(_ME[i], ins, _RC[0][i]) for i in range(W)]
        sb = [sbox(x) for x in u]
        # full rounds 1..HF-1: stored wires
        for r in range(1, HF):
            ws = [wires[self.wire_full_a(r, i)] for i in range(W)]
            for i in range(W):
                expr = lincomb(_ME[i], sb, _RC[r][i])
                cons.append(alg.sub(ws[i], expr))
            sb = [sbox(x) for x in ws]
        # partial block: state tracked as integer coefficients over `basis`
        # basis = S-box outputs of round HF-1 (12 terms) + per-partial-round
        # S-box outputs appended as they occur
        basis = list(sb)
        C = [[_ME[i][j] for j in range(W)] for i in range(W)]
        d = [0] * W
        for p in range(PR):
            r = HF + p
            wsp = wires[self.wire_partial(p)]
            # u_r[0] = state[0] + rc  (stored); elements 1..11 stay symbolic
            expr = lincomb(C[0], basis, d[0] + _RC[r][0])
            cons.append(alg.sub(wsp, expr))
            basis.append(sbox(wsp))
            nb = len(basis) - 1
            # rows entering the MDS: elem 0 -> pure new basis term; others
            # keep their coefficients but pick up the round constant
            rows_C = [[0] * nb + [1]]
            rows_d = [0]
            for i in range(1, W):
                rows_C.append(C[i] + [0] * (nb + 1 - len(C[i])))
                rows_d.append((d[i] + _RC[r][i]) % P)
            C = [[sum(_MI[i][j] * rows_C[j][k] for j in range(W)) % P
                  for k in range(nb + 1)] for i in range(W)]
            d = [sum(_MI[i][j] * rows_d[j] for j in range(W)) % P
                 for i in range(W)]
        # final full rounds
        for r in range(HF + PR, TR):
            ws = [wires[self.wire_full_b(r, i)] for i in range(W)]
            if r == HF + PR:
                for i in range(W):
                    expr = lincomb(C[i], basis, d[i] + _RC[r][i])
                    cons.append(alg.sub(ws[i], expr))
            else:
                for i in range(W):
                    expr = lincomb(_ME[i], sb, _RC[r][i])
                    cons.append(alg.sub(ws[i], expr))
            sb = [sbox(x) for x in ws]
        # outputs
        for i in range(W):
            expr = lincomb(_ME[i], sb, 0)
            cons.append(alg.sub(wires[self.wire_out(i)], expr))
        assert len(cons) == self.num_constraints
        return cons


# ---------------------------------------------------------------------------
# builder gadget + witness fill
# ---------------------------------------------------------------------------

def _host_permute_trace(state):
    """state: list of 12 uint64 [B] arrays.  Returns (outputs, stored) where
    stored maps exactly onto the gate's storage wires in wire order."""
    full_a, partial, full_b = [], [], []
    cur = [_host_mat_row(_ME, i, state) for i in range(W)]  # initial ext layer
    for r in range(TR):
        u = [gadd(cur[i], np.uint64(_RC[r][i] % P)) for i in range(W)]
        is_full = r < HF or r >= HF + PR
        if r >= 1:
            if r < HF:
                full_a.extend(u)
            elif r < HF + PR:
                partial.append(u[0])
            else:
                full_b.extend(u)
        if is_full:
            sb = [_host_sbox(x) for x in u]
            cur = [_host_mat_row(_ME, i, sb) for i in range(W)]
        else:
            sb = [_host_sbox(u[0])] + u[1:]
            cur = [_host_mat_row(_MI, i, sb) for i in range(W)]
    return cur, full_a + partial + full_b


def _host_sbox(x):
    x2 = gmul(x, x)
    x4 = gmul(x2, x2)
    return gmul(gmul(x4, x2), x)


def _host_mat_row(M, i, sb):
    acc = None
    for j in range(W):
        t = gmul_const(sb[j], M[i][j])
        acc = t if acc is None else gadd(acc, t)
    return acc


def poseidon_permute(b, state):
    """state: 12 targets -> 12 output targets via one PoseidonGate row."""
    gate = PoseidonGate()
    row = b.add_row(gate)
    for i in range(W):
        b.connect(b.wire(row, gate.wire_in(i)), state[i])
    outs = [b.wire(row, gate.wire_out(i)) for i in range(W)]
    stored = ([b.wire(row, gate.wire_full_a(r, i))
               for r in range(1, HF) for i in range(W)]
              + [b.wire(row, gate.wire_partial(p)) for p in range(PR)]
              + [b.wire(row, gate.wire_full_b(r, i))
                 for r in range(HF + PR, TR) for i in range(W)])

    def fill(ev, ins=np.array(state), outs=np.array(outs),
             stored=np.array(stored)):
        vals = ev.get(ins)  # [12, B]
        out_vals, stored_vals = _host_permute_trace([vals[i] for i in range(W)])
        ev.set(stored, np.stack(stored_vals))
        ev.set(outs, np.stack(out_vals))

    b.add_op(fill, stored + outs, "poseidon")
    return outs
