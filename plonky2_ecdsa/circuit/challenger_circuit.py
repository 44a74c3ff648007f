"""In-circuit Fiat-Shamir challenger + Merkle gadgets (recursion building
blocks).

`CircuitChallenger` mirrors prover/challenger.py's overwrite-mode duplex
sponge statement-for-statement, but over circuit TARGETS: each permutation
is one PoseidonGate row, so the challenges an outer circuit derives are
CONSTRAINED to equal the ones the native verifier would derive from the same
absorbed data.  `split_challenge_64` decomposes a challenge into bits with a
canonicity side-condition (the two 64-bit representations of a Goldilocks
element differ exactly in hi32 == 2^32-1, which the constraint excludes), so
query-index bits and PoW bit checks are sound.  `merkle_verify_circuit`
re-hashes a leaf up a Merkle path with select-ordered siblings and binds the
root to a cap digest chosen by the residual index bits.
"""

from __future__ import annotations

import numpy as np

from ..fields import goldilocks as gl
from ..hash import poseidon as ps
from .poseidon_gate import poseidon_permute

P = gl.P
RATE = ps.RATE
WIDTH = ps.WIDTH


class CircuitChallenger:
    """Duplex sponge over targets (prover/challenger.py Challenger mirror)."""

    def __init__(self, b):
        self.b = b
        z = b.zero()
        self.state = [z] * WIDTH
        self.inputs: list = []
        self.outputs: list = []

    def observe(self, t):
        self.inputs.append(t)
        self.outputs = []
        if len(self.inputs) == RATE:
            self._duplex()

    def observe_elements(self, ts):
        for t in ts:
            self.observe(t)

    def observe_cap(self, cap):
        """cap: list of digests, each a list of 4 targets (absorb order
        matches native observe_cap's [..., C, 4] row-major flatten)."""
        for digest in cap:
            for t in digest:
                self.observe(t)

    def observe_ext(self, e):
        self.observe(e[0])
        self.observe(e[1])

    def _duplex(self):
        st = list(self.state)
        for i, t in enumerate(self.inputs):
            st[i] = t
        self.state = poseidon_permute(self.b, st)
        self.inputs = []
        self.outputs = list(self.state[:RATE])

    def get_challenge(self):
        if self.inputs or not self.outputs:
            self._duplex()
        return self.outputs.pop()

    def get_ext(self):
        a = self.get_challenge()
        c = self.get_challenge()
        return (a, c)

    def check_pow_circuit(self, witness_t, pow_bits: int):
        """Absorb the grinding witness and constrain the response's top
        `pow_bits` bits to zero (native Challenger.check_pow mirror: flush,
        observe witness, draw one challenge, check hi32 >> (32-pb) == 0)."""
        if self.inputs:
            self._duplex()
        self.observe(witness_t)
        resp = self.get_challenge()
        bits = split_challenge_64(self.b, resp)
        for j in range(64 - pow_bits, 64):
            self.b.assert_zero(bits[j])


def split_challenge_64(b, t):
    """Target -> 64 boolean targets (little-endian) of the CANONICAL 64-bit
    representation.  Constrains t == lo + 2^32*hi with lo/hi bit-decomposed
    (32 bits each) and excludes the non-canonical second representation
    (hi == 2^32-1 with lo != 0 encodes v + P for v < 2^32-1)."""
    lo = b.add_virtual_target()
    hi = b.add_virtual_target()

    def fill(ev, t=t, lo=lo, hi=hi):
        v = ev.get(t)
        ev.set(np.array([lo, hi]),
               np.stack([v & np.uint64(0xFFFFFFFF), v >> np.uint64(32)]))

    b.add_op(fill, [lo, hi], "split64")
    lo_bits = b.split_le_base2(lo, 32)
    hi_bits = b.split_le_base2(hi, 32)
    # t == lo + 2^32 * hi
    recomb = b.arithmetic(1, 1 << 32, lo, b.one(), hi)
    b.connect(recomb, t)
    # canonicity: not (hi == 2^32-1 and lo != 0)
    eq = b.is_equal(hi, b.constant((1 << 32) - 1))
    b.assert_zero(b.mul(eq, lo))
    return lo_bits + hi_bits


def select_digest(b, bit, a, c):
    """bit ? a : c elementwise over 4-target digests."""
    return [b.select(bit, a[j], c[j]) for j in range(4)]


def hash_no_pad_circuit(b, elems):
    """Sponge over targets (hash/poseidon.py hash_no_pad mirror: zero-init
    state, overwrite-absorb rate-8 chunks, digest = state[:4])."""
    assert elems
    z = b.zero()
    state = [z] * WIDTH
    for off in range(0, len(elems), RATE):
        chunk = elems[off : off + RATE]
        state = list(chunk) + state[len(chunk):]
        state = poseidon_permute(b, state)
    return state[:4]


def merkle_verify_circuit(b, leaf, idx_bits, path, cap):
    """Constrain a Merkle opening: leaf (list of targets) hashes up `path`
    (list of 4-target sibling digests, leaf level first) ordered by
    `idx_bits` (booleans, little-endian) to the cap digest selected by the
    remaining bits.  len(idx_bits) == len(path) + cap_height."""
    cur = hash_no_pad_circuit(b, leaf)
    for d, sib in enumerate(path):
        bit = idx_bits[d]
        first = select_digest(b, bit, sib, cur)
        second = select_digest(b, bit, cur, sib)
        cur = hash_no_pad_circuit(b, first + second)
    rest = idx_bits[len(path):]
    assert len(cap) == 1 << len(rest), (len(cap), len(rest))
    sel = list(cap)
    for bit in rest:
        sel = [select_digest(b, bit, sel[2 * i + 1], sel[2 * i])
               for i in range(len(sel) // 2)]
    for j in range(4):
        b.connect(cur[j], sel[0][j])


def pow_product_circuit(b, bits, base: int, shift: int = 1):
    """shift * base^(sum bits[t] 2^t) as a target: product of per-bit
    selects between g^(2^t) and 1."""
    acc = b.constant(shift % P)
    g = base % P
    for t, bit in enumerate(bits):
        factor = b.select(bit, b.constant(g), b.one())
        acc = b.mul(acc, factor)
        g = g * g % P
    return acc
