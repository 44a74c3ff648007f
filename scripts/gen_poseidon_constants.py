"""Independent re-derivation of the Poseidon2 parameters from spec.

Clean-room Grain-LFSR implementation per the Poseidon paper (GKRRS19,
Appendix B "Instantiation of round constants" / the reference
generate_parameters_grain.sage), deliberately NOT sharing code with
hash/poseidon.py's generator: this one keeps the 80-bit LFSR state as a
single python int with bitmask taps, so the two derivations agree only if
both implement the spec (constants reproducible from spec, not trusted
from one implementation).

Also re-runs, from scratch, the deterministic internal-diagonal search and
the Poseidon2 paper's security condition for the internal linear layer
(§5.3 / the poseidon2 reference's sage checks): the characteristic
polynomial of M_I = ones + diag(mu_i - 1) must be IRREDUCIBLE over GF(p),
which makes the minimal polynomial maximal-degree irreducible and rules out
invariant-subspace trails of any length.

Parameters (hash/poseidon.py instance): prime field, x^alpha S-box, n=64
field bits, t=12, R_F=8, R_P=22, over the Goldilocks prime; Poseidon2
consumes R_F*t + R_P = 118 round constants in application order.

Usage:
    python scripts/gen_poseidon_constants.py            # verify vs package
    python scripts/gen_poseidon_constants.py --write    # refresh vector file
"""

import json
import os
import sys

P = 0xFFFFFFFF00000001  # Goldilocks
T = 12
FIELD_BITS = 64
R_F = 8
R_P = 22
NUM_CONSTANTS = T * R_F + R_P  # 118 (Poseidon2: internal rounds use 1 each)
DIAG_MAX = 245  # 11 + mu <= 256 keeps the 22-bit-plane accumulation exact

VEC_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "tests", "vectors", "poseidon_constants.json")


class Grain:
    """80-bit Grain LFSR, state as an int (bit 79 = oldest / output side).

    Taps per the Poseidon reference: new bit = s62 ^ s51 ^ s38 ^ s23 ^ s13
    ^ s0 (indices from the oldest end); each clock shifts the oldest bit out
    and EMITS THE FEEDBACK BIT (the reference sage's generator yields the
    newly computed bit, not the shifted-out one)."""

    def __init__(self, init_bits):
        assert len(init_bits) == 80
        # store so that init_bits[0] is the oldest bit (shifted out first)
        self.state = 0
        for b in init_bits:
            self.state = (self.state << 1) | b

    def clock(self):
        s = self.state

        def bit(i):  # i-th oldest bit
            return (s >> (79 - i)) & 1

        nb = bit(62) ^ bit(51) ^ bit(38) ^ bit(23) ^ bit(13) ^ bit(0)
        self.state = ((s << 1) & ((1 << 80) - 1)) | nb
        return nb


def init_sequence():
    bits = []

    def push(v, w):
        bits.extend((v >> (w - 1 - i)) & 1 for i in range(w))

    push(1, 2)           # field tag: prime field
    push(0, 4)           # sbox tag: x^alpha
    push(FIELD_BITS, 12)
    push(T, 12)
    push(R_F, 10)
    push(R_P, 10)
    bits.extend([1] * 30)
    return bits


def derive_constants():
    g = Grain(init_sequence())
    for _ in range(160):
        g.clock()

    def sample_bit():
        # shrinking generator: emit the bit after each 1, skip after each 0
        while True:
            first = g.clock()
            second = g.clock()
            if first:
                return second

    out = []
    while len(out) < NUM_CONSTANTS:
        v = 0
        for _ in range(FIELD_BITS):
            v = (v << 1) | sample_bit()
        if v < P:  # rejection sampling into the field
            out.append(v)
    return out


def m4_matrix():
    """The Poseidon2 paper's 4x4 MDS block (restated independently)."""
    return [[5, 7, 1, 3], [4, 6, 1, 1], [1, 3, 5, 7], [1, 1, 4, 6]]


def ext_matrix():
    """External matrix circ(2*M4, M4, M4) as an explicit 12x12 row list."""
    m4 = m4_matrix()
    return [[m4[i % 4][j % 4] * (2 if i // 4 == j // 4 else 1)
             for j in range(T)] for i in range(T)]


# ---------------------------------------------------------------------------
# internal-diagonal search + irreducibility check (pure-int polynomial
# arithmetic over GF(p); ascending coefficient order)
# ---------------------------------------------------------------------------

def _polymul(a, b):
    r = [0] * (len(a) + len(b) - 1)
    for i, ai in enumerate(a):
        if ai:
            for j, bj in enumerate(b):
                r[i + j] = (r[i + j] + ai * bj) % P
    return r


def _polymod(a, f):
    """a mod f, f monic."""
    a = a[:]
    d = len(f) - 1
    while len(a) - 1 >= d:
        c = a[-1] % P
        if c:
            off = len(a) - 1 - d
            for i in range(d + 1):
                a[off + i] = (a[off + i] - c * f[i]) % P
        a.pop()
    while len(a) > 1 and a[-1] == 0:
        a.pop()
    return a or [0]


def _polygcd(a, b):
    a, b = a[:], b[:]
    while len(b) > 1 or b[0] != 0:
        inv = pow(b[-1], -1, P)
        bm = [(c * inv) % P for c in b]
        a = _polymod(a, bm)
        a, b = b, a
    return a


def char_poly_internal(mu):
    """Characteristic polynomial of M_I = ones + diag(mu_i - 1).

    Rank-one update of a diagonal matrix: det(xI - M_I) =
    prod_i (x - d_i) - sum_i prod_{j != i} (x - d_j), with d_i = mu_i - 1."""
    d = [(m - 1) % P for m in mu]
    prod = [1]
    for di in d:
        prod = _polymul(prod, [(-di) % P, 1])
    s = [0] * T
    for i in range(T):
        pi = [1]
        for j in range(T):
            if j != i:
                pi = _polymul(pi, [(-d[j]) % P, 1])
        s = [(a + b) % P for a, b in zip(s, pi)]
    return [(a - b) % P for a, b in zip(prod, s + [0])]


def poly_irreducible(f):
    """Degree-12 f irreducible over GF(p): x^(p^12) == x (mod f) and
    gcd(x^(p^(12/q)) - x, f) = 1 for the prime divisors q in {2, 3}."""
    d = len(f) - 1
    assert f[-1] == 1
    g = [0, 1]
    gs = {}
    for k in range(1, d + 1):
        base, res, e = g, [1], P
        while e:
            if e & 1:
                res = _polymod(_polymul(res, base), f)
            base = _polymod(_polymul(base, base), f)
            e >>= 1
        g = res
        gs[k] = g
    if gs[d] != [0, 1]:
        return False
    for k in (d // 2, d // 3):
        h = gs[k][:] + [0] * max(0, 2 - len(gs[k]))
        h[1] = (h[1] - 1) % P
        while len(h) > 1 and h[-1] == 0:
            h.pop()
        if len(_polygcd(f, h)) - 1 != 0:
            return False
    return True


def derive_internal_diag():
    """Deterministic ascending search: start at (2..13), bump the last entry
    until the internal matrix's characteristic polynomial is irreducible."""
    mu = list(range(2, 2 + T))
    while True:
        if poly_irreducible(char_poly_internal(mu)):
            return mu
        mu[-1] += 1
        assert mu[-1] <= DIAG_MAX, "diagonal search exhausted"


def main():
    rc = derive_constants()
    diag = derive_internal_diag()
    payload = {
        "params": {"p": str(P), "t": T, "field_bits": FIELD_BITS,
                   "r_f": R_F, "r_p": R_P, "variant": "poseidon2"},
        "round_constants": [str(c) for c in rc],
        "m4": m4_matrix(),
        "ext_matrix": ext_matrix(),
        "internal_diag": diag,
    }
    if "--write" in sys.argv:
        with open(VEC_PATH, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {len(rc)} constants + diag {diag} -> {VEC_PATH}")
        return
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))
    from plonky2_ecdsa.hash import poseidon

    assert rc == poseidon.ROUND_CONSTANTS, "round-constant derivation drift"
    assert ext_matrix() == poseidon.EXT_MATRIX, "external-matrix drift"
    assert diag == list(poseidon.INTERNAL_DIAG), "internal-diagonal drift"
    print(f"OK: {len(rc)} Grain round constants + matrices + diag {diag} "
          f"match hash/poseidon.py")


if __name__ == "__main__":
    main()
