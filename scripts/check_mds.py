"""Exhaustive MDS check: a matrix is MDS iff every square submatrix (all
minors, every size) is nonsingular over GF(p).

DP over (row-mask, col-mask) pairs via Laplace expansion along the lowest
set column.  Default target is the Poseidon2 external layer's 4x4 M4 block
(the paper's MDS requirement lives on M4; the 12x12 block-circulant
circ(2*M4, M4, M4) is deliberately NOT MDS overall).  Run as a script to
print the verdict; used by tests/test_prover.py::test_poseidon_m4_is_mds.
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from plonky2_ecdsa.fields.goldilocks import P
from plonky2_ecdsa.hash.poseidon import M4


def all_minors_nonzero(M=None, verbose: bool = False):
    """True iff every minor of M (default: the Poseidon2 M4 block) is
    nonzero mod p."""
    if M is None:
        M = [[v % P for v in row] for row in M4]
    WIDTH = len(M)
    t0 = time.time()
    by_pop = [[] for _ in range(WIDTH + 1)]
    for m in range(1 << WIDTH):
        by_pop[bin(m).count("1")].append(m)
    bits_of = {m: [i for i in range(WIDTH) if m >> i & 1] for m in range(1 << WIDTH)}
    det = {}
    zero_minor = None
    for k in range(1, WIDTH + 1):
        nd = {}
        for rm in by_pop[k]:
            rbits = bits_of[rm]
            for cm in by_pop[k]:
                c0 = (cm & -cm).bit_length() - 1
                cm2 = cm & (cm - 1)
                if k == 1:
                    d = M[rbits[0]][c0]
                else:
                    d = 0
                    sign = 1
                    for i in rbits:
                        a = M[i][c0]
                        if a:
                            d += sign * a * det[(rm & ~(1 << i), cm2)]
                        sign = -sign
                    d %= P
                nd[(rm, cm)] = d
                if d == 0 and zero_minor is None:
                    zero_minor = (rbits, bits_of[cm])
        det = nd
        if verbose:
            print(f"k={k}: {len(nd)} minors checked, {time.time()-t0:.0f}s",
                  flush=True)
    if verbose:
        print("MDS =", zero_minor is None,
              ("first zero minor: " + str(zero_minor)) if zero_minor else "")
    return zero_minor is None


if __name__ == "__main__":
    ok = all_minors_nonzero(verbose=True)
    sys.exit(0 if ok else 1)
