"""Generate tests/vectors/*.json golden vectors from an INDEPENDENT
implementation (SURVEY.md §7 hard part 6).

Everything below is computed with self-contained textbook formulas over
Python ints — no imports from plonky2_ecdsa — so the frozen vectors
cross-check the library rather than echo it.  Curve/GLV constants are the
published secp256k1 / NIST P-256 domain parameters (unavoidably shared).

Run: python scripts/gen_vectors.py   (rewrites tests/vectors/)
"""

import json
import os
import random

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "vectors")

# --------------------------------------------------------------------------
# Independent reference implementation (textbook; ints only)
# --------------------------------------------------------------------------

GOLDILOCKS_P = 2**64 - 2**32 + 1

SECP = dict(
    p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    a=0, b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)
P256 = dict(
    p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    a=-3,
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


def ec_add(C, P1, P2):
    """Affine short-Weierstrass addition; None = infinity."""
    p = C["p"]
    if P1 is None:
        return P2
    if P2 is None:
        return P1
    x1, y1 = P1
    x2, y2 = P2
    if x1 == x2 and (y1 + y2) % p == 0:
        return None
    if P1 == P2:
        lam = (3 * x1 * x1 + C["a"]) * pow(2 * y1, -1, p) % p
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return (x3, y3)


def ec_mul(C, P1, k):
    R = None
    while k:
        if k & 1:
            R = ec_add(C, R, P1)
        P1 = ec_add(C, P1, P1)
        k >>= 1
    return R


def ecdsa_sign(C, msg, sk, nonce):
    n = C["n"]
    R = ec_mul(C, (C["gx"], C["gy"]), nonce)
    r = R[0] % n
    s = pow(nonce, -1, n) * (msg + r * sk) % n
    assert r and s
    return r, s


def ecdsa_verify(C, msg, r, s, pk):
    n = C["n"]
    if not (0 < r < n and 0 < s < n):
        return False
    w = pow(s, -1, n)
    u1, u2 = msg * w % n, r * w % n
    R = ec_add(C, ec_mul(C, (C["gx"], C["gy"]), u1), ec_mul(C, pk, u2))
    return R is not None and R[0] % n == r


def to_limbs(v, bits=29, k=9):
    return [(v >> (bits * i)) & ((1 << bits) - 1) for i in range(k)]


def main():
    os.makedirs(OUT, exist_ok=True)
    rng = random.Random(0x600D_5EED)

    # ---- limbs / convert_base --------------------------------------------
    limb_vecs = []
    for _ in range(12):
        v = rng.getrandbits(rng.choice([32, 64, 200, 256]))
        limb_vecs.append({
            "value": hex(v),
            "limbs29": to_limbs(v),
            "digits32": [(v >> (32 * i)) & 0xFFFFFFFF for i in range(9)],
        })
    # ---- goldilocks field -------------------------------------------------
    gvecs = []
    for _ in range(16):
        a = rng.randrange(GOLDILOCKS_P)
        b = rng.randrange(GOLDILOCKS_P)
        gvecs.append({
            "a": hex(a), "b": hex(b),
            "add": hex((a + b) % GOLDILOCKS_P),
            "sub": hex((a - b) % GOLDILOCKS_P),
            "mul": hex(a * b % GOLDILOCKS_P),
            "inv_a": hex(pow(a, -1, GOLDILOCKS_P) if a else 0),
        })
    # ---- foreign fields ---------------------------------------------------
    fvecs = {}
    for name, C in (("secp256k1", SECP), ("p256", P256)):
        for fld in ("p", "n"):
            m = C[fld]
            rows = []
            for _ in range(8):
                a = rng.randrange(m)
                b = rng.randrange(m)
                rows.append({
                    "a": hex(a), "b": hex(b),
                    "add": hex((a + b) % m), "sub": hex((a - b) % m),
                    "mul": hex(a * b % m),
                    "inv_a": hex(pow(a, -1, m) if a else 0),
                })
            fvecs[f"{name}_{'base' if fld == 'p' else 'scalar'}"] = {
                "modulus": hex(m), "ops": rows}
    # ---- curve ops --------------------------------------------------------
    cvecs = {}
    for name, C in (("secp256k1", SECP), ("p256", P256)):
        G = (C["gx"], C["gy"])
        pts = {"2G": ec_mul(C, G, 2), "3G": ec_mul(C, G, 3)}
        muls = []
        for _ in range(6):
            k = rng.randrange(1, C["n"])
            Q = ec_mul(C, G, k)
            muls.append({"k": hex(k), "x": hex(Q[0]), "y": hex(Q[1])})
        adds = []
        for _ in range(4):
            k1 = rng.randrange(1, C["n"])
            k2 = rng.randrange(1, C["n"])
            A, B2 = ec_mul(C, G, k1), ec_mul(C, G, k2)
            S = ec_add(C, A, B2)
            D = ec_add(C, A, A)
            adds.append({"ax": hex(A[0]), "ay": hex(A[1]),
                         "bx": hex(B2[0]), "by": hex(B2[1]),
                         "sum_x": hex(S[0]), "sum_y": hex(S[1]),
                         "dbl_x": hex(D[0]), "dbl_y": hex(D[1])})
        cvecs[name] = {"G": {"x": hex(G[0]), "y": hex(G[1])},
                       "small": {k: {"x": hex(v[0]), "y": hex(v[1])}
                                 for k, v in pts.items()},
                       "muls": muls, "adds": adds}
    # ---- ECDSA ------------------------------------------------------------
    evecs = {}
    for name, C in (("secp256k1", SECP), ("p256", P256)):
        rows = []
        for _ in range(4):
            sk = rng.randrange(1, C["n"])
            msg = rng.randrange(C["n"])
            nonce = rng.randrange(1, C["n"])
            r, s = ecdsa_sign(C, msg, sk, nonce)
            pk = ec_mul(C, (C["gx"], C["gy"]), sk)
            assert ecdsa_verify(C, msg, r, s, pk)
            assert not ecdsa_verify(C, (msg + 1) % C["n"], r, s, pk)
            rows.append({"sk": hex(sk), "msg": hex(msg), "nonce": hex(nonce),
                         "r": hex(r), "s": hex(s),
                         "pk_x": hex(pk[0]), "pk_y": hex(pk[1])})
        evecs[name] = rows

    for fname, obj in [("limbs.json", limb_vecs), ("goldilocks.json", gvecs),
                       ("foreign_fields.json", fvecs), ("curve.json", cvecs),
                       ("ecdsa.json", evecs)]:
        with open(os.path.join(OUT, fname), "w") as f:
            json.dump(obj, f, indent=1)
        print(f"wrote tests/vectors/{fname}")


if __name__ == "__main__":
    main()
