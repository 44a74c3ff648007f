"""Native (out-of-circuit) elliptic-curve and ECDSA layer over Python ints.

This build's equivalent of the reference's L1 layer (SURVEY.md §2 #13-#21):
  * curve types / group law ............ reference src/curve/curve_types.rs,
    curve_adds.rs (exact-int affine law here; the reference's projective
    formula choice is an implementation detail, results agree in affine)
  * Yao windowed scalar-mul / MSM ...... src/curve/curve_multiplication.rs:8-83,
    curve_msm.rs:29-186
  * batch-inversion affine summation ... src/curve/curve_summation.rs:29-189
  * GLV constants + decomposition ...... src/curve/glv.rs:11-102
  * ECDSA keygen/sign/verify ........... src/curve/ecdsa.rs:16-62
  * secp256k1 / P-256 definitions ...... src/curve/secp256k1.rs, p256.rs,
    src/field/p256_base.rs, p256_scalar.rs

This layer is used for circuit constants (fixed-base tables, deterministic
offset points), witness hints (GLV decomposition), and as the ground-truth
oracle in tests.  It is deliberately exact Python-int math; the batched
tensorized curve arithmetic lives in the gadget/witness layer.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache


@dataclass(frozen=True)
class CurveParams:
    """Short Weierstrass curve y^2 = x^3 + a*x + b over GF(p), group order n."""

    name: str
    p: int  # base field modulus
    n: int  # scalar field modulus (group order)
    a: int
    b: int
    gx: int
    gy: int

    def generator(self) -> "Point":
        return Point(self, self.gx, self.gy)

    def zero(self) -> "Point":
        return Point(self, 0, 0, zero=True)

    def is_safe_curve(self) -> bool:
        # nonzero discriminant: 4a^3 + 27b^2 != 0 (curve_types.rs:34-38)
        return (4 * pow(self.a, 3, self.p) + 27 * pow(self.b, 2, self.p)) % self.p != 0


SECP256K1 = CurveParams(
    name="secp256k1",
    p=2**256 - 2**32 - 977,
    n=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    a=0,
    b=7,
    gx=0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    gy=0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)

P256 = CurveParams(
    name="p256",
    p=2**256 - 2**224 + 2**192 + 2**96 - 1,
    n=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    a=-3 % (2**256 - 2**224 + 2**192 + 2**96 - 1),
    b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
    gx=0x6B17D1F2E12C4247F8BCE6E563A440F277037D812DEB33A0F4A13945D898C296,
    gy=0x4FE342E2FE1A7F9B8EE7EB4A7C0F9E162BCE33576B315ECECBB6406837BF51F5,
)


class Point:
    """Affine point (with explicit zero flag, as curve_types.rs AffinePoint)."""

    __slots__ = ("curve", "x", "y", "zero")

    def __init__(self, curve: CurveParams, x: int, y: int, zero: bool = False):
        self.curve = curve
        self.x = x % curve.p if not zero else 0
        self.y = y % curve.p if not zero else 0
        self.zero = zero

    def is_valid(self) -> bool:
        if self.zero:
            return True
        p, c = self.curve.p, self.curve
        return (self.y * self.y - (self.x**3 + c.a * self.x + c.b)) % p == 0

    def __eq__(self, other) -> bool:
        if self.zero or other.zero:
            return self.zero == other.zero
        return self.x == other.x and self.y == other.y

    def __hash__(self):
        return hash((self.curve.name, self.x, self.y, self.zero))

    def __neg__(self) -> "Point":
        if self.zero:
            return self
        return Point(self.curve, self.x, (-self.y) % self.curve.p)

    def double(self) -> "Point":
        if self.zero or self.y == 0:
            return self.curve.zero()
        p = self.curve.p
        lam = (3 * self.x * self.x + self.curve.a) * pow(2 * self.y, -1, p) % p
        x3 = (lam * lam - 2 * self.x) % p
        y3 = (lam * (self.x - x3) - self.y) % p
        return Point(self.curve, x3, y3)

    def __add__(self, other: "Point") -> "Point":
        if self.zero:
            return other
        if other.zero:
            return self
        p = self.curve.p
        if self.x == other.x:
            if (self.y + other.y) % p == 0:
                return self.curve.zero()
            return self.double()
        lam = (other.y - self.y) * pow(other.x - self.x, -1, p) % p
        x3 = (lam * lam - self.x - other.x) % p
        y3 = (lam * (self.x - x3) - self.y) % p
        return Point(self.curve, x3, y3)

    def __sub__(self, other: "Point") -> "Point":
        return self + (-other)

    def __mul__(self, k: int) -> "Point":
        return scalar_mul(self, k)

    __rmul__ = __mul__

    def __repr__(self):
        if self.zero:
            return f"Point({self.curve.name}, ZERO)"
        return f"Point({self.curve.name}, x={self.x:#x}, y={self.y:#x})"


def scalar_mul(pt: Point, k: int) -> Point:
    """Plain double-and-add (the mul_naive oracle, secp256k1.rs:84-99)."""
    k %= pt.curve.n
    acc = pt.curve.zero()
    add = pt
    while k:
        if k & 1:
            acc = acc + add
        add = add.double()
        k >>= 1
    return acc


class ProjectivePoint:
    """Jacobian-coordinate point (x = X/Z^2, y = Y/Z^3).

    Reference ProjectivePoint (curve_types.rs:137-236) with the same EFD
    formula choices: dbl-2007-bl doubling (curve_types.rs:191-218),
    add-1998-cmo-2 proj+proj and madd-1998-cmo proj+affine additions
    (curve_adds.rs:8-111), and Montgomery batch inversion in
    `batch_to_affine` (curve_types.rs:173-189)."""

    __slots__ = ("curve", "X", "Y", "Z")

    def __init__(self, curve: CurveParams, X: int, Y: int, Z: int):
        self.curve = curve
        self.X, self.Y, self.Z = X % curve.p, Y % curve.p, Z % curve.p

    @staticmethod
    def zero(curve: CurveParams) -> "ProjectivePoint":
        return ProjectivePoint(curve, 1, 1, 0)

    @staticmethod
    def from_affine(pt: Point) -> "ProjectivePoint":
        if pt.zero:
            return ProjectivePoint.zero(pt.curve)
        return ProjectivePoint(pt.curve, pt.x, pt.y, 1)

    @property
    def is_zero(self) -> bool:
        return self.Z == 0

    def to_affine(self) -> Point:
        if self.is_zero:
            return self.curve.zero()
        p = self.curve.p
        zinv = pow(self.Z, -1, p)
        z2 = zinv * zinv % p
        return Point(self.curve, self.X * z2 % p, self.Y * z2 % p * zinv % p)

    def double(self) -> "ProjectivePoint":
        # dbl-2007-bl (general a; curve_types.rs:191-218)
        if self.is_zero:
            return self
        p, a = self.curve.p, self.curve.a
        X1, Y1, Z1 = self.X, self.Y, self.Z
        if Y1 == 0:
            return ProjectivePoint.zero(self.curve)
        XX = X1 * X1 % p
        YY = Y1 * Y1 % p
        YYYY = YY * YY % p
        ZZ = Z1 * Z1 % p
        S = 2 * ((X1 + YY) ** 2 - XX - YYYY) % p
        M = (3 * XX + a * ZZ % p * ZZ) % p
        T = (M * M - 2 * S) % p
        Y3 = (M * (S - T) - 8 * YYYY) % p
        Z3 = ((Y1 + Z1) ** 2 - YY - ZZ) % p
        return ProjectivePoint(self.curve, T, Y3, Z3)

    def __add__(self, other):
        p = self.curve.p
        if isinstance(other, Point):  # madd-1998-cmo (curve_adds.rs:62-111)
            if other.zero:
                return self
            if self.is_zero:
                return ProjectivePoint.from_affine(other)
            X1, Y1, Z1 = self.X, self.Y, self.Z
            Z1Z1 = Z1 * Z1 % p
            U2 = other.x * Z1Z1 % p
            S2 = other.y * Z1 % p * Z1Z1 % p
            H = (U2 - X1) % p
            r = (S2 - Y1) % p
            if H == 0:
                if r == 0:
                    return self.double()
                return ProjectivePoint.zero(self.curve)
            HH = H * H % p
            HHH = H * HH % p
            V = X1 * HH % p
            X3 = (r * r - HHH - 2 * V) % p
            Y3 = (r * (V - X3) - Y1 * HHH) % p
            Z3 = Z1 * H % p
            return ProjectivePoint(self.curve, X3, Y3, Z3)
        # add-1998-cmo-2 (curve_adds.rs:8-60)
        if self.is_zero:
            return other
        if other.is_zero:
            return self
        X1, Y1, Z1 = self.X, self.Y, self.Z
        X2, Y2, Z2 = other.X, other.Y, other.Z
        Z1Z1 = Z1 * Z1 % p
        Z2Z2 = Z2 * Z2 % p
        U1 = X1 * Z2Z2 % p
        U2 = X2 * Z1Z1 % p
        S1 = Y1 * Z2 % p * Z2Z2 % p
        S2 = Y2 * Z1 % p * Z1Z1 % p
        H = (U2 - U1) % p
        r = (S2 - S1) % p
        if H == 0:
            if r == 0:
                return self.double()
            return ProjectivePoint.zero(self.curve)
        HH = H * H % p
        HHH = H * HH % p
        V = U1 * HH % p
        X3 = (r * r - HHH - 2 * V) % p
        Y3 = (r * (V - X3) - S1 * HHH) % p
        Z3 = Z1 * Z2 % p * H % p
        return ProjectivePoint(self.curve, X3, Y3, Z3)

    def __neg__(self) -> "ProjectivePoint":
        return ProjectivePoint(self.curve, self.X, -self.Y, self.Z)

    def __repr__(self):
        return f"ProjectivePoint({self.curve.name}, Z={'0' if self.is_zero else '!=0'})"


def batch_to_affine(pts) -> list:
    """Projective -> affine for a whole list with ONE field inversion
    (Montgomery trick; curve_types.rs:173-189)."""
    pts = list(pts)
    if not pts:
        return []
    p = pts[0].curve.p
    idxs = [i for i, q in enumerate(pts) if not q.is_zero]
    zs = [pts[i].Z for i in idxs]
    invs = _batch_inverse(zs, p)
    out = [q.curve.zero() for q in pts]
    for i, zinv in zip(idxs, invs):
        q = pts[i]
        z2 = zinv * zinv % p
        out[i] = Point(q.curve, q.X * z2 % p, q.Y * z2 % p * zinv % p)
    return out


# ---------------------------------------------------------------------------
# Yao windowed multiplication / MSM (curve_multiplication.rs, curve_msm.rs)
# ---------------------------------------------------------------------------

WINDOW_BITS = 4  # curve_multiplication.rs:8


def mul_precompute(g: Point, window_bits: int = WINDOW_BITS):
    """Table of (2^w)^i * g, i = 0..ceil(256/w) (curve_multiplication.rs:24-37)."""
    digits = -(-g.curve.n.bit_length() // window_bits)
    table = []
    cur = g
    for _ in range(digits):
        table.append(cur)
        for _ in range(window_bits):
            cur = cur.double()
    return table


def mul_with_precomputation(table, k: int, window_bits: int = WINDOW_BITS) -> Point:
    """Yao's method: bucket digits then suffix-sum (curve_multiplication.rs:39-73)."""
    curve = table[0].curve
    base = 1 << window_bits
    buckets = [curve.zero() for _ in range(base)]
    kk = k % curve.n
    for i, pt in enumerate(table):
        d = (kk >> (window_bits * i)) & (base - 1)
        if d:
            buckets[d] = buckets[d] + pt
    acc = curve.zero()
    run = curve.zero()
    for d in range(base - 1, 0, -1):
        run = run + buckets[d]
        acc = acc + run
    return acc


def msm(scalars, points, window_bits: int = 5) -> Point:
    """Multi-scalar mul Σ k_i * P_i, Yao-style shared digit buckets
    (curve_msm.rs:56-157; w = 5 is the reference's "experimentally fastest",
    src/curve/ecdsa.rs:56). Sequential here — the data-parallel axis of the
    reference's rayon version becomes the signature batch axis on the device."""
    assert len(scalars) == len(points) and points
    curve = points[0].curve
    base = 1 << window_bits
    digits = -(-curve.n.bit_length() // window_bits)
    buckets = [curve.zero() for _ in range(base)]
    for k, pt in zip(scalars, points):
        kk = k % curve.n
        cur = pt
        for i in range(digits):
            d = (kk >> (window_bits * i)) & (base - 1)
            if d:
                buckets[d] = buckets[d] + cur
            for _ in range(window_bits):
                cur = cur.double()
    acc = curve.zero()
    run = curve.zero()
    for d in range(base - 1, 0, -1):
        run = run + buckets[d]
        acc = acc + run
    return acc


def affine_summation_batch_inversion(points) -> Point:
    """Sum a list of affine points with Montgomery batch inversion, recursing on
    halved lists (curve_summation.rs:82-189 semantics).  Exceptional pairs
    (zero / equal-x) are resolved with the generic law."""
    pts = [q for q in points if not q.zero]
    if not pts:
        return points[0].curve.zero() if points else None
    curve = pts[0].curve
    p = curve.p
    while len(pts) > 1:
        nxt = []
        pairs = []
        for i in range(0, len(pts) - 1, 2):
            a, b = pts[i], pts[i + 1]
            if a.x == b.x and (a.y + b.y) % p == 0:
                continue  # sums to zero, drop
            pairs.append((a, b))
        carry = [pts[-1]] if len(pts) % 2 else []
        # batch-invert denominators
        dens = [(2 * a.y if (a.x == b.x) else (b.x - a.x)) % p for a, b in pairs]
        invs = _batch_inverse(dens, p)
        for (a, b), inv in zip(pairs, invs):
            if a.x == b.x:
                lam = (3 * a.x * a.x + curve.a) * inv % p
            else:
                lam = (b.y - a.y) * inv % p
            x3 = (lam * lam - a.x - b.x) % p
            y3 = (lam * (a.x - x3) - a.y) % p
            nxt.append(Point(curve, x3, y3))
        pts = nxt + carry
        if not pts:
            return curve.zero()
    return pts[0]


# Reference cutoff (curve_summation.rs:29-40): below this many pairwise sums
# the per-batch inversion overhead outweighs the saved per-add inversions.
PAIRWISE_SUM_CUTOFF = 70


def affine_summation_pairwise(points) -> Point:
    """Sum via sequential generic adds (curve_summation.rs:44-68 semantics:
    the small-list path, no batch inversion)."""
    if not points:
        return None
    acc = points[0].curve.zero()
    for q in points:
        acc = acc + q
    return acc


def affine_multisummation_best(points) -> Point:
    """Heuristic dispatch between the pairwise and batch-inversion summation.
    Reference semantics (curve_summation.rs:29-40): the switch compares
    `pairwise_sums = len/2` against the cutoff, so batch inversion kicks in
    at list length 2*70 = 140 (the threshold is on the pairwise-sum count,
    not the list length)."""
    if len(points) // 2 < PAIRWISE_SUM_CUTOFF:
        return affine_summation_pairwise(points)
    return affine_summation_batch_inversion(points)


def _batch_inverse(vals, p):
    """Montgomery trick: n inversions with 1 modular inverse + 3n muls."""
    if not vals:
        return []
    prefix = [1]
    for v in vals:
        prefix.append(prefix[-1] * v % p)
    inv_all = pow(prefix[-1], -1, p)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        out[i] = prefix[i] * inv_all % p
        inv_all = inv_all * vals[i] % p
    return out


# ---------------------------------------------------------------------------
# GLV endomorphism for secp256k1 (src/curve/glv.rs)
# ---------------------------------------------------------------------------

def _from_u64_limbs(ls):
    return sum(l << (64 * i) for i, l in enumerate(ls))


# Constants match src/curve/glv.rs:11-32 ([u64;4] little-endian limb encoding).
GLV_BETA = _from_u64_limbs([
    13923278643952681454, 11308619431505398165, 7954561588662645993, 8856726876819556112,
])
GLV_S = _from_u64_limbs([
    16069571880186789234, 1310022930574435960, 11900229862571533402, 6008836872998760672,
])
GLV_A1 = _from_u64_limbs([16747920425669159701, 3496713202691238861, 0, 0])
GLV_MINUS_B1 = _from_u64_limbs([8022177200260244675, 16448129721693014056, 0, 0])
GLV_A2 = _from_u64_limbs([6323353552219852760, 1498098850674701302, 1, 0])
GLV_B2 = GLV_A1


def decompose_secp256k1_scalar(k: int):
    """Lattice decomposition (HEHCC Alg. 15.41; src/curve/glv.rs:39-77).

    Returns (|k1|, |k2|, k1_neg, k2_neg) with k1 + s*k2 = k (signs applied)."""
    n = SECP256K1.n
    k %= n
    c1 = _round_ratio(GLV_B2 * k, n)
    c2 = _round_ratio(GLV_MINUS_B1 * k, n)
    k1_raw = (k - c1 * GLV_A1 - c2 * GLV_A2) % n
    k2_raw = (c1 * GLV_MINUS_B1 - c2 * GLV_B2) % n
    assert (k1_raw + GLV_S * k2_raw) % n == k
    k1_neg = k1_raw > n // 2
    k2_neg = k2_raw > n // 2
    k1 = n - k1_raw if k1_neg else k1_raw
    k2 = n - k2_raw if k2_neg else k2_raw
    return k1, k2, k1_neg, k2_neg


def _round_ratio(num: int, den: int) -> int:
    """round(num/den), ties away from zero, num >= 0 (num::rational Ratio::round)."""
    q, r = divmod(num, den)
    return q + (1 if 2 * r >= den else 0)


def glv_mul(pt: Point, k: int) -> Point:
    """k*P = k1*P + k2*psi(P), psi: (x, y) -> (beta*x, y) (glv.rs:84-102)."""
    k1, k2, k1_neg, k2_neg = decompose_secp256k1_scalar(k)
    sp = Point(pt.curve, pt.x * GLV_BETA % pt.curve.p, pt.y, pt.zero)
    first = -pt if k1_neg else pt
    second = -sp if k2_neg else sp
    return msm([k1, k2], [first, second], 5)


# ---------------------------------------------------------------------------
# ECDSA (src/curve/ecdsa.rs)
# ---------------------------------------------------------------------------

def base_to_scalar(curve: CurveParams, x: int) -> int:
    """Bit-cast of a base-field element into the scalar field WITHOUT modular
    reduction semantics beyond canonical int reinterpretation
    (curve_types.rs:280-286: to_canonical_biguint -> from_noncanonical_biguint)."""
    return x % curve.n


def keygen(curve: CurveParams, sk: int):
    sk %= curve.n
    return sk, curve.generator() * sk


def sign_message(curve: CurveParams, msg: int, sk: int, nonce: int):
    """Deterministic-nonce variant of sign_message (ecdsa.rs:25-40).

    The reference samples a random nonce; a nonce parameter keeps tests
    reproducible (determinism fix per SURVEY.md §7 item 6)."""
    n = curve.n
    msg, sk = msg % n, sk % n
    k = nonce % n
    while True:
        rr = curve.generator() * k
        if not rr.zero and rr.x % n != 0:
            break
        k += 1
    r = base_to_scalar(curve, rr.x)
    s = pow(k, -1, n) * (msg + r * sk) % n
    return r, s


def verify_message(curve: CurveParams, msg: int, r: int, s: int, pk: Point) -> bool:
    """ECDSA verification via 2-scalar MSM (ecdsa.rs:42-62)."""
    n = curve.n
    assert pk.is_valid() and not pk.zero
    c = pow(s, -1, n)
    u1 = msg * c % n
    u2 = r * c % n
    point = msm([u1, u2], [curve.generator(), pk], 5)
    if point.zero:
        return False
    return r % n == base_to_scalar(curve, point.x)


# ---------------------------------------------------------------------------
# Deterministic offset points ("rando") via Keccak of F::ZERO
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def deterministic_offset_point(curve: CurveParams, hash_bytes: int = 32) -> Point:
    """KeccakHash::<N>::hash_no_pad(&[F::ZERO]) -> scalar -> scalar*G.

    Mirrors src/gadgets/curve_msm.rs:33-37 (N=32) and
    curve_windowed_mul.rs:139-143 (N=25): keccak256 of the 8-byte LE encoding
    of Goldilocks zero, truncated to N bytes, read little-endian, reduced mod n.
    """
    from ..hash.keccak import keccak256

    h = keccak256(b"\x00" * 8)[:hash_bytes]
    scalar = int.from_bytes(h, "little") % curve.n
    return curve.generator() * scalar
