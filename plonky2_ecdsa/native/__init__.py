"""Native (C++) witness-tape executor.

The circuit template's witness tape is a list of vectorized ops over the
value table ``vals[num_targets, B]``.  The numpy closures in the gadgets are
the semantic reference; this module compiles the SAME ops (from structured
records attached at build time, see CircuitBuilder.add_op(rec=...)) down to
C++ kernels (witness_ops.cpp) called through ctypes on the shared table.

This is the framework's native runtime component for witness generation —
the equivalent of the reference's Rust witness generators
(src/gadgets/*.rs run_once, SURVEY.md §3.5), which otherwise dominate
end-to-end proving throughput (numpy per-op dispatch costs ~250us/op;
the C++ path runs the same op in ~2-10us).

Ops without native kernels (rare: glv_decompose, ux_*, div_rem) fall back to
their python closures mid-stream — both paths share the one value table.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys

import numpy as np

_LIB = None
_LIB_TRIED = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "witness_ops.cpp")


# Content-hashed build output inside the checkout (git-ignored).
_DEFAULT_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".native_build")


def _build_dir() -> str:
    d = os.environ.get("PLONKY2_NATIVE_DIR", _DEFAULT_BUILD_DIR)
    os.makedirs(d, exist_ok=True)
    return d


def get_lib():
    """Compile (once, content-hashed) and load the kernel library.
    Returns None when no C++ toolchain is available (numpy fallback)."""
    global _LIB, _LIB_TRIED
    if _LIB is not None or _LIB_TRIED:
        return _LIB
    _LIB_TRIED = True
    if os.environ.get("PLONKY2_NO_NATIVE") == "1":
        return None
    try:
        with open(_SRC, "rb") as f:
            src = f.read()
        tag = hashlib.sha256(src).hexdigest()[:16]
        path = os.path.join(_build_dir(), f"witness_ops_{tag}.so")
        if not os.path.exists(path):
            tmp = path + f".tmp{os.getpid()}"
            subprocess.run(
                ["g++", "-O3", "-march=native", "-shared", "-fPIC",
                 "-o", tmp, _SRC],
                check=True, capture_output=True)
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        for name, nargs in _SIGS.items():
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int
            fn.argtypes = None  # called with prepared ctypes values
        _LIB = lib
    except Exception as e:  # pragma: no cover - toolchain-specific
        print(f"[plonky2_ecdsa.native] build failed, numpy fallback: {e}",
              file=sys.stderr)
        _LIB = None
    return _LIB


_SIGS = {
    "op_mul_nn": 12, "op_inv_nn": 11, "op_add_nn": 12, "op_sub_nn": 12,
    "op_add_many_nn": 12, "op_cmp_const": 8, "op_range": 6, "op_arith": 8,
    "op_random_access": 10, "op_split": 5, "op_is_equal": 5,
    "op_scatter_wires": 10, "op_range_lookup": 7, "op_lookup_mult": 9,
}


def scatter_wires_pair(lib, vals: np.ndarray, pos_cols, pos_rows, pos_tids,
                       num_wires: int, n: int):
    """vals [num_targets, B] u64 -> (lo, hi) u32 [B, num_wires, n] via the
    native scatter (device wire-tensor layout, no u64 intermediate)."""
    B = vals.shape[1]
    lo = np.zeros((B, num_wires, n), np.uint32)
    hi = np.zeros((B, num_wires, n), np.uint32)
    pc, pr, pt = (_arr(pos_cols), _arr(pos_rows), _arr(pos_tids))
    rc = lib.op_scatter_wires(
        vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_int64(B), _ptr(pc), _ptr(pr), _ptr(pt),
        ctypes.c_int64(len(pc)), ctypes.c_int64(num_wires), ctypes.c_int64(n),
        lo.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        hi.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    assert rc == 0
    return lo, hi


def _arr(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _ff_params(ff):
    m = int(ff.m)
    dig = _arr([(m >> (32 * i)) & 0xFFFFFFFF for i in range(8)])
    m29 = _arr(ff.limbs29)
    return dig, m29


class NativeTape:
    """Compiled tape: per-op prepared callables over a shared value table."""

    def __init__(self, circuit):
        self.lib = get_lib()
        self.steps = []          # (is_native, payload)
        self.keepalive = []      # numpy arrays referenced by prepared args
        rm = circuit.read_map
        n_native = 0
        for op in circuit.tape:
            rec = getattr(op, "rec", None)
            if self.lib is None or rec is None or not self._supported(rec[0]):
                self.steps.append((False, op.fn))
                continue
            kind, p = rec
            prep = getattr(self, f"_prep_{kind}")(p, rm)
            # pre-wrap ints once (c_int64 construction per call costs more
            # than the kernels for the small ops)
            prep = tuple(
                ctypes.c_int64(a - (1 << 64) if a >= (1 << 63) else a)
                if isinstance(a, (int, np.integer)) else a for a in prep)
            self.steps.append((True, (getattr(self.lib, f"op_{kind}"), prep)))
            n_native += 1
        self.n_native = n_native

    def _supported(self, kind):
        return f"op_{kind}" in _SIGS

    def _keep(self, a):
        self.keepalive.append(a)
        return a

    # ---- per-op argument preparation (reads resolved via read_map, writes raw)
    def _prep_mul_nn(self, p, rm):
        x = self._keep(_arr(rm[_arr(p["x"])]))
        y = self._keep(_arr(rm[_arr(p["y"])]))
        q = self._keep(_arr(p["q"]))
        r = self._keep(_arr(p["r"]))
        c = self._keep(_arr(p["carry"]))
        dig, m29 = self._ff_cached(p["ff"])
        return (_ptr(x), len(x), _ptr(y), len(y), _ptr(q), _ptr(r), _ptr(c),
                _ptr(dig), len(dig), _ptr(m29))

    def _prep_inv_nn(self, p, rm):
        x = self._keep(_arr(rm[_arr(p["x"])]))
        inv = self._keep(_arr(p["inv"]))
        q = self._keep(_arr(p["q"]))
        c = self._keep(_arr(p["carry"]))
        dig, m29 = self._ff_cached(p["ff"])
        return (_ptr(x), len(x), _ptr(inv), _ptr(q), _ptr(c),
                _ptr(dig), len(dig), _ptr(m29))

    def _prep_add_nn(self, p, rm):
        x = self._keep(_arr(rm[_arr(p["x"])]))
        y = self._keep(_arr(rm[_arr(p["y"])]))
        s = self._keep(_arr(p["s"]))
        c = self._keep(_arr(p["c"]))
        dig, m29 = self._ff_cached(p["ff"])
        return (_ptr(x), len(x), _ptr(y), len(y), _ptr(s), int(p["ovf"]),
                _ptr(c), _ptr(dig), len(dig), _ptr(m29))

    _prep_sub_nn = _prep_add_nn

    def _prep_add_many_nn(self, p, rm):
        terms = np.stack([rm[_arr(ts)] for ts in p["terms"]])  # [k, nt]
        t = self._keep(_arr(terms.ravel()))
        s = self._keep(_arr(p["s"]))
        c = self._keep(_arr(p["c"]))
        dig, m29 = self._ff_cached(p["ff"])
        return (_ptr(t), terms.shape[0], terms.shape[1], _ptr(s),
                int(p["ovf"]), _ptr(c), _ptr(dig), len(dig), _ptr(m29))

    def _prep_cmp_const(self, p, rm):
        x = self._keep(_arr(rm[_arr(p["x"])]))
        mv = self._keep(_arr(p["mv"]))
        d = self._keep(_arr(p["d"]))
        brw = self._keep(_arr(p["brw"]))
        return (_ptr(x), len(x), _ptr(mv), _ptr(d), _ptr(brw), int(p["le"]))

    def _prep_range(self, p, rm):
        v = self._keep(_arr(rm[_arr(p["vals"])]))
        limbs = self._keep(_arr(np.asarray(p["limbs"]).ravel()))
        nl = int(p["nl"])
        return (_ptr(v), len(v), _ptr(limbs), nl)

    def _prep_range_lookup(self, p, rm):
        v = self._keep(_arr(rm[_arr(p["vals"])]))
        limbs = self._keep(_arr(np.asarray(p["limbs"]).ravel()))
        return (_ptr(v), len(v), _ptr(limbs), int(p["nl"]), int(p["lb"]))

    def _prep_lookup_mult(self, p, rm):
        gmeta = self._keep(_arr(np.array(
            [[len(vals), nl, scale] for vals, nl, scale in p["groups"]]
        ).ravel()))
        gvals = self._keep(_arr(np.concatenate(
            [rm[_arr(vals)] for vals, _nl, _sc in p["groups"]])
            if p["groups"] else np.zeros(0, np.int64)))
        m_t = self._keep(_arr(p["m_ts"]))
        return (_ptr(gmeta), len(p["groups"]), _ptr(gvals), _ptr(m_t),
                int(p["n"]), int(p["lb"]), int(p["zero_terms"]))

    def _prep_arith(self, p, rm):
        return (int(rm[p["m1"]]), int(rm[p["m2"]]), int(rm[p["ad"]]),
                int(p["out"]), int(p["c0"]), int(p["c1"]))

    def _prep_random_access(self, p, rm):
        items = self._keep(_arr(rm[_arr(p["items"])]))
        bits = self._keep(_arr(p["bits"]))
        halves = self._keep(_arr(p.get("halves", [])))
        return (int(rm[p["idx"]]), _ptr(items), len(items), int(p["out"]),
                _ptr(bits), len(bits), _ptr(halves), len(halves))

    def _prep_split(self, p, rm):
        bits = self._keep(_arr(p["bits"]))
        return (int(rm[p["x"]]), _ptr(bits), len(bits))

    def _prep_is_equal(self, p, rm):
        return (int(rm[p["d"]]), int(p["inv"]), int(p["eq"]))

    _ff_cache: dict = {}

    def _ff_cached(self, ff):
        key = id(ff)
        hit = self._ff_cache.get(key)
        if hit is None:
            hit = tuple(self._keep(a) for a in _ff_params(ff))
            self._ff_cache[key] = hit
        return hit

    # ---- execution
    def run(self, ev):
        vals = ev.vals
        assert vals.dtype == np.uint64 and vals.flags.c_contiguous
        B = vals.shape[1]
        vptr = vals.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        Bc = ctypes.c_int64(B)
        for is_native, payload in self.steps:
            if is_native:
                fn, prep = payload
                rc = fn(vptr, Bc, *prep)
                if rc != 0:
                    raise AssertionError(
                        f"native witness op {fn} failed with code {rc}")
            else:
                payload(ev)
