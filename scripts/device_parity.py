"""Device-vs-numpy parity of the prover's stages at production widths.

Each stage is jitted on the default JAX device and compared with the numpy
reference for EXACT equality: all the arithmetic is integer arithmetic mod p,
so there is no tolerance.  Large inputs are drawn on the device; where the
numpy reference of a whole slab would take minutes, a sample of its
independent rows is compared.  Any mismatch raises.

stage_parity(log) checks every stage and logs each compiled module's
memory_analysis(); bench.py runs it as its preflight and chip_smoke.py as
its parity phase.

Usage: python scripts/device_parity.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

_PREFLIGHT_VECTORS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "vectors", "preflight_digests.json")
_PREFLIGHT_POW = 10

# production shape of the secp256k1 prover: B lanes, k wire columns,
# n rows, N = 4n LDE points
B, K_WIRES, N_ROWS, N_LDE = 32, 128, 1 << 13, 1 << 15


def _digest(*arrs):
    import hashlib

    h = hashlib.sha256()
    for a in arrs:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _preflight_host_side(rng):
    """Deterministic inputs (seeded rng) + numpy reference digests for the
    Poseidon2 permutation at [12, 2, 8192], the batch inverse at the LogUp
    width (B=32, k=155, 512) and the PoW grind (B=32, pow=10).  The digests
    are frozen in tests/vectors/preflight_digests.json when present: the
    numpy reference grind takes minutes on a small host."""
    from plonky2_ecdsa.fields import goldilocks as gl
    from plonky2_ecdsa.hash import poseidon as ps
    from plonky2_ecdsa.prover.challenger import Challenger
    from plonky2_ecdsa.prover.prover import _batch_inverse_axis1

    shape = (2, 8192)
    v = rng.integers(0, gl.P, (12,) + shape, dtype=np.uint64)
    plo, phi = gl.from_u64(v)

    Bp, k = 32, 155
    bv = rng.integers(1, gl.P, (Bp, k, 512), dtype=np.uint64)
    bpair = gl.from_u64(bv)

    # pow=10 keeps the numpy REFERENCE sweep to ~1 chunk (the device path is
    # the production pow=16 one; only the shift scalar differs)
    seedv = rng.integers(0, gl.P, Bp, dtype=np.uint64)
    seed = gl.from_u64(seedv)
    ch2 = Challenger(np, (Bp,))
    ch2.observe(seed)
    ch2._duplex()
    slo = np.stack([s[0] for s in ch2.state])
    shi = np.stack([s[1] for s in ch2.state])

    inputs = dict(plo=plo, phi=phi, blo=bpair[0], bhi=bpair[1],
                  slo=slo, shi=shi)
    if os.path.exists(_PREFLIGHT_VECTORS):
        import json

        with open(_PREFLIGHT_VECTORS) as f:
            return inputs, json.load(f)

    ps_ref = ps.permute_stacked(plo, phi)
    bi_ref = _batch_inverse_axis1(bpair, np)
    ch_ref = Challenger(np, (Bp,))
    ch_ref.observe(seed)
    w_ref = ch_ref.grind(_PREFLIGHT_POW)
    return inputs, dict(ps=_digest(ps_ref[0], ps_ref[1]),
                        bi=_digest(bi_ref[0], bi_ref[1]),
                        w=_digest(w_ref[0]))


def gen_preflight_vectors():
    """Regenerate tests/vectors/preflight_digests.json (rerun after changing
    the preflight shapes or the Poseidon/field semantics)."""
    import json

    if os.path.exists(_PREFLIGHT_VECTORS):
        os.remove(_PREFLIGHT_VECTORS)
    _inputs, refs = _preflight_host_side(np.random.default_rng(0xECD5A))
    with open(_PREFLIGHT_VECTORS, "w") as f:
        json.dump(refs, f, indent=1)
    print(f"wrote {_PREFLIGHT_VECTORS}")


def device_grind(slo, shi, pow_bits):
    """The prover's device PoW grind from a duplexed sponge state [12, B]."""
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.challenger import GRIND_EXHAUSTED, Challenger

    ch = Challenger(jnp, (slo.shape[1],))
    ch.state = [(slo[i], shi[i]) for i in range(slo.shape[0])]
    w, _ = ch.grind(pow_bits)
    return w, w != jnp.uint32(GRIND_EXHAUSTED)


def _check(log, name, ok):
    log(f"{name}: {'OK' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"device parity failed: {name}")


def _mem_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "memory_analysis: n/a"
    return (f"memory_analysis: args={m.argument_size_in_bytes} "
            f"out={m.output_size_in_bytes} temp={m.temp_size_in_bytes} "
            f"code={m.generated_code_size_in_bytes} bytes")


def _run(log, name, fn, *args):
    """jit + compile fn at args, log its memory analysis, run it."""
    import jax

    t0 = time.time()
    compiled = jax.jit(fn).lower(*args).compile()
    t1 = time.time()
    out = jax.block_until_ready(compiled(*args))
    log(f"{name}: compile {t1 - t0:.2f}s run {time.time() - t1:.3f}s "
        f"{_mem_line(compiled)}")
    return out


def _rand_field(key, shape):
    """Uniform-ish canonical Goldilocks pairs drawn on the device (top bit
    of hi cleared, so every value is < 2^63 < p)."""
    import jax
    import jax.numpy as jnp

    k1, k2 = jax.random.split(key)
    lo = jax.random.bits(k1, shape, jnp.uint32)
    hi = jax.random.bits(k2, shape, jnp.uint32) & jnp.uint32(0x7FFFFFFF)
    return lo, hi


def _rows(pair, rows):
    """Rows of a device (lo, hi) pair, fetched to the host."""
    import jax

    return jax.device_get((pair[0][rows], pair[1][rows]))


def _eq(dev, ref):
    return (np.array_equal(np.asarray(dev[0]), ref[0])
            and np.array_equal(np.asarray(dev[1]), ref[1]))


def _with_tables(op, sizes):
    """op(lo, hi) as a function of (tabs, lo, hi): the NTT tables enter as
    jit ARGUMENTS, as in the prover (make_jit_prover's device path)."""
    import jax
    import jax.numpy as jnp

    from plonky2_ecdsa.prover import ntt

    tabs = jax.tree_util.tree_map(jnp.asarray, ntt.host_tables(sizes))

    def fn(tabs, lo, hi):
        tok = ntt._DEVICE_TABLES.set(tabs)
        try:
            return op(lo, hi)
        finally:
            ntt._DEVICE_TABLES.reset(tok)

    return fn, tabs


def stage_parity(log=print, lanes=B, wires=K_WIRES, n=N_ROWS, N=N_LDE):
    """Every prover stage class vs numpy, exact; production widths by
    default (smaller ones rehearse the control flow on the CPU)."""
    import jax
    import jax.numpy as jnp

    from plonky2_ecdsa.fields import goldilocks as gl
    from plonky2_ecdsa.hash import poseidon as ps
    from plonky2_ecdsa.prover import ntt
    from plonky2_ecdsa.prover.prover import _batch_inverse_axis1

    keys = jax.random.split(jax.random.PRNGKey(0xECD5A), 5)

    a = _rand_field(keys[0], (1 << 16,))
    b = _rand_field(keys[1], (1 << 16,))
    got = _run(log, "gl.mul [2^16]", lambda a, b: gl.mul(*a, *b), a, b)
    _check(log, "gl.mul [2^16] parity",
           _eq(got, gl.mul(*jax.device_get(a), *jax.device_get(b))))

    # the permutation at the width of one leaf-sponge step of the wires
    # commit: state [12, B, N]; lanes are independent, so numpy checks the
    # first and the last lane's N states
    name = f"poseidon2 permutation [12, {lanes}, {N}]"
    st = _rand_field(keys[2], (ps.WIDTH, lanes, N))
    got = _run(log, name, lambda s: ps.permute_stacked(*s), st)
    ends = np.array([0, lanes - 1])
    _check(log, f"{name} parity (lanes 0, {lanes - 1})",
           _eq(jax.device_get((got[0][:, ends], got[1][:, ends])),
               ps.permute_stacked(*jax.device_get((st[0][:, ends], st[1][:, ends])))))
    del st, got

    # fixed shapes against frozen numpy digests: the permutation at
    # [12, 2, 8192], the batch inverse at the LogUp width, the device grind
    inputs, refs = _preflight_host_side(np.random.default_rng(0xECD5A))
    dev = {k: jnp.asarray(v) for k, v in inputs.items()}
    got = jax.device_get(_run(log, "poseidon2 permutation [12, 2, 8192]",
                              lambda lo, hi: ps.permute_stacked(lo, hi),
                              dev["plo"], dev["phi"]))
    _check(log, "poseidon2 permutation [12, 2, 8192] parity",
           _digest(got[0], got[1]) == refs["ps"])
    got = jax.device_get(_run(log, "batch inverse B=32 k=155 n=512",
                              lambda lo, hi: _batch_inverse_axis1((lo, hi), jnp),
                              dev["blo"], dev["bhi"]))
    _check(log, "batch inverse B=32 k=155 n=512 parity",
           _digest(got[0], got[1]) == refs["bi"])
    w, found = jax.device_get(_run(
        log, f"grind B=32 pow={_PREFLIGHT_POW}",
        lambda slo, shi: device_grind(slo, shi, _PREFLIGHT_POW),
        dev["slo"], dev["shi"]))
    _check(log, f"grind B=32 pow={_PREFLIGHT_POW} parity",
           bool(found.all()) and _digest(w) == refs["w"])

    # NTT stages on [B*k, n] slabs; rows are independent, so the first and
    # last 8 rows are compared with numpy
    R = lanes * wires
    rows = np.r_[0:8, R - 8:R]
    stages = [
        (f"intt [{R}, {n}]", n, ntt.intt, ntt.intt),
        (f"coset LDE [{R}, {n} -> {N}]", n,
         lambda lo, hi: ntt.coset_ntt_from_coeffs(lo, hi, N),
         lambda lo, hi: ntt.coset_ntt_from_coeffs(lo, hi, N)),
        (f"ntt [{R}, {N}]", N, ntt.ntt, ntt.ntt),
    ]
    for i, (name, width, op, ref) in enumerate(stages):
        slab = _rand_field(keys[3 + (width == N)], (R, width))
        fn, tabs = _with_tables(op, [n, N])
        got = _run(log, name, fn, tabs, *slab)
        _check(log, f"{name} parity (rows {len(rows)})",
               _eq(_rows(got, rows), ref(*_rows(slab, rows))))
        del slab, got


def main():
    import jax

    print(f"backend={jax.default_backend()} devices={jax.devices()}")
    t0 = time.time()
    stage_parity()
    print(f"stage parity OK ({time.time() - t0:.1f}s)")


if __name__ == "__main__":
    main()
