"""Time individual prover kernels on the attached device at real ECDSA shapes.

Synthetic data, per-kernel jits: isolates NTT / Poseidon-sponge / Merkle /
grind / gather cost so optimization effort goes where the time is.

Usage: python scripts/profile_stages.py [B]

Shapes default to the production secp256k1 circuit: n=2^13, N=2^15 (4x LDE),
128 wire columns, B=32 proof lanes.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import plonky2_ecdsa  # noqa: F401,E402  (compile cache + field interior)

import jax
import jax.numpy as jnp

from plonky2_ecdsa.fields import goldilocks as gl
from plonky2_ecdsa.hash import merkle, poseidon
from plonky2_ecdsa.prover import ntt


def _checksummed(fn):
    """Wrap fn so the jitted computation ends in a scalar checksum: reading
    that scalar back forces completion without copying the full output to
    the host."""
    def wrapped(*args):
        out = fn(*args)
        leaves = jax.tree_util.tree_leaves(out)
        acc = None
        for leaf in leaves:
            s = jnp.sum(leaf.astype(jnp.uint32)) if leaf.dtype != jnp.uint32 else jnp.sum(leaf)
            acc = s if acc is None else acc + s
        return acc
    return wrapped


def timeit(label, fn, *args, reps=3):
    jfn = jax.jit(_checksummed(fn))
    np.asarray(jfn(*args))
    t0 = time.time()
    for _ in range(reps):
        np.asarray(jfn(*args))
    dt = (time.time() - t0) / reps
    print(f"{label:44s} {dt*1e3:10.1f} ms", flush=True)
    return dt


def main():
    B = int(sys.argv[1]) if len(sys.argv) > 1 else 32
    n, N = 1 << 13, 1 << 15
    wires = 128
    print(f"platform={jax.devices()[0].platform} B={B} n={n} N={N} wires={wires}")
    rng = np.random.default_rng(0)

    def rand_pair(shape):
        v = rng.integers(0, gl.P, size=shape, dtype=np.uint64)
        lo, hi = gl.from_u64(v)
        return jnp.asarray(lo), jnp.asarray(hi)

    tabs = ntt.host_tables([n, N])
    tabs = jax.tree_util.tree_map(jnp.asarray, tabs)

    def with_tabs(f):
        def g(*a):
            tok = ntt._DEVICE_TABLES.set(tabs)
            try:
                return f(*a)
            finally:
                ntt._DEVICE_TABLES.reset(tok)
        return g

    # --- raw poseidon permutation throughput (one big call) -----------------
    lanes = B * N  # the leaf-sponge lane count
    sl, sh = rand_pair((12, lanes))
    t = timeit(f"poseidon permute [12, B*N={lanes}]",
               lambda a, b: poseidon.permute_stacked(a, b), sl, sh)
    print(f"  -> {lanes/t/1e6:.0f} Mperm/s", flush=True)

    # --- leaf sponge at the wires-commit shape ------------------------------
    ll, lh = rand_pair((B, wires, N))
    t = timeit(f"leaf sponge [B,{wires},N] (16 perms/leaf)",
               lambda a, b: merkle.leaf_digests_from_polys(a, b, jnp), ll, lh)
    print(f"  -> {B*N*(wires//8)/t/1e6:.0f} Mperm/s effective", flush=True)

    # --- full tree from digests --------------------------------------------
    dl, dh = rand_pair((B, N, 4))
    timeit("merkle tree from digests [B,N,4]",
           lambda a, b: merkle._build_tree_from_digests(a, b, 4, jnp).cap, dl, dh)

    # --- intt at n / coset ntt at N (wires commit shapes) -------------------
    wl, wh = rand_pair((B, wires, n))
    timeit(f"intt [B,{wires},n]", jax.jit(with_tabs(lambda a, b: ntt.intt(a, b))), wl, wh)
    cl, chh = rand_pair((B, wires, n))
    timeit(f"coset_ntt n->N [B,{wires}]",
           jax.jit(with_tabs(lambda a, b: ntt.coset_ntt_from_coeffs(a, b, N))), cl, chh)

    # --- elementwise mul baseline over the big LDE tensor -------------------
    xl, xh = rand_pair((B, wires, N))
    yl, yh = rand_pair((B, wires, N))
    t = timeit(f"gl.mul [B,{wires},N]",
               lambda a, b, c, d: gl.mul(a, b, c, d), xl, xh, yl, yh)
    print(f"  -> {B*wires*N/t/1e9:.2f} G goldilocks-muls/s", flush=True)

    # --- batch inverse at the LogUp width -----------------------------------
    il, ih = rand_pair((B, 155, n))
    from plonky2_ecdsa.prover.prover import _batch_inverse_axis1

    timeit("batch_inverse [B,155,n]",
           lambda a, b: _batch_inverse_axis1((a, b), jnp), il, ih)

    # --- PoW grind at the production transcript shape -----------------------
    from plonky2_ecdsa.prover.challenger import Challenger

    def grind(slo, shi):
        ch = Challenger(jnp, (B,))
        ch.state = [(slo[i], shi[i]) for i in range(12)]
        ch.outputs = list(ch.state[:8])
        return ch.grind(16)

    gsl, gsh = rand_pair((12, B))
    timeit("pow grind 16 bits [B lanes]", grind, gsl, gsh)

    # --- query-phase gathers (packed tree open vs per-level loop) --------
    idx = jnp.asarray(rng.integers(0, N, size=(B, 42)).astype(np.int32))
    tree = merkle._build_tree_from_digests(dl, dh, 4, jnp)
    timeit("packed tree.open [B,N] Q=42",
           lambda i: tree.open(i), idx)
    timeit("take_along gather [B,128,N] Q=42",
           lambda i: (jnp.take_along_axis(ll, i[:, None, :], -1),
                      jnp.take_along_axis(lh, i[:, None, :], -1)), idx)


if __name__ == "__main__":
    main()
