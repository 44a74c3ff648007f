"""Stage-level timing of the full ECDSA prove pipeline on the device.

Compiles prefixes of prove_core via the stop_after debug knob and reports the
incremental cost of each stage.  Circuit data + witness are cached to disk so
reruns skip the ~1 min host build.

Usage: python scripts/profile_prove.py [B] [stage1,stage2,...]

Set PLONKY2_TRACE_DIR=/path to additionally capture a jax.profiler trace
of each stage's steady-state run (open with TensorBoard / Perfetto; the
per-kernel timeline is the roofline-accounting source for BASELINE.md).

Set PLONKY2_PROFILE_JSON=/path to write the per-stage timings as a
machine-readable artifact."""

import os
import pickle
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import plonky2_ecdsa  # noqa: F401,E402  (compile cache + field interior)

CIRCUIT_REV = "r5a"  # bump when the ECDSA circuit shape changes (invalidates the temp-dir caches)


def _cache_paths(B):
    from plonky2_ecdsa.circuit.config import CircuitConfig

    cfg = CircuitConfig.standard_ecc_config()
    tag = (f"{CIRCUIT_REV}r{cfg.fri.rate_bits}c{cfg.permutation_chunk_size}"
           f"q{cfg.fri.num_query_rounds}b{B}")
    d = tempfile.gettempdir()
    return (os.path.join(d, f"ecdsa_data_{tag}.npz"),
            os.path.join(d, f"ecdsa_wit_{tag}.npz"))


def get_system(B):
    from plonky2_ecdsa.prover.serialize import load_circuit_data, save_circuit_data

    dpath, wpath = _cache_paths(B)
    if os.path.exists(dpath) and os.path.exists(wpath):
        data = load_circuit_data(dpath)
        z = np.load(wpath)
        return data, z["W"], z["pis"]
    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    t0 = time.time()
    system = api.EcdsaProverSystem(cn.SECP256K1)
    stmts = api.random_statements(cn.SECP256K1, B, seed=3)
    W, pis = system.witness(stmts)
    data = system.data
    print(f"built system in {time.time()-t0:.1f}s (n={system.n})", flush=True)
    save_circuit_data(data, dpath)
    np.savez(wpath, W=W, pis=pis)
    return data, W, pis


def main():
    import jax
    import jax.numpy as jnp

    from plonky2_ecdsa.prover.prover import (Backend, host_prep, prove_core,
                                                 prover_tables, _register_pytrees)
    from plonky2_ecdsa.prover import ntt

    B = int(sys.argv[1]) if len(sys.argv) > 1 else 4
    stages = (sys.argv[2].split(",") if len(sys.argv) > 2
              else ["commit", "zs", "quotient", "openings", "fri", "full"])
    data, W, pis = get_system(B)
    _register_pytrees()
    bk = Backend(data, jnp)
    tabs = prover_tables(data, jnp)
    wires_pair, pi_pair, pis_pair = host_prep(data, W, pis)
    args = tuple(jax.device_put(a) for a in (wires_pair, pi_pair, pis_pair))

    prev = 0.0
    records = []
    for stage in stages:
        sa = None if stage == "full" else stage

        def core(bk, tabs, wp, pp, psp, sa=sa):
            tok = ntt._DEVICE_TABLES.set(tabs)
            try:
                return prove_core(data, bk, wp, pp, psp, jnp, stop_after=sa)
            finally:
                ntt._DEVICE_TABLES.reset(tok)

        def summed(bk, tabs, wp, pp, psp):
            # end the jitted computation in one scalar checksum: reading it
            # back forces completion without copying the outputs to the host
            out = core(bk, tabs, wp, pp, psp)
            acc = jnp.uint32(0)
            for leaf in jax.tree_util.tree_leaves(out):
                acc = acc + jnp.sum(leaf.astype(jnp.uint32))
            return acc

        jcore = jax.jit(summed)
        t0 = time.time()
        np.asarray(jcore(bk, tabs, *args))
        compile_s = time.time() - t0
        reps = 2
        trace_dir = os.environ.get("PLONKY2_TRACE_DIR")
        if trace_dir:
            with jax.profiler.trace(os.path.join(trace_dir, f"stage_{stage}")):
                np.asarray(jcore(bk, tabs, *args))
        t0 = time.time()
        for _ in range(reps):
            np.asarray(jcore(bk, tabs, *args))
        dt = (time.time() - t0) / reps
        print(f"{stage:12s} cumulative {dt*1e3:9.1f} ms  (+{(dt-prev)*1e3:9.1f} ms)"
              f"   [compile {compile_s:.0f}s]", flush=True)
        records.append({"stage": stage, "cumulative_ms": round(dt * 1e3, 1),
                        "incremental_ms": round((dt - prev) * 1e3, 1),
                        "compile_s": round(compile_s, 1)})
        prev = dt

    jpath = os.environ.get("PLONKY2_PROFILE_JSON")
    if jpath:
        import json

        payload = {"platform": jax.devices()[0].platform, "B": B,
                   "n": data.n, "N": data.N,
                   "num_wires": data.circuit.config.num_wires,
                   "stages": records}
        with open(jpath, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {jpath}", flush=True)


if __name__ == "__main__":
    main()
