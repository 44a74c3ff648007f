#!/usr/bin/env python3
"""Smoke run of the production secp256k1 ECDSA prover on one NVIDIA GPU.

One process, one card.  Phases, in order:

  1. header      JAX version, devices, device_kind, and the card's name and
                 power limit from nvidia-smi (a child process off JAX).
  2. parity      every prover stage jitted at production widths and compared
                 with the numpy reference for exact equality
                 (scripts/device_parity.py), with each memory_analysis().
  3. main        EcdsaProverSystem(SECP256K1) at standard_ecc_config (n=2^13,
                 128 wires, N=2^15, 42 FRI queries, 16 PoW bits); B=32 lanes
                 through make_jit_prover(...).run_vals: cold and cached
                 compile, three batches of fresh statements, every proof
                 verified, lane 0 bit-identical to the numpy prover at B=1.
  4. interiors   gl.mul on 2^20 elements and the permutation at the
                 leaf-sponge width, in the u64 and the u32-pair interior.

Its times are smoke timings of one run, not benchmark metrics.  Any failure
raises: the script then exits non-zero and never prints the last line,
which is {"ok": true, "device": {"platform", "kind", "count"}}.

  python chip_smoke.py                all phases (one card)
  python chip_smoke.py --only parity  header + parity
  python chip_smoke.py --four         header + the sharded prover over four
                                      cards (dp=4, then dp=2 x col=2), each
                                      lane vs the one-card proof; no other
                                      phase
"""

import argparse
import json
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
B = 32
BATCHES = 3


def contract_line(info: dict) -> str:
    """The last line of a passing run: exactly the keys the contract reads."""
    return json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}})


def lanes_equal(a, i: int, b, j: int) -> bool:
    """Lane i of proof a is bit-identical to lane j of proof b (every proof
    array has its batch axis first)."""
    import jax

    from plonky2_ecdsa.prover.prover import _register_pytrees

    _register_pytrees()
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    if ta != tb or a.layout != b.layout:
        return False
    return all(np.array_equal(np.asarray(x)[i], np.asarray(y)[j])
               for x, y in zip(la, lb))


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "n/a"
    return (f"args={m.argument_size_in_bytes} out={m.output_size_in_bytes} "
            f"temp={m.temp_size_in_bytes} code={m.generated_code_size_in_bytes} "
            "bytes")


def _cache_entries() -> int:
    from plonky2_ecdsa import jaxcfg

    return sum(len(files) for _, _, files in os.walk(jaxcfg.cache_dir()))


def _peak_bytes() -> str:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return str(stats.get("peak_bytes_in_use", "n/a"))


def header():
    """Print the header; return (device info, card line).  Fails unless
    JAX's first device is a GPU."""
    import jax

    from plonky2_ecdsa.utils.device import device_info, gpu_name_and_power

    info = device_info()
    print(f"jax {jax.__version__} devices={jax.devices()} "
          f"device_kind={info['kind']}", flush=True)
    if info["platform"] != "gpu":
        raise SystemExit(f"chip_smoke: needs a GPU, JAX found "
                         f"platform={info['platform']!r}")
    card = gpu_name_and_power()
    for line in card.splitlines():
        print(f"nvidia-smi name, power.limit: {line}", flush=True)
    return info, card.splitlines()[0]


def check_native():
    from plonky2_ecdsa import native

    if native.get_lib() is None:
        raise RuntimeError("native witness library did not build "
                           "(the witness would silently run through numpy)")


def production_system(log):
    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    t0 = time.time()
    system = api.EcdsaProverSystem(cn.SECP256K1)
    cfg = system.circuit.config
    log(f"circuit build {time.time() - t0:.1f}s: n={system.n} "
        f"wires={cfg.num_wires} rate_bits={cfg.fri.rate_bits} "
        f"queries={cfg.fri.num_query_rounds} pow_bits={cfg.fri.proof_of_work_bits}")
    assert (system.n, cfg.num_wires, cfg.fri.rate_bits, cfg.fri.num_query_rounds,
            cfg.fri.proof_of_work_bits) == (1 << 13, 128, 2, 42, 16), \
        "not the production standard_ecc_config shape"
    return system


def check_fixed_data(log, data):
    """The device-built fixed commitment equals the numpy build."""
    from plonky2_ecdsa.fields import goldilocks as gl
    from plonky2_ecdsa.prover.data import _fixed_commit_host

    t0 = time.time()
    _coeffs, lde, tree = _fixed_commit_host(
        *gl.from_u64(data.fixed_values), data.n, data.N,
        data.circuit.config.fri.cap_height)
    ok = (np.array_equal(lde[0], data.fixed_lde[0])
          and np.array_equal(lde[1], data.fixed_lde[1])
          and len(tree.levels) == len(data.fixed_tree.levels)
          and all(np.array_equal(x, y) for lx, ly in
                  zip(tree.levels, data.fixed_tree.levels)
                  for x, y in zip(lx, ly)))
    log(f"fixed commitment device == numpy: {'OK' if ok else 'FAIL'} "
        f"(numpy {time.time() - t0:.1f}s)")
    if not ok:
        raise AssertionError("device fixed commitment differs from numpy")


def numpy_reference(log, system, stmt):
    """The host numpy prover's B=1 proof of one statement."""
    from plonky2_ecdsa.prover.prover import prove

    t0 = time.time()
    W, pis = system.witness([stmt])
    ref = prove(system.data, W, pis)
    log(f"numpy prove B=1: {time.time() - t0:.1f}s")
    return ref


def phase_main(log, system, batch=B, batches=BATCHES):
    import jax

    from plonky2_ecdsa import api
    from plonky2_ecdsa.prover.prover import make_jit_prover

    t0 = time.time()
    data = system.data
    log(f"fixed data (device commit) {time.time() - t0:.1f}s")

    t0 = time.time()
    stmts = [api.random_statements(system.curve, batch, seed=3 + k)
             for k in range(batches)]
    vals = [system.witness_vals(s) for s in stmts]
    log(f"statements + witness tapes for {batches} x B={batch}: "
        f"{time.time() - t0:.1f}s")

    # the numpy references run on the host while XLA compiles the step
    with ThreadPoolExecutor(1) as host:
        fixed_ok = host.submit(check_fixed_data, log, data)
        ref = host.submit(numpy_reference, log, system, stmts[0][0])

        run = make_jit_prover(data)
        before = _cache_entries()
        t0 = time.time()
        lowered = run.lower_vals(vals[0][0])
        t1 = time.time()
        compiled = lowered.compile()
        t2 = time.time()
        new = _cache_entries() - before
        log(f"prove step first compile in this process: trace {t1 - t0:.1f}s "
            f"compile {t2 - t1:.1f}s ("
            + (f"cold: {new} new persistent-cache entries" if new else
               "the persistent cache already held it: not a cold compile") + ")")
        log(f"prove step memory_analysis: {_mem(compiled)}")

        jax.clear_caches()
        run = make_jit_prover(data)
        t0 = time.time()
        lowered = run.lower_vals(vals[0][0])
        t1 = time.time()
        lowered.compile()
        t2 = time.time()
        log(f"prove step after jax.clear_caches(): trace {t1 - t0:.1f}s "
            f"compile (persistent cache) {t2 - t1:.1f}s")

        t0 = time.time()
        run.run_vals(*vals[0])
        log(f"first prove (warm-up) {time.time() - t0:.2f}s")
        fixed_ok.result()
        ref = ref.result()

    t0 = time.time()
    handles = [run.dispatch_vals(*v) for v in vals]
    proofs = [run.collect(h) for h in handles]
    dt = (time.time() - t0) / batches
    log(f"steady (smoke timing, not a benchmark): {dt:.3f} s/batch of "
        f"B={batch} over {batches} batches; peak_bytes_in_use={_peak_bytes()}")

    t0 = time.time()
    for k, (p, st) in enumerate(zip(proofs, stmts)):
        if not system.verify(p):
            raise AssertionError(f"batch {k}: proof failed verification")
        if not system.verify_statement(p, 0, st[0]):
            raise AssertionError(f"batch {k}: lane 0 does not bind its statement")
    log(f"all {batches * batch} proofs verified, lane 0 statements bound "
        f"({time.time() - t0:.1f}s host verify)")
    if not lanes_equal(proofs[0], 0, ref, 0):
        raise AssertionError("lane 0 differs from the numpy proof")
    log("lane 0 bit-identical to the numpy prover: OK")


def _time_calls(fn, args, reps):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def phase_interiors(log, mul_len=1 << 20, perm_shape=(12, B, 1 << 15),
                    rounds=5):
    """Both Goldilocks interiors in one process: compile each, check they
    agree, then time them in alternating rounds (median, min-max spread)."""
    import jax

    from plonky2_ecdsa.fields import goldilocks as gl
    from plonky2_ecdsa.hash import poseidon as ps
    from scripts.device_parity import _rand_field

    keys = jax.random.split(jax.random.PRNGKey(7), 3)
    a, b = _rand_field(keys[0], (mul_len,)), _rand_field(keys[1], (mul_len,))
    st = _rand_field(keys[2], perm_shape)
    default = gl._JAX_U64
    compiled = {}
    try:
        for interior in ("u64", "u32"):
            gl.enable_jax_u64(interior == "u64")
            compiled[interior] = (
                jax.jit(lambda a, b: gl.mul(*a, *b)).lower(a, b).compile(),
                jax.jit(lambda s: ps._permute_rounds_jax(*s)).lower(st).compile())
    finally:
        gl.enable_jax_u64(default)
    outs = {k: jax.device_get((m(a, b), p(st))) for k, (m, p) in compiled.items()}
    if not all(np.array_equal(x, y) for x, y in zip(
            jax.tree_util.tree_leaves(outs["u64"]),
            jax.tree_util.tree_leaves(outs["u32"]))):
        raise AssertionError("u64 and u32 interiors disagree")
    times = {(k, op): [] for k in compiled for op in ("mul", "perm")}
    for _ in range(rounds):
        for k, (m, p) in compiled.items():
            times[(k, "mul")].append(_time_calls(m, (a, b), 50))
            times[(k, "perm")].append(_time_calls(p, (st,), 5))
    for (k, op), ts in sorted(times.items()):
        what = (f"gl.mul [{mul_len}]" if op == "mul"
                else f"permutation {list(perm_shape)}")
        log(f"interior {k} {what}: median {np.median(ts) * 1e3:.4f} ms "
            f"(min {min(ts) * 1e3:.4f}, max {max(ts) * 1e3:.4f}; "
            f"{rounds} rounds)")


def _mesh_proof(log, data, col, W, pis):
    """Prove W over a four-card (dp, col) mesh, twice; returns the proof."""
    from plonky2_ecdsa.parallel.mesh import make_mesh_prover, prover_mesh
    from plonky2_ecdsa.prover.prover import host_prep

    mesh = prover_mesh(4, col_parallel=col)
    run = make_mesh_prover(data, mesh)
    t0 = time.time()
    run(W, pis)
    t1 = time.time()
    proof = run(W, pis)
    t2 = time.time()
    shards = run.core(*host_prep(data, W, pis)).openings0[0][0]
    where = sorted({(s.device.id, s.index[0].start or 0)
                    for s in shards.addressable_shards})
    log(f"mesh {dict(mesh.shape)}: compile + run {t1 - t0:.1f}s, "
        f"run {t2 - t1:.2f}s; openings0 shards (device, first lane): {where}")
    return dict(mesh.shape), proof


def phase_four(log, system, batch=B):
    """make_mesh_prover over four cards, dp=4 and dp=2 x col=2 (compiled
    concurrently); every proof verified and every lane bit-identical to the
    one-card make_jit_prover proof of the same witness."""
    import jax

    from plonky2_ecdsa import api
    from plonky2_ecdsa.prover.prover import make_jit_prover

    if len(jax.devices()) < 4:
        raise SystemExit(f"--four needs 4 devices, found {len(jax.devices())}")
    data = system.data
    stmts = api.random_statements(system.curve, batch, seed=3)
    W, pis = system.witness(stmts)
    vals = system.witness_vals(stmts)
    run = make_jit_prover(data)
    with ThreadPoolExecutor(2) as pool:
        meshes = [pool.submit(_mesh_proof, log, data, col, W, pis)
                  for col in (1, 2)]
        t0 = time.time()
        ref = run.run_vals(*vals)
        log(f"one-card prove B={batch} (compile + run) {time.time() - t0:.1f}s")
        meshes = [m.result() for m in meshes]
    with ThreadPoolExecutor(3) as pool:
        oks = [pool.submit(system.verify, p) for p in [ref] + [p for _, p in meshes]]
        oks = [ok.result() for ok in oks]
    if not oks[0]:
        raise AssertionError("one-card proof failed verification")
    for (shape, proof), ok in zip(meshes, oks[1:]):
        if not ok:
            raise AssertionError(f"mesh {shape}: proof failed verification")
        bad = [i for i in range(batch) if not lanes_equal(proof, i, ref, i)]
        if bad:
            raise AssertionError(f"mesh {shape}: lanes {bad} differ from the "
                                 "one-card proof")
        log(f"mesh {shape}: proof verified; all {batch} lanes bit-identical "
            "to the one-card proof")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", choices=["parity"],
                    help="run the header and this phase only")
    ap.add_argument("--four", action="store_true",
                    help="the four-card mesh prover path, and no other phase")
    args = ap.parse_args(argv)

    t_start = time.time()
    sys.path.insert(0, REPO)
    import plonky2_ecdsa  # noqa: F401  (cache + field interior, before any jit)

    info, card = header()

    def log(msg):
        print(f"[{time.time() - t_start:7.1f}s] {msg}  | {card}", flush=True)

    log(f"compile cache: {plonky2_ecdsa.jaxcfg.cache_dir()}")
    if args.four:
        check_native()
        phase_four(log, production_system(log))
    else:
        from scripts.device_parity import stage_parity

        stage_parity(log)
        if args.only != "parity":
            check_native()
            phase_main(log, production_system(log))
            phase_interiors(log)
    log("all phases passed")
    print(contract_line(info), flush=True)


if __name__ == "__main__":
    main()
