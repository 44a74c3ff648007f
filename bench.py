"""Benchmark harness: batched secp256k1 ECDSA proving throughput per chip.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric: full PLONK+FRI proofs of in-circuit secp256k1 ECDSA verification
(the reference's test_ecdsa_circuit_narrow workload, src/gadgets/ecdsa.rs:163)
produced per second on one chip, steady-state jitted device pipeline.

Baseline anchor (see BASELINE.md "CPU baseline anchor"): the reference
publishes no numbers and no Rust toolchain exists in this image (direct
measurement attempted and impossible), so `vs_baseline` divides by 0.2
proofs/s — the midpoint anchor derived from plonky2's published 170 ms /
2^12-row proving figure scaled to the reference ECDSA circuit's 2^15-2^16
rows on CI-class hardware.

Env knobs: BENCH_BATCH (default: platform-dependent), BENCH_REPS (default 5),
BENCH_SMALL=1 benches the nonnative-mul-chain microcircuit instead,
BENCH_P256=1 benches the P-256 ECDSA circuit (windowed mul path) instead of
secp256k1/GLV.

Every proof in the pipelined stream is verified (after the timed section, so
host-side verification does not distort the device throughput measurement);
any invalid proof aborts the bench.
"""

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

RUST_CPU_PROOFS_PER_SEC_EST = 0.2  # documented estimate, BASELINE.md


def bench_recursive(reps, on_device, platform):
    """BENCH_RECURSIVE=1: throughput of OUTER proofs — on-device FRI proving
    of the recursive verifier circuit for the production secp256k1 ECDSA
    circuit (n=2^13 inner -> n=2^14 outer under recursion_ecc_config; the
    degree-7 PoseidonGate quotient at blowup 8 is the device-side risk this
    mode exists to exercise).  Each outer lane verifies
    one inner proof lane in-circuit and re-exports its 45 statement limbs."""
    import dataclasses

    import jax

    from plonky2_ecdsa import api
    from plonky2_ecdsa.circuit.builder import CircuitBuilder
    from plonky2_ecdsa.circuit.config import CircuitConfig, FriConfig
    from plonky2_ecdsa.circuit.recursive_verifier import (
        build_recursive_verifier, recursive_verifier_inputs)
    from plonky2_ecdsa.curve import native as cn
    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import make_jit_prover, prove
    from plonky2_ecdsa.prover.verifier import verify

    B = int(os.environ.get("BENCH_BATCH", "8" if on_device else "1"))
    t0 = time.time()
    system = api.EcdsaProverSystem(cn.SECP256K1)
    idata = system.data
    stmts = api.random_statements(cn.SECP256K1, B, seed=11)
    build_i = time.time() - t0
    # inner proofs (inputs to the recursion; produced once, not timed)
    t0 = time.time()
    if on_device:
        run_i = make_jit_prover(idata)
        Vi, ipis = system.witness_vals(stmts)
        iproof = run_i.run_vals(Vi, ipis)
    else:
        Wi, ipis = system.witness(stmts)
        iproof = prove(idata, Wi, ipis)
    inner_s = time.time() - t0
    assert verify(idata, iproof), "inner ECDSA proof failed verification"

    t0 = time.time()
    ocfg = CircuitConfig.recursion_ecc_config()
    if os.environ.get("BENCH_RECURSIVE_FAST_FRI") == "1":
        # compile/HBM escape hatch: reduced OUTER FRI (circuit identical)
        ocfg = dataclasses.replace(ocfg, fri=FriConfig(
            rate_bits=3, cap_height=1, num_query_rounds=4,
            proof_of_work_bits=4))
    ob = CircuitBuilder(ocfg)
    build_recursive_verifier(ob, idata)
    oc = ob.build()
    odata = build_circuit_data(oc)
    build_o = time.time() - t0
    t0 = time.time()
    inputs = recursive_verifier_inputs(idata, iproof)
    Vo = oc._run_tape(inputs, B, None)
    opis = oc.public_input_values()
    assert np.array_equal(opis, ipis), "statement limbs must re-export"
    wit_s = time.time() - t0
    run = make_jit_prover(odata)
    t0 = time.time()
    proof = run.run_vals(Vo, opis)  # compile + first run
    compile_s = time.time() - t0
    assert verify(odata, proof), "outer (recursive) proof failed verification"

    t0 = time.time()
    pending = None
    proofs = []
    done = 0
    for _ in range(reps):
        handle = run.dispatch_vals(Vo, opis)
        if pending is not None:
            proofs.append(run.collect(pending))
            done += 1
        pending = handle
    proofs.append(run.collect(pending))
    done += 1
    dt = (time.time() - t0) / done
    for i, p in enumerate(proofs):
        assert verify(odata, p), f"outer batch {i} failed verification"
        assert np.array_equal(p.pis, ipis)
    value = B / dt
    print(f"# platform={platform} RECURSIVE B={B} inner_n={idata.n} "
          f"outer_n={oc.n} outer_N={odata.N} Q_outer={ocfg.fri.num_query_rounds} "
          f"build_i={build_i:.1f}s inner={inner_s:.1f}s build_o={build_o:.1f}s "
          f"witness={wit_s:.1f}s compile={compile_s:.1f}s "
          f"steady={dt:.2f}s/batch ({done} batches)", file=sys.stderr)
    print(json.dumps({
        "metric": "recursive_ecdsa_outer_proofs_per_sec_per_chip",
        "value": round(value, 3), "unit": "proofs/s",
        # same CPU anchor as the flat bench: the reference stack would pay
        # at least one flat proof per statement plus the (heavier) recursive
        # wrap, so flat-anchor ratio is a conservative lower bound
        "vs_baseline": round(value / RUST_CPU_PROOFS_PER_SEC_EST, 2),
    }))


def main():
    import jax

    from plonky2_ecdsa.utils.device import device_info, gpu_name_and_power

    dev = device_info()
    platform = dev["platform"]
    on_device = platform != "cpu"
    try:
        card = gpu_name_and_power() if platform == "gpu" else "n/a"
    except (OSError, subprocess.SubprocessError):
        card = "nvidia-smi unavailable"
    # 10 steady-state batches: the pipeline's fill/drain edges (first upload,
    # last readback) are not overlapped, so fewer batches skew the mean;
    # every streamed proof is still verified
    reps = int(os.environ.get("BENCH_REPS", "10"))
    small = os.environ.get("BENCH_SMALL") == "1"

    from plonky2_ecdsa.prover.data import build_circuit_data
    from plonky2_ecdsa.prover.prover import make_jit_prover
    from plonky2_ecdsa.prover.verifier import verify

    if small:
        from plonky2_ecdsa.circuit.examples import nonnative_mul_chain_circuit

        B = int(os.environ.get("BENCH_BATCH", "64" if on_device else "4"))
        b = nonnative_mul_chain_circuit()
        circuit = b.build()
        num_muls = 11
        rng = np.random.default_rng(7)
        from plonky2_ecdsa.api import int_to_limbs
        from plonky2_ecdsa.curve import native as cn

        xs = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(B)]
        ys = [int.from_bytes(rng.bytes(40), "little") % cn.SECP256K1.p for _ in range(B)]
        W = circuit.generate_witness({"x": int_to_limbs(xs), "y": int_to_limbs(ys)}, B)
        pis = circuit.public_input_values()
        data = build_circuit_data(circuit)
        run = make_jit_prover(data)
        proof = run(W, pis)  # compile + warmup
        assert verify(data, proof)
        t0 = time.time()
        for _ in range(reps):
            proof = run(W, pis)
            jax.block_until_ready(proof.openings0)
        dt = (time.time() - t0) / reps
        value = B * num_muls / dt
        print(json.dumps({
            "metric": "nonnative_muls_proved_per_sec_per_chip",
            "value": round(value, 2), "unit": "muls/s",
            "vs_baseline": round(value / (RUST_CPU_PROOFS_PER_SEC_EST * 11), 2),
        }))
        return

    if os.environ.get("BENCH_RECURSIVE") == "1":
        return bench_recursive(reps, on_device, platform)

    from plonky2_ecdsa import api
    from plonky2_ecdsa.curve import native as cn

    if on_device and os.environ.get("BENCH_SKIP_PREFLIGHT") != "1":
        # on-device parity preflight (fail fast BEFORE the timed run): every
        # prover stage at production widths vs numpy, exact
        from scripts.device_parity import stage_parity

        t0 = time.time()
        stage_parity(log=lambda m: print(f"# preflight {m}", file=sys.stderr))
        print(f"# preflight parity checks OK ({time.time()-t0:.1f}s)",
              file=sys.stderr)

    curve = cn.P256 if os.environ.get("BENCH_P256") == "1" else cn.SECP256K1
    # B=32: the batch chip_smoke.py checks the production prover at
    B = int(os.environ.get("BENCH_BATCH", "32" if on_device else "1"))
    t0 = time.time()
    system = api.EcdsaProverSystem(curve)
    build_s = time.time() - t0
    t0 = time.time()
    all_stmts = [api.random_statements(curve, B, seed=3 + k)
                 for k in range(reps)]
    stmts_s = time.time() - t0
    t0 = time.time()
    V, pis = system.witness_vals(all_stmts[0])
    wit_s = time.time() - t0
    t0 = time.time()
    data = system.data
    data_s = time.time() - t0
    run = make_jit_prover(data)
    t0 = time.time()
    proof = run.run_vals(V, pis)  # compile + first run
    compile_s = time.time() - t0
    assert system.verify(proof), "bench proof failed verification"

    # steady state: host witness generation for batch k+1 overlaps the
    # device proving batch k (the production serving pipeline shape)
    import threading
    from queue import Queue

    q: Queue = Queue(maxsize=2)

    def producer():
        for stmts in all_stmts:
            q.put(system.witness_vals(stmts))
        q.put(None)

    t0 = time.time()
    th = threading.Thread(target=producer)
    th.start()
    done = 0
    proofs = []
    if os.environ.get("BENCH_PIPE", "thread") == "thread":
        # 3-stage pipeline with a dedicated COLLECTOR thread: the blocking
        # proof readback runs concurrently with the main thread's next
        # dispatch, so readback overlaps device compute.
        hq: Queue = Queue(maxsize=2)
        err: list = []

        def collector():
            try:
                while True:
                    h = hq.get()
                    if h is None:
                        return
                    proofs.append(run.collect(h))
            except Exception as e:  # surface in the main thread
                err.append(e)

        cth = threading.Thread(target=collector)
        cth.start()
        while True:
            item = q.get()
            if item is None:
                break
            hq.put(run.dispatch_vals(*item))
            done += 1
        hq.put(None)
        cth.join()
        th.join()
        if err:
            raise err[0]
        assert len(proofs) == done
    else:  # BENCH_PIPE=2deep: in-thread 2-deep pipeline
        pending = None
        while True:
            item = q.get()
            if item is None:
                break
            # dispatch batch k+1 (async upload+prove) before collecting
            # batch k's proof, so transfer overlaps compute
            handle = run.dispatch_vals(*item)
            if pending is not None:
                proofs.append(run.collect(pending))
                done += 1
            pending = handle
        if pending is not None:
            proofs.append(run.collect(pending))
            done += 1
        th.join()
    dt = (time.time() - t0) / done
    # verify EVERY streamed proof (outside the timed section: host-side
    # verification must not distort the device throughput measurement).
    # NOTE peak host memory is proportional to BENCH_BATCH x BENCH_REPS:
    # every streamed Proof (incl. full FRI query data) is held until the
    # timed loop ends; pop-verify drops each as soon as it is checked.
    i = 0
    while proofs:
        assert system.verify(proofs.pop(0)), \
            f"bench batch {i} proof failed verification"
        i += 1
    value = B / dt
    print(f"# platform={platform} device_kind={dev['kind']} card=[{card}] "
          f"B={B} n={system.n} build={build_s:.1f}s "
          f"witness={wit_s:.1f}s data={data_s:.1f}s compile={compile_s:.1f}s "
          f"steady={dt:.2f}s/batch (pipelined, {done} batches)", file=sys.stderr)
    print(json.dumps({
        "metric": f"{curve.name}_ecdsa_proofs_per_sec_per_chip",
        "value": round(value, 3), "unit": "proofs/s",
        "vs_baseline": round(value / RUST_CPU_PROOFS_PER_SEC_EST, 2),
    }))


if __name__ == "__main__":
    main()
