"""Command-line surface: build / sign / prove / verify / gates.

The reference ships as a library crate only (no CLI, SURVEY.md §1); serving a
batched accelerator prover wants a process entry point, so this adds one around the
library API (api.EcdsaProverSystem + prover.serialize):

    python -m plonky2_ecdsa sign   --curve secp256k1 --count 4 --out stmts.json
    python -m plonky2_ecdsa build  --curve secp256k1 --data circuit.npz
    python -m plonky2_ecdsa prove  --curve secp256k1 --statements stmts.json \
        --proof proof.pkl [--data circuit.npz] [--jit]
    python -m plonky2_ecdsa verify --curve secp256k1 --proof proof.pkl \
        [--statements stmts.json] [--data circuit.npz]
    python -m plonky2_ecdsa gates  --curve secp256k1

Statements are JSON: [{"msg": hex, "r": hex, "s": hex, "pk_x": hex,
"pk_y": hex}, ...] — the statement tuple the proof binds as public inputs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _curve(name: str):
    from .curve import native as cn

    try:
        return {"secp256k1": cn.SECP256K1, "p256": cn.P256}[name]
    except KeyError:
        raise SystemExit(f"unknown curve {name!r} (secp256k1 | p256)")


def _config(name: str):
    from .circuit.config import CircuitConfig

    return {"standard": CircuitConfig.standard_ecc_config,
            "wide": CircuitConfig.wide_ecc_config}[name]()


def _load_statements(path: str, curve):
    from .api import EcdsaStatement
    from .curve import native as cn

    with open(path) as f:
        rows = json.load(f)
    return [EcdsaStatement(
        msg=int(r["msg"], 16), r=int(r["r"], 16), s=int(r["s"], 16),
        pk=cn.Point(curve, int(r["pk_x"], 16), int(r["pk_y"], 16))) for r in rows]


def _dump_statements(stmts, path: str):
    rows = [{"msg": f"{st.msg:x}", "r": f"{st.r:x}", "s": f"{st.s:x}",
             "pk_x": f"{st.pk.x:x}", "pk_y": f"{st.pk.y:x}"} for st in stmts]
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def _system(args):
    from . import api

    t0 = time.time()
    system = api.EcdsaProverSystem(_curve(args.curve), _config(args.config))
    print(f"[cli] built {args.curve} circuit: n={system.n} "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)
    return system


def cmd_sign(args):
    from . import api

    stmts = api.random_statements(_curve(args.curve), args.count, seed=args.seed)
    _dump_statements(stmts, args.out)
    print(f"[cli] wrote {args.count} signed statements -> {args.out}", file=sys.stderr)


def cmd_build(args):
    from .prover.serialize import save_circuit_data

    system = _system(args)
    save_circuit_data(system.data, args.data)
    print(f"[cli] circuit data -> {args.data}", file=sys.stderr)


def cmd_gates(args):
    system = _system(args)
    print(json.dumps({"curve": args.curve, "config": args.config,
                      "rows": system.num_rows, "n": system.n,
                      "gate_rows": system.gate_counts()}, indent=1))


def cmd_prove(args):
    from .prover.serialize import save_proof

    system = _system(args)  # template needed for witness generation
    if args.statements:
        stmts = _load_statements(args.statements, system.curve)
    else:
        from . import api

        stmts = api.random_statements(system.curve, args.batch, seed=args.seed)
        print(f"[cli] no --statements given; proving {args.batch} random "
              f"signed statements (seed {args.seed})", file=sys.stderr)
    t0 = time.time()
    proof = system.prove(stmts, jit=args.jit)
    dt = time.time() - t0
    assert system.verify(proof), "freshly produced proof failed verification"
    save_proof(proof, args.proof)
    print(f"[cli] proved {len(stmts)} statements in {dt:.2f}s "
          f"({len(stmts)/dt:.2f} proofs/s incl. witness+compile) -> {args.proof}",
          file=sys.stderr)


def cmd_verify(args):
    from .prover.serialize import load_circuit_data, load_proof
    from .prover.verifier import verify as verify_proof

    if args.data:
        data = load_circuit_data(args.data)
    else:
        data = _system(args).data
    proof = load_proof(args.proof)
    ok = verify_proof(data, proof)
    if ok and args.statements:
        import numpy as np

        from .api import int_to_limbs

        stmts = _load_statements(args.statements, _curve(args.curve))
        for i, st in enumerate(stmts):
            want = np.concatenate([
                int_to_limbs([st.pk.x])[0], int_to_limbs([st.pk.y])[0],
                int_to_limbs([st.msg])[0], int_to_limbs([st.r])[0],
                int_to_limbs([st.s])[0]])
            if not np.array_equal(proof.pis[i], want):
                print(f"[cli] lane {i}: public inputs do NOT bind the statement",
                      file=sys.stderr)
                ok = False
    print(json.dumps({"verified": bool(ok)}))
    raise SystemExit(0 if ok else 1)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="plonky2_ecdsa", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p):
        p.add_argument("--curve", default="secp256k1", choices=["secp256k1", "p256"])
        p.add_argument("--config", default="standard", choices=["standard", "wide"])

    p = sub.add_parser("sign", help="generate random signed statements (native signer)")
    common(p)
    p.add_argument("--count", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", required=True)
    p.set_defaults(fn=cmd_sign)

    p = sub.add_parser("build", help="build + persist circuit data (.npz)")
    common(p)
    p.add_argument("--data", required=True)
    p.set_defaults(fn=cmd_build)

    p = sub.add_parser("gates", help="print circuit size / per-gate row counts")
    common(p)
    p.set_defaults(fn=cmd_gates)

    p = sub.add_parser("prove", help="prove a statement batch -> proof file")
    common(p)
    p.add_argument("--statements", help="JSON from `sign` (default: random batch)")
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--proof", required=True)
    p.add_argument("--jit", action="store_true", help="use the jitted device pipeline")
    p.set_defaults(fn=cmd_prove)

    p = sub.add_parser("verify", help="verify a proof file (+ optional statement binding)")
    common(p)
    p.add_argument("--proof", required=True)
    p.add_argument("--data", help="circuit data .npz (skips rebuild)")
    p.add_argument("--statements", help="check lanes bind these statements")
    p.set_defaults(fn=cmd_verify)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
