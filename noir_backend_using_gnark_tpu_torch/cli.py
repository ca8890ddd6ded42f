"""noir-tpu-torch CLI: the nargo-verb surface over ACIR program packages.

Counterpart of ``noir_backend_using_gnark_tpu/cli.py`` (the ``noir-tpu``
command), with the same commands, flags, files and messages, plus
``--device``. The reference's integration suite drives a forked
``nargo`` with ``check / compile / execute / prove / verify / test /
gates`` (tests/tests.rs:101-138). There is no Noir compiler here, so a
*program package* is a directory holding the compiled artifact and the
nargo-style TOML files:

    <package>/
      circuit.acir.json   # ACIR (acvm serde JSON, acir/parse.py)
      abi.json            # {param name: witness index or [indices]}
      Prover.toml         # witness inputs by name (nargo format)
      Verifier.toml       # public inputs by name (nargo format)

Artifacts go under <package>/target/: witness.hex (the encoded felt
vector, the reference's wire format), proof.hex, pk.hex and vk.hex, in
the JAX package's byte layouts, so either CLI reads the other's files.

The device work runs on the CUDA card unless ``--device cpu`` is given;
without a card the command exits 1 instead of running on the CPU::

    python -m noir_backend_using_gnark_tpu_torch.cli prove tests/programs/pred_eq --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import tomllib

from .acir import lowering, parse, solver
from .api import Backend
from .config import Config
from .errors import BackendError
from .utils import bigint

R = bigint.FR_MODULUS


def _load_package(pkg: str, backend: Backend | None = None):
    """(circuit, abi) of a package; the parse time goes to
    ``backend.timings["parse"]`` when a backend is given."""
    acir_path = os.path.join(pkg, "circuit.acir.json")
    if not os.path.exists(acir_path):
        raise BackendError(f"no circuit.acir.json in {pkg}")
    t0 = time.perf_counter()
    with open(acir_path) as f:
        circuit = parse.parse_circuit(f.read())
    if backend is not None:
        backend.timings["parse"] = time.perf_counter() - t0
    abi = {}
    abi_path = os.path.join(pkg, "abi.json")
    if os.path.exists(abi_path):
        with open(abi_path) as f:
            abi = json.load(f)
    return circuit, abi


def _parse_value(v) -> int:
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, int):
        return v % R
    if isinstance(v, str):
        return int(v, 0) % R
    raise BackendError(f"cannot interpret TOML value {v!r} as a field element")


def _toml_witness(path: str, abi: dict) -> dict:
    """TOML inputs -> {witness index: value} via the abi name map."""
    if not os.path.exists(path):
        return {}
    with open(path, "rb") as f:
        doc = tomllib.load(f)
    out = {}
    for name, value in doc.items():
        indices = abi.get(name, None)
        if indices is None:
            raise BackendError(f"parameter {name!r} not in abi.json")
        if isinstance(indices, int):
            indices = [indices]
        values = value if isinstance(value, list) else [value]
        if len(values) != len(indices):
            raise BackendError(f"parameter {name!r}: {len(values)} values for {len(indices)} witnesses")
        for idx, v in zip(indices, values):
            out[int(idx)] = _parse_value(v)
    return out


def _target(pkg: str) -> str:
    d = os.path.join(pkg, "target")
    os.makedirs(d, exist_ok=True)
    return d


def _write(path: str, text: str) -> None:
    with open(path, "w") as f:
        f.write(text)


def _read_hex(path: str) -> bytes:
    with open(path) as f:
        return bytes.fromhex(f.read())


def _solve_values(pkg: str, backend: Backend):
    circuit, abi = _load_package(pkg, backend)
    initial = _toml_witness(os.path.join(pkg, "Prover.toml"), abi)
    return circuit, solver.dense_values(circuit, backend.solve(circuit, initial))


def cmd_check(pkg: str, backend: Backend) -> int:
    circuit, abi = _load_package(pkg, backend)
    _toml_witness(os.path.join(pkg, "Prover.toml"), abi)
    print(f"[check] ok: {len(circuit.opcodes)} opcodes, {len(circuit.public_inputs)} public inputs")
    return 0


def cmd_compile(pkg: str, backend: Backend) -> int:
    # No Noir compiler in this distribution: validates and stages the ACIR.
    circuit, _ = _load_package(pkg, backend)
    out = os.path.join(_target(pkg), "circuit.acir.json")
    _write(out, parse.circuit_to_json(circuit))
    print(f"[compile] staged {out}")
    return 0


def cmd_gates(pkg: str, backend: Backend) -> int:
    circuit, _ = _load_package(pkg, backend)
    print(f"[gates] exact circuit size: {backend.get_exact_circuit_size(circuit)}")
    return 0


def cmd_execute(pkg: str, backend: Backend) -> int:
    _, values = _solve_values(pkg, backend)
    out = os.path.join(_target(pkg), "witness.hex")
    _write(out, bigint.encode_felts(values))
    print(f"[execute] solved {len(values)} witnesses -> {out}")
    return 0


def cmd_prove(pkg: str, backend: Backend) -> int:
    """Reuses target/pk.hex and vk.hex when both exist (either package
    may have written them), else preprocesses and writes them."""
    circuit, values = _solve_values(pkg, backend)
    target = _target(pkg)
    pk_path = os.path.join(target, "pk.hex")
    vk_path = os.path.join(target, "vk.hex")
    if os.path.exists(pk_path) and os.path.exists(vk_path):
        pk = _read_hex(pk_path)
    else:
        pk, vk = backend.preprocess(circuit)
        _write(pk_path, pk.hex())
        _write(vk_path, vk.hex())
    proof = backend.prove_with_pk(circuit, values, pk)
    out = os.path.join(target, "proof.hex")
    _write(out, proof.hex())
    print(f"[prove] proof -> {out}")
    return 0


def cmd_verify(pkg: str, backend: Backend) -> int:
    circuit, abi = _load_package(pkg, backend)
    target = _target(pkg)
    try:
        proof = _read_hex(os.path.join(target, "proof.hex"))
        vk = _read_hex(os.path.join(target, "vk.hex"))
    except ValueError:
        # Corrupt hex is a verification failure, not a crash (the
        # reference maps malformed artifacts to DeserializeProof errors,
        # errors.rs:5-38).
        print("[verify] FAILED (corrupt proof/vk hex)")
        return 1
    verifier_inputs = _toml_witness(os.path.join(pkg, "Verifier.toml"), abi)
    pc = lowering.lower_to_plonk(circuit)
    publics = [verifier_inputs.get(i, 0) for i in pc.public_witness_indices]
    ok = backend.verify_with_vk(proof, publics, circuit, vk)
    print(f"[verify] {'ok' if ok else 'FAILED'}")
    return 0 if ok else 1


def cmd_test(pkg: str, backend: Backend) -> int:
    """Smoke test: execute -> prove -> verify round trip."""
    rc = cmd_execute(pkg, backend)
    rc = rc or cmd_prove(pkg, backend)
    rc = rc or cmd_verify(pkg, backend)
    print(f"[test] {'ok' if rc == 0 else 'FAILED'}")
    return rc


COMMANDS = {
    "check": cmd_check,
    "compile": cmd_compile,
    "execute": cmd_execute,
    "prove": cmd_prove,
    "verify": cmd_verify,
    "gates": cmd_gates,
    "test": cmd_test,
}


def _backend(args) -> Backend:
    """The configured Backend; raises BackendError for what this port
    does not run yet, rather than ignoring the flag."""
    if args.scheme == "groth16":
        raise BackendError("--scheme groth16 is not ported yet (ROADMAP queue 1, item 10)")
    if args.mesh > 1:
        raise BackendError(f"--mesh {args.mesh} is not ported yet (ROADMAP queue 1, item 11)")
    cfg = Config()
    if args.srs_path:
        cfg.srs_path = args.srs_path
    if args.srs_size:
        cfg.srs_size = args.srs_size
    if args.seed:
        cfg.prover_seed = bytes.fromhex(args.seed)
    return Backend(cfg, device=args.device)


def main(argv=None, timings: dict | None = None) -> int:
    """Run one command; returns its exit code. ``timings``, when given,
    receives the wall seconds of the command's phases (parse, solve,
    preprocess, prove, verify and the prover's rounds)."""
    ap = argparse.ArgumentParser(
        prog="noir-tpu-torch",
        description="Noir proving backend on PyTorch/CUDA (nargo-verb compatible)",
    )
    ap.add_argument("command", choices=sorted(COMMANDS))
    ap.add_argument("package", nargs="?", default=".", help="program package dir")
    ap.add_argument("--srs-path", default=None)
    ap.add_argument("--srs-size", type=int, default=None)
    ap.add_argument("--seed", default=None, help="hex seed for deterministic proofs")
    ap.add_argument("--scheme", choices=("plonk", "groth16"), default="plonk",
                    help="proof system (reference cargo features plonk/groth16; groth16 is not ported yet)")
    ap.add_argument("--mesh", type=int, default=1, metavar="N",
                    help="shard the prover over an N-device mesh (not ported yet: N must be 1)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the prover (default cuda; 'cpu' runs the kernels' plain versions)")
    args = ap.parse_args(argv)
    try:
        backend = _backend(args)
        rc = COMMANDS[args.command](args.package, backend)
    except BackendError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if timings is not None:
        timings.update(backend.timings)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
