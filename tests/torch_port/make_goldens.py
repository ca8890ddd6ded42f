"""Golden artifacts for the port's byte-equality tests, written by the
JAX package.

Fixture (recorded in ``fixtures/meta.json`` as well):
  * program: the multiply/add chain of ``bench.py`` (``run_plonk``) at
    ``ROWS = 30``: one public witness x, then ROWS - 2 gates
    ``acc = acc * x`` (every third step) or ``acc = acc + x``; solved
    with ``x = X = 3``;
  * SRS: ``kzg.generate_srs(SRS_SIZE = 64, ALPHA)``, saved to the
    backend's ``srs_path``, so ``Backend(Config(srs_size=64, ...))``
    loads it instead of drawing a random alpha;
  * proof: gnark format, blinding from ``prover_seed = SEED``; and the
    same pk proved in the expanded layout (``proof_expanded``);
  * the SRS and the vk in gnark-crypto's layouts (``srs_gnark``,
    ``vk_gnark``, formats/gnark.py).

Program package (``fixtures/pkg_priv_x_neq_pub_y/``): the CLI flow
``execute``, ``prove``, ``verify`` on ``tests/programs/priv_x_neq_pub_y``
with an SRS of ``PKG_SRS_SIZE`` points (the smallest its 8-row domain
admits) generated from ``PKG_ALPHA``, and ``--seed PKG_SEED``; the
files are the package's ``target/witness.hex``, ``pk.hex``, ``vk.hex``
and ``proof.hex``.

Run from the repository root to rewrite the files (``fixture`` or
``package`` as an argument rewrites one part only):

    JAX_PLATFORMS=cpu python tests/torch_port/make_goldens.py

The same functions build the fixture with the port (``make(port)``),
which is how the tests compare the two packages.
"""

from __future__ import annotations

import hashlib
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

ROWS = 30
X = 3
ALPHA = 0x2A5C6F1E9B3D7A41C0FFEE1234567890ABCDEF0123456789DEADBEEF42424242
SEED = bytes(range(1, 33))
SRS_SIZE = 64
FIXTURES = Path(__file__).resolve().parent / "fixtures"
NAMES = ("srs", "pk", "vk", "proof")
LAYOUT_NAMES = ("proof_expanded", "srs_gnark", "vk_gnark")
PKG = "priv_x_neq_pub_y"
PKG_ALPHA = 0x1B2E3D4C5F60718293A4B5C6D7E8F90112233445566778899AABBCCDDEEFF00
PKG_SEED = "ab" * 32
PKG_SRS_SIZE = 16
PKG_FILES = ("witness", "pk", "vk", "proof")
PKG_FIXTURES = FIXTURES / f"pkg_{PKG}"
PROGRAMS = Path(__file__).resolve().parents[1] / "programs"


def build_circuit(builder, rows: int = ROWS):
    """bench.py's chain: x public, rows - 2 gates alternating mul/add."""
    cb = builder.CircuitBuilder()
    x = cb.witness(public=True)
    acc = x
    for i in range(rows - 2):
        acc = cb.mul(acc, x) if i % 3 == 0 else cb.add(acc, x)
    return cb.build()


def make(pkg: str, device: str | None = None) -> dict:
    """{srs, pk, vk, proof} bytes of the fixture, computed by package
    ``pkg`` (the JAX package, or the port with ``device``)."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    kzg, artifacts = mod("kzg.kzg"), mod("artifacts")
    solver, api, config = mod("acir.solver"), mod("api"), mod("config")
    circuit = build_circuit(mod("acir.builder"))
    values = solver.dense_values(circuit, solver.solve(circuit, {1: X}))
    dev = {} if device is None else {"device": device}
    srs = kzg.generate_srs(SRS_SIZE, ALPHA, **dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "srs.hex")
        artifacts.save_srs(srs, path)
        cfg = config.Config(srs_path=path, srs_size=SRS_SIZE, prover_seed=SEED)
        backend = api.Backend(cfg, **dev)
        pk, vk = backend.preprocess(circuit)
        proof = backend.prove_with_pk(circuit, values, pk)
        if not backend.verify_with_vk(proof, values, circuit, vk):
            raise RuntimeError(f"{pkg}: the fixture proof does not verify")
    return {"srs": artifacts.srs_to_bytes(srs), "pk": pk, "vk": vk, "proof": proof}


def make_layouts(pkg: str, goldens: dict, device: str | None = None) -> dict:
    """{proof_expanded, srs_gnark, vk_gnark} of the fixture, computed by
    package ``pkg`` from the stored SRS and keys: the stored pk proved
    in the expanded layout, and the SRS and vk in gnark's layouts."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    artifacts, gnark, api, config = mod("artifacts"), mod("formats.gnark"), mod("api"), mod("config")
    circuit = build_circuit(mod("acir.builder"))
    solver = mod("acir.solver")
    values = solver.dense_values(circuit, solver.solve(circuit, {1: X}))
    dev = {} if device is None else {"device": device}
    srs = artifacts.srs_from_bytes(goldens["srs"], **dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "srs.hex")
        artifacts.save_srs(srs, path)
        cfg = config.Config(srs_path=path, srs_size=SRS_SIZE, prover_seed=SEED, proof_format="expanded")
        backend = api.Backend(cfg, **dev)
        proof = backend.prove_with_pk(circuit, values, goldens["pk"])
        if not backend.verify_with_vk(proof, values, circuit, goldens["vk"]):
            raise RuntimeError(f"{pkg}: the expanded fixture proof does not verify")
    return {
        "proof_expanded": proof,
        "srs_gnark": gnark.srs_to_gnark_bytes(srs),
        "vk_gnark": gnark.vk_to_gnark_bytes(artifacts.vk_from_bytes(goldens["vk"])),
    }


def package_args(srs_path: str) -> list:
    """The CLI flags of the package fixture."""
    return ["--srs-path", srs_path, "--srs-size", str(PKG_SRS_SIZE), "--seed", PKG_SEED]


def make_package(pkg: str, workdir: str, device: str | None = None) -> dict:
    """The package fixture's target files ({witness, pk, vk, proof} hex
    text) from the CLI of package ``pkg`` (the port's with ``device``),
    run in ``workdir``."""
    import shutil

    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    kzg, artifacts, cli = mod("kzg.kzg"), mod("artifacts"), mod("cli")
    dev, flags = ({}, []) if device is None else ({"device": device}, ["--device", device])
    srs_path = os.path.join(workdir, "srs.hex")
    artifacts.save_srs(kzg.generate_srs(PKG_SRS_SIZE, PKG_ALPHA, **dev), srs_path)
    target = os.path.join(workdir, PKG)
    shutil.copytree(PROGRAMS / PKG, target)
    for command in ("execute", "prove", "verify"):
        rc = cli.main([command, target, *package_args(srs_path), *flags])
        if rc != 0:
            raise RuntimeError(f"{pkg}: cli {command} exited {rc}")
    return {name: Path(target, "target", f"{name}.hex").read_text() for name in PKG_FILES}


def load() -> dict:
    out = {name: (FIXTURES / f"{name}.bin").read_bytes() for name in NAMES + LAYOUT_NAMES}
    out.update({f"pkg_{name}": (PKG_FIXTURES / f"{name}.hex").read_text() for name in PKG_FILES})
    return out


def _setup_jax(root: Path) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # The test suite's XLA settings (tests/conftest.py): CPU fusion off
    # for the big-integer graphs, and its persistent compile cache.
    os.environ.setdefault("XLA_FLAGS", "--xla_disable_hlo_passes=fusion,cpu-fusion")
    os.environ.pop("NOIRTPU_MIN_DOMAIN", None)
    os.environ.setdefault("NOIRTPU_JAX_CACHE", str(root / ".jax_cache"))  # the JAX CLI's cache
    sys.path.insert(0, str(root))
    import jax

    jax.config.update("jax_compilation_cache_dir", str(root / ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)


def _write_part(part: str) -> None:
    """Write the files of one part ("fixture" or "package")."""
    if part == "fixture":
        out = make("noir_backend_using_gnark_tpu")
        out.update(make_layouts("noir_backend_using_gnark_tpu", out))
        FIXTURES.mkdir(exist_ok=True)
        for name in NAMES + LAYOUT_NAMES:
            (FIXTURES / f"{name}.bin").write_bytes(out[name])
    elif part == "package":
        with tempfile.TemporaryDirectory() as tmp:
            files = make_package("noir_backend_using_gnark_tpu", tmp)
        PKG_FIXTURES.mkdir(exist_ok=True)
        for name, text in files.items():
            (PKG_FIXTURES / f"{name}.hex").write_text(text)
    else:
        raise SystemExit(f"unknown part {part!r}: fixture or package")


def main(argv: list) -> None:
    """With no argument, each part runs in a process of its own: one JAX
    process that compiles the kernels of both domains exceeds the host's
    limit on memory maps (vm.max_map_count) and dies in LLVM."""
    import subprocess

    root = Path(__file__).resolve().parents[2]
    if argv:
        _setup_jax(root)
        _write_part(argv[0])
        return
    for part in ("fixture", "package"):
        subprocess.run([sys.executable, __file__, part], check=True)
    write_meta()


def write_meta() -> None:
    """fixtures/meta.json: the parameters and the sha256 of every file."""
    out = load()
    meta = {
        "program": "bench.py run_plonk chain (make_goldens.build_circuit)",
        "rows": ROWS,
        "x": X,
        "alpha": hex(ALPHA),
        "prover_seed": SEED.hex(),
        "srs_size": SRS_SIZE,
        "proof_format": "gnark",
        "sha256": {name: hashlib.sha256(out[name]).hexdigest() for name in NAMES + LAYOUT_NAMES},
        "package": {
            "program": f"tests/programs/{PKG}",
            "alpha": hex(PKG_ALPHA),
            "seed": PKG_SEED,
            "srs_size": PKG_SRS_SIZE,
            "sha256": {name: hashlib.sha256(out[f"pkg_{name}"].encode()).hexdigest() for name in PKG_FILES},
        },
    }
    (FIXTURES / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(json.dumps(meta, indent=1))


if __name__ == "__main__":
    main(sys.argv[1:])
