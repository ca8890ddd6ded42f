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
  * proof: gnark format, blinding from ``prover_seed = SEED``.

Run from the repository root to rewrite the files:

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


def load() -> dict:
    return {name: (FIXTURES / f"{name}.bin").read_bytes() for name in NAMES}


def main() -> None:
    root = Path(__file__).resolve().parents[2]
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    # The test suite's XLA settings (tests/conftest.py): CPU fusion off
    # for the big-integer graphs, and its persistent compile cache.
    os.environ.setdefault("XLA_FLAGS", "--xla_disable_hlo_passes=fusion,cpu-fusion")
    os.environ.pop("NOIRTPU_MIN_DOMAIN", None)
    sys.path.insert(0, str(root))
    import jax

    jax.config.update("jax_compilation_cache_dir", str(root / ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    out = make("noir_backend_using_gnark_tpu")
    FIXTURES.mkdir(exist_ok=True)
    for name in NAMES:
        (FIXTURES / f"{name}.bin").write_bytes(out[name])
    meta = {
        "program": "bench.py run_plonk chain (make_goldens.build_circuit)",
        "rows": ROWS,
        "x": X,
        "alpha": hex(ALPHA),
        "prover_seed": SEED.hex(),
        "srs_size": SRS_SIZE,
        "proof_format": "gnark",
        "sha256": {name: hashlib.sha256(out[name]).hexdigest() for name in NAMES},
    }
    (FIXTURES / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
    print(json.dumps(meta, indent=1))


if __name__ == "__main__":
    main()
