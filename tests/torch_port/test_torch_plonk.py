"""The port's whole slice, Backend preprocess -> prove -> verify, against
the JAX package: byte-equal SRS, pk, vk and gnark-format proof for the
fixture of make_goldens.py, each package's verifier accepting the
other's proof, and the two routes that carry state across (the JAX
package's bytes, and its arrays through convert.py)."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import make_goldens as MG
from noir_backend_using_gnark_tpu_torch import artifacts, convert
from noir_backend_using_gnark_tpu_torch.acir import builder, lowering, solver
from noir_backend_using_gnark_tpu_torch.api import Backend
from noir_backend_using_gnark_tpu_torch.config import Config
from noir_backend_using_gnark_tpu_torch.errors import BackendError
from noir_backend_using_gnark_tpu_torch.plonk import prove as port_prove

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[2]
PORT = "noir_backend_using_gnark_tpu_torch"


@pytest.fixture(scope="module")
def goldens():
    return MG.load()


@pytest.fixture(scope="module")
def port_out():
    return MG.make(PORT, device="cpu")


@pytest.fixture(scope="module")
def fixture_circuit():
    circuit = MG.build_circuit(builder)
    values = solver.dense_values(circuit, solver.solve(circuit, {1: MG.X}))
    return circuit, values


@pytest.mark.parametrize("name", MG.NAMES)
def test_port_bytes_equal_jax_goldens(port_out, goldens, name):
    assert port_out[name] == goldens[name]


def test_jax_verifier_accepts_port_proof(port_out):
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts
    from noir_backend_using_gnark_tpu.plonk import gnark_protocol as jax_gp

    vk = jax_artifacts.vk_from_bytes(port_out["vk"])
    proof = jax_artifacts.proof_from_bytes(port_out["proof"])
    assert jax_gp.verify(vk, proof, [MG.X])
    assert not jax_gp.verify(vk, proof, [MG.X + 1])


def test_port_verifier_accepts_jax_proof(goldens, fixture_circuit):
    circuit, values = fixture_circuit
    backend = Backend(Config(), device="cpu")
    assert backend.verify_with_vk(goldens["proof"], values, circuit, goldens["vk"])
    bad = bytearray(goldens["proof"])
    bad[-1] ^= 1
    assert not backend.verify_with_vk(bytes(bad), values, circuit, goldens["vk"])
    assert not backend.verify_with_vk(goldens["proof"], [MG.X + 1], circuit, goldens["vk"])


def test_port_reads_jax_bytes(goldens):
    """The bytes route: the port's codecs read the JAX package's SRS and
    pk blobs and write them back unchanged."""
    srs = artifacts.srs_from_bytes(goldens["srs"])
    assert srs.size == MG.SRS_SIZE
    assert artifacts.srs_to_bytes(srs) == goldens["srs"]
    pk = artifacts.pk_from_bytes(goldens["pk"], srs=srs)
    assert pk.srs_fingerprint == artifacts.srs_digest(srs)
    assert artifacts.pk_to_bytes(pk) == goldens["pk"]
    assert artifacts.vk_to_bytes(pk.vk) == goldens["vk"]


def test_port_proves_from_converted_jax_state(goldens, fixture_circuit):
    """The array route: the JAX package's SRS and pk objects, converted
    by convert.py, give the port the golden proof."""
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts

    jax_srs = jax_artifacts.srs_from_bytes(goldens["srs"])
    srs = convert.srs_from_jax(jax_srs)
    mine = artifacts.srs_from_bytes(goldens["srs"])
    for a, b in zip(srs.g1_powers, mine.g1_powers):
        assert torch.equal(a, b)
    for a, b in zip(convert.affine_to_jax(mine.g1_powers), jax_srs.g1_powers):
        assert np.array_equal(a, np.asarray(b))
    pk = convert.pk_from_jax(jax_artifacts.pk_from_bytes(goldens["pk"]), srs=srs)
    circuit, values = fixture_circuit
    assignment = lowering.build_assignment(lowering.lower_to_plonk(circuit), values)
    proof = port_prove.prove(pk, assignment, MG.SEED)
    assert artifacts.proof_to_bytes(proof) == goldens["proof"]


def test_kzg_batch_open_verifies(goldens):
    """batch_open_at on the golden SRS: the host pairing check accepts
    the opening and rejects a wrong value."""
    from noir_backend_using_gnark_tpu_torch.kzg import kzg
    from noir_backend_using_gnark_tpu_torch.ops import field as F

    srs = artifacts.srs_from_bytes(goldens["srs"])
    polys = [F.from_ints([(7 * i + j) ** 3 for j in range(m)], F.FR) for i, m in enumerate((9, 16, 5))]
    commitments = kzg.commit_many_ints(srs, polys)
    z, gamma = 1234567, 89101112
    proof, values = kzg.batch_open_at(srs, polys, z, gamma)
    r = F.FR.modulus
    for p, v in zip(polys, values):
        assert v == sum(c * pow(z, i, r) for i, c in enumerate(F.to_ints(p, F.FR))) % r
    assert kzg.verify_batch_open(commitments, z, values, proof, gamma, srs.g2_gen, srs.g2_alpha)
    values[1] = (values[1] + 1) % r
    assert not kzg.verify_batch_open(commitments, z, values, proof, gamma, srs.g2_gen, srs.g2_alpha)


@pytest.mark.slow
def test_goldens_match_live_jax(goldens, monkeypatch):
    """Recompute the fixture with the JAX package (cold CPU compiles
    take minutes) and hold the stored files to it."""
    monkeypatch.delenv("NOIRTPU_MIN_DOMAIN", raising=False)
    live = MG.make("noir_backend_using_gnark_tpu")
    for name in MG.NAMES:
        assert live[name] == goldens[name], name


def test_backend_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: Backend() resolves to it")
    with pytest.raises(BackendError, match="device='cpu'"):
        Backend()


@pytest.mark.parametrize("field,value", [
    ("scheme", "groth16"), ("proof_format", "expanded"), ("proof_format", "linearized"),
])
def test_config_refuses_what_is_not_ported(field, value):
    """Groth16 is not ported and is refused; the expanded proof layout is
    ported and accepted; an unknown layout is refused."""
    if value != "expanded":
        with pytest.raises(ValueError, match="unsupported|unknown"):
            Config(**{field: value}).validate()
    else:
        assert getattr(Config(**{field: value}).validate(), field) == value


def test_legacy_pk_loads_and_proves(goldens, fixture_circuit, tmp_path):
    """An NTPUPK_1 key (the v2 blob without its 8-byte SRS fingerprint,
    as older JAX builds wrote it) loads in both packages to the same
    key, and the port proves with it to the golden proof bytes."""
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts

    v2 = goldens["pk"]
    assert v2[:8] == b"NTPUPK_2"
    legacy = b"NTPUPK_1" + v2[16:]
    mine = artifacts.pk_from_bytes(legacy)
    theirs = jax_artifacts.pk_from_bytes(legacy)
    assert mine.srs_fingerprint is None and theirs.srs_fingerprint is None
    assert (mine.n, mine.nb_public, mine.nb_vars) == (theirs.n, theirs.nb_public, theirs.nb_vars)
    for w in ("wire_a", "wire_b", "wire_c"):
        assert np.array_equal(getattr(mine, w), getattr(theirs, w))
    for name in artifacts._PK_POLYS:
        assert np.array_equal(convert.limbs32_to_16(getattr(mine, name)), np.asarray(getattr(theirs, name)))
    assert artifacts.vk_to_bytes(mine.vk) == goldens["vk"]

    path = str(tmp_path / "srs.hex")
    artifacts.save_srs(artifacts.srs_from_bytes(goldens["srs"]), path)
    backend = Backend(Config(srs_path=path, srs_size=MG.SRS_SIZE, prover_seed=MG.SEED), device="cpu")
    circuit, values = fixture_circuit
    assert backend.prove_with_pk(circuit, values, legacy) == goldens["proof"]


def test_bls12_381_proving_rejected(fixture_circuit):
    """Config(curve="bls12_381") constructs, as in the JAX package, and
    every proving operation raises BackendError (tests/test_plonk.py's
    test of the same name)."""
    circuit, values = fixture_circuit
    b = Backend(Config(curve="bls12_381"), device="cpu")
    with pytest.raises(BackendError, match="bn254-only"):
        b.preprocess(circuit)
    with pytest.raises(BackendError, match="bn254-only"):
        b.prove_with_pk(circuit, values, b"")
    with pytest.raises(BackendError, match="bn254-only"):
        b.verify_with_vk(b"", values, circuit, b"")


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py or k4_compare.py,
    imports jax or the JAX package (a plain text search, so no spelling
    slips through)."""
    needles = (re.compile(r"\bimport jax\b|\bfrom jax\b"),
               re.compile(r"noir_backend_using_gnark_tpu\.|from noir_backend_using_gnark_tpu "))
    files = sorted((ROOT / PORT).rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "k4_compare.py"]
    assert len(files) > 20
    hits = [
        f"{path.relative_to(ROOT)}:{i}: {line.strip()}"
        for path in files
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if any(n.search(line) for n in needles)
    ]
    assert not hits, hits
