"""The expanded proof layout (15 openings, NTPUPRF1 container) against the
JAX package: the port's expanded proof of the make_goldens.py fixture is
byte-equal to the JAX-written golden, each package's verifier accepts
the other's proof, a flipped byte is rejected, and the transcript and
container codecs agree. Every comparison is exact."""

import pytest
import torch

import make_goldens as MG
from noir_backend_using_gnark_tpu_torch import artifacts
from noir_backend_using_gnark_tpu_torch.acir import builder, solver
from noir_backend_using_gnark_tpu_torch.api import Backend
from noir_backend_using_gnark_tpu_torch.config import Config
from noir_backend_using_gnark_tpu_torch.formats.gnark import GnarkProof
from noir_backend_using_gnark_tpu_torch.plonk import keys, transcript
from noir_backend_using_gnark_tpu_torch.plonk import verify as port_verify

torch.set_num_threads(1)

PORT = "noir_backend_using_gnark_tpu_torch"
#: Byte offsets of a flip: a commitment, an evaluation, z(zeta*omega),
#: the last opening proof.
_EVALS = 8 + 7 * 32 + 4
FLIPS = (10, _EVALS + 3 * 32 + 31, _EVALS + 15 * 32 + 31, -1)


@pytest.fixture(scope="module")
def goldens():
    return MG.load()


@pytest.fixture(scope="module")
def port_layouts(goldens):
    return MG.make_layouts(PORT, goldens, device="cpu")


@pytest.fixture(scope="module")
def fixture_circuit():
    circuit = MG.build_circuit(builder)
    values = solver.dense_values(circuit, solver.solve(circuit, {1: MG.X}))
    return circuit, values


def test_port_expanded_proof_equals_jax_golden(port_layouts, goldens):
    assert port_layouts["proof_expanded"] == goldens["proof_expanded"]


def test_jax_verifier_accepts_port_expanded_proof(port_layouts, goldens):
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts
    from noir_backend_using_gnark_tpu.plonk import verify as jax_verify

    vk = jax_artifacts.vk_from_bytes(goldens["vk"])
    proof = jax_artifacts.proof_from_bytes(port_layouts["proof_expanded"])
    assert jax_verify.verify(vk, proof, [MG.X])
    assert not jax_verify.verify(vk, proof, [MG.X + 1])


def test_port_verifier_accepts_jax_expanded_proof(goldens, fixture_circuit):
    circuit, values = fixture_circuit
    backend = Backend(Config(), device="cpu")  # the layout is read from the bytes
    assert backend.verify_with_vk(goldens["proof_expanded"], values, circuit, goldens["vk"])
    assert not backend.verify_with_vk(goldens["proof_expanded"], [MG.X + 1], circuit, goldens["vk"])


@pytest.mark.parametrize("offset", FLIPS)
def test_flipped_byte_is_rejected_by_both(goldens, fixture_circuit, offset):
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts
    from noir_backend_using_gnark_tpu.plonk import verify as jax_verify

    circuit, values = fixture_circuit
    bad = bytearray(goldens["proof_expanded"])
    bad[offset] ^= 0x01
    bad = bytes(bad)
    assert not Backend(device="cpu").verify_with_vk(bad, values, circuit, goldens["vk"])
    vk = jax_artifacts.vk_from_bytes(goldens["vk"])
    try:
        accepted = jax_verify.verify(vk, jax_artifacts.proof_from_bytes(bad), [MG.X])
    except Exception:  # noqa: BLE001 - a blob the JAX codec refuses is a rejection too
        accepted = False
    assert not accepted


def test_expanded_container_matches_jax(goldens):
    """proof_from_bytes -> proof_to_bytes round trip, field for field
    equal to the JAX package's decode; the gnark blob still decodes as
    a GnarkProof."""
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts

    proof = artifacts.proof_from_bytes(goldens["proof_expanded"])
    assert isinstance(proof, keys.Proof)
    assert len(proof.evals) == len(keys.ZETA_OPENING_LABELS) == 15
    assert artifacts.proof_to_bytes(proof) == goldens["proof_expanded"]
    theirs = jax_artifacts.proof_from_bytes(goldens["proof_expanded"])
    for name in ("a", "b", "c", "z", "t0", "t1", "t2", "evals", "z_omega", "w_zeta", "w_zeta_omega"):
        assert getattr(proof, name) == getattr(theirs, name), name
    assert isinstance(artifacts.proof_from_bytes(goldens["proof"]), GnarkProof)


def test_expanded_container_errors(goldens):
    from noir_backend_using_gnark_tpu_torch.errors import DeserializeProofError, SerializeProofError

    with pytest.raises(DeserializeProofError):
        artifacts.proof_from_bytes(goldens["proof_expanded"][:100])
    bad = bytearray(goldens["proof_expanded"])
    bad[8] = (bad[8] & 0x3F)  # the uncompressed flag on the first commitment
    with pytest.raises(DeserializeProofError):
        artifacts.proof_from_bytes(bytes(bad))
    with pytest.raises(SerializeProofError):
        artifacts.proof_to_bytes(object())


def test_verify_dispatches_on_the_layout(goldens):
    vk = artifacts.vk_from_bytes(goldens["vk"])
    for name in ("proof", "proof_expanded"):
        assert port_verify.verify(vk, artifacts.proof_from_bytes(goldens[name]), [MG.X]), name


def test_transcript_matches_jax(goldens):
    """The expanded transcript's challenges, with points (affine and
    infinity) and felts absorbed, equal the JAX package's."""
    from noir_backend_using_gnark_tpu.plonk import transcript as jax_transcript

    vk = artifacts.vk_from_bytes(goldens["vk"])
    proof = artifacts.proof_from_bytes(goldens["proof_expanded"])
    mine = transcript.expanded_transcript(vk, [MG.X])
    theirs = jax_transcript.Transcript("noirtpu-plonk-v2")
    theirs.absorb(b"n", vk.n.to_bytes(8, "big"))
    for label, pt in zip((b"vk_ql", b"vk_qr", b"vk_qo", b"vk_qm", b"vk_qc", b"vk_s1", b"vk_s2", b"vk_s3"),
                         vk.commitment_list()):
        theirs.absorb_point(label, pt)
    theirs.absorb_felt(b"public", MG.X)
    for ts in (mine, theirs):
        ts.absorb_point(b"a", proof.a)
        ts.absorb_point(b"inf", None)
        ts.absorb_felt(b"v", proof.z_omega)
    assert mine.challenge(b"beta") == theirs.challenge(b"beta")
    assert mine.challenge(b"gamma") == theirs.challenge(b"gamma")


def test_expanded_prove_draws_the_gnark_blinding(port_layouts, goldens):
    """Both layouts draw the same nine blinding values in the same order,
    so their round-1 and round-2 commitments agree."""
    gnark = artifacts.proof_from_bytes(goldens["proof"])
    expanded = artifacts.proof_from_bytes(port_layouts["proof_expanded"])
    assert (expanded.a, expanded.b, expanded.c) == gnark.lro


def test_verify_from_cs_accepts_both_layouts(goldens, fixture_circuit, tmp_path):
    circuit, values = fixture_circuit
    path = str(tmp_path / "srs.hex")
    artifacts.save_srs(artifacts.srs_from_bytes(goldens["srs"]), path)
    backend = Backend(Config(srs_path=path, srs_size=MG.SRS_SIZE), device="cpu")
    assert backend.verify_from_cs(goldens["proof_expanded"], values, circuit)
    assert backend.verify_from_cs(goldens["proof"], values, circuit)
    assert not backend.verify_from_cs(goldens["proof_expanded"], [MG.X + 1], circuit)


@pytest.mark.slow
def test_expanded_golden_matches_live_jax(goldens, monkeypatch):
    """Recompute the expanded proof with the JAX package (cold CPU
    compiles take minutes) and hold the stored file to it."""
    monkeypatch.delenv("NOIRTPU_MIN_DOMAIN", raising=False)
    live = MG.make_layouts("noir_backend_using_gnark_tpu", goldens)
    for name in MG.LAYOUT_NAMES:
        assert live[name] == goldens[name], name
