"""The port's CLI and the rest of its Backend surface against the JAX
package: for every package of tests/programs/, the ACIR codec, the
``gates`` count and the ``execute`` witness bytes equal the JAX
package's (called live: all of it is host code); the CLI flow on the
CPU reproduces the JAX-written goldens of the package fixture of
make_goldens.py; each CLI reads the other's files; the negative probes
of the verify recipe exit 1. Every comparison is exact."""

import os
import shutil
from pathlib import Path

import pytest
import torch

import make_goldens as MG
from noir_backend_using_gnark_tpu_torch import cli
from noir_backend_using_gnark_tpu_torch.acir import model, parse, solver
from noir_backend_using_gnark_tpu_torch.api import Backend
from noir_backend_using_gnark_tpu_torch.errors import BackendError, CircuitParseError
from noir_backend_using_gnark_tpu_torch.utils import bigint

torch.set_num_threads(1)

PORT = "noir_backend_using_gnark_tpu_torch"
PROGRAMS = sorted(p.name for p in MG.PROGRAMS.iterdir() if p.is_dir())
CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _jax_cli_cache(monkeypatch):
    """The JAX CLI points JAX's compile cache at NOIRTPU_JAX_CACHE: keep
    it on the repository's cache, as tests/conftest.py does."""
    monkeypatch.setenv("NOIRTPU_JAX_CACHE", str(MG.PROGRAMS.parents[1] / ".jax_cache"))


def _acir_text(name: str) -> str:
    return (MG.PROGRAMS / name / "circuit.acir.json").read_text()


def _copy(name: str, dest: Path) -> str:
    shutil.copytree(MG.PROGRAMS / name, dest / name)
    return str(dest / name)


def test_all_sixteen_packages_present():
    assert len(PROGRAMS) == 16


@pytest.mark.parametrize("name", PROGRAMS)
def test_acir_codec_matches_jax(name):
    """circuit_to_json(parse_circuit(...)) equal in both packages, and
    each package parses the other's output to the same document."""
    from noir_backend_using_gnark_tpu.acir import parse as jax_parse

    text = _acir_text(name)
    mine = parse.circuit_to_json(parse.parse_circuit(text))
    theirs = jax_parse.circuit_to_json(jax_parse.parse_circuit(text))
    assert mine == theirs
    assert parse.circuit_to_json(parse.parse_circuit(theirs)) == mine
    assert jax_parse.circuit_to_json(jax_parse.parse_circuit(mine)) == theirs


@pytest.mark.parametrize("name", PROGRAMS)
def test_gates_matches_jax(name, capsys):
    """The `gates` command prints the JAX CLI's line (range_check: both
    exit 1, the reference's size formula refuses black-box opcodes)."""
    from noir_backend_using_gnark_tpu import cli as jax_cli

    pkg = str(MG.PROGRAMS / name)
    rc_jax = jax_cli.main(["gates", pkg])
    out_jax = capsys.readouterr()
    rc = cli.main(["gates", pkg, *CPU])
    out = capsys.readouterr()
    assert (rc, out.out) == (rc_jax, out_jax.out)
    assert rc == (1 if name == "range_check" else 0)


@pytest.mark.parametrize("name", PROGRAMS)
def test_execute_witness_matches_jax(name, tmp_path):
    """`execute` writes the JAX CLI's target/witness.hex, and solve ->
    dense_values -> encode_felts agree as functions too."""
    from noir_backend_using_gnark_tpu import cli as jax_cli
    from noir_backend_using_gnark_tpu.acir import solver as jax_solver
    from noir_backend_using_gnark_tpu.utils import bigint as jax_bigint

    mine_dir, theirs_dir = tmp_path / "port", tmp_path / "jax"
    pkg, jax_pkg = _copy(name, mine_dir), _copy(name, theirs_dir)
    assert cli.main(["execute", pkg, *CPU]) == 0
    assert jax_cli.main(["execute", jax_pkg]) == 0
    witness = Path(pkg, "target", "witness.hex").read_text()
    assert witness == Path(jax_pkg, "target", "witness.hex").read_text()

    circuit, abi = cli._load_package(pkg)
    initial = cli._toml_witness(os.path.join(pkg, "Prover.toml"), abi)
    values = solver.dense_values(circuit, solver.solve(circuit, dict(initial)))
    jax_circuit, _ = jax_cli._load_package(jax_pkg)
    jax_values = jax_solver.dense_values(jax_circuit, jax_solver.solve(jax_circuit, dict(initial)))
    assert values == jax_values
    assert bigint.encode_felts(values) == jax_bigint.encode_felts(jax_values) == witness
    assert bigint.decode_felts(witness) == values


def test_introspection_matches_jax():
    """np_language and black_box_function_supported over every BlackBoxFunc."""
    from noir_backend_using_gnark_tpu.acir import model as jax_model
    from noir_backend_using_gnark_tpu.api import Backend as JaxBackend

    mine, theirs = Backend(device="cpu"), JaxBackend()
    assert mine.np_language() == theirs.np_language() == {"PLONKCSat": {"width": 3}}
    assert [f.value for f in model.BlackBoxFunc] == [f.value for f in jax_model.BlackBoxFunc]
    for f in model.BlackBoxFunc:
        assert mine.black_box_function_supported(f) == theirs.black_box_function_supported(
            jax_model.BlackBoxFunc(f.value)
        ), f


@pytest.mark.parametrize("func,n_out", [("AND", 1), ("XOR", 1), ("RANGE", 0), ("SHA256", 32),
                                        ("Blake2s", 32), ("HashToField128Security", 1)])
def test_solve_black_box_function_call_matches_jax(func, n_out):
    from noir_backend_using_gnark_tpu.acir import model as jax_model
    from noir_backend_using_gnark_tpu.api import Backend as JaxBackend

    inputs = ((1, 8), (2, 8))
    outputs = tuple(range(3, 3 + n_out))
    mine = model.BlackBoxFuncCall(model.BlackBoxFunc(func),
                                  tuple(model.FunctionInput(w, b) for w, b in inputs), outputs)
    theirs = jax_model.BlackBoxFuncCall(jax_model.BlackBoxFunc(func),
                                        tuple(jax_model.FunctionInput(w, b) for w, b in inputs), outputs)
    w_mine, w_theirs = {1: 0b11001010, 2: 0b10100110}, {1: 0b11001010, 2: 0b10100110}
    Backend(device="cpu").solve_black_box_function_call(w_mine, mine)
    JaxBackend().solve_black_box_function_call(w_theirs, theirs)
    assert w_mine == w_theirs
    assert len(w_mine) == 2 + n_out


def test_felt_codecs_match_jax():
    from noir_backend_using_gnark_tpu.utils import bigint as jax_bigint

    felts = [0, 1, bigint.FR_MODULUS - 1, 2**200 + 12345]
    enc = bigint.encode_felts(felts)
    assert enc == jax_bigint.encode_felts(felts)
    assert bigint.decode_felts(enc) == jax_bigint.decode_felts(enc) == felts
    for v in felts:
        assert bigint.decode_felt_hex(bigint.encode_felt_hex(v)) == v
        assert bigint.encode_felt_hex(v) == jax_bigint.encode_felt_hex(v)
    for bad in ("00", enc[:-2]):
        with pytest.raises(ValueError):
            bigint.decode_felts(bad)


def test_parse_errors_are_circuit_parse_errors():
    for doc in ("{", "[]", '{"opcodes": []}', '{"opcodes": [{"Nope": {}}], "public_inputs": [],'
                ' "current_witness_index": 1}'):
        with pytest.raises(CircuitParseError):
            parse.parse_circuit(doc)


# ---------------------------------------------------------------------------
# The CLI flow on the CPU against the JAX-written package fixture
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def goldens():
    return MG.load()


@pytest.fixture(scope="module")
def port_package(tmp_path_factory):
    """The package fixture's flow (execute, prove, verify) through the
    port's CLI; returns its directory and its target files."""
    work = tmp_path_factory.mktemp("pkg")
    files = MG.make_package(PORT, str(work), device="cpu")
    return work, files


@pytest.mark.parametrize("name", MG.PKG_FILES)
def test_cli_package_bytes_equal_jax_goldens(port_package, goldens, name):
    _, files = port_package
    assert files[name] == goldens[f"pkg_{name}"]


def test_jax_cli_verifies_port_package(port_package):
    from noir_backend_using_gnark_tpu import cli as jax_cli

    work, _ = port_package
    srs = str(work / "srs.hex")
    assert jax_cli.main(["verify", str(work / MG.PKG), "--srs-path", srs]) == 0


def test_port_cli_verifies_and_proves_from_jax_files(goldens, tmp_path):
    """The JAX CLI's target files in a fresh package: the port's verify
    accepts its proof, and the port's prove reuses its pk.hex and gives
    its proof bytes."""
    from noir_backend_using_gnark_tpu_torch import artifacts
    from noir_backend_using_gnark_tpu_torch.kzg import kzg

    pkg = _copy(MG.PKG, tmp_path)
    target = Path(pkg, "target")
    target.mkdir()
    for name in ("pk", "vk", "proof"):
        (target / f"{name}.hex").write_text(goldens[f"pkg_{name}"])
    srs = str(tmp_path / "srs.hex")
    artifacts.save_srs(kzg.generate_srs(MG.PKG_SRS_SIZE, MG.PKG_ALPHA), srs)
    assert cli.main(["verify", pkg, *CPU]) == 0
    (target / "proof.hex").unlink()
    assert cli.main(["prove", pkg, *MG.package_args(srs), *CPU]) == 0
    assert (target / "proof.hex").read_text() == goldens["pkg_proof"]


def _probe_dir(goldens, tmp_path) -> str:
    pkg = _copy(MG.PKG, tmp_path)
    target = Path(pkg, "target")
    target.mkdir()
    for name in ("vk", "proof"):
        (target / f"{name}.hex").write_text(goldens[f"pkg_{name}"])
    return pkg


def test_probe_flipped_proof_byte_fails(goldens, tmp_path, capsys):
    pkg = _probe_dir(goldens, tmp_path)
    assert cli.main(["verify", pkg, *CPU]) == 0
    proof = bytearray.fromhex(goldens["pkg_proof"])
    proof[40] ^= 0x01
    Path(pkg, "target", "proof.hex").write_text(proof.hex())
    assert cli.main(["verify", pkg, *CPU]) == 1
    assert "[verify] FAILED" in capsys.readouterr().out


def test_probe_changed_public_input_fails(goldens, tmp_path, capsys):
    pkg = _probe_dir(goldens, tmp_path)
    Path(pkg, "Verifier.toml").write_text('y = "3"\n')
    assert cli.main(["verify", pkg, *CPU]) == 1
    assert "[verify] FAILED" in capsys.readouterr().out


def test_probe_unsatisfied_witness_fails(tmp_path, capsys):
    pkg = _copy(MG.PKG, tmp_path)
    Path(pkg, "Prover.toml").write_text('x = "2"\ny = "2"\n')
    assert cli.main(["execute", pkg, *CPU]) == 1
    assert "unsatisfied arithmetic constraint" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["modules", "range_check"])
def test_cli_test_command_round_trip(name, tmp_path):
    """`test` (execute -> prove -> verify) on a package with one public
    input, and on the one whose ACIR keeps a RANGE black box."""
    from noir_backend_using_gnark_tpu_torch import artifacts
    from noir_backend_using_gnark_tpu_torch.kzg import kzg

    pkg = _copy(name, tmp_path)
    srs = str(tmp_path / "srs.hex")
    artifacts.save_srs(kzg.generate_srs(MG.PKG_SRS_SIZE, MG.PKG_ALPHA), srs)
    assert cli.main(["test", pkg, *MG.package_args(srs), *CPU]) == 0
    for f in ("witness", "pk", "vk", "proof"):
        assert Path(pkg, "target", f"{f}.hex").is_file()


def test_cli_without_card_exits_1(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the CLI resolves to it")
    pkg = _copy(MG.PKG, tmp_path)
    assert cli.main(["execute", pkg]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not Path(pkg, "target").exists()


@pytest.mark.parametrize("flags,item", [(["--scheme", "groth16"], "item 10"), (["--mesh", "2"], "item 11")])
def test_cli_refuses_what_is_not_ported(flags, item, tmp_path, capsys):
    pkg = _copy(MG.PKG, tmp_path)
    assert cli.main(["execute", pkg, *flags, *CPU]) == 1
    assert item in capsys.readouterr().err
    assert not Path(pkg, "target").exists()


def test_cli_errors_exit_1(tmp_path, capsys):
    assert cli.main(["check", str(tmp_path), *CPU]) == 1
    assert "no circuit.acir.json" in capsys.readouterr().err
    with pytest.raises(BackendError):
        cli._toml_witness(str(MG.PROGRAMS / MG.PKG / "Prover.toml"), {"x": 1})
