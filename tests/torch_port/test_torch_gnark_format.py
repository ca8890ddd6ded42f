"""The gnark-crypto SRS and gnark vk layouts (formats/gnark.py) against the
JAX package: byte-equal to the JAX-written goldens of make_goldens.py,
round trips through the files of save_srs_gnark / load_srs_gnark, and
bad blobs raising DeserializeKeyError in both packages. Every
comparison is exact."""

import random
import struct

import pytest
import torch

import make_goldens as MG
from noir_backend_using_gnark_tpu_torch import artifacts
from noir_backend_using_gnark_tpu_torch.errors import DeserializeKeyError
from noir_backend_using_gnark_tpu_torch.formats import gnark
from noir_backend_using_gnark_tpu_torch.utils import hostcurve as H

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def goldens():
    return MG.load()


@pytest.fixture(scope="module")
def srs(goldens):
    return artifacts.srs_from_bytes(goldens["srs"])


def test_srs_to_gnark_bytes_equals_golden(srs, goldens):
    assert gnark.srs_to_gnark_bytes(srs) == goldens["srs_gnark"]


def test_srs_from_gnark_bytes_equals_native_srs(srs, goldens):
    back = gnark.srs_from_gnark_bytes(goldens["srs_gnark"])
    for a, b in zip(back.g1_powers, srs.g1_powers):
        assert torch.equal(a, b)
    assert (back.g2_gen, back.g2_alpha) == (srs.g2_gen, srs.g2_alpha)
    assert artifacts.srs_to_bytes(back) == goldens["srs"]


def test_jax_reads_port_gnark_srs(srs, goldens):
    """The JAX package's gnark SRS decoder reads the port's bytes to the
    same points."""
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark

    theirs = jax_gnark.srs_from_gnark_bytes(gnark.srs_to_gnark_bytes(srs))
    assert theirs.g1_ints() == srs.g1_ints()
    for a, b in ((theirs.g2_gen, srs.g2_gen), (theirs.g2_alpha, srs.g2_alpha)):
        assert [c.coeffs for c in a] == [c.coeffs for c in b]


def test_save_load_srs_gnark_round_trip(srs, goldens, tmp_path):
    path = artifacts.save_srs_gnark(srs, str(tmp_path / "sub" / "srs.hex"))
    assert bytes.fromhex(open(path).read()) == goldens["srs_gnark"]
    back = artifacts.load_srs_gnark(path)
    assert artifacts.srs_digest(back) == artifacts.srs_digest(srs)
    assert artifacts.srs_to_bytes(back) == goldens["srs"]


def test_vk_gnark_bytes_equal_golden_and_jax(goldens, srs):
    from noir_backend_using_gnark_tpu import artifacts as jax_artifacts
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark

    vk = artifacts.vk_from_bytes(goldens["vk"])
    assert gnark.vk_to_gnark_bytes(vk) == goldens["vk_gnark"]
    assert jax_gnark.vk_to_gnark_bytes(jax_artifacts.vk_from_bytes(goldens["vk"])) == goldens["vk_gnark"]
    back = gnark.vk_from_gnark_bytes(goldens["vk_gnark"], srs=srs)
    assert artifacts.vk_to_bytes(back) == goldens["vk"]
    bare = gnark.vk_from_gnark_bytes(goldens["vk_gnark"])
    assert bare.g2_gen is None and bare.g2_alpha is None
    assert artifacts.vk_to_bytes(gnark.vk_init_kzg(bare, srs)) == goldens["vk"]
    theirs = jax_gnark.vk_from_gnark_bytes(goldens["vk_gnark"], srs=srs)
    assert vars(theirs) == vars(back)


def _g2_points():
    rng = random.Random(7)
    g = H.g2_generator()
    return [None, g, H.g2_neg(g)] + [H.g2_mul(g, rng.randrange(1, H.R)) for _ in range(6)]


def test_g2_compressed_codec_matches_jax():
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark

    for pt in _g2_points():
        raw = gnark.g2_bytes_compressed(pt)
        assert raw == jax_gnark.g2_bytes_compressed(pt)
        assert gnark.g2_read_compressed(b"\x00" + raw, 1) == (pt, 65)


def test_fq2_sqrt_matches_jax():
    """The same root (or None) as the JAX package's, on squares and on
    random elements (half of them non-squares)."""
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark
    from noir_backend_using_gnark_tpu.utils import hostcurve as JH

    rng = random.Random(11)
    values = [H.FQ2([rng.randrange(H.Q), rng.randrange(H.Q)]) for _ in range(8)]
    values += [H.FQ2([rng.randrange(H.Q), 0]) for _ in range(4)] + [H.FQ2([0, 0])]
    squares = [v * v for v in values]
    for a in values + squares:
        mine = gnark._fq2_sqrt(a)
        theirs = jax_gnark._fq2_sqrt(JH.FQ2(list(a.coeffs)))
        assert (mine is None) == (theirs is None)
        if mine is not None:
            assert mine.coeffs == theirs.coeffs
            assert mine * mine == a
    assert all(gnark._fq2_sqrt(s) is not None for s in squares)


def _bad_srs_blobs(blob: bytes) -> dict:
    g1_off = 64 + 64 + 4
    out = {
        "truncated points": blob[:-5],
        "truncated count": blob[:130],
        "empty": b"",
    }
    b = bytearray(blob)
    b[0] = (b[0] & 0x3F)  # the uncompressed flag on G2
    out["G2 uncompressed flag"] = bytes(b)
    b = bytearray(blob)
    b[63] ^= 0x01  # x of G2 off the twist or out of the subgroup
    out["G2 x changed"] = bytes(b)
    b = bytearray(blob)
    b[g1_off] = (b[g1_off] & 0x3F)  # the uncompressed flag on a G1 point
    out["G1 uncompressed flag"] = bytes(b)
    b = bytearray(blob)
    b[g1_off + 32 : g1_off + 64] = bytes([0xBF] + [0xFF] * 31)  # x >= q
    out["G1 x out of range"] = bytes(b)
    return out


@pytest.mark.parametrize("case", ["truncated points", "truncated count", "empty", "G2 uncompressed flag",
                                  "G2 x changed", "G1 uncompressed flag", "G1 x out of range"])
def test_bad_srs_blob_raises_in_both(goldens, case):
    from noir_backend_using_gnark_tpu.errors import DeserializeKeyError as JaxDeserializeKeyError
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark

    blob = _bad_srs_blobs(goldens["srs_gnark"])[case]
    with pytest.raises(DeserializeKeyError):
        gnark.srs_from_gnark_bytes(blob)
    with pytest.raises(JaxDeserializeKeyError):
        jax_gnark.srs_from_gnark_bytes(blob)


def test_load_srs_gnark_bad_hex_raises(tmp_path):
    path = tmp_path / "srs.hex"
    path.write_text("zz")
    with pytest.raises(DeserializeKeyError):
        artifacts.load_srs_gnark(str(path))


def _bad_vk_blobs(blob: bytes) -> dict:
    r = H.R
    out = {"truncated": blob[:-1], "empty": b"", "header only": blob[:8]}
    b = bytearray(blob)
    b[8:40] = ((int.from_bytes(blob[8:40], "big") + 1) % r).to_bytes(32, "big")
    out["SizeInv inconsistent"] = bytes(b)
    b = bytearray(blob)
    b[40:72] = r.to_bytes(32, "big")
    out["Generator out of range"] = bytes(b)
    b = bytearray(blob)
    b[112] = (b[112] & 0x3F)  # the uncompressed flag on S[0]
    out["S1 uncompressed flag"] = bytes(b)
    return out


@pytest.mark.parametrize("case", ["truncated", "empty", "header only", "SizeInv inconsistent",
                                  "Generator out of range", "S1 uncompressed flag"])
def test_bad_vk_blob_raises_in_both(goldens, case):
    from noir_backend_using_gnark_tpu.errors import DeserializeKeyError as JaxDeserializeKeyError
    from noir_backend_using_gnark_tpu.formats import gnark as jax_gnark

    blob = _bad_vk_blobs(goldens["vk_gnark"])[case]
    with pytest.raises(DeserializeKeyError):
        gnark.vk_from_gnark_bytes(blob)
    with pytest.raises(JaxDeserializeKeyError):
        jax_gnark.vk_from_gnark_bytes(blob)


def test_vk_gnark_layout_fields(goldens):
    """Size, SizeInv, Generator, NbPublicVariables and CosetShift sit
    where gnark's marshal.go puts them."""
    vk = artifacts.vk_from_bytes(goldens["vk"])
    blob = goldens["vk_gnark"]
    assert struct.unpack(">Q", blob[:8])[0] == vk.n
    assert int.from_bytes(blob[8:40], "big") == pow(vk.n, -1, H.R)
    assert int.from_bytes(blob[40:72], "big") == vk.generator
    assert struct.unpack(">Q", blob[72:80])[0] == vk.nb_public
    assert int.from_bytes(blob[80:112], "big") == vk.k1
    assert len(blob) == 112 + 8 * 32
