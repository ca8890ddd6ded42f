"""The port's field layer (plain K3 path, scans, limb conversion)
against the JAX package's ops/field.py and ops/scan_utils.py.

Inputs come from a seeded numpy generator and go through both packages;
field results are compared as integers and as limbs, tolerance zero.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from noir_backend_using_gnark_tpu.ops import field as JF
from noir_backend_using_gnark_tpu.ops import scan_utils as JS
from noir_backend_using_gnark_tpu_torch import convert
from noir_backend_using_gnark_tpu_torch.ops import field as F
from noir_backend_using_gnark_tpu_torch.ops import scan_utils as S
from noir_backend_using_gnark_tpu_torch.utils import bigint

torch.set_num_threads(1)

SPECS = {"fr": (F.FR, JF.FR), "fq": (F.FQ, JF.FQ)}
N = 64


def rand_ints(seed: int, modulus: int, n: int = N) -> list:
    """Seeded field elements with the edge values 0, 1, 2, p-1, p-2 first."""
    gen = np.random.default_rng(seed)
    words = gen.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    vals = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % modulus for row in words]
    return [0, 1, 2, modulus - 1, modulus - 2] + vals[5:]


def both(values, spec_pair):
    port_spec, jax_spec = spec_pair
    return F.from_ints(values, port_spec), JF.from_ints(values, jax_spec)


def assert_same(port_t, jax_a, spec_pair):
    port_spec, jax_spec = spec_pair
    assert F.to_ints(port_t, port_spec) == JF.to_ints(jax_a, jax_spec)
    assert torch.equal(port_t, convert.field_from_jax(np.asarray(jax_a)))


@pytest.mark.parametrize("field", ["fr", "fq"])
@pytest.mark.parametrize("op", ["mont_mul", "add", "sub"])
def test_binary_ops_match_jax(field, op):
    pair = SPECS[field]
    p = pair[0].modulus
    a_t, a_j = both(rand_ints(1, p), pair)
    b_t, b_j = both(rand_ints(2, p)[::-1], pair)
    got = getattr(F, op)(a_t, b_t, pair[0])
    want = getattr(JF, op)(a_j, b_j, pair[1])
    assert_same(got, want, pair)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_unary_ops_match_jax(field):
    pair = SPECS[field]
    a_t, a_j = both(rand_ints(3, pair[0].modulus), pair)
    assert_same(F.neg(a_t, pair[0]), JF.neg(a_j, pair[1]), pair)
    assert_same(F.to_mont(a_t, pair[0]), JF.to_mont(a_j, pair[1]), pair)
    assert_same(F.from_mont(a_t, pair[0]), JF.from_mont(a_j, pair[1]), pair)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_broadcast_scalar_and_vector(field):
    """(8, K, n) * (8, 1, 1) and (8, K, n) + (8, 1, n): the two
    broadcasts the prover uses, against JAX with the operand broadcast
    by hand."""
    pair = SPECS[field]
    p = pair[0].modulus
    vals = rand_ints(4, p, 3 * 16)
    a_t, a_j = both(vals, pair)
    a_t, a_j = a_t.reshape(8, 3, 16), a_j.reshape(16, 3, 16)
    s_t, s_j = both([vals[7]], pair)
    v_t, v_j = both(rand_ints(5, p, 16), pair)
    got = F.mont_mul(a_t, s_t.reshape(8, 1, 1), pair[0])
    want = JF.mont_mul(a_j, np.broadcast_to(np.asarray(s_j).reshape(16, 1, 1), a_j.shape), pair[1])
    assert_same(got.reshape(8, -1), want.reshape(16, -1), pair)
    got = F.add(a_t, v_t.reshape(8, 1, 16), pair[0])
    want = JF.add(a_j, np.broadcast_to(np.asarray(v_j).reshape(16, 1, 16), a_j.shape), pair[1])
    assert_same(got.reshape(8, -1), want.reshape(16, -1), pair)


@pytest.mark.parametrize("field", ["fr", "fq"])
def test_inv_and_batch_inv_match_jax(field):
    pair = SPECS[field]
    p = pair[0].modulus
    vals = rand_ints(6, p, 37)  # includes 0: maps to 0
    a_t, a_j = both(vals, pair)
    assert_same(F.batch_inv(a_t, pair[0]), JF.batch_inv(a_j, pair[1]), pair)
    assert_same(F.inv(a_t[:, :8], pair[0]), JF.inv(a_j[:, :8], pair[1]), pair)
    assert F.to_ints(F.batch_inv(a_t, pair[0]), pair[0]) == [pow(v, -1, p) if v else 0 for v in vals]


def test_rolled_scan_prefix_product_matches_jax():
    pair = SPECS["fr"]
    vals = rand_ints(7, pair[0].modulus, 45)[1:]  # nonzero head
    a_t, a_j = both(vals, pair)
    got = S.rolled_scan(lambda x, y: F.mont_mul(x, y, F.FR), a_t)
    want = JS.rolled_scan(lambda x, y: JF.mont_mul(x, y, JF.FR), a_j)
    assert_same(got, want, pair)
    acc, host = 1, []
    for v in vals:
        acc = acc * v % F.FR.modulus
        host.append(acc)
    assert F.to_ints(S.inclusive_scan(lambda x, y: F.mont_mul(x, y, F.FR), a_t), F.FR) == host


@pytest.mark.parametrize("n", [1, 2, 5, 16, 33])
def test_inclusive_scan_lengths(n):
    vals = rand_ints(8, F.FR.modulus, max(n, 5))[:n]
    t = F.from_ints(vals, F.FR)
    got = F.to_ints(S.inclusive_scan(lambda x, y: F.add(x, y, F.FR), t), F.FR)
    assert got == [sum(vals[: i + 1]) % F.FR.modulus for i in range(n)]
    got = F.to_ints(S.rolled_scan(lambda x, y: F.add(x, y, F.FR), t), F.FR)
    assert got == [sum(vals[: i + 1]) % F.FR.modulus for i in range(n)]


def test_limb_conversion_roundtrip():
    vals = rand_ints(9, 1 << 256, 20) + [(1 << 256) - 1]
    jax_layout = bigint_limbs16(vals)
    port = convert.limbs16_to_32(jax_layout)
    assert F.limbs_to_ints(port) == vals
    assert np.array_equal(convert.limbs32_to_16(port), jax_layout)
    with pytest.raises(ValueError):
        convert.limbs16_to_32(np.full((16, 1), 1 << 16, np.uint32))


def bigint_limbs16(vals) -> np.ndarray:
    from noir_backend_using_gnark_tpu.utils import bigint as jb

    return jb.ints_to_limb_array(vals)


def test_kernel_header_constants():
    """csrc/field.cuh hard-codes p, -p^-1 mod 2^32 and R mod p for both
    fields; no compiler runs here, so hold them against the integers."""
    text = (Path(F.__file__).resolve().parents[1] / "csrc" / "field.cuh").read_text()
    for struct, modulus in (("Fr", bigint.FR_MODULUS), ("Fq", bigint.FQ_MODULUS)):
        body = text[text.index(f"struct {struct} {{") :]
        body = body[: body.index("};")]
        n0 = int(re.search(r"N0 = (0x[0-9a-f]+)u", body).group(1), 16)
        assert n0 == (-pow(modulus, -1, 1 << 32)) % (1 << 32)
        p_part, one_part = body.split("one(int i)")
        limbs = [int(h, 16) for h in re.findall(r"return (0x[0-9a-f]+)u", p_part)]
        assert sum(l << (32 * i) for i, l in enumerate(limbs)) == modulus
        limbs = [int(h, 16) for h in re.findall(r"return (0x[0-9a-f]+)u", one_part)]
        assert sum(l << (32 * i) for i, l in enumerate(limbs)) == (1 << 256) % modulus


def test_cuda_tensor_without_card_raises():
    """A wrapper never takes the plain path for a non-CPU tensor: on a
    'meta' tensor it goes to the kernel side and refuses the tensor."""
    a = torch.zeros((8, 4), dtype=torch.int32, device="meta")
    with pytest.raises((ValueError, RuntimeError)):
        F.mont_mul(a, a, F.FR)
