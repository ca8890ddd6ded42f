"""The port's NTT (plain K4 path, and K4's pass plan on the CPU), its
tables and its polynomial layer against the JAX package's ops/ntt.py and
ops/poly.py, element for element."""

import re

import numpy as np
import pytest
import torch

from noir_backend_using_gnark_tpu.ops import field as JF
from noir_backend_using_gnark_tpu.ops import ntt as JN
from noir_backend_using_gnark_tpu.ops import poly as JP
from noir_backend_using_gnark_tpu_torch import convert
from noir_backend_using_gnark_tpu_torch.ops import field as F
from noir_backend_using_gnark_tpu_torch.ops import ntt as N
from noir_backend_using_gnark_tpu_torch.ops import poly as P

torch.set_num_threads(1)

R = F.FR.modulus


def rand_fr(seed: int, n: int) -> list:
    gen = np.random.default_rng(seed)
    words = gen.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    return [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R for row in words]


def both(values, shape):
    """The same values as a port tensor (8, *shape) and a JAX array (16, *shape)."""
    t = F.from_ints(values, F.FR).reshape((8,) + shape)
    j = JF.from_ints(values, JF.FR).reshape((16,) + shape)
    return t, j


def assert_same(port_t, jax_a):
    assert torch.equal(port_t, convert.field_from_jax(np.asarray(jax_a)))


@pytest.mark.parametrize("logn", [3, 4, 5, 6, 7, 8])
def test_ntt_intt_coset_match_jax(logn):
    n = 1 << logn
    t, j = both(rand_fr(logn, 2 * n), (2, n))
    assert_same(N.ntt(t), JN.ntt(j))
    assert_same(N.intt(t), JN.intt(j))
    assert_same(N.coset_ntt(t, 5), JN.coset_ntt(j, 5))
    assert_same(N.coset_intt(t, 5), JN.coset_intt(j, 5))
    assert torch.equal(N.intt(N.ntt(t)), t)


def test_ntt_matches_host_dft():
    n = 8
    vals = rand_fr(20, n)
    t = F.from_ints(vals, F.FR)
    w = N.Domain.get(n).w_int
    want = [sum(v * pow(w, i * k, R) for i, v in enumerate(vals)) % R for k in range(n)]
    assert F.to_ints(N.ntt(t), F.FR) == want


def test_domain_tables_match_jax():
    for n in (8, 256):
        d, jd = N.Domain.get(n), JN.Domain.get(n)
        assert d.w_int == jd.w_int and d.n_inv_int == jd.n_inv_int
        assert_same(d.fwd_table("cpu"), jd.fwd_table())
        assert_same(d.x_powers("cpu"), jd.x_powers())


def host_chain(base: int, n: int) -> list:
    """[base^0 .. base^{n-1}] in Montgomery form by the host bigint chain
    the port used to build its tables with."""
    acc, out = F.R_INT % R, []
    for _ in range(n):
        out.append(acc)
        acc = acc * base % R
    return out


@pytest.mark.parametrize("logn", [10, 13])
def test_device_tables_match_host_chain_and_jax(logn):
    """power_table (doubling over the field product) equals the host chain
    and the JAX package's powers_of, for the forward, inverse and coset
    bases of the domain."""
    n = 1 << logn
    d = N.Domain.get(n)
    for base in (d.w_int, d.w_inv_int, 5, pow(5, -1, R)):
        got = N.power_table(base, n, "cpu")
        assert F.limbs_to_ints(got) == host_chain(base, n)
        want = JN.powers_of(JF.from_ints([base], JF.FR)[:, 0], n, JF.FR)
        assert_same(got, want)
    assert F.limbs_to_ints(d.fwd_table("cpu")) == host_chain(d.w_int, n // 2)
    assert F.limbs_to_ints(d.inv_table("cpu")) == host_chain(d.w_inv_int, n // 2)
    assert F.limbs_to_ints(N.coset_scale(5, n, True, "cpu")) == host_chain(pow(5, -1, R), n)


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8])
def test_power_table_small_lengths(n):
    assert F.limbs_to_ints(N.power_table(7, n, "cpu")) == host_chain(7, n)


@pytest.mark.parametrize("logn", list(range(14)) + [16])
def test_four_step_plan_matches_plain_and_jax(logn):
    """K4's pass plan on the CPU (the split, the transposing first pass,
    the in-place passes and their twiddles with the sign fold) equals the
    radix-2 plain version and the JAX package's ntt / intt (with 1/n), at
    the kernel's LMAX and at LMAX = 4, where 2^9 .. 2^12 take three passes
    and 2^13 and 2^16 four."""
    n = 1 << logn
    batch = 2 if logn <= 13 else 1
    t, j = both(rand_fr(100 + logn, batch * n), (batch, n))
    d = N.Domain.get(n)
    fwd, inv, n_inv = d.fwd_table("cpu"), d.inv_table("cpu"), d.n_inv("cpu")
    want_fwd = N._transform_plain(t, fwd, d.rev("cpu"))
    want_inv = N._transform_plain(t, inv, d.rev("cpu"), n_inv)
    assert_same(want_fwd, JN.ntt(j))
    assert_same(want_inv, JN.intt(j))
    for lmax in (N.LMAX, 4):
        assert torch.equal(N._transform_four_step_plain(t, fwd, lmax=lmax), want_fwd), lmax
        assert torch.equal(N._transform_four_step_plain(t, inv, n_inv, lmax=lmax), want_inv), lmax


def test_ntt_plan_bounds():
    """Every size up to 2^28 takes at most MAX_PASSES passes of at most
    LMAX bits; a split size has no part below log2 COLS (a block takes
    COLS adjacent columns of the first and of the last digit); the main
    path's sizes take two passes."""
    cols_bits = N.COLS.bit_length() - 1
    for logn in range(29):
        plan = N.ntt_plan(logn)
        assert sum(plan) == logn and 1 <= len(plan) <= N.MAX_PASSES, logn
        assert max(plan) <= N.LMAX and max(plan) - min(plan) <= 1, logn
        assert len(plan) == 1 or min(plan) >= cols_bits, logn
    assert N.ntt_plan(16) == (8, 8) and N.ntt_plan(18) == (9, 9)
    assert [len(N.ntt_plan(k)) for k in (9, 10, 18, 19, 27, 28)] == [1, 2, 2, 3, 3, 4]
    assert N.ntt_plan(13, 4) == (4, 3, 3, 3)


def test_k4_constants_match_its_source():
    """ntt_plan splits as csrc/ntt.cu's ntt_split does: the same LMAX,
    COLS and MAX_PASSES, and the same formula."""
    src = (N.cuda_build.CSRC / "ntt.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)$", src, flags=re.M))
    assert int(defines["NTT_LMAX"]) == N.LMAX
    assert int(defines["NTT_COLS"]) == N.COLS
    assert int(defines["NTT_MAX_PASSES"]) == N.MAX_PASSES
    assert "(logn + NTT_LMAX - 1) / NTT_LMAX" in src
    assert "logn / npass + (p < logn % npass ? 1 : 0)" in src


def test_horner_and_division_match_jax():
    n = 37
    t, j = both(rand_fr(30, 3 * n), (3, n))
    z_val = rand_fr(31, 1)
    zt, zj = both(z_val, (1,))
    assert_same(P.horner_states(t, zt), JP.horner_states(j, zj))
    q_t, r_t = P.divide_by_linear(t[:, 0], zt)
    q_j, r_j = JP.divide_by_linear(j[:, 0], zj)
    assert_same(q_t, q_j)
    assert_same(r_t, r_j)
    coeffs = F.to_ints(t[:, 0], F.FR)
    assert F.to_ints(r_t, F.FR) == [sum(c * pow(z_val[0], i, R) for i, c in enumerate(coeffs)) % R]


def test_eval_many_and_lincomb_match_jax():
    lens = (5, 12, 9)
    vals = rand_fr(40, sum(lens))
    polys_t, polys_j, off = [], [], 0
    for m in lens:
        t, j = both(vals[off : off + m], (m,))
        polys_t.append(t)
        polys_j.append(j)
        off += m
    zt, zj = both(rand_fr(41, 1), (1,))
    got = P.eval_many(polys_t, zt)
    want = JP.eval_many(polys_j, zj)
    assert F.to_ints(got, F.FR) == [JF.to_ints(w, JF.FR)[0] for w in want]
    weights = rand_fr(42, 3)
    got = P.linear_combination(polys_t, weights)
    want = JP.linear_combination(polys_j, [JF.from_ints([w], JF.FR) for w in weights])
    assert_same(got, want)
