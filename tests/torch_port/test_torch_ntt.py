"""The port's NTT (plain K4 path) and polynomial layer against the JAX
package's ops/ntt.py and ops/poly.py, element for element."""

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
