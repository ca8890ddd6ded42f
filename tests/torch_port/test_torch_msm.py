"""The port's curve and MSM layers (plain K1 and K2) against the JAX
package's ops/curve.py, ops/msm.py and ops/msm_pallas.py.

Points are compared in affine form (Jacobian coordinates are not
unique), tolerance zero. The JAX Pallas kernels run in interpret mode,
as tests/test_msm.py runs them; their CPU compile takes tens of minutes,
so those comparisons carry the ``slow`` marker like the JAX package's
own, and the quick tests hold the port against the JAX package's digit
recoding, its XLA MSM and host-integer oracles.
"""

import re

import numpy as np
import pytest
import torch

from noir_backend_using_gnark_tpu.ops import curve as JC
from noir_backend_using_gnark_tpu.ops import field as JF
from noir_backend_using_gnark_tpu.ops import msm as JM
from noir_backend_using_gnark_tpu.utils import hostcurve as H
from noir_backend_using_gnark_tpu_torch import convert
from noir_backend_using_gnark_tpu_torch.ops import curve as C
from noir_backend_using_gnark_tpu_torch.ops import field as F
from noir_backend_using_gnark_tpu_torch.ops import msm as M
from noir_backend_using_gnark_tpu_torch.ops import msm_kernels as MK

torch.set_num_threads(1)

R = H.R


def host_points(seed: int, n: int, distinct: int = 8):
    """n affine points tiled from `distinct` random multiples of G, with
    a repeat, a negation and an infinity planted; plus n scalars (one 0)."""
    gen = np.random.default_rng(seed)
    g = H.g1_generator()
    base = [H.g1_mul(g, int(gen.integers(1, 1 << 62)) * 7919 + 1) for _ in range(distinct)]
    pts = [base[i % distinct] for i in range(n)]
    pts[3] = None
    pts[5] = H.g1_neg(pts[4])
    pts[9] = pts[10]
    words = gen.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
    scalars = [sum(int(w) << (32 * i) for i, w in enumerate(row)) % R for row in words]
    scalars[7] = 0
    return pts, scalars


def bucket_oracle(pts, mags, negs, c):
    """S[w][b] = sum of +-P_j over |digit(w, j)| == b, with host ints."""
    w_count, n = mags.shape
    nb = (1 << (c - 1)) + 1
    out = [[None] * nb for _ in range(w_count)]
    for w in range(w_count):
        for j in range(n):
            b = int(mags[w, j])
            if b == 0 or pts[j] is None:
                continue
            p = H.g1_neg(pts[j]) if negs[w, j] else pts[j]
            out[w][b] = H.g1_add(out[w][b], p)
    return out


def port_affine(p: C.JacobianPoint):
    return C.to_affine_ints(p.map(lambda a: a.reshape(8, -1)))


def jax_affine(p):
    import jax

    return JC.to_affine_ints(jax.tree_util.tree_map(lambda a: a.reshape(16, -1), p))


# ---------------------------------------------------------------------------
# Curve ops
# ---------------------------------------------------------------------------


def test_curve_ops_match_jax():
    pts, _ = host_points(1, 12)
    other = pts[::-1]
    other[0] = pts[0]  # a doubling inside add
    other[1] = H.g1_neg(pts[1])  # P + (-P)
    p_t, q_t = C.from_affine_ints(pts), C.from_affine_ints(other)
    p_j, q_j = JC.from_affine_ints(pts), JC.from_affine_ints(other)
    assert port_affine(C.add(p_t, q_t)) == jax_affine(JC.add(p_j, q_j))
    assert port_affine(C.double(p_t)) == jax_affine(JC.double(p_j))
    assert port_affine(C.add(p_t, q_t)) == [H.g1_add(a, b) for a, b in zip(pts, other)]
    qx = F.from_ints([pt[0] if pt else 1 for pt in other], F.FQ)
    qy = F.from_ints([pt[1] if pt else 1 for pt in other], F.FQ)
    q_inf = torch.tensor([pt is None for pt in other])
    got = port_affine(C.add_mixed(p_t, qx, qy, q_inf))
    want = jax_affine(JC.add_mixed(p_j, q_j.x, q_j.y, JF.is_zero(q_j.z)))
    assert got == want == [H.g1_add(a, b) for a, b in zip(pts, other)]


def test_to_affine_and_packing_match_jax():
    pts, _ = host_points(2, 12)
    jac = C.from_affine_ints(pts)
    # Scale to a non-trivial Z: (X z^2, Y z^3, z) is the same point.
    z = F.from_ints(list(range(3, 15)), F.FQ)
    z2 = F.mont_mul(z, z, F.FQ)
    scaled = C.JacobianPoint(F.mont_mul(jac.x, z2, F.FQ), F.mont_mul(jac.y, F.mont_mul(z2, z, F.FQ), F.FQ),
                             F.select(C.is_infinity(jac), jac.z, z))
    assert C.to_affine_ints(scaled) == pts
    packed = C._to_affine_packed(scaled)
    want = np.asarray(JC._to_affine_packed(JC.from_affine_ints(pts)))
    assert np.array_equal(convert.limbs32_to_16(packed[:8]), want[:16])
    assert np.array_equal(convert.limbs32_to_16(packed[8:16]), want[16:32])
    assert np.array_equal(packed[16].numpy(), want[32].astype(np.int32))


def test_fixed_base_mul_matches_host():
    gen = np.random.default_rng(3)
    scalars = [0, 1, 2, R - 1] + [int(v) for v in gen.integers(1, 1 << 62, size=4)]
    tx, ty = C.generator_powers_table(256)
    sc = F.from_ints(scalars, F.FR, to_mont=False)
    got = C.to_affine_ints(C.fixed_base_mul(tx, ty, sc))
    assert got == [H.g1_mul(H.g1_generator(), s) for s in scalars]


# ---------------------------------------------------------------------------
# Digits and K1 (bucket accumulation)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [4, 6, 7])
def test_signed_digits_match_jax(c):
    _, scalars = host_points(4, 40)
    scalars[0], scalars[1] = R - 1, (1 << 253) + 12345
    w_count = M.num_windows(c)
    mags, negs = MK.signed_digits(F.from_ints(scalars, F.FR, to_mont=False), c, w_count)
    jm, jn = JM.signed_digits(JF.from_ints(scalars, JF.FR, to_mont=False), c, w_count)
    assert np.array_equal(mags.numpy(), np.asarray(jm).astype(np.int64))
    assert np.array_equal(negs.numpy(), np.asarray(jn))


def test_digit_stream_refuses_wide_windows():
    sc = F.from_ints([1, 2], F.FR, to_mont=False)
    with pytest.raises(ValueError, match="int8"):
        MK.digit_stream(sc, torch.zeros(2, dtype=torch.bool), 8)


def test_window_width_two_is_refused():
    """At c = 2, c * W = 254 < 255 bits and the top window's carry would
    be lost (r - 1 carries): the digit stream and K1's wrapper refuse it
    (and K1's C entry, which the card's tests reach)."""
    pts, scalars = host_points(11, 12)
    scalars[0] = R - 1
    sc = F.from_ints(scalars, F.FR, to_mont=False)
    assert 2 * M.num_windows(2) == 254 and all(c * M.num_windows(c) >= 255 for c in range(3, 8))
    with pytest.raises(ValueError, match="3 <= c"):
        MK.digit_stream(sc, torch.zeros(12, dtype=torch.bool), 2)
    batch = M.affine_from_ints(pts)
    with pytest.raises(ValueError, match="c >= 3"):
        MK._accumulate_cuda(batch.x, batch.y, batch.inf, sc, 2)
    with pytest.raises(ValueError, match="3 <= c"):
        MK.accumulate_buckets(batch.x, batch.y, batch.inf, sc, 2)
    src = (MK.cuda_build.CSRC / "msm_accum.cu").read_text()
    assert "c < 3 || c > 7" in src


@pytest.mark.parametrize("c", [4, 6])
def test_plain_accumulation_matches_oracle(c):
    """Plain K1 per (window, bucket), in affine form, against host sums
    over the JAX package's signed digits."""
    pts, scalars = host_points(5, 256)
    batch = M.affine_from_ints(pts)
    sc = F.from_ints(scalars, F.FR, to_mont=False)
    got = MK.accumulate_buckets(batch.x, batch.y, batch.inf, sc, c)
    jm, jn = JM.signed_digits(JF.from_ints(scalars, JF.FR, to_mont=False), c, M.num_windows(c))
    want = bucket_oracle(pts, np.asarray(jm), np.asarray(jn), c)
    assert port_affine(got) == [pt for row in want for pt in row]


@pytest.mark.slow
@pytest.mark.parametrize("c", [4, 6])
def test_plain_accumulation_matches_pallas_interpret(c):
    from noir_backend_using_gnark_tpu.ops import msm_pallas as MP

    pts, scalars = host_points(5, 256)
    batch = M.affine_from_ints(pts)
    sc = F.from_ints(scalars, F.FR, to_mont=False)
    got = MK.accumulate_buckets(batch.x, batch.y, batch.inf, sc, c)
    jb = JM.affine_from_ints(pts)
    want = MP.accumulate_buckets_pallas(
        jb.x, jb.y, jb.inf, JF.from_ints(scalars, JF.FR, to_mont=False), c, interpret=True
    )
    assert port_affine(got) == jax_affine(want)


# ---------------------------------------------------------------------------
# Weighted reduction and K2 (window join)
# ---------------------------------------------------------------------------


def _totals(seed: int, k: int = 3, w_count: int = 43):
    """Random Jacobian totals (K, W) with an infinite entry and one MSM
    whose totals are all infinite."""
    gen = np.random.default_rng(seed)
    g = H.g1_generator()
    pts = [H.g1_mul(g, int(v)) for v in gen.integers(1, 1 << 62, size=k * w_count)]
    pts[5] = None
    pts[2 * w_count :] = [None] * ((k - 2) * w_count)
    return pts


def test_plain_join_matches_oracle():
    c, k, w_count = 6, 3, 43
    pts = _totals(6, k, w_count)
    totals = C.from_affine_ints(pts).map(lambda a: a.reshape(8, k, w_count))
    got = port_affine(MK.join_windows(totals, c))
    want = []
    for i in range(k):
        acc = None
        for w in range(w_count):
            pt = pts[i * w_count + w]
            acc = H.g1_add(acc, H.g1_mul(pt, 1 << (c * w)) if pt else None)
        want.append(acc)
    assert got == want


@pytest.mark.slow
def test_plain_join_matches_pallas_interpret():
    import jax

    from noir_backend_using_gnark_tpu.ops import msm_pallas as MP

    c, k, w_count = 6, 3, 43
    pts = _totals(6, k, w_count)
    totals = C.from_affine_ints(pts).map(lambda a: a.reshape(8, k, w_count))
    jt = jax.tree_util.tree_map(lambda a: a.reshape(16, k, w_count), JC.from_affine_ints(pts))
    want = jax_affine(MP.join_windows_pallas(jt, c, interpret=True))
    assert port_affine(MK.join_windows(totals, c)) == want


def test_weighted_bucket_reduce_matches_oracle():
    pts = _totals(7, 2, 9)
    buckets = C.from_affine_ints(pts).map(lambda a: a.reshape(8, 2, 9))
    got = port_affine(M._weighted_bucket_reduce(buckets))
    want = []
    for i in range(2):
        acc = None
        for b in range(1, 9):
            pt = pts[i * 9 + b]
            acc = H.g1_add(acc, H.g1_mul(pt, b) if pt else None)
        want.append(acc)
    assert got == want


# ---------------------------------------------------------------------------
# Whole MSM
# ---------------------------------------------------------------------------


#: Inputs that reach the edge cases of K1's recoding, sort and runs.
EDGE_CASES = ["random", "equal_scalars", "r_minus_1", "one_window", "all_infinity"]


def edge_case(case: str, pts: list, scalars: list, c: int = M.WINDOW_BITS):
    """``host_points`` output turned into one of EDGE_CASES: every
    scalar equal (one bucket per window holds every point), r - 1 (a
    carry into the top window), one nonzero digit in window 20, or every
    point at infinity."""
    if case == "equal_scalars":
        scalars = [scalars[0]] * len(scalars)
    elif case == "r_minus_1":
        scalars = [R - 1] * len(scalars)
    elif case == "one_window":
        scalars = [(s % 31 + 1) << (c * 20) for s in scalars]
    elif case == "all_infinity":
        pts = [None] * len(pts)
    return pts, scalars


@pytest.mark.parametrize("case", EDGE_CASES)
def test_msm_matches_jax_2e10(case):
    pts, scalars = edge_case(case, *host_points(8, 1 << 10, distinct=16))
    got = M.msm_ints(pts, scalars)
    assert got == JM.msm_ints(pts, scalars)
    assert got == H.g1_msm(pts, scalars)


@pytest.mark.parametrize("case", EDGE_CASES)
@pytest.mark.parametrize("n", [1, 33, 4097, 1 << 17])
def test_accum_plan_holds_every_level(case, n):
    """K1's scratch sizes (``accum_plan``) hold the partial sums of every
    reduction level, and the final pass adds at most FAN per bucket."""
    pts, scalars = host_points(10, 64)
    pts, scalars = edge_case(case, pts, scalars)
    c = M.WINDOW_BITS
    reps = -(-n // 64)
    tiled = F.from_ints(scalars, F.FR, to_mont=False).repeat(1, reps)[:, :n]
    pinf = torch.tensor([pt is None for pt in pts]).repeat(reps)[:n]
    digits = MK.digit_stream(tiled, pinf, c).to(torch.int64)
    keys = torch.arange(digits.shape[0]).unsqueeze(1) * MK.num_buckets(c) + digits.abs()
    counts = torch.bincount(keys[digits != 0], minlength=digits.shape[0] * MK.num_buckets(c))
    levels, table_len, cap_1, cap_2 = MK.accum_plan(n, c)
    keys = digits.shape[0] * MK.num_buckets(c)
    assert table_len == -(-n // MK.CHUNK) * keys + keys + (levels + 1) * (keys + 1)
    per_level = [-(-counts // (MK.RUN * MK.FAN ** (lvl - 1))) for lvl in range(1, levels + 1)]
    assert int(per_level[0].sum()) <= cap_1
    assert all(int(p.sum()) <= cap_2 for p in per_level[1:])
    assert int(per_level[-1].max()) <= MK.FAN
    assert levels == 1 or MK.RUN * MK.FAN ** (levels - 1) < n


def test_k1_constants_match_its_source():
    """The wrapper sizes K1's scratch with the constants that
    csrc/msm_accum.cu defines, and KEYS_MAX holds every c <= 7."""
    src = (MK.cuda_build.CSRC / "msm_accum.cu").read_text()
    defines = dict(re.findall(r"^#define (\w+) (\d+)$", src, flags=re.M))
    for name in ("RUN", "FAN", "KEYS_MAX"):
        assert int(defines[name]) == getattr(MK, name), name
    assert 32 * int(defines["SCALARS_PER_LANE"]) == MK.CHUNK
    assert all(MK.num_windows(c) * MK.num_buckets(c) <= MK.KEYS_MAX for c in range(2, 8))
    assert MK.num_windows(8) * MK.num_buckets(8) > MK.KEYS_MAX


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA entry points raise on CPU tensors: no path falls back to
    the plain versions."""
    batch = M.affine_from_ints(host_points(11, 12)[0])
    sc = F.from_ints(list(range(12)), F.FR, to_mont=False)
    with pytest.raises(ValueError, match="CUDA device"):
        MK._accumulate_cuda(batch.x, batch.y, batch.inf, sc, 6)
    with pytest.raises(ValueError, match=r"W \* B <= 2560"):
        MK._accumulate_cuda(batch.x, batch.y, batch.inf, sc, 8)
    totals = C.from_affine_ints(host_points(11, 12)[0]).map(lambda a: a.reshape(8, 3, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        MK._join_cuda(totals, 6)


def test_msm_all_zero_scalars_is_infinity():
    pts, _ = host_points(9, 16)
    assert M.msm_ints(pts, [0] * 16) is None
