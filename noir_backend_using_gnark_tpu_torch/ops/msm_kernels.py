"""The two Pippenger kernels: bucket accumulation (K1) and window join (K2).

Counterpart of ``noir_backend_using_gnark_tpu/ops/msm_pallas.py``:

  * :func:`accumulate_buckets` replaces ``accumulate_buckets_pallas`` and
    keeps its contract: Jacobian bucket sums S[w][b] of shape (W, B),
    B = 2^(c-1) + 1, bucket 0 at infinity. On the card it launches
    ``csrc/msm_accum.cu``, which recodes the scalars, sorts the
    (window, digit) pairs by bucket and sums them in fixed-length runs;
  * :func:`join_windows` replaces ``join_windows_pallas``: for totals
    T[k][w] of K <= 8 MSMs it returns sum_w 2^(c*w) T[k][w]. On the card
    it launches ``csrc/msm_join.cu``.

Beside each wrapper sits its plain version, written from the JAX
package's definition of the same function (``ops/msm.py::
accumulate_buckets`` and ``_join_windows``) over the complete curve
formulas of :mod:`.curve`, evaluated with the plain field versions
(``curve.PLAIN``), so that on the card they do not run on kernel K3
either. A wrapper takes the plain version only for
tensors on the CPU; for CUDA tensors it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from .. import cuda_build
from . import curve as C
from . import field as F

K1 = cuda_build.Kernel(
    "msm_accum",
    "msm_accum.cu",
    "msm_accumulate",
    [ctypes.c_void_p] * 10
    + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [ctypes.c_longlong] * 3,
)
K2 = cuda_build.Kernel(
    "msm_join",
    "msm_join.cu",
    "msm_join",
    [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int, ctypes.c_int],
)

#: Largest window width whose signed digits fit the int8 digit stream
#: (magnitudes reach 2^(c-1)).
MAX_WINDOW_BITS = 7
#: Smallest window width whose signed recoding keeps every carry: the
#: top window's carry needs c * W >= 255 bits, and at c = 2 (W = 127)
#: c * W = 254, so a scalar whose top window carries (r - 1, for one)
#: would lose it. The JAX package's ``signed_digits`` shares the flaw
#: at c = 2 and is left as it is, as the reference.
MIN_WINDOW_BITS = 3
#: K1's constants as ``csrc/msm_accum.cu`` defines them, which size its
#: scratch (the C entry refuses smaller scratch): sorted pairs summed per
#: thread in registers (RUN), partial sums of one bucket added per
#: thread in each later level (FAN), scalars per warp in the sort
#: (CHUNK), and the most (window, bucket) keys its histograms hold.
RUN = 16
FAN = 2
CHUNK = 256
KEYS_MAX = 2560


def num_windows(c: int, nbits: int = 254) -> int:
    return -(-nbits // c)


def num_buckets(c: int) -> int:
    return (1 << (c - 1)) + 1


def extract_digits(scalars: torch.Tensor, c: int, num_w: int) -> torch.Tensor:
    """Canonical limb scalars (8, N) -> unsigned c-bit digits (W, N) int64."""
    s64 = scalars.to(torch.int64) & 0xFFFFFFFF
    out = []
    for w in range(num_w):
        bit0 = w * c
        li, off = bit0 // 32, bit0 % 32
        lo = s64[li] >> off
        if off + c > 32 and li + 1 < F.NUM_LIMBS:
            lo = lo | (s64[li + 1] << (32 - off))
        out.append(lo & ((1 << c) - 1))
    return torch.stack(out, dim=0)


def signed_digits(scalars: torch.Tensor, c: int, num_w: int):
    """Signed-window recoding: (magnitudes, negative) both (W, N).

    A digit above 2^(c-1) becomes digit - 2^c with a carry into the next
    window, so magnitudes are at most 2^(c-1). Exact whenever the scalar
    fits in num_w * c - 1 bits (Fr < 2^254 with c * W >= 255)."""
    digits = extract_digits(scalars, c, num_w)
    half, full = 1 << (c - 1), 1 << c
    carry = torch.zeros_like(digits[0])
    mags, negs = [], []
    for w in range(num_w):
        t = digits[w] + carry
        neg = t > half
        mags.append(torch.where(neg, full - t, t))
        negs.append(neg)
        carry = neg.to(torch.int64)
    return torch.stack(mags, dim=0), torch.stack(negs, dim=0)


def digit_stream(scalars: torch.Tensor, pinf: torch.Tensor, c: int) -> torch.Tensor:
    """(W, N) int8 signed digits, 0 for points at infinity: the plain
    path's recoding (the kernel recodes on the device)."""
    if c > MAX_WINDOW_BITS or c < MIN_WINDOW_BITS:
        # A magnitude of 2^(c-1) = 128 at c = 8 wraps in int8 and would
        # silently drop those points from every bucket; below c = 3 the
        # top window's carry is lost (see MIN_WINDOW_BITS).
        raise ValueError(
            f"window width c={c}: the int8 digit stream needs "
            f"{MIN_WINDOW_BITS} <= c <= {MAX_WINDOW_BITS}"
        )
    mags, negs = signed_digits(scalars, c, num_windows(c))
    digits = torch.where(negs, -mags, mags)
    digits = torch.where(pinf.unsqueeze(0), torch.zeros_like(digits), digits)
    return digits.to(torch.int8).contiguous()


# ---------------------------------------------------------------------------
# K1: bucket accumulation
# ---------------------------------------------------------------------------


def _plain_lanes(n: int) -> int:
    """Lanes of the plain scan: a power of two near n / 64 (<= 4096),
    which keeps the lane fold (W * B * L additions) below the scan's
    W * N while the scan stays at about 64 steps."""
    return 1 << max(0, min(12, (n // 64).bit_length() - 1))


def _accumulate_plain(px, py, digits, c: int) -> C.JacobianPoint:
    """Lane-parallel bucket scan (ops/msm.py::accumulate_buckets): each
    of L lanes per window keeps a private table; step t adds point
    t * L + l into its lane's bucket |digit| by gather, complete mixed
    add and scatter; a pairwise fold then sums the L tables."""
    w_count, n = digits.shape
    nb = num_buckets(c)
    lanes = _plain_lanes(n)
    pad = (-n) % lanes
    if pad:
        digits = torch.cat([digits, digits.new_zeros((w_count, pad))], dim=1)
        px = torch.cat([px, px.new_zeros((F.NUM_LIMBS, pad))], dim=1)
        py = torch.cat([py, py.new_zeros((F.NUM_LIMBS, pad))], dim=1)
    device = px.device
    tbl = C.infinity((w_count, lanes, nb), device).map(lambda a: a.clone())
    for t in range(digits.shape[1] // lanes):
        sl = slice(t * lanes, (t + 1) * lanes)
        d = digits[:, sl].to(torch.int64)
        mag = d.abs()
        idx = mag.reshape(1, w_count, lanes, 1).expand(F.NUM_LIMBS, w_count, lanes, 1)
        cur = tbl.map(lambda a: torch.gather(a, 3, idx).squeeze(-1))
        qx = px[:, sl].unsqueeze(1).expand(F.NUM_LIMBS, w_count, lanes)
        qy = py[:, sl].unsqueeze(1).expand(F.NUM_LIMBS, w_count, lanes)
        qy = F.select(d < 0, C.PLAIN.neg(qy), qy)
        new = C.add_mixed(cur, qx, qy, mag == 0, C.PLAIN)
        for a, v in zip(tbl, new):
            a.scatter_(3, idx, v.unsqueeze(-1))
    while tbl.x.shape[2] > 1:
        h = tbl.x.shape[2] // 2
        tbl = C.add(tbl.map(lambda a: a[:, :, :h]), tbl.map(lambda a: a[:, :, h:]), C.PLAIN)
    return tbl.map(lambda a: a[:, :, 0].contiguous())


def accum_plan(n: int, c: int) -> tuple[int, int, int, int]:
    """K1's scratch for n points: (levels, table_len, cap_1, cap_2).

    A bucket with n_k pairs has ceil(n_k / (RUN * FAN^(l-1))) partial
    sums at level l; summed over the K = W * B buckets that is at most
    cap_l = W * n // (RUN * FAN^(l-1)) + K, the size of level l's
    scratch. ``levels`` is the least L >= 1 with RUN * FAN^L >= n, so
    the final pass adds at most FAN partials per bucket. The int table
    holds the sort's per-chunk counts (ceil(n / CHUNK), K), the key
    counts (K) and the offsets of every level (levels + 1, K + 1)."""
    keys = num_windows(c) * num_buckets(c)
    levels = 1
    while RUN * FAN**levels < n:
        levels += 1
    table_len = -(-n // CHUNK) * keys + keys + (levels + 1) * (keys + 1)
    caps = [num_windows(c) * n // (RUN * FAN ** (lvl - 1)) + keys for lvl in (1, 2)]
    return levels, table_len, caps[0], caps[1]


def _accumulate_cuda(px, py, pinf, scalars, c: int) -> C.JacobianPoint:
    n = px.shape[-1]
    w_count, nb = num_windows(c), num_buckets(c)
    if c < MIN_WINDOW_BITS or w_count * nb > KEYS_MAX:
        # The signed recoding needs c >= 3 (MIN_WINDOW_BITS); each warp of
        # the sort keeps a shared histogram of KEYS_MAX (window, bucket)
        # keys, so c <= 7.
        raise ValueError(
            f"window width c={c}: msm_accum needs c >= {MIN_WINDOW_BITS} and W * B <= {KEYS_MAX} keys"
        )
    if w_count * n >= 1 << 31:
        # The payload word is a 31-bit pair index and the sign bit.
        raise ValueError(f"msm_accum: {n} points need W * N < 2^31 sorted pairs")
    for name, t, dt, shape in (
        ("px", px, torch.int32, (F.NUM_LIMBS, n)),
        ("py", py, torch.int32, (F.NUM_LIMBS, n)),
        ("pinf", pinf, torch.bool, (n,)),
        ("scalars", scalars, torch.int32, (F.NUM_LIMBS, n)),
    ):
        cuda_build.check_tensor(t, f"msm_accum.{name}", dt, shape)
    _, table_len, cap_a, cap_b = accum_plan(n, c)
    kw = dict(dtype=torch.int32, device=px.device)
    out = torch.empty((3 * F.NUM_LIMBS, w_count, nb), **kw)
    pts = torch.empty((n, 2 * F.NUM_LIMBS), **kw)
    table = torch.empty((table_len,), **kw)
    payload = torch.empty((w_count * n,), **kw)
    part_a = torch.empty((3 * F.NUM_LIMBS, cap_a), **kw)
    part_b = torch.empty((3 * F.NUM_LIMBS, cap_b), **kw)
    K1.launch(
        out.data_ptr(), pts.data_ptr(), table.data_ptr(), payload.data_ptr(),
        part_a.data_ptr(), part_b.data_ptr(),
        px.data_ptr(), py.data_ptr(), pinf.data_ptr(), scalars.data_ptr(),
        n, w_count, nb, c, table_len, cap_a, cap_b,
    )
    return C.JacobianPoint(out[: F.NUM_LIMBS], out[F.NUM_LIMBS : 2 * F.NUM_LIMBS], out[2 * F.NUM_LIMBS :])


def accumulate_buckets(px, py, pinf, scalars, c: int) -> C.JacobianPoint:
    """Bucket sums S as a Jacobian batch (W, B) for affine points
    ``px``, ``py`` (8, N) Fq Montgomery, ``pinf`` (N,) bool and
    canonical scalars (8, N)."""
    if px.device.type == "cpu":
        return _accumulate_plain(px, py, digit_stream(scalars, pinf, c), c)
    return _accumulate_cuda(px.contiguous(), py.contiguous(), pinf.contiguous(), scalars.contiguous(), c)


# ---------------------------------------------------------------------------
# K2: window join
# ---------------------------------------------------------------------------


def _join_plain(totals: C.JacobianPoint, c: int) -> C.JacobianPoint:
    """Horner over windows, highest first (ops/msm.py::_join_windows)."""
    w_count = totals.x.shape[-1]
    acc = C.infinity(totals.batch_shape[:-1], totals.x.device)
    for w in range(w_count - 1, -1, -1):
        for _ in range(c):
            acc = C.double(acc, C.PLAIN)
        acc = C.add(acc, totals.map(lambda a: a[..., w]), C.PLAIN)
    return acc


def _join_cuda(totals: C.JacobianPoint, c: int, rounds: torch.Tensor | None = None) -> C.JacobianPoint:
    """``rounds``, if given, an int32 (K,) tensor on the card, receives
    the rounds of dependent Montgomery products each join ran."""
    k_count, w_count = totals.x.shape[1:]
    if k_count > 8 or w_count > 128:
        raise ValueError(f"join kernel needs K <= 8, W <= 128; got K={k_count}, W={w_count}")
    coords = [a.contiguous() for a in totals]
    for name, t in zip("xyz", coords):
        cuda_build.check_tensor(t, f"msm_join.{name}", torch.int32, (F.NUM_LIMBS, k_count, w_count))
    out = torch.empty((3 * F.NUM_LIMBS, k_count), dtype=torch.int32, device=coords[0].device)
    if rounds is not None:
        cuda_build.check_tensor(rounds, "msm_join.rounds", torch.int32, (k_count,))
    K2.launch(out.data_ptr(), 0 if rounds is None else rounds.data_ptr(),
              *(t.data_ptr() for t in coords), k_count, w_count, c)
    return C.JacobianPoint(out[: F.NUM_LIMBS], out[F.NUM_LIMBS : 2 * F.NUM_LIMBS], out[2 * F.NUM_LIMBS :])


def join_windows(totals: C.JacobianPoint, c: int) -> C.JacobianPoint:
    """sum_w 2^(c*w) * totals[..., w]: totals has batch (W,) or (K, W);
    the result has batch () or (K,)."""
    squeeze = totals.x.ndim == 2
    if squeeze:
        totals = totals.map(lambda a: a.unsqueeze(1))
    if totals.x.device.type == "cpu":
        out = _join_plain(totals, c)
    else:
        out = _join_cuda(totals, c)
    return out.map(lambda a: a[:, 0]) if squeeze else out
