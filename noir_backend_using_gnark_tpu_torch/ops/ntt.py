"""Radix-2 NTT / INTT over BN254 Fr on torch tensors.

Counterpart of ``noir_backend_using_gnark_tpu/ops/ntt.py`` (and of the
TPU's MXU forms in ``ops/mxu_ntt.py``, which compute the same elements):
natural order in, natural order out, batched along the last axis, the
inverse transform including its 1/n.

:func:`transform` is the wrapper of kernel K4 (``csrc/ntt.cu``): on a
CUDA tensor it launches the kernel, on a CPU tensor it runs the plain
version beside it (bit reversal, then log2 n butterfly stages over the
plain field versions). The kernel splits log2 n into passes of at most
``LMAX`` bits (:func:`ntt_plan`); :func:`_transform_four_step_plain`
follows its pass plan and index math on the CPU, for the tests. Coset
transforms scale by the coset powers with one K3 multiply on the way in
or out. The twiddle and coset tables are geometric series built on the
tensor's device by doubling (:func:`power_table`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import cuda_build
from ..utils import bigint
from . import field as F

FR = F.FR

K4 = cuda_build.Kernel(
    "ntt",
    "ntt.cu",
    "ntt_run",
    [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int],
)


#: K4's constants as ``csrc/ntt.cu`` defines them: the largest
#: sub-transform of one pass (2^LMAX elements, held in shared memory),
#: the sub-transforms a block holds side by side (COLS), and the most
#: passes of any size up to 2^28.
LMAX = 9
COLS = 4
MAX_PASSES = 4


def ntt_plan(logn: int, lmax: int = LMAX) -> tuple:
    """K4's split of log2 n into passes (``ntt_split`` in ``ntt.cu``):
    the fewest parts of at most ``lmax`` bits, as equal as they can be,
    the larger ones first."""
    parts = max(1, -(-logn // lmax))
    base, rem = divmod(logn, parts)
    return tuple(base + (p < rem) for p in range(parts))


def power_table(base: int, n: int, device) -> torch.Tensor:
    """[base^0 .. base^{n-1}] mod r in Montgomery form, (8, n), built on
    ``device`` by doubling: [b^0 .. b^{m-1}] times b^m gives the next m
    powers, so ceil(log2 n) field products (K3 launches on the card)
    instead of n host steps. The exact field gives the host chain's
    values."""
    r = FR.modulus
    steps = max(n - 1, 0).bit_length()
    doubling = [pow(base, 1 << i, r) for i in range(steps)]
    b_pows = F.from_ints(doubling, FR, device=device) if steps else None
    out = F.one_mont(FR, (1,), device).contiguous()
    for i in range(steps):
        out = torch.cat([out, F.mont_mul(out[:, : n - (1 << i)], b_pows[:, i : i + 1], FR)], dim=1)
    return out


def bit_reverse_perm(n: int) -> np.ndarray:
    k = n.bit_length() - 1
    idx = np.arange(n, dtype=np.int64)
    rev = np.zeros_like(idx)
    for i in range(k):
        rev |= ((idx >> i) & 1) << (k - 1 - i)
    return rev


class Domain:
    """Radix-2 evaluation domain of size n = 2^k over Fr, with its
    tables built on first use for each device."""

    _cache: dict = {}

    def __init__(self, n: int):
        if n & (n - 1) or n == 0:
            raise ValueError("domain size must be a power of two")
        k = n.bit_length() - 1
        if k > bigint.FR_TWO_ADICITY:
            raise ValueError(f"domain 2^{k} exceeds BN254 Fr 2-adicity 28")
        self.n = n
        self.k = k
        self.w_int = pow(bigint.FR_ROOT_OF_UNITY, 1 << (bigint.FR_TWO_ADICITY - k), FR.modulus)
        self.w_inv_int = pow(self.w_int, -1, FR.modulus)
        self.n_inv_int = pow(n, -1, FR.modulus)
        self._tables: dict = {}

    @classmethod
    def get(cls, n: int) -> "Domain":
        if n not in cls._cache:
            cls._cache[n] = cls(n)
        return cls._cache[n]

    def _table(self, name: str, device, build):
        key = (name, str(torch.device(device)))
        if key not in self._tables:
            self._tables[key] = build()
        return self._tables[key]

    def fwd_table(self, device) -> torch.Tensor:
        return self._table("fwd", device, lambda: power_table(self.w_int, max(self.n // 2, 1), device))

    def inv_table(self, device) -> torch.Tensor:
        return self._table("inv", device, lambda: power_table(self.w_inv_int, max(self.n // 2, 1), device))

    def x_powers(self, device) -> torch.Tensor:
        """[w^0 .. w^{n-1}] (8, n): the domain points."""
        return self._table("x", device, lambda: power_table(self.w_int, self.n, device))

    def n_inv(self, device) -> torch.Tensor:
        return self._table("n_inv", device, lambda: F.const(self.n_inv_int, FR, device).reshape(8, 1).contiguous())

    def rev(self, device) -> torch.Tensor:
        return self._table("rev", device, lambda: torch.from_numpy(bit_reverse_perm(self.n)).to(device))


# ---------------------------------------------------------------------------
# K4 wrapper and its plain version
# ---------------------------------------------------------------------------


def _transform_plain(a: torch.Tensor, table: torch.Tensor, rev: torch.Tensor, scale=None) -> torch.Tensor:
    """Bit-reversed decimation in time (ops/ntt.py::ntt_stages)."""
    n = a.shape[-1]
    k = n.bit_length() - 1
    a = a.index_select(-1, rev)
    if scale is not None:
        a = F._mont_mul_plain(a, scale.reshape((8,) + (1,) * (a.ndim - 1)), FR)
    if k == 0:
        return a.contiguous()
    p = torch.arange(n // 2, device=a.device)
    for s in range(1, k + 1):
        half = 1 << (s - 1)
        j = p & (half - 1)
        i0 = ((p >> (s - 1)) << s) + j
        i1 = i0 + half
        tw = table.index_select(-1, j << (k - s)).reshape((8,) + (1,) * (a.ndim - 2) + (n // 2,))
        u = a.index_select(-1, i0)
        v = F._mont_mul_plain(a.index_select(-1, i1), tw, FR)
        a = a.clone()
        a[..., i0] = F._add_plain(u, v, FR)
        a[..., i1] = F._sub_plain(u, v, FR)
    return a


def _transform_four_step_plain(a: torch.Tensor, table: torch.Tensor, scale=None, lmax: int = LMAX) -> torch.Tensor:
    """The transform by K4's pass plan, for the tests (the kernel's index
    math on the CPU). With n = L_0 * ... * L_{P-1} (:func:`ntt_plan`),
    input index j = sum j_q A_q and output index k = sum k_q B_q, where
    A_q = L_0 .. L_{q-1} and B_q = L_{q+1} .. L_{P-1}:

      * pass 0 transforms digit P-1 (columns of stride A_{P-1}) and
        stores each column as a row at sum_{q<P-1} j_q B_q: the only
        transposing pass, from ``a`` to the output;
      * pass p >= 1 transforms digit q = P-1-p in place, at stride B_q;
      * each sub-transform of L_q elements is a radix-2 transform with
        the roots w^(i n / L_q) of ``table``;
      * the pass for digit q >= 1 multiplies its output k (column suffix
        s) by w^(A_{q-1} j_{q-1} (k B_q + s)), the twiddle of the next
        pass, read from ``table`` as -w^(e - n/2) for e >= n/2; the pass
        for digit 0 multiplies by ``scale``.
    """
    n = a.shape[-1]
    logn = n.bit_length() - 1
    parts = ntt_plan(logn, lmax)
    npass = len(parts)
    sizes = [1 << p for p in parts]
    log_a = [sum(parts[:q]) for q in range(npass)]
    log_b = [sum(parts[q + 1 :]) for q in range(npass)]
    x = a.reshape(F.NUM_LIMBS, -1, n)
    batch = x.shape[1]

    def power(e: torch.Tensor) -> torch.Tensor:
        e = e % n
        neg = e >= n // 2
        w = table.index_select(-1, torch.where(neg, e - n // 2, e).flatten()).reshape(F.NUM_LIMBS, *e.shape)
        return torch.where(neg.unsqueeze(0), F._neg_plain(w, FR), w)

    def sub_transform(v: torch.Tensor, q: int) -> torch.Tensor:
        size = sizes[q]
        roots = table.index_select(-1, torch.arange(max(size // 2, 1), device=a.device) * (n // size))
        return _transform_plain(v, roots, torch.from_numpy(bit_reverse_perm(size)).to(a.device))

    def finish(y: torch.Tensor, q: int, exponent) -> torch.Tensor:
        """The epilogue of the pass for digit q: twiddle or scale."""
        if q >= 1:
            return F._mont_mul_plain(y, power(exponent).unsqueeze(1), FR)
        if scale is not None:
            return F._mont_mul_plain(y, scale.reshape((F.NUM_LIMBS,) + (1,) * (y.ndim - 1)), FR)
        return y

    if npass == 1:
        out = finish(sub_transform(x, 0), 0, None)
        return out.reshape(a.shape)
    # Pass 0: digit P-1, column col = sum_{q<P-1} j_q A_q, stored as a row.
    q, size = npass - 1, sizes[-1]
    ncol = n // size
    cols = x.reshape(F.NUM_LIMBS, batch, size, ncol).transpose(-1, -2)
    col = torch.arange(ncol, device=a.device)
    k = torch.arange(size, device=a.device)
    tw_mul = col & ~((1 << log_a[q - 1]) - 1)  # A_{q-1} j_{q-1}: j_{q-1} is col's top digit
    y = finish(sub_transform(cols, q), q, tw_mul[:, None] * k[None, :])
    row = sum(((col >> log_a[d]) & (sizes[d] - 1)) << log_b[d] for d in range(npass - 1))
    out = torch.empty_like(x)
    out[..., (row[:, None] + k[None, :]).flatten()] = y.reshape(F.NUM_LIMBS, batch, n)
    # Passes 1 .. P-1: digit q in place at stride B_q.
    for q in range(npass - 2, -1, -1):
        size, stride = sizes[q], 1 << log_b[q]
        v = out.reshape(F.NUM_LIMBS, batch, 1 << log_a[q], size, stride).transpose(-1, -2)
        exponent = None
        if q >= 1:
            prefix = torch.arange(1 << log_a[q], device=a.device)
            tw_mul = (prefix & (sizes[q - 1] - 1)) << log_a[q - 1]
            k = torch.arange(size, device=a.device)
            s = torch.arange(stride, device=a.device)
            exponent = tw_mul[:, None, None] * (k[None, None, :] * stride + s[None, :, None])
        y = finish(sub_transform(v, q), q, exponent)
        out = y.transpose(-1, -2).reshape(F.NUM_LIMBS, batch, n)
    return out.reshape(a.shape)


def transform(a: torch.Tensor, table: torch.Tensor, domain: Domain, scale=None) -> torch.Tensor:
    """Radix-2 transform along the last axis with twiddle ``table``
    (8, n/2), times the single element ``scale`` when given."""
    if a.device.type == "cpu":
        return _transform_plain(a, table, domain.rev(a.device), scale)
    n = a.shape[-1]
    if n != domain.n or a.shape[0] != F.NUM_LIMBS:
        raise ValueError(f"ntt: expected (8, ..., {domain.n}), got {tuple(a.shape)}")
    a = a.contiguous()
    batch = a.numel() // (F.NUM_LIMBS * n)
    cuda_build.check_tensor(a, "ntt.a", torch.int32)
    cuda_build.check_tensor(table, "ntt.table", torch.int32, (F.NUM_LIMBS, max(n // 2, 1)))
    if scale is not None:
        cuda_build.check_tensor(scale, "ntt.scale", torch.int32, (F.NUM_LIMBS, 1))
    out = torch.empty_like(a)
    K4.launch(out.data_ptr(), a.data_ptr(), table.data_ptr(),
              None if scale is None else scale.data_ptr(), batch, domain.k)
    return out


def ntt(a: torch.Tensor, domain: Domain | None = None) -> torch.Tensor:
    """Forward NTT: coefficients -> evaluations on the subgroup."""
    domain = domain or Domain.get(a.shape[-1])
    return transform(a, domain.fwd_table(a.device), domain)


def intt(a: torch.Tensor, domain: Domain | None = None) -> torch.Tensor:
    """Inverse NTT: evaluations -> coefficients (including 1/n)."""
    domain = domain or Domain.get(a.shape[-1])
    return transform(a, domain.inv_table(a.device), domain, scale=domain.n_inv(a.device))


_COSET_CACHE: dict = {}


def coset_scale(shift: int, n: int, inverse: bool, device) -> torch.Tensor:
    """[g^0 .. g^{n-1}] (or of g^-1) as an (8, n) tensor, cached."""
    key = (shift, n, inverse, str(torch.device(device)))
    if key not in _COSET_CACHE:
        base = pow(shift, -1, FR.modulus) if inverse else shift
        _COSET_CACHE[key] = power_table(base, n, device)
    return _COSET_CACHE[key]


def _along_last(vec: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """(8, n) -> (8, 1, ..., n), broadcastable against ``like``."""
    return vec.reshape((F.NUM_LIMBS,) + (1,) * (like.ndim - 2) + (vec.shape[-1],))


def coset_ntt(a: torch.Tensor, shift: int, domain: Domain | None = None) -> torch.Tensor:
    """Evaluate on the coset g*H: scale coefficient i by g^i, then NTT."""
    scale = coset_scale(shift, a.shape[-1], False, a.device)
    return ntt(F.mont_mul(a, _along_last(scale, a), FR), domain)


def coset_intt(a: torch.Tensor, shift: int, domain: Domain | None = None) -> torch.Tensor:
    """Inverse of :func:`coset_ntt`."""
    scale = coset_scale(shift, a.shape[-1], True, a.device)
    return F.mont_mul(intt(a, domain), _along_last(scale, a), FR)
