"""Batched BN254 prime-field arithmetic on torch tensors.

Counterpart of ``noir_backend_using_gnark_tpu/ops/field.py``.

  * A batch of field elements is an ``int32`` tensor of shape
    ``(8, *batch)``: 8 little-endian 32-bit limbs (bit patterns), limb-
    major, so one limb of the whole batch is contiguous. The integer is
    the one the JAX package holds as 16x16-bit limbs; ``convert.py``
    moves between the two layouts exactly.
  * Elements are in Montgomery form with R = 2^256 end to end and are
    always fully reduced into [0, p), so equal values have equal bits.
  * ``mont_mul``, ``add``, ``sub`` and ``neg`` are the wrappers of
    kernel K3 (``csrc/field.cu``): on a CUDA tensor they launch it, on a
    CPU tensor they run the plain version in this module, which widens
    to ``int64`` (torch's CPU ``uint32`` lacks ``+``, ``-``, ``>>`` and
    comparisons) and follows the JAX package's CIOS limb by limb.
  * Inversion and batch inversion are plain code over those wrappers;
    ``batch_inv`` uses the log-depth scan of :mod:`.scan_utils`.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from .. import cuda_build
from ..utils import bigint

NUM_LIMBS = 8
_M32 = 0xFFFFFFFF
_M16 = 0xFFFF
R_INT = 1 << 256


class FieldSpec(NamedTuple):
    """A prime field in the 8x32-bit limb scheme (hashable, by value)."""

    name: str
    modulus: int
    field_id: int  # the kernel's field selector: 0 = Fr, 1 = Fq
    n0_16: int  # -p^{-1} mod 2^16, for the plain 16-bit CIOS


def make_field_spec(name: str, modulus: int, field_id: int) -> FieldSpec:
    return FieldSpec(name, modulus, field_id, (-pow(modulus, -1, 1 << 16)) % (1 << 16))


FR = make_field_spec("bn254_fr", bigint.FR_MODULUS, 0)
FQ = make_field_spec("bn254_fq", bigint.FQ_MODULUS, 1)

K3 = cuda_build.Kernel(
    "field",
    "field.cu",
    "field_op",
    [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong],
)
_OP_MUL, _OP_ADD, _OP_SUB, _OP_NEG = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Host <-> limb conversions
# ---------------------------------------------------------------------------


def ints_to_limbs(values) -> np.ndarray:
    """Host ints in [0, 2^256) -> (8, N) int32 limb array."""
    values = list(values)
    if not values:
        return np.zeros((NUM_LIMBS, 0), np.int32)
    buf = b"".join(int(v).to_bytes(32, "little") for v in values)
    arr = np.frombuffer(buf, "<u4").reshape(-1, NUM_LIMBS)
    return arr.T.copy().view(np.int32)


def limbs_to_ints(arr) -> list:
    """(8, N) limb array (numpy or tensor) -> host ints."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    if arr.ndim == 1:
        arr = arr[:, None]
    raw = np.ascontiguousarray(arr.T).astype("<u4", copy=False).tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(arr.shape[1])]


def from_ints(values, spec: FieldSpec, to_mont: bool = True, device="cpu") -> torch.Tensor:
    """Host ints -> (8, N) tensor, Montgomery form by default (done on
    the host: exact and needs no kernel)."""
    p = spec.modulus
    vals = [int(v) % p for v in values]
    if to_mont:
        vals = [v * R_INT % p for v in vals]
    return torch.from_numpy(ints_to_limbs(vals)).to(device)


def to_ints(x: torch.Tensor, spec: FieldSpec, from_mont: bool = True) -> list:
    """(8, N) tensor -> host ints (undoing Montgomery form)."""
    vals = limbs_to_ints(x.reshape(NUM_LIMBS, -1))
    if from_mont:
        r_inv = pow(R_INT, -1, spec.modulus)
        vals = [v * r_inv % spec.modulus for v in vals]
    return vals


def const(value: int, spec: FieldSpec, device, batch_shape=(), mont: bool = True) -> torch.Tensor:
    """A single element broadcast (as a view) over ``batch_shape``."""
    v = int(value) % spec.modulus
    if mont:
        v = v * R_INT % spec.modulus
    t = torch.from_numpy(ints_to_limbs([v])).to(device)
    return t.reshape((NUM_LIMBS,) + (1,) * len(batch_shape)).expand((NUM_LIMBS, *batch_shape))


def one_mont(spec: FieldSpec, batch_shape=(), device="cpu") -> torch.Tensor:
    return const(1, spec, device, batch_shape)


def zeros(batch_shape=(), device="cpu") -> torch.Tensor:
    return torch.zeros((NUM_LIMBS, *batch_shape), dtype=torch.int32, device=device)


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=0)


def eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a == b).all(dim=0)


def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Lanewise a if cond else b (cond has the batch shape)."""
    return torch.where(cond.unsqueeze(0), a, b)


# ---------------------------------------------------------------------------
# Plain versions (int64 limb rows)
# ---------------------------------------------------------------------------

_CONST_CACHE: dict = {}


def _p_rows(spec: FieldSpec, device, bits: int):
    """The modulus as a (k, 1) int64 column of 32- or 16-bit limbs."""
    key = (spec.name, str(device), bits)
    if key not in _CONST_CACHE:
        k = 256 // bits
        limbs = [(spec.modulus >> (bits * i)) & ((1 << bits) - 1) for i in range(k)]
        _CONST_CACHE[key] = torch.tensor(limbs, dtype=torch.int64, device=device)
    return _CONST_CACHE[key]


def _wide_rows(a: torch.Tensor):
    a64 = a.to(torch.int64) & _M32
    return [a64[i] for i in range(NUM_LIMBS)]


def _narrow(rows) -> torch.Tensor:
    x = torch.stack(rows, dim=0)
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def _carry(rows):
    out, c = [], 0
    for r in rows:
        s = r + c
        out.append(s & _M32)
        c = s >> 32
    return out, c


def _sub_rows(a_rows, b_rows):
    out, br = [], 0
    for ai, bi in zip(a_rows, b_rows):
        s = ai - bi - br
        out.append(s & _M32)
        br = (s >> 63) & 1
    return out, br


def _reduce_once(rows, carry, spec: FieldSpec):
    """rows + carry * 2^256 < 2p -> the canonical representative."""
    p = _p_rows(spec, rows[0].device, 32)
    d, br = _sub_rows(rows, [p[i] for i in range(NUM_LIMBS)])
    use_d = (carry > 0) | (br == 0)
    return [torch.where(use_d, di, ri) for di, ri in zip(d, rows)]


def _bcast(a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    return a.expand(shape), b.expand(shape)


def _add_plain(a, b, spec: FieldSpec):
    a, b = _bcast(a, b)
    s, c = _carry([x + y for x, y in zip(_wide_rows(a), _wide_rows(b))])
    return _narrow(_reduce_once(s, c, spec))


def _sub_plain(a, b, spec: FieldSpec):
    a, b = _bcast(a, b)
    d, br = _sub_rows(_wide_rows(a), _wide_rows(b))
    p = _p_rows(spec, a.device, 32)
    dp, _ = _carry([di + p[i] * br for i, di in enumerate(d)])
    return _narrow(dp)


def _neg_plain(a, spec: FieldSpec):
    p = _p_rows(spec, a.device, 32)
    d, _ = _sub_rows([p[i] for i in range(NUM_LIMBS)], _wide_rows(a))
    z = is_zero(a)
    return _narrow([torch.where(z, torch.zeros_like(x), x) for x in d])


def _mont_mul_plain(a, b, spec: FieldSpec):
    """CIOS over 16-bit limbs held in int64, the JAX package's scheme
    (ops/field.py::mont_mul) without its lazy-carry masks: int64 holds
    the unnormalized column sums exactly."""
    a, b = _bcast(a, b)
    bshape = a.shape[1:]
    a16 = (a.to(torch.int64) & _M32).unsqueeze(1)
    a16 = torch.cat([a16 & _M16, a16 >> 16], dim=1).reshape((16,) + bshape)
    b64 = b.to(torch.int64) & _M32
    b16 = torch.stack([b64 & _M16, b64 >> 16], dim=1).reshape((16,) + bshape)
    p16 = _p_rows(spec, a.device, 16).reshape((16,) + (1,) * len(bshape))
    n0 = spec.n0_16
    t = torch.zeros((16,) + bshape, dtype=torch.int64, device=a.device)
    zero_row = torch.zeros((1,) + bshape, dtype=torch.int64, device=a.device)
    for i in range(16):
        t += a16[i] * b16
        m = (t[0] * n0) & _M16
        t += m * p16
        carry0 = t[0] >> 16
        t = torch.cat([t[1:], zero_row], dim=0)
        t[0] += carry0
    rows, c = _carry([t[2 * k] + (t[2 * k + 1] << 16) for k in range(NUM_LIMBS)])
    return _narrow(_reduce_once(rows, c, spec))


# ---------------------------------------------------------------------------
# K3 wrappers
# ---------------------------------------------------------------------------


def _operand(t: torch.Tensor, batch: tuple):
    """A contiguous operand and its read period for the kernel."""
    tb = tuple(t.shape[1:])
    while tb and tb[0] == 1:
        tb = tb[1:]
    numel = int(np.prod(tb)) if tb else 1
    n = int(np.prod(batch)) if batch else 1
    if numel == 1:
        return t.reshape(NUM_LIMBS, -1)[:, :1].contiguous(), 1
    if tb == tuple(batch[len(batch) - len(tb):]):
        return t.contiguous(), numel
    return t.expand((NUM_LIMBS, *batch)).contiguous(), n


def _launch(op: int, a: torch.Tensor, b, spec: FieldSpec) -> torch.Tensor:
    shape = torch.broadcast_shapes(a.shape, b.shape) if b is not None else a.shape
    if shape[0] != NUM_LIMBS:
        raise ValueError(f"field tensors have {NUM_LIMBS} limbs on axis 0, got shape {tuple(shape)}")
    batch = tuple(shape[1:])
    n = int(np.prod(batch)) if batch else 1
    out = torch.empty(shape, dtype=torch.int32, device=a.device)
    if n == 0:
        return out
    a2, pa = _operand(a, batch)
    b2, pb = _operand(b, batch) if b is not None else (a2, pa)
    for name, t in (("a", a2), ("b", b2)):
        cuda_build.check_tensor(t, f"field.{name}", torch.int32)
    K3.launch(op, spec.field_id, out.data_ptr(), a2.data_ptr(), b2.data_ptr(), n, pa, pb)
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Montgomery product a*b*R^-1 mod p (broadcasting over the batch)."""
    if a.device.type == "cpu":
        return _mont_mul_plain(a, b, spec)
    return _launch(_OP_MUL, a, b, spec)


def add(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a + b) mod p."""
    if a.device.type == "cpu":
        return _add_plain(a, b, spec)
    return _launch(_OP_ADD, a, b, spec)


def sub(a: torch.Tensor, b: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(a - b) mod p."""
    if a.device.type == "cpu":
        return _sub_plain(a, b, spec)
    return _launch(_OP_SUB, a, b, spec)


def neg(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """(-a) mod p, 0 maps to 0."""
    if a.device.type == "cpu":
        return _neg_plain(a, spec)
    return _launch(_OP_NEG, a, None, spec)


def mont_sqr(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    return mont_mul(a, a, spec)


def to_mont(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Canonical -> Montgomery form (multiply by R^2)."""
    return mont_mul(a, const(R_INT * R_INT % spec.modulus, spec, a.device, mont=False)
                    .reshape((NUM_LIMBS,) + (1,) * (a.ndim - 1)), spec)


def from_mont(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Montgomery -> canonical form (multiply by 1)."""
    return mont_mul(a, const(1, spec, a.device, mont=False)
                    .reshape((NUM_LIMBS,) + (1,) * (a.ndim - 1)), spec)


# ---------------------------------------------------------------------------
# Exponentiation / inversion
# ---------------------------------------------------------------------------


def mont_pow_const(a: torch.Tensor, exponent: int, spec: FieldSpec = FR) -> torch.Tensor:
    """a^exponent for a host-int exponent, batched (square and multiply)."""
    e = int(exponent)
    result = one_mont(spec, a.shape[1:], a.device)
    base = a
    while e:
        if e & 1:
            result = mont_mul(result, base, spec)
        e >>= 1
        if e:
            base = mont_sqr(base, spec)
    return result.contiguous()


def inv(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """a^-1 mod p via Fermat (0 maps to 0), batched."""
    return mont_pow_const(a, spec.modulus - 2, spec)


def batch_inv(a: torch.Tensor, spec: FieldSpec = FR) -> torch.Tensor:
    """Montgomery-trick batch inversion along the last axis: two
    log-depth product scans and one Fermat inversion. Zero entries map
    to zero, like :func:`inv`."""
    from . import scan_utils

    n = a.shape[-1]
    one = one_mont(spec, a.shape[1:], a.device)
    zmask = is_zero(a)
    safe = select(zmask, one, a)

    def mul(x, y):
        return mont_mul(x, y, spec)

    prefix = scan_utils.inclusive_scan(mul, safe)
    total_inv = inv(prefix[..., -1:], spec)
    suffix = torch.flip(scan_utils.inclusive_scan(mul, torch.flip(safe, dims=(-1,))), dims=(-1,))
    one1 = one[..., :1]
    prefix_excl = torch.cat([one1, prefix[..., :-1]], dim=-1)
    suffix_excl = torch.cat([suffix[..., 1:], one1], dim=-1) if n > 1 else one
    out = mont_mul(mont_mul(prefix_excl, suffix_excl, spec), total_inv, spec)
    return select(zmask, torch.zeros_like(out), out)
