"""Conversions between the JAX package's arrays and this port's tensors.

The JAX package holds a field element as 16 little-endian 16-bit limbs
in ``uint32`` lanes, limb-major ``(16, *batch)``; the port holds the same
integer (Montgomery form, R = 2^256 in both) as 8 little-endian 32-bit
limbs in ``int32``, limb-major ``(8, *batch)``. The conversion is exact
in both directions. Inputs are numpy arrays (or anything ``np.asarray``
accepts, such as a JAX array); this module imports nothing of JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def limbs16_to_32(arr) -> np.ndarray:
    """(16, *batch) 16-bit limbs -> (8, *batch) int32 32-bit limbs."""
    a = np.asarray(arr).astype(np.uint32)
    if a.shape[0] != 16:
        raise ValueError(f"expected 16 limbs on axis 0, got shape {a.shape}")
    if (a > 0xFFFF).any():
        raise ValueError("16-bit limbs out of range (array not fully carried)")
    out = a[0::2] | (a[1::2] << np.uint32(16))
    return np.ascontiguousarray(out).view(np.int32)


def limbs32_to_16(t) -> np.ndarray:
    """(8, *batch) 32-bit limbs (tensor or array) -> (16, *batch) uint32."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    a = np.asarray(t)
    if a.shape[0] != 8:
        raise ValueError(f"expected 8 limbs on axis 0, got shape {a.shape}")
    u = a.view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)
    out = np.empty((16,) + u.shape[1:], np.uint32)
    out[0::2] = u & np.uint32(0xFFFF)
    out[1::2] = u >> np.uint32(16)
    return out


def field_from_jax(arr, device="cpu") -> torch.Tensor:
    return torch.from_numpy(limbs16_to_32(arr)).to(device)


def affine_from_jax(x, y, inf, device="cpu"):
    """JAX AffineBatch fields -> the port's AffineBatch."""
    from .ops.msm import AffineBatch

    return AffineBatch(
        field_from_jax(x, device),
        field_from_jax(y, device),
        torch.from_numpy(np.asarray(inf).astype(bool)).to(device),
    )


def affine_to_jax(batch):
    """The port's AffineBatch -> (x, y, inf) numpy arrays in the JAX layout."""
    return limbs32_to_16(batch.x), limbs32_to_16(batch.y), batch.inf.cpu().numpy()


def srs_from_jax(srs, device="cpu"):
    """A JAX package ``kzg.SRS`` (duck-typed) -> the port's SRS."""
    from .kzg.kzg import SRS

    g1 = srs.g1_powers
    return SRS(affine_from_jax(g1.x, g1.y, g1.inf, device), srs.g2_gen, srs.g2_alpha)


_PK_ARRAYS = ("ql", "qr", "qo", "qm", "qc", "s1", "s2", "s3", "s1_evals", "s2_evals", "s3_evals")


def pk_from_jax(pk, srs=None, device="cpu"):
    """A JAX package ``ProvingKey`` (duck-typed) -> the port's, sharing
    its host fields (wire indices, vk) and converting every polynomial.
    ``srs``: the port SRS to attach (converted from pk.srs when None)."""
    from .plonk.keys import ProvingKey, VerifyingKey

    vk = pk.vk
    vk_port = VerifyingKey(**{f: getattr(vk, f) for f in VerifyingKey.__dataclass_fields__})
    if srs is None and pk.srs is not None:
        srs = srs_from_jax(pk.srs, device)
    return ProvingKey(
        n=pk.n, nb_public=pk.nb_public, nb_vars=pk.nb_vars, k1=pk.k1, k2=pk.k2,
        wire_a=np.asarray(pk.wire_a, np.int32), wire_b=np.asarray(pk.wire_b, np.int32),
        wire_c=np.asarray(pk.wire_c, np.int32),
        vk=vk_port, srs=srs,
        **{name: field_from_jax(getattr(pk, name), device) for name in _PK_ARRAYS},
    )
