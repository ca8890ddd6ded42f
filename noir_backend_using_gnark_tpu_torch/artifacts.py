"""Artifact codecs: SRS, proving and verifying keys, proofs.

Counterpart of ``noir_backend_using_gnark_tpu/artifacts.py``; every
container is byte-for-byte the JAX package's, so artifacts move freely
between the two packages:

  * G1 points: gnark-crypto's flag scheme (top two bits of byte 0: 00
    uncompressed, 10/11 compressed with the smallest/largest y, 01
    infinity);
  * the SRS container ``NTPUSRS1``, and the gnark-crypto SRS layout
    (``save_srs_gnark`` / ``load_srs_gnark``, formats/gnark.py);
  * proving keys ``NTPUPK_2`` (polynomials stored as the JAX package's
    (16, n) 16-bit limb planes), and the legacy ``NTPUPK_1`` (the same
    without the SRS fingerprint), which is read but not written;
    verifying keys ``NTPUVK_1``;
  * proofs: raw gnark v0.8 ``WriteTo`` blobs (formats/gnark.py), or the
    expanded layout (plonk/keys.Proof) in the ``NTPUPRF1`` container.

The SRS codec is vectorized: compression packs bytes with numpy, and
decompression takes every square root in one batched exponentiation on
the device.
"""

from __future__ import annotations

import hashlib
import os
import struct

import numpy as np
import torch

from . import convert
from .errors import DeserializeKeyError, DeserializeProofError, SerializeKeysError, SerializeProofError
from .utils import bigint

Q = bigint.FQ_MODULUS
R = bigint.FR_MODULUS

_FLAG_MASK = 0b11 << 6
_FLAG_UNCOMPRESSED = 0b00 << 6
_FLAG_COMPRESSED_SMALLEST = 0b10 << 6
_FLAG_COMPRESSED_LARGEST = 0b11 << 6
_FLAG_INFINITY = 0b01 << 6


# ---------------------------------------------------------------------------
# Point codecs (host)
# ---------------------------------------------------------------------------


def g1_compress(point) -> bytes:
    """Affine int point / None -> 32 bytes."""
    if point is None:
        out = bytearray(32)
        out[0] |= _FLAG_INFINITY
        return bytes(out)
    x, y = point
    out = bytearray(x.to_bytes(32, "big"))
    out[0] |= _FLAG_COMPRESSED_LARGEST if y > (Q - y) % Q else _FLAG_COMPRESSED_SMALLEST
    return bytes(out)


def g1_decompress(data: bytes):
    if len(data) != 32:
        raise ValueError("compressed G1 point must be 32 bytes")
    flag = data[0] & _FLAG_MASK
    if flag == _FLAG_INFINITY:
        return None
    x = int.from_bytes(bytes([data[0] & ~_FLAG_MASK]) + data[1:], "big")
    if x >= Q:
        raise ValueError("G1 x-coordinate out of range")
    y2 = (x * x * x + 3) % Q
    y = pow(y2, (Q + 1) // 4, Q)  # q = 3 mod 4
    if y * y % Q != y2:
        raise ValueError("point not on curve")
    neg_y = (Q - y) % Q
    larger, smaller = (y, neg_y) if y > neg_y else (neg_y, y)
    if flag == _FLAG_COMPRESSED_LARGEST:
        return (x, larger)
    if flag == _FLAG_COMPRESSED_SMALLEST:
        return (x, smaller)
    raise ValueError(f"bad G1 compression flag {flag:#x}")


def g2_bytes(point) -> bytes:
    """G2 affine (FQ2 pair) -> 128 bytes (x.c1 || x.c0 || y.c1 || y.c0)."""
    if point is None:
        return bytes(128)
    x, y = point
    return (
        x.coeffs[1].to_bytes(32, "big")
        + x.coeffs[0].to_bytes(32, "big")
        + y.coeffs[1].to_bytes(32, "big")
        + y.coeffs[0].to_bytes(32, "big")
    )


def g2_from_bytes(data: bytes, check: bool = True):
    """Decode an uncompressed G2 point, checking curve and subgroup."""
    from .utils import hostcurve

    if len(data) != 128:
        raise ValueError("uncompressed G2 point must be 128 bytes")
    if data == bytes(128):
        return None
    c = [int.from_bytes(data[i * 32 : (i + 1) * 32], "big") for i in range(4)]
    if check and any(v >= Q for v in c):
        raise ValueError("G2 coordinate out of range")
    pt = (hostcurve.FQ2([c[1], c[0]]), hostcurve.FQ2([c[3], c[2]]))
    if check:
        if not hostcurve.g2_is_on_curve(pt):
            raise ValueError("G2 point not on curve")
        if hostcurve.g2_mul(pt, R) is not None:
            raise ValueError("G2 point not in the r-torsion subgroup")
    return pt


# ---------------------------------------------------------------------------
# Vectorized G1 batch codec
# ---------------------------------------------------------------------------


def _limbs_to_be_bytes(limbs: np.ndarray) -> np.ndarray:
    """(8, n) canonical 32-bit limbs -> (n, 32) big-endian bytes."""
    le = np.ascontiguousarray(limbs.T).astype("<u4").view(np.uint8).reshape(-1, 32)
    return np.ascontiguousarray(le[:, ::-1])


def _be_bytes_to_limbs(raw: np.ndarray) -> np.ndarray:
    """(n, 32) big-endian bytes -> (8, n) int32 limbs."""
    le = np.ascontiguousarray(np.asarray(raw, np.uint8)[:, ::-1])
    return np.ascontiguousarray(le.view("<u4").reshape(-1, 8).T).view(np.int32)


def _lex_ge(limbs: np.ndarray, const_int: int) -> np.ndarray:
    """Per-element value >= const for (8, n) limb arrays."""
    u = limbs.view(np.uint32)
    cl = [(const_int >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    result = np.zeros(u.shape[1], bool)
    decided = np.zeros(u.shape[1], bool)
    for i in range(7, -1, -1):
        result |= ~decided & (u[i] > cl[i])
        decided |= u[i] != cl[i]
    return result | ~decided


def g1_batch_compress(batch) -> np.ndarray:
    """AffineBatch -> (n, 32) compressed bytes, equal to g1_compress
    point by point."""
    from .ops import field as F

    x = F.from_mont(batch.x, F.FQ).cpu().numpy()
    y = F.from_mont(batch.y, F.FQ).cpu().numpy()
    inf = batch.inf.cpu().numpy()
    out = _limbs_to_be_bytes(x)
    largest = _lex_ge(y, (Q + 1) // 2)  # y > q - y
    out[:, 0] |= np.where(largest, _FLAG_COMPRESSED_LARGEST, _FLAG_COMPRESSED_SMALLEST).astype(np.uint8)
    out[inf] = 0
    out[inf, 0] = _FLAG_INFINITY
    return out


def g1_batch_decompress(raw: np.ndarray, device):
    """(n, 32) compressed bytes -> AffineBatch on ``device``, with the
    checks of g1_decompress; the square roots (q = 3 mod 4) come from one
    batched device exponentiation."""
    from .ops import field as F
    from .ops import msm as M

    raw = np.array(raw, np.uint8)
    flags = raw[:, 0] & _FLAG_MASK
    inf = flags == _FLAG_INFINITY
    if ((flags == _FLAG_UNCOMPRESSED) & ~inf).any():
        raise ValueError(f"bad G1 compression flag {_FLAG_UNCOMPRESSED:#x}")
    raw[:, 0] &= ~_FLAG_MASK & 0xFF
    raw[inf] = 0
    x_limbs = _be_bytes_to_limbs(raw)
    if (_lex_ge(x_limbs, Q) & ~inf).any():
        raise ValueError("G1 x-coordinate out of range")
    x_m = F.to_mont(torch.from_numpy(x_limbs).to(device), F.FQ)
    rhs = F.add(F.mont_mul(F.mont_mul(x_m, x_m, F.FQ), x_m, F.FQ), F.const(3, F.FQ, device, (1,)), F.FQ)
    y_m = F.mont_pow_const(rhs, (Q + 1) // 4, F.FQ)
    inf_t = torch.from_numpy(inf).to(device)
    if not bool((F.eq(F.mont_mul(y_m, y_m, F.FQ), rhs) | inf_t).all()):
        raise ValueError("point not on curve")
    y_is_largest = torch.from_numpy(_lex_ge(F.from_mont(y_m, F.FQ).cpu().numpy(), (Q + 1) // 2))
    want_largest = torch.from_numpy(flags == _FLAG_COMPRESSED_LARGEST)
    flip = (want_largest != y_is_largest).to(device)
    y_m = F.select(flip, F.neg(y_m, F.FQ), y_m)
    one = F.one_mont(F.FQ, (raw.shape[0],), device)
    return M.AffineBatch(F.select(inf_t, one, x_m), F.select(inf_t, one, y_m), inf_t)


# ---------------------------------------------------------------------------
# SRS cache
# ---------------------------------------------------------------------------

SRS_MAGIC = b"NTPUSRS1"


def srs_to_bytes(srs) -> bytes:
    pts = g1_batch_compress(srs.g1_powers)
    return b"".join([
        SRS_MAGIC, struct.pack(">I", pts.shape[0]), pts.tobytes(),
        g2_bytes(srs.g2_gen), g2_bytes(srs.g2_alpha),
    ])


def srs_from_bytes(data: bytes, device="cpu"):
    from .kzg.kzg import SRS

    if data[:8] != SRS_MAGIC:
        raise DeserializeKeyError("bad SRS magic")
    (count,) = struct.unpack(">I", data[8:12])
    off = 12 + 32 * count
    if len(data) < off + 256:
        raise DeserializeKeyError("SRS blob truncated")
    raw = np.frombuffer(data, np.uint8, count=32 * count, offset=12).reshape(count, 32)
    g1 = g1_batch_decompress(raw, device)
    g2_gen = g2_from_bytes(data[off : off + 128])
    g2_alpha = g2_from_bytes(data[off + 128 : off + 256])
    return SRS(g1_powers=g1, g2_gen=g2_gen, g2_alpha=g2_alpha)


def default_srs_path() -> str:
    cfg = os.environ.get("XDG_CONFIG_HOME", os.path.expanduser("~/.config"))
    return os.path.join(cfg, "noir-lang-tpu", "srs.hex")


def save_srs(srs, path: str | None = None) -> str:
    path = path or default_srs_path()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(srs_to_bytes(srs).hex())
    return path


def load_srs(path: str | None = None, device="cpu"):
    path = path or default_srs_path()
    with open(path) as f:
        return srs_from_bytes(bytes.fromhex(f.read().strip()), device)


def try_load_srs(size: int, path: str | None = None, alpha: int | None = None, device="cpu"):
    """Load-else-generate-and-save (the reference's TryLoadSRS). A new
    SRS draws a random alpha unless one is given."""
    from .kzg import kzg

    try:
        srs = load_srs(path, device)
        if srs.size >= size:
            return srs
    except (FileNotFoundError, ValueError, DeserializeKeyError):
        pass
    if alpha is None:
        alpha = int.from_bytes(os.urandom(32), "big") % R
    srs = kzg.generate_srs(size, alpha, device)
    save_srs(srs, path)
    return srs


def save_srs_gnark(srs, path: str) -> str:
    """Write the SRS in the gnark-crypto ``kzg.SRS.WriteTo`` layout,
    hex-encoded like the reference cache (backend/common.go:86-125)."""
    from .formats import gnark as gnark_fmt

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(gnark_fmt.srs_to_gnark_bytes(srs).hex())
    return path


def load_srs_gnark(path: str, device="cpu"):
    """Read a gnark-layout ``srs.hex`` (see :func:`save_srs_gnark`); the
    G1 powers are decompressed on ``device`` in one batch."""
    from .formats import gnark as gnark_fmt

    with open(path) as f:
        text = f.read().strip()
    try:
        data = bytes.fromhex(text)
    except ValueError as e:
        raise DeserializeKeyError(f"gnark SRS: {e}") from e
    return gnark_fmt.srs_from_gnark_bytes(data, device)


def srs_digest(srs) -> bytes:
    """8-byte fingerprint of an SRS: hash of ([alpha]G1, size)."""
    pts = srs.g1_ints(2)
    alpha_g = pts[1] if len(pts) > 1 else pts[0]
    h = hashlib.sha256()
    h.update(g1_compress(alpha_g))
    h.update(struct.pack(">Q", srs.size))
    return h.digest()[:8]


# ---------------------------------------------------------------------------
# Proofs and keys
# ---------------------------------------------------------------------------

PROOF_MAGIC = b"NTPUPRF1"
VK_MAGIC = b"NTPUVK_1"
PK_MAGIC = b"NTPUPK_1"  # legacy (no SRS fingerprint), still readable
PK_MAGIC_V2 = b"NTPUPK_2"


def _pack_felt(v: int) -> bytes:
    return bigint.felt_to_bytes_be(v % R)


def proof_to_bytes(proof) -> bytes:
    """A gnark-protocol proof as its raw gnark v0.8 ``WriteTo`` blob; an
    expanded proof in the ``NTPUPRF1`` container: the seven commitments,
    ``u32 BE count`` and the zeta evaluations, z(zeta*omega), then the
    two opening proofs."""
    from .formats import gnark as gnark_fmt
    from .plonk.keys import Proof

    if isinstance(proof, gnark_fmt.GnarkProof):
        return gnark_fmt.proof_to_gnark_bytes(proof)
    if not isinstance(proof, Proof):
        raise SerializeProofError(f"not a proof: {type(proof).__name__}")
    out = [PROOF_MAGIC]
    out.extend(g1_compress(pt) for pt in (proof.a, proof.b, proof.c, proof.z, proof.t0, proof.t1, proof.t2))
    out.append(struct.pack(">I", len(proof.evals)))
    out.extend(_pack_felt(v) for v in proof.evals)
    out.append(_pack_felt(proof.z_omega))
    out.append(g1_compress(proof.w_zeta))
    out.append(g1_compress(proof.w_zeta_omega))
    return b"".join(out)


def proof_from_bytes(data: bytes):
    """Either layout: the ``NTPUPRF1`` magic marks an expanded proof;
    anything else is parsed as a raw gnark v0.8 blob."""
    from .formats import gnark as gnark_fmt
    from .plonk.keys import Proof

    if data[:8] != PROOF_MAGIC:
        return gnark_fmt.proof_from_gnark_bytes(data)
    try:
        off = 8
        pts = []
        for _ in range(7):
            pts.append(g1_decompress(data[off : off + 32]))
            off += 32
        (ne,) = struct.unpack(">I", data[off : off + 4])
        off += 4
        evals = []
        for _ in range(ne):
            evals.append(int.from_bytes(data[off : off + 32], "big") % R)
            off += 32
        z_omega = int.from_bytes(data[off : off + 32], "big") % R
        w_zeta = g1_decompress(data[off + 32 : off + 64])
        w_zeta_omega = g1_decompress(data[off + 64 : off + 96])
        a, b, c, z, t0, t1, t2 = pts
        return Proof(a=a, b=b, c=c, z=z, t0=t0, t1=t1, t2=t2, evals=evals, z_omega=z_omega,
                     w_zeta=w_zeta, w_zeta_omega=w_zeta_omega)
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeProofError(str(e)) from e


def vk_to_bytes(vk) -> bytes:
    out = [VK_MAGIC, struct.pack(">QII", vk.n, vk.nb_public, 0)]
    out.append(_pack_felt(vk.generator))
    out.append(_pack_felt(vk.k1))
    out.append(_pack_felt(vk.k2))
    out.extend(g1_compress(pt) for pt in vk.commitment_list())
    out.append(g2_bytes(vk.g2_gen))
    out.append(g2_bytes(vk.g2_alpha))
    return b"".join(out)


def vk_from_bytes(data: bytes):
    from .plonk.keys import VerifyingKey

    try:
        if data[:8] != VK_MAGIC:
            raise ValueError("bad vk magic")
        n, nb_public, _ = struct.unpack(">QII", data[8:24])
        off = 24
        felts = []
        for _ in range(3):
            felts.append(int.from_bytes(data[off : off + 32], "big") % R)
            off += 32
        pts = []
        for _ in range(8):
            pts.append(g1_decompress(data[off : off + 32]))
            off += 32
        g2_gen = g2_from_bytes(data[off : off + 128])
        off += 128
        g2_alpha = g2_from_bytes(data[off : off + 128])
        return VerifyingKey(
            n=n, nb_public=nb_public, generator=felts[0], k1=felts[1], k2=felts[2],
            q_l=pts[0], q_r=pts[1], q_o=pts[2], q_m=pts[3], q_c=pts[4],
            s1=pts[5], s2=pts[6], s3=pts[7], g2_gen=g2_gen, g2_alpha=g2_alpha,
        )
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeKeyError(str(e)) from e


_PK_POLYS = ("ql", "qr", "qo", "qm", "qc", "s1", "s2", "s3", "s1_evals", "s2_evals", "s3_evals")


def pk_to_bytes(pk) -> bytes:
    """Proving key blob: metadata, wire indices, the 11 polynomials as
    (16, n) 16-bit limb planes, then the vk. The SRS is not embedded,
    only its fingerprint."""
    try:
        fp = srs_digest(pk.srs) if pk.srs is not None else bytes(8)
        out = [
            PK_MAGIC_V2,
            fp,
            struct.pack(">QIIII", pk.n, pk.nb_public, pk.nb_vars, pk.k1, pk.k2),
        ]
        for w in (pk.wire_a, pk.wire_b, pk.wire_c):
            out.append(np.asarray(w, np.int32).tobytes())
        for name in _PK_POLYS:
            arr = convert.limbs32_to_16(getattr(pk, name))
            out.append(struct.pack(">I", arr.shape[1]))
            out.append(arr.tobytes())
        out.append(vk_to_bytes(pk.vk))
        return b"".join(out)
    except (ValueError, TypeError, AttributeError) as e:
        raise SerializeKeysError(str(e)) from e


def pk_from_bytes(data: bytes, srs=None, device="cpu"):
    """``NTPUPK_2``, or the legacy ``NTPUPK_1`` (no fingerprint: the key's
    ``srs_fingerprint`` is None and is not checked)."""
    from .plonk.keys import ProvingKey

    try:
        if data[:8] == PK_MAGIC_V2:
            fp, off = data[8:16], 16
        elif data[:8] == PK_MAGIC:
            fp, off = None, 8
        else:
            raise ValueError("bad pk magic")
        n, nb_public, nb_vars, k1, k2 = struct.unpack(">QIIII", data[off : off + 24])
        off += 24
        wires = []
        for _ in range(3):
            wires.append(np.frombuffer(data[off : off + 4 * n], np.int32).copy())
            off += 4 * n
        polys = {}
        for name in _PK_POLYS:
            (cols,) = struct.unpack(">I", data[off : off + 4])
            off += 4
            nbytes = 4 * 16 * cols
            arr = np.frombuffer(data[off : off + nbytes], np.uint32).reshape(16, cols)
            off += nbytes
            polys[name] = convert.field_from_jax(arr, device)
        vk = vk_from_bytes(data[off:])
        pk = ProvingKey(
            n=n, nb_public=nb_public, nb_vars=nb_vars, k1=k1, k2=k2,
            wire_a=wires[0], wire_b=wires[1], wire_c=wires[2], vk=vk, srs=srs, **polys,
        )
        pk.srs_fingerprint = fp
        return pk
    except (ValueError, struct.error, IndexError) as e:
        raise DeserializeKeyError(str(e)) from e
