"""PLONK key and proof containers.

Our equivalents of gnark's plonk.ProvingKey / VerifyingKey (the
artifacts the reference moves as hex blobs across the FFI —
helpers.go:49-94). Polynomial data lives on the proving key as torch
tensors; the verifying key and proof are plain host objects (ints and
affine points) since verification is host-side.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class VerifyingKey:
    n: int  # domain size (power of two)
    nb_public: int
    generator: int  # omega for the size-n subgroup
    k1: int
    k2: int
    q_l: object  # affine int points (x, y) or None
    q_r: object
    q_o: object
    q_m: object
    q_c: object
    s1: object
    s2: object
    s3: object
    g2_gen: object  # host FQ2 affine pair
    g2_alpha: object

    def commitment_list(self):
        return [
            self.q_l,
            self.q_r,
            self.q_o,
            self.q_m,
            self.q_c,
            self.s1,
            self.s2,
            self.s3,
        ]


@dataclass
class ProvingKey:
    """Device-side prover data. Tensors on the device it was loaded to."""

    n: int
    nb_public: int
    nb_vars: int
    k1: int
    k2: int
    # Wire variable index per row, including public & padding rows: (n,) int32.
    wire_a: np.ndarray
    wire_b: np.ndarray
    wire_c: np.ndarray
    # Selector polynomials, coefficient form (8, n) Montgomery.
    ql: torch.Tensor
    qr: torch.Tensor
    qo: torch.Tensor
    qm: torch.Tensor
    qc: torch.Tensor
    # Permutation polynomials sigma_col, coefficient form (8, n).
    s1: torch.Tensor
    s2: torch.Tensor
    s3: torch.Tensor
    # sigma evaluation vectors on H (8, n) — used in the z product.
    s1_evals: torch.Tensor
    s2_evals: torch.Tensor
    s3_evals: torch.Tensor
    vk: VerifyingKey = None
    srs: object = None  # kzg.SRS
    # 8-byte fingerprint of the SRS this pk was built against (set by
    # artifacts.pk_from_bytes for v2 blobs; None for a legacy NTPUPK_1 blob).
    srs_fingerprint: Optional[bytes] = None


@dataclass
class Proof:
    """The expanded PLONK layout: selector and sigma openings are
    included, so the verifier checks the whole identity numerically at
    zeta (no linearization polynomial). All commitments are host affine
    int points (or None)."""

    a: object
    b: object
    c: object
    z: object
    t0: object
    t1: object
    t2: object
    # Evaluations at zeta (ints), in ZETA_OPENING_LABELS order.
    evals: list
    z_omega: int  # z(zeta * omega)
    w_zeta: object  # batched opening proof at zeta
    w_zeta_omega: object  # opening proof for z at zeta*omega


#: Fixed order of the batched zeta opening (prover and verifier agree).
ZETA_OPENING_LABELS = (
    "a", "b", "c", "z", "s1", "s2", "s3", "ql", "qr", "qo", "qm", "qc", "t0", "t1", "t2",
)
