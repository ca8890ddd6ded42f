"""Runtime configuration.

Counterpart of ``noir_backend_using_gnark_tpu/config.py`` restricted to
what this port runs today: PLONK over BN254 on one device, in the gnark
v0.8 proof format or the expanded layout. ``curve="bls12_381"`` is
accepted as the JAX package accepts it, and proving with it raises in
``api.Backend``. The other values the JAX package accepts (Groth16, a
device mesh) are refused by :meth:`Config.validate` rather than
ignored.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Config:
    curve: str = "bn254"
    scheme: str = "plonk"
    # "gnark": gnark v0.8 linearized openings + gnark transcript,
    # serialized as raw gnark WriteTo blobs (the reference's artifact
    # format); "expanded": the 15-opening layout in the NTPUPRF1 container.
    proof_format: str = "gnark"
    # SRS cache (the reference's $XDG_CONFIG/noir-lang/srs.hex).
    srs_path: Optional[str] = None
    # SRS size when generating; grows on demand to the domain + 8.
    srs_size: int = 1 << 12
    # Deterministic proof blinding (None = fresh randomness per proof).
    prover_seed: Optional[bytes] = None

    def validate(self):
        if self.curve not in ("bn254", "bls12_381"):
            raise ValueError(f"unsupported curve {self.curve!r}")
        # bls12_381 is accepted, as in the JAX package: the proving
        # operations of api.Backend raise BackendError for it (bn254-only).
        if self.scheme != "plonk":
            raise ValueError(f"unsupported scheme {self.scheme!r}: this port has no Groth16 yet")
        if self.proof_format not in ("gnark", "expanded"):
            raise ValueError(f"unknown proof_format {self.proof_format!r}")
        return self


DEFAULT = Config()
