"""Public backend API on PyTorch.

Counterpart of ``noir_backend_using_gnark_tpu/api.py``: the reference's
PLONK surface (``np_language``, ``black_box_function_supported``,
``get_exact_circuit_size``, ``preprocess``, ``prove_with_pk``,
``verify_with_vk``, ``prove_with_meta``, ``verify_from_cs``) and the
witness side (``solve``, ``solve_black_box_function_call``), with host
types (ints, bytes) at the boundary and the same artifact bytes as the
JAX package, in either proof layout (``config.proof_format``).

The device work runs on ``cuda`` unless the caller passes
``device="cpu"``; without a card, ``Backend()`` raises instead of
falling back to the CPU.
"""

from __future__ import annotations

import time

import torch

from . import artifacts
from .acir import blackbox, lowering, model, solver
from .config import DEFAULT, Config
from .errors import BackendError, ProvingError
from .plonk import prove as plonk_prove
from .plonk import setup as plonk_setup
from .plonk import verify as plonk_verify
from .utils import bigint

R = bigint.FR_MODULUS


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise BackendError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev


class Backend:
    """The proving backend (reference: ``struct Gnark``, backend.rs:20).

    ``timings`` holds the wall seconds of the phases of the last call of
    each entry point (SRS load or generation, setup, the prover rounds).
    """

    def __init__(self, config: Config | None = None, device=None):
        self.config = (config or DEFAULT).validate()
        self.device = resolve_device(device)
        self._srs = None
        self.timings: dict = {}

    # -- introspection ---------------------------------------------------

    def np_language(self) -> dict:
        """PLONKCSat width 3 (backend.rs:36-38)."""
        return {"PLONKCSat": {"width": 3}}

    def black_box_function_supported(self, func: model.BlackBoxFunc) -> bool:
        """The reference's support matrix (backend.rs:40-56)."""
        return model.SUPPORTED_BLACK_BOX.get(func, False)

    def get_exact_circuit_size(self, circuit: model.Circuit) -> int:
        """#opcodes + per-arith (mul_terms + 1) (wrapper mod.rs:56-73)."""
        return circuit.circuit_size()

    # -- SRS -------------------------------------------------------------

    def _srs_for(self, n: int):
        needed = n + 8
        if self._srs is None or self._srs.size < needed:
            t0 = time.perf_counter()
            size = max(self.config.srs_size, 1)
            while size < needed:
                size *= 2
            self._srs = artifacts.try_load_srs(size, self.config.srs_path, device=self.device)
            self.timings["srs"] = time.perf_counter() - t0
        return self._srs

    # -- proving operations ----------------------------------------------

    def _require_bn254(self, op: str) -> None:
        """Proving needs the BN254 G1/pairing engine. As in the JAX
        package, ``curve="bls12_381"`` is a valid configuration whose
        proving operations raise (the reference's bls12_381 feature has
        no Go-side counterpart either)."""
        if self.config.curve != "bn254":
            raise BackendError(
                f"{op}: proving is bn254-only (curve={self.config.curve!r}; "
                "the reference's bls12_381 feature is felt-codec-only too)"
            )

    def preprocess(self, circuit: model.Circuit) -> tuple[bytes, bytes]:
        """ACIR -> (pk bytes, vk bytes) (backend.rs:81-83)."""
        self._require_bn254("preprocess")
        t0 = time.perf_counter()
        pc = lowering.lower_to_plonk(circuit)
        srs = self._srs_for(plonk_setup.domain_size_for(pc))
        t1 = time.perf_counter()
        pk, vk = plonk_setup.setup(pc, srs)
        self.timings["setup"] = time.perf_counter() - t1
        out = artifacts.pk_to_bytes(pk), artifacts.vk_to_bytes(vk)
        self.timings["preprocess"] = time.perf_counter() - t0
        return out

    def prove_with_pk(self, circuit: model.Circuit, values: list, proving_key: bytes) -> bytes:
        """Dense witness values (1-based order, missing = 0) + pk blob ->
        gnark-format proof bytes (backend.rs:85-94)."""
        self._require_bn254("prove_with_pk")
        t0 = time.perf_counter()
        pc = lowering.lower_to_plonk(circuit)
        pk = artifacts.pk_from_bytes(proving_key, device=self.device)
        pk.srs = self._srs_for(pk.n)
        fp = pk.srs_fingerprint
        if fp and fp != bytes(8) and fp != artifacts.srs_digest(pk.srs):
            raise ProvingError(
                "proving key was built against a different SRS than the one loaded "
                "(srs fingerprint mismatch)"
            )
        assignment = lowering.build_assignment(pc, [v % R for v in values])
        rounds: dict = {}
        proof = plonk_prove.prove(pk, assignment, self.config.prover_seed, timings=rounds,
                                  protocol=self.config.proof_format)
        out = artifacts.proof_to_bytes(proof)
        self.timings.update(rounds)
        self.timings["prove"] = time.perf_counter() - t0
        return out

    def verify_with_vk(self, proof: bytes, public_inputs: list, circuit: model.Circuit,
                       verification_key: bytes) -> bool:
        """Proof bytes + dense public-input values + vk blob -> bool
        (backend.rs:96-106). Host-only: O(1) points and two pairings.
        The proof's layout is read from its bytes (plonk/verify.py
        dispatches on it), whatever ``config.proof_format`` says."""
        self._require_bn254("verify_with_vk")
        t0 = time.perf_counter()
        pc = lowering.lower_to_plonk(circuit)
        publics = self._extract_publics(pc, public_inputs)
        vk = artifacts.vk_from_bytes(verification_key)
        try:
            p = artifacts.proof_from_bytes(proof)
        except BackendError:
            return False
        ok = plonk_verify.verify(vk, p, publics)
        self.timings["verify"] = time.perf_counter() - t0
        return ok

    def prove_with_meta(self, circuit: model.Circuit, values: list) -> bytes:
        """Setup and prove in one call (backend.rs:58-66)."""
        pk_bytes, _ = self.preprocess(circuit)
        return self.prove_with_pk(circuit, values, pk_bytes)

    def verify_from_cs(self, proof: bytes, public_inputs: list, circuit: model.Circuit) -> bool:
        """Setup and verify in one call (backend.rs:68-75)."""
        _, vk_bytes = self.preprocess(circuit)
        return self.verify_with_vk(proof, public_inputs, circuit, vk_bytes)

    # -- witness generation ----------------------------------------------

    def solve(self, circuit: model.Circuit, initial_witness: dict) -> dict:
        """The whole pwg loop on the host (the reference only implements
        the black-box part, backend.rs:109-170; acvm drives the rest)."""
        t0 = time.perf_counter()
        out = solver.solve(circuit, initial_witness)
        self.timings["solve"] = time.perf_counter() - t0
        return out

    def solve_black_box_function_call(self, witness: dict, func_call: model.BlackBoxFuncCall) -> None:
        blackbox.solve_black_box(func_call, witness)

    @staticmethod
    def _extract_publics(pc: lowering.PlonkCircuit, public_inputs: list) -> list:
        """Public values in lowering order, from the dense values vector
        (the acvm convention, tried first) or from a list of exactly the
        public values."""
        max_wit = max(pc.public_witness_indices, default=0)
        if len(public_inputs) >= max_wit:
            return [public_inputs[w - 1] % R for w in pc.public_witness_indices]
        if len(public_inputs) == len(pc.public_witness_indices):
            return [v % R for v in public_inputs]
        raise ProvingError(
            f"values vector of length {len(public_inputs)} covers neither the "
            f"highest public witness index {max_wit} nor the public count "
            f"{len(pc.public_witness_indices)}"
        )
