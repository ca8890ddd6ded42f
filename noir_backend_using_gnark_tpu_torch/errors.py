"""Error taxonomy of the backend (a copy of the JAX package's).

Mirrors the reference's failure classes
(src/gnark_backend_wrapper/errors.rs:5-38) as a Python exception
hierarchy. Unlike the reference's Go side —
which ``log.Fatal``s on any decode error, killing the host process
(gnark_backend_ffi/main.go:29, helpers.go:17) — every failure here is a
catchable exception.
"""

from __future__ import annotations


class BackendError(Exception):
    """Base class for all backend errors (errors.rs GnarkBackendError)."""


class SerializeCircuitError(BackendError):
    pass


class SerializeKeysError(BackendError):
    pass


class SerializeProofError(BackendError):
    pass


class SerializeFeltsError(BackendError):
    pass


class DeserializeProofError(BackendError):
    pass


class DeserializeKeyError(BackendError):
    pass


class UnsupportedOpcodeError(BackendError):
    """errors.rs:23 UnsupportedOpcodeError."""


class UnsupportedBlackBoxFuncError(BackendError):
    """acvm OpcodeResolutionError::UnsupportedBlackBoxFunc
    (src/backend.rs:114-167 error arms)."""


class VerifyInvalidBoolError(BackendError):
    """errors.rs:25 — the FFI verify returned a non-bool; kept for parity
    (our in-process verify can only raise on malformed artifacts)."""


class OpcodeResolutionError(BackendError):
    """Witness solving got stuck or an assertion failed (acvm pwg errors)."""


class CircuitParseError(BackendError):
    """Malformed ACIR JSON (Go side would log.Fatal; acir/acir.go:17-75)."""


class ProvingError(BackendError):
    pass


class VerificationError(BackendError):
    pass
