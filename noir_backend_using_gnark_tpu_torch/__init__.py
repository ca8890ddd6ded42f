"""noir_backend_using_gnark_tpu_torch: the Noir proving backend on PyTorch.

A port of ``noir_backend_using_gnark_tpu`` (JAX, TPU) to PyTorch with
hand-written CUDA kernels for the NVIDIA H100 (``csrc/``, built for
sm_90a on first use). It emits the same SRS, key and proof bytes as the
JAX package for the same inputs, and imports nothing of it.

Quick start::

    from noir_backend_using_gnark_tpu_torch import Backend, Config
    from noir_backend_using_gnark_tpu_torch.acir import builder, solver

    cb = builder.CircuitBuilder()
    x = cb.witness(public=True)
    cb.mul(x, x)
    circuit = cb.build()
    values = solver.dense_values(circuit, solver.solve(circuit, {1: 3}))
    backend = Backend(Config(prover_seed=b"\\x01" * 32))  # device="cpu" without a card
    pk, vk = backend.preprocess(circuit)
    proof = backend.prove_with_pk(circuit, values, pk)
    assert backend.verify_with_vk(proof, values, circuit, vk)
"""

from .api import Backend  # noqa: F401
from .config import Config  # noqa: F401
from . import errors  # noqa: F401

__version__ = "0.1.0"
