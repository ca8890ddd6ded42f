"""Build and load the port's hand-written CUDA kernels.

Each kernel is one source in ``csrc/`` with a plain C entry point. The
sources are compiled with ``nvcc -shared`` for ``sm_90a`` into
``build/kernels/`` at the root of the checkout, one shared library per
source, all compilers started together, and loaded with ``ctypes``.
A library's file name carries a hash of its sources and flags, so an
edited source is rebuilt and an unchanged one is reused.

Nothing here runs at import time: a kernel is built on its first launch
(or by :func:`build_all`), so the CPU tests import every module without
a CUDA toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Every kernel of the port, in registration order.
REGISTRY: list["Kernel"] = []


def nvcc_path() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


class Kernel:
    """One CUDA source, its C entry point and its launch counter.

    ``launches`` counts calls of :meth:`launch` that returned without a
    CUDA error; it is a plain integer that callers reset and read.
    """

    def __init__(self, name: str, source: str, entry: str, argtypes: list):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = list(argtypes) + [ctypes.c_void_p]  # + stream
        self.launches = 0
        self.build_log = ""
        self._fn = None
        self._err = None
        REGISTRY.append(self)

    def library(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        h.update(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        return BUILD_DIR / f"lib{self.name}-{h.hexdigest()[:16]}.so"

    def _start_build(self):
        lib = self.library()
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        return proc, tmp, lib, time.perf_counter()

    def _load(self):
        if self._fn is None:
            if not self.library().exists():
                build_all([self])
            lib = ctypes.CDLL(str(self.library()))
            fn = getattr(lib, self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = getattr(lib, f"{self.source.stem}_error_string")
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args) -> None:
        """Call the entry point on the current CUDA stream; raise if it
        reports a CUDA error (a refused launch never runs)."""
        import torch

        fn = self._load()
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{self.name}: {self.entry} failed with CUDA error {rc} "
                f"({self._err(rc).decode()})"
            )
        self.launches += 1


def build_all(kernels=None) -> dict:
    """Compile every kernel whose library is missing, all at once.

    Returns {name: seconds} for the kernels built by this call. Raises
    RuntimeError with the compiler output if any build fails.
    """
    kernels = REGISTRY if kernels is None else kernels
    started = [(k, k._start_build()) for k in kernels]
    failures, built = [], {}
    for k, job in started:
        if job is None:
            continue
        proc, tmp, lib, t0 = job
        out, _ = proc.communicate()
        k.build_log = out
        if proc.returncode != 0:
            failures.append(f"--- {k.source.name} (exit {proc.returncode})\n{out}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)
        built[k.name] = time.perf_counter() - t0
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return built


def reset_counts() -> None:
    for k in REGISTRY:
        k.launches = 0


def counts() -> dict:
    return {k.name: k.launches for k in REGISTRY}


def check_tensor(t, name: str, dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor on the current
    device with the given dtype (and shape, where given)."""
    import torch

    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device.type != "cuda" or t.device.index != torch.cuda.current_device():
        raise ValueError(f"{name}: expected a tensor on the current CUDA device, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected dtype {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
