#!/usr/bin/env python3
"""Time kernel K4 (the NTT of the PyTorch/CUDA port) of several
checkouts on one NVIDIA card, in turns.

    python3 k4_compare.py ROOT [ROOT ...]

Each ROOT is a checkout of this repository (``.`` for this one, or an
unpacked ``git archive`` of another commit). The roots run in the order
given, each in a process of its own that builds that checkout's
``csrc/ntt.cu`` and imports that checkout's package, so a comparison
runs as ``parent this this parent``. For each shape the process prints
one JSON line: CUDA-event ms per call through ``ntt.ntt`` / ``ntt.intt``,
the profiler's device ms and kernel launches per call, and the bound
(n/2 log2 n Montgomery products per polynomial, plus n for the inverse's
1/n, at the card's 32-bit multiply-add rate, or each word read and
written once at its memory rate, whichever is longer). The card's name
and power limit are printed first. Needs a CUDA card; exits non-zero
without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

#: (batch, log2 n, inverse, calls timed): round 3's coset transform,
#: round 1's inverse, and two single-polynomial sizes.
SHAPES = ((14, 18, False, 5), (3, 16, True, 20), (1, 20, False, 5), (1, 24, False, 2))
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
IMAD_PER_MONT_MUL = 2 * (64 + 64) + 8


def run_one(root: str) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, root)
    from noir_backend_using_gnark_tpu_torch import cuda_build
    from noir_backend_using_gnark_tpu_torch.ops import ntt as N

    t0 = time.perf_counter()
    cuda_build.build_all([N.K4])
    build_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda")
    gen.manual_seed(6)
    for batch, logn, inverse, calls in SHAPES:
        n = 1 << logn
        dom = N.Domain.get(n)
        x = torch.randint(-(2**31), 2**31 - 1, (8, batch, n), dtype=torch.int32, device="cuda", generator=gen)
        x[7] &= 0x0FFFFFFF
        fn = (lambda: N.intt(x, dom)) if inverse else (lambda: N.ntt(x, dom))
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / calls
        # Two rounds of calls, the first a warm-up the profile drops: in
        # a window of its own the profiler was seen to miss a launch.
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        # The profiler's step ranges carry the device time of the kernels
        # launched inside them: count only the kernels.
        kernels = [e for e in prof.key_averages()
                   if e.self_device_time_total > 0 and not e.key.startswith("ProfilerStep")]
        products = batch * ((n // 2) * logn + (n if inverse else 0))
        t_bytes = (2 * 32 * batch * n + 32 * (n // 2)) / HBM_BYTES_PER_S * 1e3
        t_ops = IMAD_PER_MONT_MUL * products / IMAD_PER_S * 1e3
        print(json.dumps({
            "root": root, "module": N.__file__, "shape": [8, batch, n], "inverse": inverse, "ms": ms,
            "device_ms": sum(e.self_device_time_total for e in kernels) / 1e3 / calls,
            "launches_per_call": sum(e.count for e in kernels) / calls,
            "kernels": sorted({e.key[:40] for e in kernels}),
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "build_s": build_s,
        }), flush=True)


def main() -> int:
    if len(sys.argv) >= 3 and sys.argv[1] == "--one":
        run_one(sys.argv[2])
        return 0
    roots = [os.path.abspath(r) for r in sys.argv[1:]]
    if not roots:
        sys.exit(__doc__)
    import torch

    if not torch.cuda.is_available():
        sys.exit("k4_compare: torch.cuda.is_available() is false: this needs an NVIDIA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for root in roots:
        rc = subprocess.run([sys.executable, os.path.abspath(__file__), "--one", root], cwd=root).returncode
        if rc != 0:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
