#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

Phases (any failure ends the run with a non-zero exit and no result):

  1. print the card's name and power limit; build the four kernels of
     ``noir_backend_using_gnark_tpu_torch/csrc`` with nvcc for sm_90a,
     all compilers at once;
  2. hold each kernel against its plain PyTorch version on the card,
     bit for bit (integers, tolerance zero; points compared in affine
     form): K3 field ops on 2^20 random elements plus 0, 1 and p - 1;
     K4 forward, inverse and coset NTTs at every size of ``K4_SIZES``
     (one, two and three passes), and intt(ntt(x)) == x at (14, 2^18); K1
     at c = 6 on equal scalars, scalars r - 1, scalars with one nonzero
     window, points all at infinity, 1, 33 and 4097 points, and 4096
     points with repeated, negated and infinite points, and each K1
     result equal bit for bit to a second call's; K2 at K = 3 and
     K = 8, W = 43 (infinite totals, a total equal or opposite to the
     accumulator) and at K = 1, W = 1;
  3. the golden check: the fixture circuit of tests/torch_port
     (fixtures/meta.json) gives SRS, pk, vk and proof bytes equal to the
     stored files, which the JAX package wrote;
  4. the main path at 2^16 gates: Backend(device="cuda") preprocess ->
     prove_with_pk -> verify_with_vk on the bench.py chain circuit, a
     flipped proof byte must fail to verify, wall times of each phase,
     and the launch counters (every kernel must have run inside
     prove_with_pk);
  5. ``gnark_srs``: the 2^17-point SRS through save_srs_gnark ->
     load_srs_gnark (decompressed on the card), with an equal
     srs_digest; the fixture's gnark-layout SRS and vk equal the golden
     files;
  6. ``cli_main_path``: the 2^16-gate circuit written out as a program
     package (circuit_to_json, abi.json, Prover.toml, Verifier.toml) and
     driven through the CLI (``cli.main``): execute, prove (which
     preprocesses), prove again with the written pk.hex, verify, and a
     flipped proof byte; wall seconds of parse, solve, preprocess,
     prove and verify, and the launch counters of the second prove;
  7. ``expanded``: the 2^16-gate circuit proved in the expanded layout
     through Backend, verified, a flipped byte rejected, the launch
     counters of that prove; the fixture's expanded proof equal to the
     golden file; warm gnark and expanded proves timed in turns;
  8. ``cli_programs``: every package of tests/programs/ through check,
     compile, gates, execute, prove and verify (range_check's gates
     exits 1, as in the JAX package); the package fixture of
     tests/torch_port reproduces its golden target files; the three
     negative probes exit 1;
  9. each kernel timed at the main path's shapes beside its plain
     version and its bound, printed as one JSON ``kernels`` line (K4
     also at (3, 2^16) inverse, round 1's shape, with its launches per
     call, and at 2^20 and 2^24, batch 1), and the whole MSM (K1, the
     weighted bucket reduction over K3, K2) at 2^17 points.

Each path (phases 4, 6, 7 and 8) is driven with the launch counters set
to 0 just before it and read just after, and every kernel must have run
in it.

The last line of standard output is the device line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import json
import random
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "noir_backend_using_gnark_tpu_torch"
FIXTURES = ROOT / "tests" / "torch_port" / "fixtures"
PROGRAMS = ROOT / "tests" / "programs"

#: Main-path circuit: bench.py's chain with 1 public row + 65535 gates
#: = 2^16 rows, so the domain is exactly 2^16 and the SRS 2^17 points.
MAIN_ROWS = (1 << 16) + 1
MAIN_X = 3
MAIN_SEED = 20260417

# Card rates for the bounds (NVIDIA H100 SXM data sheet, at the full
# 700 W): HBM3 at 3.35 TB/s; 67 TFLOP/s of float32 outside the tensor
# cores = 132 SMs x 128 lanes x 2 flops x 1.98 GHz. Hopper has half as
# many INT32 lanes as FP32 lanes per SM, so 32-bit integer multiply-adds
# (IMAD, one per lane per clock) run at 67e12 / 4 per second.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 67e12 / 4
#: 32-bit multiply-adds in one 8-limb Montgomery product: 64 a*b and 64
#: m*p wide products (two IMAD each: low and high word) + 8 for m.
IMAD_PER_MONT_MUL = 2 * (64 + 64) + 8
#: Profiler names of the kernels each entry point launches.
K1_SYMBOLS = ["k1_pass", "k1_slices", "k1_scan", "k1_runs", "k1_fold", "k1_final"]
K2_SYMBOLS = ["k2_join"]
K4_SYMBOLS = ["ntt_pass"]
#: log2 n of the K4 checks: one pass up to 2^9, two up to 2^18, three
#: above (2^19, 2^20, 2^23).
K4_SIZES = (0, 1, 2, 5, 8, 9, 10, 11, 12, 16, 17, 18, 19, 20, 23)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def chain_circuit(builder, rows: int):
    """bench.py's chain: x public, then rows - 2 gates acc = acc * x
    (every third) or acc = acc + x."""
    cb = builder.CircuitBuilder()
    x = cb.witness(public=True)
    acc = x
    for i in range(rows - 2):
        acc = cb.mul(acc, x) if i % 3 == 0 else cb.add(acc, x)
    return cb.build()


def bound_ms(nbytes: float, imads: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = imads / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_words(gen, n: int):
    """n random canonical elements of either field, made on the card: 8
    random words with the top word masked below p's top word."""
    import torch

    w = torch.randint(-(2**31), 2**31 - 1, (8, n), dtype=torch.int32, device=gen.device, generator=gen)
    w[7] &= 0x0FFFFFFF
    return w


def rand_points(rng, dev, n: int):
    """n affine points: 64 distinct multiples of G, repeated, half of
    the repeats negated, and every 17th point at infinity."""
    import torch

    from noir_backend_using_gnark_tpu_torch.ops import curve as C
    from noir_backend_using_gnark_tpu_torch.ops import field as F
    from noir_backend_using_gnark_tpu_torch.ops import msm as M

    table_x, table_y = C.generator_powers_table(256, dev)
    sc = F.from_ints([rng.randrange(1, F.FR.modulus) for _ in range(64)], F.FR, to_mont=False, device=dev)
    ax, ay, _ = C.to_affine(C.fixed_base_mul(table_x, table_y, sc))
    idx = torch.arange(n, device=dev) % 64
    x, y = ax[:, idx].contiguous(), ay[:, idx].contiguous()
    negate = (torch.arange(n, device=dev) // 64) % 2 == 1
    y = F.select(negate, F.neg(y, F.FQ), y)
    inf = torch.arange(n, device=dev) % 17 == 0
    return M.AffineBatch(x, y, inf)


def affine_equal(p, q) -> bool:
    """Two Jacobian batches hold the same points (tolerance zero)."""
    import torch

    from noir_backend_using_gnark_tpu_torch.ops import curve as C

    ax, ay, ai = C.to_affine(p)
    bx, by, bi = C.to_affine(q)
    return bool(torch.equal(ai, bi) and torch.equal(ax[:, ~ai], bx[:, ~bi]) and torch.equal(ay[:, ~ai], by[:, ~bi]))


def check_msm_kernels(dev, rng, gen) -> None:
    """Phase 2 for K1 and K2: each kernel against its plain version, in
    affine form, on the inputs that reach their edge cases (c = 6)."""
    import torch

    from noir_backend_using_gnark_tpu_torch.ops import curve as C
    from noir_backend_using_gnark_tpu_torch.ops import field as F
    from noir_backend_using_gnark_tpu_torch.ops import msm as M
    from noir_backend_using_gnark_tpu_torch.ops import msm_kernels as MK

    c = 6

    def column(value: int, n: int):
        return F.from_ints([value], F.FR, to_mont=False, device=dev).expand(8, n).contiguous()

    base = rand_points(rng, dev, 4096)
    every_inf = M.AffineBatch(base.x, base.y, torch.ones_like(base.inf))
    one_window = F.from_ints([rng.randrange(1, 32) << (c * 20) for _ in range(4096)], F.FR,
                             to_mont=False, device=dev)
    cases = [
        ("equal scalars (one bucket per window holds every point)", base, column(rng.randrange(F.FR.modulus), 4096)),
        ("scalars r - 1 (a carry into the top window)", base, column(F.FR.modulus - 1, 4096)),
        ("one nonzero window (w = 20)", base, one_window),
        ("every point at infinity", every_inf, rand_words(gen, 4096)),
        ("4096 points: repeated, negated and infinite", base, rand_words(gen, 4096)),
    ]
    for n in (1, 33, 4097):
        cases.append((f"{n} points (a ragged last run)", rand_points(rng, dev, n), rand_words(gen, n)))
    buckets = None
    for name, pts, sc in cases:
        got = MK.accumulate_buckets(pts.x, pts.y, pts.inf, sc, c)
        again = MK.accumulate_buckets(pts.x, pts.y, pts.inf, sc, c)
        want = MK._accumulate_plain(pts.x, pts.y, MK.digit_stream(sc, pts.inf, c), c)
        torch.cuda.synchronize()
        check(affine_equal(got, want), f"K1 bucket sums disagree with the plain version: {name}")
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K1 gave other Jacobian coordinates on a second call: {name}")
        print(json.dumps({"phase": "check", "kernel": "K1", "input": name, "points": pts.n, "c": c,
                          "ok": True}), flush=True)
        if pts.n == 4096 and name.startswith("4096"):
            buckets = got

    # K2 inputs: totals from the 4096-point buckets, rolled per MSM.
    def totals_of(k_count: int):
        stacked = C.JacobianPoint(*(torch.stack([a.roll(i, -1) for i in range(k_count)], 1) for a in buckets))
        return M._weighted_bucket_reduce(stacked).map(lambda a: a.clone())

    w_count = MK.num_windows(c)
    t3 = totals_of(3)
    t3.z[:, 1, 5] = 0  # an infinite total inside the Horner chain
    t3.z[:, 2, :] = 0  # an MSM whose every total is infinite
    t8 = totals_of(8)
    # MSMs 0 and 1: the total of window 20 equals, or is the opposite
    # of, the accumulator it is added to (a doubling and P + (-P)).
    w0 = 20
    acc = MK._join_plain(t8.map(lambda a: a[:, :2, w0 + 1 :]), c)
    for _ in range(c):
        acc = C.double(acc, C.PLAIN)
    t8.x[:, :2, w0] = acc.x
    t8.y[:, 0, w0] = acc.y[:, 0]
    t8.y[:, 1, w0] = F.neg(acc.y[:, 1], F.FQ)
    t8.z[:, :2, w0] = acc.z
    t8.z[:, 2, :] = 0  # every total infinite
    t8.z[:, 3, 5] = 0  # an infinite total inside the chain
    t8.z[:, 4, w_count - 1] = 0  # an infinite top window: the chain starts at infinity
    t1 = t8.map(lambda a: a[:, 5:6, :1].contiguous())
    for name, totals in (("K=3, W=43, infinite totals", t3), ("K=8, W=43, equal, opposite and infinite", t8),
                         ("K=1, W=1", t1)):
        got = MK.join_windows(totals, c)
        want = MK._join_plain(totals, c)
        torch.cuda.synchronize()
        check(affine_equal(got, want), f"K2 window join disagrees with the plain version: {name}")
        print(json.dumps({"phase": "check", "kernel": "K2", "input": name, "ok": True}), flush=True)


def check_ntt_kernel(dev, gen) -> None:
    """Phase 2 for K4: forward, inverse and coset transforms against the
    plain radix-2 version, bit for bit, at every size of K4_SIZES."""
    import torch

    from noir_backend_using_gnark_tpu_torch.ops import field as F
    from noir_backend_using_gnark_tpu_torch.ops import ntt as N

    for logn in K4_SIZES:
        n = 1 << logn
        batch = 5 if logn <= 12 else 3 if logn <= 18 else 1
        dom = N.Domain.get(n)
        x = rand_words(gen, batch * n).reshape(8, batch, n).contiguous()
        rev = dom.rev(dev)
        coset_in = F._mont_mul_plain(x, N.coset_scale(5, n, False, dev).reshape(8, 1, n), F.FR)
        pairs = (
            ("ntt", lambda: N.ntt(x, dom), lambda: N._transform_plain(x, dom.fwd_table(dev), rev)),
            ("intt", lambda: N.intt(x, dom),
             lambda: N._transform_plain(x, dom.inv_table(dev), rev, dom.n_inv(dev))),
            ("coset_ntt", lambda: N.coset_ntt(x, 5, dom),
             lambda: N._transform_plain(coset_in, dom.fwd_table(dev), rev)),
        )
        for name, k_fn, p_fn in pairs:
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K4 {name} at 2^{logn} (batch {batch}) disagrees with its plain version")
        print(json.dumps({"phase": "check", "kernel": "K4", "logn": logn, "batch": batch,
                          "passes": len(N.ntt_plan(logn)), "ok": True}), flush=True)
    dom = N.Domain.get(1 << 18)
    x = rand_words(gen, 14 << 18).reshape(8, 14, 1 << 18).contiguous()
    check(torch.equal(N.intt(N.ntt(x, dom), dom), x), "K4 intt(ntt(x)) != x at (14, 2^18)")
    print(json.dumps({"phase": "check", "kernel": "K4", "input": "intt(ntt(x)) == x at (14, 2^18)",
                      "ok": True}), flush=True)


def launched(before: dict, after: dict, path: str) -> dict:
    """Launches per kernel between two counter reads; every kernel must
    have run on ``path``."""
    got = {k: after[k] - before[k] for k in after}
    for name, count in got.items():
        check(count > 0, f"kernel {name} was not launched on the {path} path")
    return got


def write_package(pkg: Path, circuit_json: str, abi: dict, prover: str, verifier: str) -> str:
    """A program package: the ACIR, its abi and the two TOML files."""
    if pkg.exists():
        shutil.rmtree(pkg)
    pkg.mkdir(parents=True)
    (pkg / "circuit.acir.json").write_text(circuit_json)
    (pkg / "abi.json").write_text(json.dumps(abi))
    (pkg / "Prover.toml").write_text(prover)
    (pkg / "Verifier.toml").write_text(verifier)
    return str(pkg)


def run_cli(cli, argv: list, want: int = 0, timings: dict | None = None) -> None:
    rc = cli.main(argv, timings)
    check(rc == want, f"cli {' '.join(argv[:2])} exited {rc}, not {want}")


def flip_byte(path: Path, offset: int) -> None:
    raw = bytearray.fromhex(path.read_text())
    raw[offset] ^= 0x01
    path.write_text(raw.hex())


def phase_gnark_srs(srs, fixture_srs, smoke_dir: Path, dev) -> dict:
    """save_srs_gnark -> load_srs_gnark of ``srs`` on ``dev``, and the
    fixture's gnark-layout SRS and vk against the golden files."""
    from noir_backend_using_gnark_tpu_torch import artifacts
    from noir_backend_using_gnark_tpu_torch.formats import gnark

    path = str(smoke_dir / "main_srs_gnark.hex")
    t0 = time.perf_counter()
    artifacts.save_srs_gnark(srs, path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = artifacts.load_srs_gnark(path, device=dev)
    torch_sync(dev)
    load_s = time.perf_counter() - t0
    check(artifacts.srs_digest(back) == artifacts.srs_digest(srs), "gnark SRS round trip changed the digest")
    check(all(bool((a == b).all()) for a, b in zip(back.g1_powers, srs.g1_powers)),
          "gnark SRS round trip changed the G1 powers")
    check((back.g2_gen, back.g2_alpha) == (srs.g2_gen, srs.g2_alpha), "gnark SRS round trip changed G2")
    check(gnark.srs_to_gnark_bytes(fixture_srs) == (FIXTURES / "srs_gnark.bin").read_bytes(),
          "the fixture's gnark-layout SRS differs from the golden file")
    vk = artifacts.vk_from_bytes((FIXTURES / "vk.bin").read_bytes())
    check(gnark.vk_to_gnark_bytes(vk) == (FIXTURES / "vk_gnark.bin").read_bytes(),
          "the fixture's gnark-layout vk differs from the golden file")
    return {"points": srs.size, "save_s": save_s, "load_s": load_s, "file_bytes": Path(path).stat().st_size}


def phase_cli_main(cli, parse, circuit, values, x: int, srs_path: str, srs_size: int, seed: bytes,
                   pkg: Path, device: str, want_proof: bytes | None) -> dict:
    """The main-path circuit as a program package through the CLI. The
    second prove reuses target/pk.hex, so all of its device work is
    inside prove_with_pk; it runs between two reads of the counters."""
    from noir_backend_using_gnark_tpu_torch import cuda_build
    from noir_backend_using_gnark_tpu_torch.utils import bigint

    t0 = time.perf_counter()
    text = parse.circuit_to_json(circuit)
    write_package(pkg, text, {"x": 1}, f'x = "{x}"\n', f'x = "{x}"\n')
    write_s = time.perf_counter() - t0
    flags = ["--srs-path", srs_path, "--srs-size", str(srs_size), "--seed", seed.hex(), "--device", device]
    t_exec, t_prove, t_warm, t_verify = {}, {}, {}, {}
    run_cli(cli, ["execute", str(pkg), *flags], timings=t_exec)
    check((pkg / "target" / "witness.hex").read_text() == bigint.encode_felts(values),
          "cli execute wrote another witness than the solver's")
    t0 = time.perf_counter()
    run_cli(cli, ["prove", str(pkg), *flags], timings=t_prove)
    prove_wall = time.perf_counter() - t0
    proof = (pkg / "target" / "proof.hex").read_text()
    if want_proof is not None:
        check(bytes.fromhex(proof) == want_proof, "cli prove gave other bytes than Backend with the same seed")
    before = cuda_build.counts()
    t0 = time.perf_counter()
    run_cli(cli, ["prove", str(pkg), *flags], timings=t_warm)
    warm_wall = time.perf_counter() - t0
    after = cuda_build.counts()
    check((pkg / "target" / "proof.hex").read_text() == proof, "a second cli prove gave other bytes")
    run_cli(cli, ["verify", str(pkg), *flags], timings=t_verify)
    flip_byte(pkg / "target" / "proof.hex", -1)
    run_cli(cli, ["verify", str(pkg), *flags], want=1)
    return {
        "acir_json_bytes": len(text), "write_package_s": write_s,
        "execute": {k: t_exec[k] for k in ("parse", "solve")},
        "prove_first": {k: t_prove.get(k) for k in ("parse", "solve", "srs", "preprocess", "prove")},
        "prove_first_wall_s": prove_wall,
        "prove_warm": {k: t_warm.get(k) for k in ("parse", "solve", "prove", "round1", "round2", "round3",
                                                   "round45")},
        "prove_warm_wall_s": warm_wall,
        "verify": {k: t_verify.get(k) for k in ("parse", "verify")},
        "counts": (before, after),
    }


def phase_expanded(api, config, circuit, values, pk_b: bytes, srs_path: str, srs_size: int, seed: bytes,
                   device: str, fixture) -> dict:
    """The expanded layout through Backend at the main path's size, and
    the fixture's expanded proof against the golden file."""
    from noir_backend_using_gnark_tpu_torch import cuda_build

    def backend(fmt: str, path=srs_path, size=srs_size, s=seed):
        return api.Backend(config.Config(srs_path=path, srs_size=size, prover_seed=s, proof_format=fmt),
                           device=device)

    exp, gnark = backend("expanded"), backend("gnark")
    before = cuda_build.counts()
    t0 = time.perf_counter()
    proof = exp.prove_with_pk(circuit, values, pk_b)
    first_s = time.perf_counter() - t0
    after = cuda_build.counts()
    check(proof[:8] == b"NTPUPRF1", "the expanded prove did not write the NTPUPRF1 container")
    t0 = time.perf_counter()
    ok = exp.verify_with_vk(proof, values, circuit, fixture["main_vk"])
    verify_s = time.perf_counter() - t0
    check(ok, "the expanded 2^16-gate proof does not verify")
    bad = bytearray(proof)
    bad[-1] ^= 0x01
    check(not exp.verify_with_vk(bytes(bad), values, circuit, fixture["main_vk"]),
          "a flipped expanded proof byte still verifies")
    # Warm proves of both layouts in turns: gnark, expanded, expanded, gnark.
    warm = {"gnark": [], "expanded": []}
    for fmt, b in (("gnark", gnark), ("expanded", exp), ("expanded", exp), ("gnark", gnark)):
        t0 = time.perf_counter()
        out = b.prove_with_pk(circuit, values, pk_b)
        warm[fmt].append(time.perf_counter() - t0)
        check(out == (proof if fmt == "expanded" else fixture["main_proof"]), f"a warm {fmt} prove gave other bytes")
    golden = backend("expanded", fixture["srs_path"], fixture["srs_size"], fixture["seed"])
    check(golden.prove_with_pk(fixture["circuit"], fixture["values"], fixture["pk"]) == fixture["proof_expanded"],
          "the fixture's expanded proof differs from the golden file")
    check(golden.verify_with_vk(fixture["proof_expanded"], fixture["values"], fixture["circuit"], fixture["vk"]),
          "the golden expanded proof does not verify")
    return {"proof_bytes": len(proof), "first_prove_s": first_s, "verify_s": verify_s,
            "rounds_s": {k: exp.timings.get(k) for k in ("round1", "round2", "round3", "round45")},
            "warm_prove_s": warm, "counts": (before, after)}


def phase_cli_programs(cli, work: Path, device: str, meta: dict) -> dict:
    """Every package of tests/programs/ through the whole CLI flow; the
    package fixture's golden target files; the negative probes."""
    from noir_backend_using_gnark_tpu_torch import artifacts, cuda_build
    from noir_backend_using_gnark_tpu_torch.kzg import kzg

    pkg_meta = meta["package"]
    if work.exists():
        shutil.rmtree(work)
    work.mkdir(parents=True)
    # One SRS for every package: the largest domain is 256 rows.
    srs_path = str(work / "srs.hex")
    artifacts.save_srs(kzg.generate_srs(512, int(pkg_meta["alpha"], 16), device), srs_path)
    flags = ["--srs-path", srs_path, "--srs-size", "512", "--seed", pkg_meta["seed"], "--device", device]
    per_package = {}
    before = cuda_build.counts()
    for pkg in sorted(p for p in PROGRAMS.iterdir() if p.is_dir()):
        dest = work / pkg.name
        shutil.copytree(pkg, dest)
        t0 = time.perf_counter()
        for command in ("check", "compile", "gates", "execute", "prove", "verify"):
            want = 1 if (command, pkg.name) == ("gates", "range_check") else 0
            run_cli(cli, [command, str(dest), *flags], want=want)
        per_package[pkg.name] = time.perf_counter() - t0
    after = cuda_build.counts()

    # The package fixture: its SRS, seed and golden target files.
    name = Path(pkg_meta["program"]).name
    golden_dir = FIXTURES / f"pkg_{name}"
    fix_srs = str(work / "fixture_srs.hex")
    artifacts.save_srs(kzg.generate_srs(pkg_meta["srs_size"], int(pkg_meta["alpha"], 16), device), fix_srs)
    fix_flags = ["--srs-path", fix_srs, "--srs-size", str(pkg_meta["srs_size"]), "--seed", pkg_meta["seed"],
                 "--device", device]
    dest = work / "golden" / name
    shutil.copytree(PROGRAMS / name, dest)
    for command in ("execute", "prove", "verify"):
        run_cli(cli, [command, str(dest), *fix_flags])
    for f in ("witness", "pk", "vk", "proof"):
        check((dest / "target" / f"{f}.hex").read_text() == (golden_dir / f"{f}.hex").read_text(),
              f"cli {f}.hex of {name} differs from the JAX-written golden")

    # The three negative probes.
    flip_byte(dest / "target" / "proof.hex", 40)
    run_cli(cli, ["verify", str(dest), *fix_flags], want=1)
    (dest / "target" / "proof.hex").write_text((golden_dir / "proof.hex").read_text())
    (dest / "Verifier.toml").write_text('y = "3"\n')
    run_cli(cli, ["verify", str(dest), *fix_flags], want=1)
    (dest / "Prover.toml").write_text('x = "2"\ny = "2"\n')
    run_cli(cli, ["execute", str(dest), *fix_flags], want=1)
    return {"packages": len(per_package), "seconds_per_package": per_package, "golden_bytes_equal": True,
            "probes_exit_1": 3, "counts": (before, after)}


def torch_sync(dev) -> None:
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA card")
    if not (ROOT / PKG / "csrc").is_dir():
        fail(f"{PKG}/csrc not found next to chip_smoke.py: run it from a checkout of the repo")
    sys.path.insert(0, str(ROOT))

    from noir_backend_using_gnark_tpu_torch import api, artifacts, cli, config, cuda_build
    from noir_backend_using_gnark_tpu_torch.acir import builder, parse, solver
    from noir_backend_using_gnark_tpu_torch.kzg import kzg
    from noir_backend_using_gnark_tpu_torch.ops import curve as C
    from noir_backend_using_gnark_tpu_torch.ops import field as F
    from noir_backend_using_gnark_tpu_torch.ops import msm as M
    from noir_backend_using_gnark_tpu_torch.ops import msm_kernels as MK
    from noir_backend_using_gnark_tpu_torch.ops import ntt as N

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    built = cuda_build.build_all()
    print(json.dumps({"phase": "build", "seconds": time.perf_counter() - t0,
                      "per_kernel_seconds": built}), flush=True)
    build_dir = ROOT / "chiprun_out"
    build_dir.mkdir(exist_ok=True)
    (build_dir / "ptxas.log").write_text(
        "\n".join(f"=== {k.name}\n{k.build_log}" for k in cuda_build.REGISTRY)
    )

    # ---- 2. kernels against their plain versions ----------------------
    rng = random.Random(MAIN_SEED)
    gen = torch.Generator(device=dev)
    gen.manual_seed(MAIN_SEED)

    def rand_field(spec, n):
        vals = [0, 1, spec.modulus - 1] + [rng.randrange(spec.modulus) for _ in range(n - 3)]
        return F.from_ints(vals, spec, device=dev)

    n3 = 1 << 20
    for spec in (F.FR, F.FQ):
        a = torch.cat([rand_field(spec, 1024), rand_words(gen, n3 - 1024)], dim=1)
        b = torch.cat([rand_field(spec, 1024).flip(-1), rand_words(gen, n3 - 1024)], dim=1)
        for name, k_fn, p_fn in (
            ("mont_mul", lambda: F.mont_mul(a, b, spec), lambda: F._mont_mul_plain(a, b, spec)),
            ("add", lambda: F.add(a, b, spec), lambda: F._add_plain(a, b, spec)),
            ("sub", lambda: F.sub(a, b, spec), lambda: F._sub_plain(a, b, spec)),
            ("neg", lambda: F.neg(a, spec), lambda: F._neg_plain(a, spec)),
            ("mont_mul_bcast", lambda: F.mont_mul(a, b[:, :1], spec),
             lambda: F._mont_mul_plain(a, b[:, :1], spec)),
        ):
            got, want = k_fn(), p_fn()
            torch.cuda.synchronize()
            check(torch.equal(got, want), f"K3 {name} ({spec.name}) disagrees with its plain version")
    print(json.dumps({"phase": "check", "kernel": "K3", "elements": n3, "ok": True}), flush=True)

    check_ntt_kernel(dev, gen)
    check_msm_kernels(dev, rng, gen)

    # ---- 3. golden bytes ----------------------------------------------
    meta = json.loads((FIXTURES / "meta.json").read_text())
    t0 = time.perf_counter()
    golden = {name: (FIXTURES / f"{name}.bin").read_bytes() for name in ("srs", "pk", "vk", "proof")}
    circuit = chain_circuit(builder, meta["rows"])
    values = solver.dense_values(circuit, solver.solve(circuit, {1: meta["x"]}))
    srs = kzg.generate_srs(meta["srs_size"], int(meta["alpha"], 16), dev)
    smoke_dir = ROOT / "build" / "smoke"
    smoke_dir.mkdir(parents=True, exist_ok=True)
    path = str(smoke_dir / "fixture_srs.hex")
    artifacts.save_srs(srs, path)
    cfg = config.Config(srs_path=path, srs_size=meta["srs_size"], prover_seed=bytes.fromhex(meta["prover_seed"]))
    backend = api.Backend(cfg, device="cuda")
    pk_b, vk_b = backend.preprocess(circuit)
    proof_b = backend.prove_with_pk(circuit, values, pk_b)
    mine = {"srs": artifacts.srs_to_bytes(srs), "pk": pk_b, "vk": vk_b, "proof": proof_b}
    for name in golden:
        check(mine[name] == golden[name], f"golden check: {name} bytes differ from the JAX package's")
    check(backend.verify_with_vk(golden["proof"], values, circuit, golden["vk"]), "golden proof does not verify")
    check(backend.prove_with_meta(circuit, values) == golden["proof"], "prove_with_meta differs from the golden proof")
    print(json.dumps({"phase": "golden", "ok": True, "seconds": time.perf_counter() - t0}), flush=True)
    fixture = {"circuit": circuit, "values": values, "srs": srs, "srs_path": path, "srs_size": meta["srs_size"],
               "seed": bytes.fromhex(meta["prover_seed"]), "pk": golden["pk"], "vk": golden["vk"],
               "proof_expanded": (FIXTURES / "proof_expanded.bin").read_bytes()}

    # ---- 4. the main path at 2^16 gates --------------------------------
    # Drop the tables the checks built, so that the first prove builds
    # its own, as in a fresh process.
    N.Domain._cache.clear()
    N._COSET_CACHE.clear()
    t_main = {}
    t0 = time.perf_counter()
    circuit = chain_circuit(builder, MAIN_ROWS)
    t_main["build_circuit"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    values = solver.dense_values(circuit, solver.solve(circuit, {1: MAIN_X}))
    t_main["solve"] = time.perf_counter() - t0

    srs_size = 1 << 17
    t0 = time.perf_counter()
    srs = kzg.generate_srs(srs_size, rng.randrange(1, F.FR.modulus), dev)
    torch.cuda.synchronize()
    t_main["srs_generate"] = time.perf_counter() - t0
    path = str(smoke_dir / "main_srs.hex")
    t0 = time.perf_counter()
    artifacts.save_srs(srs, path)
    t_main["srs_save"] = time.perf_counter() - t0

    seed = MAIN_SEED.to_bytes(32, "big")
    backend = api.Backend(config.Config(srs_path=path, srs_size=srs_size, prover_seed=seed), device="cuda")
    cuda_build.reset_counts()
    pk_b, vk_b = backend.preprocess(circuit)
    after_pre = cuda_build.counts()
    proof_b = backend.prove_with_pk(circuit, values, pk_b)
    after_prove = cuda_build.counts()
    ok = backend.verify_with_vk(proof_b, values, circuit, vk_b)
    launches = cuda_build.counts()
    check(ok, "the 2^16-gate proof does not verify")
    t_main["verify_accepted"] = backend.timings["verify"]
    bad = bytearray(proof_b)
    bad[-1] ^= 0x01
    check(not backend.verify_with_vk(bytes(bad), values, circuit, vk_b), "a flipped proof byte still verifies")
    # The flipped z(zeta*omega) fails the scalar identity before the pairings.
    t_main["verify_rejected"] = backend.timings["verify"]
    in_prove = launched(after_pre, after_prove, "main (inside prove_with_pk)")
    launched(dict.fromkeys(launches, 0), launches, "main")
    pk_n = artifacts.pk_from_bytes(pk_b).n
    check(pk_n == 1 << 16, f"main-path domain is {pk_n}, not 2^16")
    t_main.update({f"backend_{k}": v for k, v in backend.timings.items()})
    print(json.dumps({"phase": "main_path", "gates": MAIN_ROWS - 2, "domain": pk_n, "srs_points": srs_size,
                      "verified": ok, "seconds": t_main, "launches_main_path": launches,
                      "launches_in_prove": in_prove, "proof_bytes": len(proof_b)}), flush=True)

    # A second prove with the domain tables warm, then a third under the
    # profiler: the device's busy and idle share of a prove.
    t0 = time.perf_counter()
    again = backend.prove_with_pk(circuit, values, pk_b)
    warm_s = time.perf_counter() - t0
    warm_rounds = {k: backend.timings[k] for k in ("round1", "round2", "round3", "round45")}
    check(again == proof_b, "a second prove with the same seed gave other bytes")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        again = backend.prove_with_pk(circuit, values, pk_b)
        torch.cuda.synchronize()
        prof_wall = time.perf_counter() - t0
    check(again == proof_b, "a profiled prove gave other bytes")
    by_kernel = sorted(
        ((e.key, e.self_device_time_total / 1e3, e.count) for e in prof.key_averages()
         if e.self_device_time_total > 0),
        key=lambda r: -r[1],
    )
    busy_ms = sum(r[1] for r in by_kernel)
    print(json.dumps({"phase": "prove_profile", "warm_prove_s": warm_s, "warm_rounds_s": warm_rounds,
                      "profiled_prove_s": prof_wall, "device_busy_ms": busy_ms,
                      "device_idle_share": 1 - busy_ms / 1e3 / prof_wall,
                      "top_device_ms": [[k[:60], ms, n] for k, ms, n in by_kernel[:12]]}), flush=True)

    # ---- 5-8. the gnark SRS layout, the CLI, the expanded layout --------
    fixture.update(main_vk=vk_b, main_proof=proof_b)
    by_path = {"main_path": launches}
    result = phase_gnark_srs(srs, fixture["srs"], smoke_dir, dev)
    print(json.dumps({"phase": "gnark_srs", "ok": True, **result}), flush=True)

    cuda_build.reset_counts()
    result = phase_cli_main(cli, parse, circuit, values, MAIN_X, path, srs_size, seed, smoke_dir / "chain_pkg",
                            "cuda", proof_b)
    before, after = result.pop("counts")
    by_path["cli_main_path"] = cuda_build.counts()
    result["launches_in_second_prove"] = launched(before, after, "cli_main_path (second prove)")
    print(json.dumps({"phase": "cli_main_path", "ok": True, "gates": MAIN_ROWS - 2, **result,
                      "launches": by_path["cli_main_path"]}), flush=True)

    cuda_build.reset_counts()
    result = phase_expanded(api, config, circuit, values, pk_b, path, srs_size, seed, "cuda", fixture)
    before, after = result.pop("counts")
    by_path["expanded"] = cuda_build.counts()
    result["launches_in_prove_with_pk"] = launched(before, after, "expanded (inside prove_with_pk)")
    print(json.dumps({"phase": "expanded", "ok": True, "gates": MAIN_ROWS - 2, "verified": True,
                      "golden_equal": True, **result, "launches": by_path["expanded"]}), flush=True)

    cuda_build.reset_counts()
    result = phase_cli_programs(cli, smoke_dir / "programs", "cuda", meta)
    before, after = result.pop("counts")
    by_path["cli_programs"] = cuda_build.counts()
    launched(before, after, "cli_programs")
    print(json.dumps({"phase": "cli_programs", "ok": True, **result, "launches": by_path["cli_programs"]}),
          flush=True)

    def kernel_profile(fn, symbols, calls: int):
        """Device ms and kernel launches per call of the named kernels,
        from the profiler (ms None when it reports no device time). The
        calls are made twice and only the second round is kept: in a
        window of its own the profiler was seen to miss a launch."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)) as p:
            for _ in range(2):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                p.step()
        events = [e for e in p.key_averages() if any(s in e.key for s in symbols) and e.self_device_time_total > 0]
        total = sum(e.self_device_time_total for e in events)
        return (total / 1e3 / calls if total else None), sum(e.count for e in events) / calls

    def device_ms(fn, symbols, calls: int):
        return kernel_profile(fn, symbols, calls)[0]

    # ---- 9. kernel times at the main path's shapes -----------------------
    rows = []
    n4 = 1 << 18  # the quotient domain of round 3
    a = rand_words(gen, n4)
    b = rand_words(gen, n4)
    ms = cuda_ms(lambda: F.mont_mul(a, b, F.FR), 50)
    plain = cuda_ms(lambda: F._mont_mul_plain(a, b, F.FR), 3)
    check(torch.equal(F.mont_mul(a, b, F.FR), F._mont_mul_plain(a, b, F.FR)), "K3 timing inputs disagree")
    bd, by = bound_ms(3 * 32 * n4, IMAD_PER_MONT_MUL * n4)
    rows.append(dict(name="field_mont_mul", kernel="K3", shape=f"(8, {n4}) Fr mont_mul",
                     route="cuda", source=f"{PKG}/csrc/field.cu",
                     replaces="noir_backend_using_gnark_tpu/ops/field.py:219", ms=ms, plain_ms=plain,
                     bound_ms=bd, bound_by=by,
                     device_ms=device_ms(lambda: F.mont_mul(a, b, F.FR), ["field_kernel"], 50)))

    def k4_row(batch: int, logn: int, inverse: bool, reps: int) -> dict:
        """K4 at (8, batch, 2^logn): CUDA-event ms, profiler device ms,
        launches per call and the bound (n/2 log2 n products per
        polynomial, plus n for the inverse's 1/n; each word read and
        written once, and the table read once)."""
        n = 1 << logn
        dom = N.Domain.get(n)
        x = rand_words(gen, batch * n).reshape(8, batch, n).contiguous()
        fn = (lambda: N.intt(x, dom)) if inverse else (lambda: N.ntt(x, dom))
        dev_ms, per_call = kernel_profile(fn, K4_SYMBOLS, reps)
        products = batch * ((n // 2) * logn + (n if inverse else 0))
        bd, by = bound_ms(2 * 32 * batch * n + 32 * (n // 2), IMAD_PER_MONT_MUL * products)
        return dict(shape=f"(8, {batch}, 2^{logn}) {'inverse' if inverse else 'forward'}",
                    ms=cuda_ms(fn, reps), device_ms=dev_ms, launches_per_call=per_call,
                    passes=len(N.ntt_plan(logn)), bound_ms=bd, bound_by=by)

    main_fwd = k4_row(14, 18, False, 10)
    dom4 = N.Domain.get(n4)
    x = rand_words(gen, 14 * n4).reshape(8, 14, n4).contiguous()
    t0 = time.perf_counter()
    want = N._transform_plain(x, dom4.fwd_table(dev), dom4.rev(dev))
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    check(torch.equal(N.ntt(x, dom4), want), "K4 timing inputs disagree")
    more_shapes = [k4_row(3, 16, True, 20), k4_row(1, 20, False, 5), k4_row(1, 24, False, 2)]
    for row in (main_fwd, more_shapes[0]):
        check(round(row["launches_per_call"]) == 2,
              f"K4 made {row['launches_per_call']} launches per call at {row['shape']}")
    rows.append(dict(name="ntt", kernel="K4", shape="(8, 14, 2^18) forward NTT (round-3 coset transform)",
                     route="cuda", source=f"{PKG}/csrc/ntt.cu",
                     replaces="noir_backend_using_gnark_tpu/ops/ntt.py:174", ms=main_fwd["ms"], plain_ms=plain,
                     bound_ms=main_fwd["bound_ms"], bound_by=main_fwd["bound_by"], device_ms=main_fwd["device_ms"],
                     launches_per_call=main_fwd["launches_per_call"], other_shapes=more_shapes))

    npts = 1 << 17
    pts = srs.g1_powers
    sc = rand_words(gen, npts)
    digits = MK.digit_stream(sc, pts.inf, 6)
    ms = cuda_ms(lambda: MK.accumulate_buckets(pts.x, pts.y, pts.inf, sc, 6), 10)
    t0 = time.perf_counter()
    want = MK._accumulate_plain(pts.x, pts.y, digits, 6)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    check(affine_equal(MK.accumulate_buckets(pts.x, pts.y, pts.inf, sc, 6), want), "K1 timing inputs disagree")
    nonzero = int((digits != 0).sum())
    w_count = MK.num_windows(6)
    nbytes = 64 * npts + w_count * npts + 96 * w_count * MK.num_buckets(6)
    bd, by = bound_ms(nbytes, IMAD_PER_MONT_MUL * 11 * nonzero)
    rows.append(dict(name="msm_accum", kernel="K1", shape=f"{npts} points, c=6, W=43, B=33",
                     route="cuda", source=f"{PKG}/csrc/msm_accum.cu",
                     replaces="noir_backend_using_gnark_tpu/ops/msm_pallas.py:645", ms=ms, plain_ms=plain,
                     bound_ms=bd, bound_by=by, nonzero_digits=nonzero,
                     device_ms=device_ms(lambda: MK.accumulate_buckets(pts.x, pts.y, pts.inf, sc, 6),
                                         K1_SYMBOLS, 10)))

    totals = M._weighted_bucket_reduce(C.JacobianPoint(*(torch.stack([a, a, a], 1) for a in want)))
    ms = cuda_ms(lambda: MK.join_windows(totals, 6), 5)
    plain = cuda_ms(lambda: MK._join_plain(totals, 6), 1, warmup=0)
    check(affine_equal(MK.join_windows(totals, 6), MK._join_plain(totals, 6)), "K2 timing inputs disagree")
    imads = IMAD_PER_MONT_MUL * 3 * (6 * (w_count - 1) * 7 + w_count * 16)
    bd, by = bound_ms(96 * 3 * w_count + 96 * 3, imads)
    join_ms = device_ms(lambda: MK.join_windows(totals, 6), K2_SYMBOLS, 5)
    # The rounds of dependent products each join ran, counted by K2.
    rounds = torch.zeros(3, dtype=torch.int32, device=dev)
    check(affine_equal(MK._join_cuda(totals, 6, rounds), MK.join_windows(totals, 6)),
          "K2 with its round counter gave another sum")
    chain = int(rounds.max())
    rows.append(dict(name="msm_join", kernel="K2", shape="K=3 MSMs, W=43 windows, c=6",
                     route="cuda", source=f"{PKG}/csrc/msm_join.cu",
                     replaces="noir_backend_using_gnark_tpu/ops/msm_pallas.py:477", ms=ms, plain_ms=plain,
                     bound_ms=bd, bound_by=by, device_ms=join_ms, dependent_products_per_join=chain,
                     ns_per_dependent_product=join_ms * 1e6 / chain if join_ms else None))

    # The whole MSM (msm_kernel_pallas's counterpart): K1, the weighted
    # bucket reduction (plain log-depth scans over K3), K2. Its plain
    # version runs K1 and K2 plain (the reduction is the same code). The
    # bound adds to K1's work a running-sum reduction (2 B complete
    # additions of 16 products per window) and K2's Horner chain.
    ms = cuda_ms(lambda: M.msm(pts, sc, 6), 10)
    t0 = time.perf_counter()
    want = MK._join_plain(M._weighted_bucket_reduce(MK._accumulate_plain(pts.x, pts.y, digits, 6)), 6)
    torch.cuda.synchronize()
    plain = (time.perf_counter() - t0) * 1e3
    got = M.msm(pts, sc, 6)
    check(affine_equal(got.map(lambda a: a.reshape(8, 1)), want.map(lambda a: a.reshape(8, 1))),
          "the whole MSM disagrees with its plain version")
    imads = IMAD_PER_MONT_MUL * (11 * nonzero + 16 * 2 * MK.num_buckets(6) * w_count
                                 + 6 * (w_count - 1) * 7 + w_count * 16)
    bd, by = bound_ms((64 + 32 + 1) * npts + 96, imads)  # x, y, scalar, inf in; one point out
    rows.append(dict(name="msm_whole", kernel="K1+K2", shape=f"{npts} points, c=6: K1, weighted reduce, K2",
                     route="cuda", source=f"{PKG}/ops/msm.py (csrc/msm_accum.cu, csrc/field.cu, csrc/msm_join.cu)",
                     replaces="noir_backend_using_gnark_tpu/ops/msm_pallas.py:735", ms=ms, plain_ms=plain,
                     bound_ms=bd, bound_by=by,
                     device_ms=device_ms(lambda: M.msm(pts, sc, 6), K1_SYMBOLS + K2_SYMBOLS + ["field_kernel"], 10)))

    # One launch of K1 per MSM, so K1's count is the whole MSM's.
    name_of = {"K3": "field", "K4": "ntt", "K1": "msm_accum", "K2": "msm_join", "K1+K2": "msm_accum"}
    for row in rows:
        row["launches"] = launches[name_of[row["kernel"]]]
        row["launches_in_prove"] = in_prove[name_of[row["kernel"]]]
        row["launches_by_path"] = {path: c[name_of[row["kernel"]]] for path, c in by_path.items()}
        row["max_abs_err"] = 0
        row["library_ms"] = None
    print(json.dumps({"card": smi}), flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
