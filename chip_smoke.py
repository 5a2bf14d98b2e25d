#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
exits nonzero:

1. Device check: refuses to run without CUDA; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``bulklmm_tpu_torch/csrc/*.cu`` for sm_90a from the
   checkout's sources and prints the build time.
3. Kernel vs its plain version on the card, at small shapes (c = 1, 2, 3
   and 8 covariate columns, a ragged 70 x 45 tile edge, and n = 2,000 to
   cross many sample chunks). Bar: max |dLOD| <= 5e-5 (the JAX package's
   bar for its Pallas kernel), scaled by n/48 above n = 79.
4. The slice at BXD scale (79 samples x 7,321 markers x 35,554 traits,
   synthetic, seed 2026): BALANCED ``bulkscan`` on CUDA tensors must launch
   the kernel and give a finite (7321, 35554) L; the kernel must match its
   plain version on the scan's own rotated inputs and h2 within 5e-5; and
   L must stay within 1e-4 of the EXACT64 scan (the float64 oracle) on the
   traits whose grid h2 agrees.
5. Times, printed and not gated: the median of 5 runs after one warm-up,
   by CUDA events around the work and then a checksum fetch, of the
   BALANCED ``bulkscan`` (host eigendecomposition included), the kernel
   alone and its plain version at that shape.

The second-to-last line is one JSON object describing each kernel; the last
is ``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, P, M = 79, 7321, 35554
SEED = 2026
KERNEL_BAR = 5e-5  # max |dLOD|, kernel vs plain, n <= 79
ORACLE_BAR = 1e-4  # max |dLOD|, BALANCED vs EXACT64 on equal-h2 traits
PARITY_BAR = 1e-5  # BASELINE.md's accuracy bar, reported


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


def synth_bxd(n=N, p=P, m=M, seed=SEED):
    """BXD-shaped synthetic data, generated as bench.py's synth_bxd does."""
    rng = np.random.default_rng(seed)
    G = rng.uniform(0.0, 1.0, (n, p)).astype(np.float32)
    X = G - 0.5
    K = 2.0 * X.astype(np.float64) @ X.astype(np.float64).T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    return G, K, Y


def device_check() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke needs a CUDA device; torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device 0: {torch.cuda.get_device_name(0)}")
    return card


def import_port():
    """The port from this checkout, never an installed copy."""
    here = Path(__file__).resolve().parent
    import bulklmm_tpu_torch

    check(Path(bulklmm_tpu_torch.__file__).resolve().is_relative_to(here),
          f"bulklmm_tpu_torch imported from {bulklmm_tpu_torch.__file__}, not this checkout")
    check("jax" not in sys.modules, "the port imported jax")


def build() -> None:
    from bulklmm_tpu_torch.kernels.build import BUILD_DIR, load_library

    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    log = BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print("  ptxas:", line.strip())


def _kernel_inputs(n, p, m, c, rng, dev):
    f32 = np.float32
    Y0 = rng.normal(size=(n, m)).astype(f32)
    X0m = rng.normal(size=(n, p)).astype(f32)
    C0 = np.concatenate([np.ones((n, 1))] + [rng.normal(size=(n, 1)) for _ in range(c - 1)], 1)
    lam = rng.uniform(0.1, 2.0, n).astype(f32)
    h2 = rng.uniform(0.0, 0.9, m).astype(f32)
    return [torch.from_numpy(np.asarray(a, dtype=f32)).to(dev) for a in (Y0, X0m, C0, lam, h2)]


def kernel_checks(dev) -> None:
    from bulklmm_tpu_torch.kernels.liteqtl_fused import (
        liteqtl_lod_cuda, liteqtl_lod_plain, prepare_inputs,
    )

    rng = np.random.default_rng(3)
    cases = [(48, 96, 64, c) for c in (1, 2, 3, 8)] + [(48, 70, 45, 1), (2000, 96, 64, 2)]
    for n, p, m, c in cases:
        ops = prepare_inputs(*_kernel_inputs(n, p, m, c, rng, dev))
        out = liteqtl_lod_cuda(*ops)
        torch.cuda.synchronize()
        ref = liteqtl_lod_plain(*ops)
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        err = (out - ref).abs().max().item()
        print(f"  kernel vs plain n={n} p={p} m={m} c={c}: max|dLOD| = {err:.3e} (bar {bar:.2e})")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "kernel output not finite")
        check(err <= bar, f"kernel disagrees with its plain version at {(n, p, m, c)}")


def _max_abs_diff_cols(A, B, cols, block=4096):
    """max |A - B| over the columns ``cols``, in float64, block by block."""
    worst = 0.0
    idx = torch.nonzero(cols).flatten()
    for s in range(0, idx.numel(), block):
        j = idx[s : s + block]
        worst = max(worst, (A[:, j].double() - B[:, j].double()).abs().max().item())
    return worst


def _time_ms(fn) -> float:
    """One run timed by CUDA events around the work; the checksum fetch
    after the end event waits for the result and proves it finite."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    check(np.isfinite(float(out.sum())), "non-finite checksum while timing")
    return start.elapsed_time(end)


def slice_at_bxd(dev):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.ops.rotation import decompose_kinship
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    G, K, Y = synth_bxd()
    Gd = torch.from_numpy(G).to(dev)
    Yd = torch.from_numpy(Y).to(dev)
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    lf.launches = 0
    t0 = time.perf_counter()
    res = bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = lf.launches
    print(f"  BALANCED bulkscan, first call: {first_s:.3f} s, kernel launches: {launches}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(launches > 0, "the BALANCED bulkscan did not launch the CUDA kernel")
    check(tuple(res.L.shape) == (P, M), f"L has shape {tuple(res.L.shape)}")
    check(res.L.is_cuda and res.L.dtype == torch.float32, "L is not float32 on the card")
    check(bool(torch.isfinite(res.L).all()), "L is not finite")

    # the kernel against its plain version on the scan's own inputs
    dec = decompose_kinship(K, dtype=torch.float64, device=dev)
    with with_highest_matmul():
        Y0 = dec.Ut @ Yd.double()
        X0m = dec.Ut @ Gd.double()
        C0 = dec.Ut @ torch.ones((N, 1), dtype=torch.float64, device=dev)
    Lk = lf.fused_lods_per_trait(Y0, X0m, C0, dec.lam, res.h2_null_list)
    torch.cuda.synchronize()
    Lp = lf.fused_lods_per_trait_reference(Y0, X0m, C0, dec.lam, res.h2_null_list)
    torch.cuda.synchronize()
    ops = lf.prepare_inputs(Y0, X0m, C0, dec.lam, res.h2_null_list)
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    kerr = _max_abs_diff_cols(Lk, Lp, all_cols)
    same_as_scan = _max_abs_diff_cols(Lk, res.L, all_cols)
    print(f"  kernel vs plain at BXD scale: max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}); "
          f"kernel vs the scan's L: {same_as_scan:.3e}")
    check(kerr <= KERNEL_BAR, "kernel disagrees with its plain version at BXD scale")
    del Lp

    exact = bt.bulkscan(Yd, Gd, K, precision=bt.EXACT64)
    torch.cuda.synchronize()
    same = exact.h2_null_list == res.h2_null_list.double()
    nflip = int((~same).sum())
    oerr = _max_abs_diff_cols(res.L, exact.L, same)
    print(f"  BALANCED vs EXACT64: {nflip} of {M} traits with a different grid h2; "
          f"max|dLOD| on the rest = {oerr:.3e} (bar {ORACLE_BAR:.0e}; "
          f"BASELINE.md's {PARITY_BAR:.0e}: {'met' if oerr <= PARITY_BAR else 'NOT met'})")
    check(oerr <= ORACLE_BAR, "BALANCED strays from the EXACT64 oracle")
    del exact
    return Yd, Gd, K, ops, launches, kerr


def times(card, Yd, Gd, K, ops):
    """Median of 5 runs after one warm-up each; the kernel and its plain
    version run in turns, so drifting clocks hit both alike."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    runs = {
        "BALANCED bulkscan": lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED).L,
        "kernel alone": lambda: lf.liteqtl_lod_cuda(*ops),
        "plain version": lambda: lf.liteqtl_lod_plain(*ops),
    }
    ms = {name: [] for name in runs}
    for fn in runs.values():
        _time_ms(fn)
    for _ in range(5):
        for name, fn in runs.items():
            ms[name].append(_time_ms(fn))
    print(f"  times on {card}, median of 5 (ms):")
    for name, t in ms.items():
        print(f"    {name:18s} {statistics.median(t):9.3f}   runs {[round(x, 3) for x in t]}")
    return statistics.median(ms["kernel alone"]), statistics.median(ms["plain version"])


def main() -> None:
    import_port()
    print("[1] device check")
    card = device_check()
    dev = torch.device("cuda", 0)
    print("[2] build")
    build()
    print("[3] kernel vs plain version on the card")
    kernel_checks(dev)
    print(f"[4] BALANCED bulkscan at BXD scale ({N} x {P} x {M})")
    Yd, Gd, K, ops, launches, kerr = slice_at_bxd(dev)
    print("[5] times")
    k_ms, p_ms = times(card, Yd, Gd, K, ops)
    print(json.dumps({"kernels": [{
        "name": "liteqtl_lod",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/liteqtl_fused.cu",
        "replaces": "bulklmm_tpu/pallas/liteqtl_fused.py:106",
        "launches": launches,
        "max_abs_err": kerr,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
