#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
exits nonzero:

1. Device check: refuses to run without CUDA; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``bulklmm_tpu_torch/csrc/*.cu`` for sm_90a from the
   checkout's sources and prints the build time.
3. Each kernel vs its plain version on the card, at small shapes. The LOD
   kernel: c = 1, 2, 3 and 8 covariate columns, a ragged 70 x 45 tile edge,
   and n = 2,000 to cross many sample chunks. The alt-grid kernel: c = 1, 2
   and 3, g = 1 and 10, the ragged edge, n = 2,000, with the h2 panel on
   and off. Bar: max |dLOD| <= 5e-5 (the JAX package's bar for its Pallas
   kernels), scaled by n/48 above n = 79; at most 0.01 % of the pairs may
   take another grid index (near-ties under another summation order).
4. The null-grid path at BXD scale (79 samples x 7,321 markers x 35,554
   traits, synthetic, seed 2026): BALANCED ``bulkscan`` on CUDA tensors must
   launch the LOD kernel and give a finite (7321, 35554) L; the kernel must
   match its plain version on the scan's own rotated inputs and h2 within
   5e-5; and L must stay within 1e-4 of the EXACT64 scan (the float64
   oracle) on the traits whose grid h2 agrees.
5. The alt-grid path at BXD scale, default 10-point grid: BALANCED
   ``bulkscan(method="alt-grid")`` must launch the alt-grid kernel and give
   a finite float64 L and h2 panel (the JAX package's dtypes); the kernel
   must match its plain version on the scan's own rotated inputs within
   5e-5; L must stay within 1e-4 of EXACT64 alt-grid on all pairs
   (reported against BASELINE.md's 1e-5 and the JAX package's 2e-5), with
   the h2 panel flips and the peak device memory reported.
6. The null-exact path at BXD scale: BALANCED ``bulkscan(method=
   "null-exact")`` must launch the LOD kernel and stay within 1e-4 of
   EXACT64 null-exact; the largest |dh2| and the Brent iterations are
   reported.
7. Times, printed and not gated: the median of 5 runs after one warm-up,
   by CUDA events around the work and then a checksum fetch, of each
   BALANCED ``bulkscan`` (host eigendecomposition included), and of each
   kernel alone and its plain version at the scan's shape.

Every path runs with every kernel's launch counter set to 0 just before it
and read just after. The second-to-last line is one JSON object describing
each kernel; the last is ``{"ok": true, "device": {...}}``. Imports nothing
of JAX.
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
JAX_ALTGRID_BAR = 2e-5  # the JAX package's bar for alt-grid, reported
INDEX_FLIP_SHARE = 1e-4  # grid-index flips, kernel vs plain, share of pairs
GRID = np.arange(0.0, 0.91, 0.1)  # bulkscan's default h2 grid
PRIOR = (1.0, 0.0)  # bulkscan's default prior


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
        print(f"  LOD kernel vs plain n={n} p={p} m={m} c={c}: max|dLOD| = {err:.3e} (bar {bar:.2e})")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "kernel output not finite")
        check(err <= bar, f"kernel disagrees with its plain version at {(n, p, m, c)}")


def _index_flips(kk, kp) -> int:
    return int((kk != kp).sum())


def altgrid_checks(dev) -> None:
    from bulklmm_tpu_torch.kernels import altgrid_fused as af

    rng = np.random.default_rng(4)
    cases = [(48, 96, 64, c, 10, True) for c in (1, 2, 3)] + [
        (48, 96, 64, 1, 1, True), (48, 96, 64, 2, 1, False), (48, 70, 45, 2, 10, True),
        (48, 70, 45, 3, 10, False), (2000, 96, 64, 2, 10, True),
    ]
    for n, p, m, c, g, panel in cases:
        Y0, X0m, C0, lam, _ = _kernel_inputs(n, p, m, c, rng, dev)
        grid = torch.as_tensor(GRID[:g] if g > 1 else [0.3], dtype=torch.float32, device=dev)
        ops = af.prepare_inputs(Y0, X0m, C0, lam, grid, prior=PRIOR)
        out, kk = af.altgrid_cuda(*ops, panel=panel)
        torch.cuda.synchronize()
        ref, kp = af.altgrid_plain(*ops, panel=panel)
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        err = (out - ref).abs().max().item()
        flips = _index_flips(kk, kp) if panel else 0
        print(f"  alt-grid kernel vs plain n={n} p={p} m={m} c={c} g={g} panel={panel}: "
              f"max|dLOD| = {err:.3e} (bar {bar:.2e}), index flips {flips} of {p * m}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "alt-grid output not finite")
        check(err <= bar, f"alt-grid kernel disagrees with its plain version at {(n, p, m, c, g)}")
        check((kk is None) == (not panel), "alt-grid index returned against the panel flag")
        check(flips <= INDEX_FLIP_SHARE * p * m, f"alt-grid index flips at {(n, p, m, c, g)}")
        if panel:
            other, _ = af.altgrid_cuda(*ops, panel=False)
            check(torch.equal(other, out), "alt-grid L depends on the panel flag")


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


def _reset_counts():
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    lf.launches = af.launches = 0


def _counts():
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    return {"liteqtl_lod": lf.launches, "altgrid": af.launches}


def _drive(what, fn):
    """One path with every launch count set to 0 just before and read just
    after; prints the first call's time and the peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = _counts()
    print(f"  {what}, first call: {first_s:.3f} s, kernel launches: {counts}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return res, counts


def _rotated_bxd(K, Yd, Gd, dev):
    from bulklmm_tpu_torch.ops.rotation import decompose_kinship
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    dec = decompose_kinship(K, dtype=torch.float64, device=dev)
    with with_highest_matmul():
        Y0 = dec.Ut @ Yd.double()
        X0m = dec.Ut @ Gd.double()
        C0 = dec.Ut @ torch.ones((N, 1), dtype=torch.float64, device=dev)
    return Y0, X0m, C0, dec.lam


def slice_at_bxd(dev):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    G, K, Y = synth_bxd()
    Gd = torch.from_numpy(G).to(dev)
    Yd = torch.from_numpy(Y).to(dev)
    res, counts = _drive("BALANCED null-grid bulkscan",
                         lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED))
    launches = counts["liteqtl_lod"]
    check(launches > 0, "the BALANCED bulkscan did not launch the CUDA kernel")
    check(tuple(res.L.shape) == (P, M), f"L has shape {tuple(res.L.shape)}")
    check(res.L.is_cuda and res.L.dtype == torch.float32, "L is not float32 on the card")
    check(bool(torch.isfinite(res.L).all()), "L is not finite")

    # the kernel against its plain version on the scan's own inputs
    Y0, X0m, C0, lam = _rotated_bxd(K, Yd, Gd, dev)
    Lk = lf.fused_lods_per_trait(Y0, X0m, C0, lam, res.h2_null_list)
    torch.cuda.synchronize()
    Lp = lf.fused_lods_per_trait_reference(Y0, X0m, C0, lam, res.h2_null_list)
    torch.cuda.synchronize()
    ops = lf.prepare_inputs(Y0, X0m, C0, lam, res.h2_null_list)
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


def altgrid_at_bxd(dev, Yd, Gd, K):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import altgrid_fused as af

    res, counts = _drive(
        "BALANCED alt-grid bulkscan",
        lambda: bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.BALANCED),
    )
    launches = counts["altgrid"]
    check(launches > 0, "the BALANCED alt-grid bulkscan did not launch the alt-grid kernel")
    check(tuple(res.L.shape) == (P, M) and tuple(res.h2_panel.shape) == (P, M),
          f"alt-grid L {tuple(res.L.shape)}, panel {tuple(res.h2_panel.shape)}")
    check(res.L.is_cuda and res.L.dtype == res.h2_panel.dtype == torch.float64,
          "alt-grid L and h2_panel are not float64 on the card (the JAX package's dtypes)")
    check(bool(torch.isfinite(res.L).all()), "alt-grid L is not finite")
    grid = torch.as_tensor(GRID, dtype=torch.float64, device=dev)
    check(bool(torch.isin(res.h2_panel, grid).all()), "alt-grid h2_panel holds off-grid values")

    # the kernel against its plain version on the scan's own rotated inputs
    ops = af.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev), grid, prior=PRIOR)
    Lk, kk = af.altgrid_cuda(*ops)
    torch.cuda.synchronize()
    Lp, kp = af.altgrid_plain(*ops)
    torch.cuda.synchronize()
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    kerr = _max_abs_diff_cols(Lk, Lp, all_cols)
    flips = _index_flips(kk, kp)
    same_as_scan = _max_abs_diff_cols(Lk, res.L, all_cols)
    print(f"  alt-grid kernel vs plain at BXD scale: max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}), "
          f"index flips {flips} of {P * M}; kernel vs the scan's L: {same_as_scan:.3e}")
    check(kerr <= KERNEL_BAR, "alt-grid kernel disagrees with its plain version at BXD scale")
    check(flips <= INDEX_FLIP_SHARE * P * M, "alt-grid kernel index flips at BXD scale")
    del Lk, kk, Lp, kp

    exact = bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.EXACT64)
    torch.cuda.synchronize()
    oerr = _max_abs_diff_cols(res.L, exact.L, all_cols)
    pflips = int((res.h2_panel != exact.h2_panel).sum())
    print(f"  alt-grid BALANCED vs EXACT64 on all {P * M} pairs: max|dLOD| = {oerr:.3e} "
          f"(bar {ORACLE_BAR:.0e}; BASELINE.md's {PARITY_BAR:.0e}: "
          f"{'met' if oerr <= PARITY_BAR else 'NOT met'}; the JAX package's "
          f"{JAX_ALTGRID_BAR:.0e}: {'met' if oerr <= JAX_ALTGRID_BAR else 'NOT met'}); "
          f"h2_panel flips {pflips} ({pflips / (P * M):.2e} of the pairs)")
    check(oerr <= ORACLE_BAR, "alt-grid BALANCED strays from the EXACT64 oracle")
    del exact, res
    return ops, launches, kerr


def nullexact_at_bxd(dev, Yd, Gd, K):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops import brent

    res, counts = _drive(
        "BALANCED null-exact bulkscan",
        lambda: bt.bulkscan(Yd, Gd, K, method="null-exact", precision=bt.BALANCED),
    )
    iters = brent.iterations
    check(counts["liteqtl_lod"] > 0, "the BALANCED null-exact bulkscan did not launch the LOD kernel")
    check(tuple(res.L.shape) == (P, M) and res.L.dtype == torch.float32, "null-exact L shape or dtype")
    check(res.h2_null_list.dtype == torch.float64, "null-exact h2 is not float64 under BALANCED")
    check(bool(torch.isfinite(res.L).all()), "null-exact L is not finite")
    exact = bt.bulkscan(Yd, Gd, K, method="null-exact", precision=bt.EXACT64)
    torch.cuda.synchronize()
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    oerr = _max_abs_diff_cols(res.L, exact.L, all_cols)
    dh2 = (res.h2_null_list - exact.h2_null_list).abs().max().item()
    print(f"  null-exact BALANCED vs EXACT64: max|dLOD| = {oerr:.3e} (bar {ORACLE_BAR:.0e}; "
          f"BASELINE.md's {PARITY_BAR:.0e}: {'met' if oerr <= PARITY_BAR else 'NOT met'}); "
          f"max|dh2| = {dh2:.3e}; Brent iterations {iters} (BALANCED), "
          f"{brent.iterations} (EXACT64)")
    check(oerr <= ORACLE_BAR, "null-exact BALANCED strays from the EXACT64 oracle")
    del exact, res


def times(card, Yd, Gd, K, lod_ops, alt_ops):
    """Median of 5 runs after one warm-up each; every kernel and its plain
    version run in turns, so drifting clocks hit both alike."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    runs = {
        "BALANCED null-grid bulkscan": lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED).L,
        "LOD kernel alone": lambda: lf.liteqtl_lod_cuda(*lod_ops),
        "LOD plain version": lambda: lf.liteqtl_lod_plain(*lod_ops),
        "BALANCED alt-grid bulkscan": lambda: bt.bulkscan(
            Yd, Gd, K, method="alt-grid", precision=bt.BALANCED).L,
        "alt-grid kernel alone": lambda: af.altgrid_cuda(*alt_ops)[0],
        "alt-grid plain version": lambda: af.altgrid_plain(*alt_ops)[0],
        "BALANCED null-exact bulkscan": lambda: bt.bulkscan(
            Yd, Gd, K, method="null-exact", precision=bt.BALANCED).L,
    }
    ms = {name: [] for name in runs}
    for fn in runs.values():
        _time_ms(fn)
    for _ in range(5):
        for name, fn in runs.items():
            ms[name].append(_time_ms(fn))
    print(f"  times on {card}, median of 5 (ms):")
    med = {name: statistics.median(t) for name, t in ms.items()}
    for name, t in ms.items():
        print(f"    {name:28s} {med[name]:9.3f}   runs {[round(x, 3) for x in t]}")
    flops = 2.0 * N * P * M * len(GRID)
    print(f"  alt-grid kernel: {flops / med['alt-grid kernel alone'] / 1e9:.1f} TFLOP/s "
          f"({flops:.3e} flops)")
    return med


def main() -> None:
    import_port()
    print("[1] device check")
    card = device_check()
    dev = torch.device("cuda", 0)
    print("[2] build")
    build()
    print("[3] kernels vs their plain versions on the card")
    kernel_checks(dev)
    altgrid_checks(dev)
    print(f"[4] BALANCED null-grid bulkscan at BXD scale ({N} x {P} x {M})")
    Yd, Gd, K, lod_ops, lod_launches, lod_err = slice_at_bxd(dev)
    print(f"[5] BALANCED alt-grid bulkscan at BXD scale ({N} x {P} x {M}, g = {len(GRID)})")
    alt_ops, alt_launches, alt_err = altgrid_at_bxd(dev, Yd, Gd, K)
    print(f"[6] BALANCED null-exact bulkscan at BXD scale ({N} x {P} x {M})")
    nullexact_at_bxd(dev, Yd, Gd, K)
    print("[7] times")
    med = times(card, Yd, Gd, K, lod_ops, alt_ops)
    print(json.dumps({"kernels": [{
        "name": "liteqtl_lod",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/liteqtl_fused.cu",
        "replaces": "bulklmm_tpu/pallas/liteqtl_fused.py:106",
        "launches": lod_launches,
        "max_abs_err": lod_err,
        "ms": med["LOD kernel alone"],
        "plain_ms": med["LOD plain version"],
    }, {
        "name": "altgrid",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/altgrid_fused.cu",
        "replaces": "bulklmm_tpu/pallas/altgrid_fused.py:177",
        "launches": alt_launches,
        "max_abs_err": alt_err,
        "ms": med["alt-grid kernel alone"],
        "plain_ms": med["alt-grid plain version"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
