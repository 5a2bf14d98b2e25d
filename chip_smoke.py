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
   kernel: c = 1, 2 and 3 covariate columns on the resident kernel and 4 and
   8 on the general one, a ragged 70 x 45 tile edge, n = 79, 80, 81, 88 (the
   deepest resident operand) and 89 (the first general one), 129 and 321
   markers x 65 and 130 traits (one past a tile each way, an odd row length
   of the output, several marker groups), n = 2,000 to cross many sample
   chunks, and the general kernel forced at a resident shape; the launcher's
   resident-or-general rule must be the wrapper module's. The alt-grid
   kernel: c = 1, 2
   and 3, g = 1 and 10, the ragged edge, n = 79, 80 and 81 (the last one
   past a sample chunk), 129 markers x 65 traits (one past a tile each way),
   n = 2,000, with the h2 panel on and off. The bulk-permutation kernel:
   c = 1, 2 and 3, K = 1 (the observed column alone), 24 and 257 (one past a
   tile), 65 markers (one past a tile), a ragged 70-marker x 5-trait block,
   n = 79, 80, 81, 88 (the deepest resident operand) and 89 (the first
   chunked one), n = 2,000, and a block with one masked trait and one masked
   marker; the launcher's resident-or-chunked rule must be the wrapper
   module's. Bar: max |dLOD| <= 5e-5 (the JAX package's bar for its Pallas
   kernels), scaled by n/48 above n = 79, and max |d max r^2| <= 1e-5 for
   the permutation kernel; at most 0.01 % of the pairs may take another grid
   index (near-ties under another summation order). The resident LOD
   kernel, the permutation and the alt-grid kernels take their products as
   three TF32 passes on the tensor cores; each is also held, reported and
   not gated, against its split reference, which repeats that arithmetic in
   plain torch. The LOD kernel's effects variant (LOD, effect and standard
   error from the same products) at the same kind of shapes (c = 1, 2, 3
   resident and 4, 8 general; n = 48, 79, 88, 89 and 2,000; the ragged edge;
   the general kernel forced): max |dLOD| within the bar above, its LOD
   within 1e-6 of the LOD-only kernel's on the same operands, |d effect| <=
   1e-4 (|effect| + SE) and |dSE| <= 1e-4 SE. The run fails, at its end, if
   ptxas reported a spill in any kernel or if the LOD-only instantiations'
   registers or shared memory moved from LOD_ONLY_PTXAS.
4. The null-grid path at BXD scale (79 samples x 7,321 markers x 35,554
   traits, synthetic, seed 2026): BALANCED ``bulkscan`` on CUDA tensors must
   launch the LOD kernel and give a finite (7321, 35554) L; the kernel must
   match its plain version on the scan's own rotated inputs and h2 within
   5e-5 (its split reference and the general kernel are reported beside
   it); and L must stay within 1e-4 of the EXACT64 scan (the float64
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
7. The permutation path at BXD scale: BALANCED ``bulkscan_perms`` with
   1,000 permutations (1,001 columns) on CUDA tensors must launch the
   bulk-permutation kernel and give a finite (35554, 1001) float32
   ``maxlods`` on the card; column 0 must equal the per-trait maximum of
   phase 4's L within 1e-4; the kernel must match its plain version on the
   scan's own operands for the first 1,024-trait block; and ``maxlods`` must
   stay within 1e-4 of the EXACT64 run (plain engine, float64, the same
   shuffle indices) on the traits whose grid h2 agrees. The oracle runs
   over blocks of 4,096 traits until 20 s are spent and prints how many
   traits it covered. On the first 2,048 traits, trait blocks of 500 and
   permutation chunks of 300 must give the default blocks' maxima within
   5e-5, and ``method="null-exact"`` with 100 permutations must stay
   within 1e-4 of its EXACT64 run. The medians over traits of
   ``get_thresholds_bulk``'s thresholds and the peak device memory are
   reported.
8. Times, printed and not gated, by CUDA events around the work and then a
   checksum fetch: the median of 5 runs after one warm-up of each BALANCED
   ``bulkscan`` (host eigendecomposition included) and of the LOD and
   alt-grid kernels alone and their plain versions at the scan's shape, the
   general LOD kernel at that shape beside the resident one, and both with
   2, 3 and 4 covariate columns (random operands; 4 takes the general
   kernel alone); the
   median of 3 after a warm-up of BALANCED ``bulkscan_perms``, of the
   bulk-permutation kernel alone and of its plain version, per trait block
   and summed over all trait blocks (each block's operands prepared
   outside the timed region). Beside them, never called by the port:
   cuBLAS's batched float32 product alone at the permutation kernel's shape
   (36 traits' numerator, scaled to 1,024 traits), with TF32 off and on, as
   ``product_only_ms``: what the card's own products take for the same flops.
9. The single-trait scans, which run no kernel of their own (plain torch
   products, as in the JAX package), at BXD width (79 x 7,321; trait 0 of
   phase 4's data with an effect planted at a marker drawn from the seed,
   half of the trait's variance) and at cohort size (2,000 x 20,000 from
   the same generator, its kinship by the port's ``calc_kinship``): under
   BALANCED and under EXACT64, ``scan`` null with effects and p-values,
   ``scan(assumption="alt")`` with effects,
   ``scan(permutation_test=True)`` and ``scan_perms_lite`` with 1,024
   permutations, and at BXD width the profile likelihood of the planted
   marker. Every output must be finite and on the card; h2_null the same
   float64 number under both presets; max |dLOD| <= 1e-4 against EXACT64
   for the null, alt and every permutation column (reported against 1e-5;
   the float32 products' gates scaled by n/79 at cohort size); the two
   permutation entry points equal; column 0 within the gate of the null
   scan; the planted marker the null scan's argmax. The largest |dh2| of
   the alt scan and its Brent iterations are reported. Times, not gated:
   the median of 5 after a warm-up of the BALANCED null, alt and
   ``scan_perms_lite`` with a cached decomposition, at BXD width also the
   median of 3 with the raw K, at cohort size the eigendecomposition once,
   and the host null fit alone by the host clock.

10. The bulk options at BXD scale (phase 4's data, BALANCED, EXACT64 as the
    oracle): ``bulkscan(output_effects=True)`` must launch the effects
    variant, give phase 4's L within 1e-6, and effects within the bars above
    of EXACT64's on the equal-h2 traits; the effects variant's time beside
    its plain version's (median of 5). ``missing="mask"`` with NaNs planted
    in 5 % of the traits (1-4 individuals each, 8 patterns): within 1e-4 of
    the EXACT64 masked run on the equal-h2 traits, its time beside the
    unmasked call's; ``missing="drop"`` equal to the scan of the complete
    individuals; masked ``bulkscan_perms`` (100 permutations, the first
    2,048 traits) within 1e-4 of EXACT64. ``auto_trait_chunk``'s decisions
    under the card's own budget, printed; ``bulkscan`` under a budget forced
    to 2 GiB must take host blocks, give the one-block L within 5e-5 (phase
    7's bar for other trait blocks) and keep the call's peak device memory
    under the budget.
    ``bulkscan_streamed`` alt-grid with the panel on the host in blocks of
    2,048 markers: the alt-grid kernel once a block, phase 5's L within
    1e-5, h2 panel flips within phase 3's share; ``bulkscan_perms_streamed``
    (100 permutations, 2,048 traits) within 5e-5 of ``bulkscan_perms``.
    Last of all, the memory model's live sets: each method's peak device
    memory above its inputs in (p, m) float64 arrays at BXD width, and in
    (n, m) ones at n = 2,000 with 64 markers (alt-grid's a grid point),
    beside ``utils/memory.py``'s multipliers, which must cover them.
11. Marker streaming at biobank n: null-grid, BALANCED, 2,000 samples x
    100,000 markers (an 800 MB float32 host panel, never on the card) x
    2,048 traits, the general LOD kernel, into an ``np.memmap`` in a
    temporary directory: within 1e-4 x n / 79 of the in-memory scan of the
    same data. Printed: both times (median of 3, host clock), their ratio
    (the upload overlap) and the streamed call's device idle share.
12. The low-rank kinship engine (``LowRankKinship``), which runs no kernel
    in either package (plain products; every launch count must stay 0).
    (a) At k = n on phase 4's data (``kinship_lowrank_exact(K, 79)``):
    BALANCED ``bulkscan`` null-grid, null-exact and alt-grid within 1e-4 of
    the rotated engine's EXACT64 scans (null-grid on the equal-h2 traits);
    ``bulkscan_perms`` on phase 10's cut (2,048 traits, 100 permutations,
    the port's indices of seed 0) within 1e-4 of its EXACT64 sweep on the
    same factors, its column 0 within 1e-4 of the rotated EXACT64 scan's
    per-trait maxima (the other columns shuffle whitened residuals in sample
    coordinates: a rank-k statistic). (b) benchmarks/lowrank_cohort.py's
    cohort, drawn on the card from a generator seeded with 2026 (0/1
    genotypes whose frequencies follow 8 ancestry directions through a
    sigmoid load, normal traits): 20,000 samples x 50,000 markers x 2,000
    traits at k = 2,048. ``kinship_lowrank_from_geno`` under BALANCED (a
    float64 panel), its time and its Rayleigh residual max_i ||K u_i -
    lam_i u_i|| / lam_1 through K applied a marker block at a time (<= 0.05,
    tests/test_lowrank.py's bar); BALANCED ``bulkscan`` null-grid,
    null-exact (its Brent iterations and the launches of one call, counted
    by the profiler), alt-grid and null-grid with effects, each within
    1e-4 x n/79 of EXACT64 on the same factors, the effects' errors
    reported; ``scan`` of trait 0 with 1,024 permutations, every column
    within the same bar; ``bulkscan_perms`` cut to 256 traits x 100
    permutations within it, column 0 within it of the scan's maxima; and
    ``bulkscan_streamed`` with the panel on the host in blocks of 8,192
    markers within it of the in-memory null-grid. Times of a second call by
    the host clock and the peak device memory. Last, the rank-k live sets
    (at BXD width, rank 79, in (p, m) float64 arrays; at 2,000 x 64 x 8,192,
    rank 2,000, against the model's whole footprint) must stay within
    ``utils/memory.py``'s rank-k multipliers. Cuts, to keep the phase near
    40 s: the permutation sweeps' traits and permutations, as stated.

Every path runs with every kernel's launch counter set to 0 just before it
and read just after. The second-to-last line is one JSON object describing
each kernel, with its bound on this card: the larger of its bytes (each
operand read once, each result written once) over 3.35 TB/s and the least
time either unit takes for float32-grade products of its operations, the
smaller of flops over 67 TFLOP/s (CUDA cores) and 3 x flops over 495
TFLOP/s (three TF32 passes on the tensor cores); ``bound_unit`` names the
unit and ``simt_bound_ms`` keeps the CUDA cores' time;
``general_kernel_ms`` is the LOD step's general kernel at the same shape;
``effects_ms``, ``effects_plain_ms`` and ``effects_bound_ms`` are its effects
variant's time, its plain version's and its bound (the same operations,
three (p, m) float32 outputs written). No
single PyTorch call computes any of the three kernels' functions, so
``library_ms`` is null. The last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N, P, M = 79, 7321, 35554
NPERMS = 1000
PERM_BLOCK = 1024  # bulkscan_perms' trait block under the kernel's engine
ORACLE_BLOCK, ORACLE_SECONDS = 4096, 20.0
OPTION_TRAITS = 2048  # traits of the chunking and null-exact checks of the permutation path
SEED = 2026
PEAK_FLOPS, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12  # H100 SXM: float32 SIMT, TF32, HBM3
SPLIT_PASSES = 3  # TF32 tensor-core passes of one float32-grade product
KERNEL_BAR = 5e-5  # max |dLOD|, kernel vs plain, n <= 79
R2_BAR = 1e-5  # max |d max r^2|, permutation kernel vs plain
ORACLE_BAR = 1e-4  # max |dLOD|, BALANCED vs EXACT64 on equal-h2 traits
PARITY_BAR = 1e-5  # BASELINE.md's accuracy bar, reported
JAX_ALTGRID_BAR = 2e-5  # the JAX package's bar for alt-grid, reported
INDEX_FLIP_SHARE = 1e-4  # grid-index flips, kernel vs plain, share of pairs
EFFECT_BAR = 1e-4  # |d effect| / (|effect| + SE) and |dSE| / SE
SAME_LOD_BAR = 1e-6  # max |dLOD|, the effects variant vs the LOD-only kernel
MASK_SHARE, MASK_PATTERNS = 0.05, 8  # phase 10's planted missing values
MASK_NPERMS = 100  # permutations of phase 10's masked and streamed sweeps
FORCED_BUDGET = 2 * 2**30  # phase 10's forced device memory budget, bytes
STREAM_BLOCK = 2048  # phase 10's marker block
STREAM_BAR = 1e-5  # max |dLOD|, streamed vs in-memory alt-grid
CALIBRATION_TRAITS = 8192  # traits of phase 10's memory live-set calls
BIOBANK_N, BIOBANK_P, BIOBANK_M = 2000, 100_000, 2048  # phase 11
#: ptxas's (registers, spill stores, spill loads, static shared bytes) of the
#: LOD kernel's LOD-only instantiations, as phase 2 printed them for the
#: sources before the effects variant came (NVIDIA H100, CUDA 12.8's nvcc):
#: the effects variant must leave them as they were
LOD_ONLY_PTXAS = {
    "liteqtl_general_kernelILi8ELb0E": (223, 0, 0, 24320),
    "liteqtl_general_kernelILi7ELb0E": (220, 0, 0, 21952),
    "liteqtl_general_kernelILi6ELb0E": (255, 0, 0, 19840),
    "liteqtl_general_kernelILi5ELb0E": (244, 0, 0, 17984),
    "liteqtl_general_kernelILi4ELb0E": (182, 0, 0, 16384),
    "liteqtl_general_kernelILi3ELb0E": (128, 0, 0, 15040),
    "liteqtl_general_kernelILi2ELb0E": (127, 0, 0, 13952),
    "liteqtl_general_kernelILi1ELb0E": (80, 0, 0, 13120),
    "liteqtl_resident_kernelILi1ELi11ELi1ELb0E": (187, 0, 0, 0),
    "liteqtl_resident_kernelILi1ELi10ELi1ELb0E": (185, 0, 0, 0),
    "liteqtl_resident_kernelILi1ELi8ELi1ELb0E": (185, 0, 0, 0),
    "liteqtl_resident_kernelILi1ELi6ELi1ELb0E": (185, 0, 0, 0),
    "liteqtl_resident_kernelILi1ELi4ELi1ELb0E": (185, 0, 0, 0),
    "liteqtl_resident_kernelILi1ELi2ELi1ELb0E": (186, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi11ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi10ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi8ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi6ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi4ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi2ELi2ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi11ELi0ELb0E": (229, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi10ELi0ELb0E": (230, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi8ELi0ELb0E": (231, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi6ELi0ELb0E": (231, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi4ELi0ELb0E": (236, 0, 0, 0),
    "liteqtl_resident_kernelILi3ELi2ELi0ELb0E": (240, 0, 0, 0),
}
GRID = np.arange(0.0, 0.91, 0.1)  # bulkscan's default h2 grid
PRIOR = (1.0, 0.0)  # bulkscan's default prior
SCAN_NPERMS = 1024  # permutations of the single-trait scans
COHORT_N, COHORT_P = 2000, 20000  # the single-trait cohort size
#: phase 12 (b): benchmarks/lowrank_cohort.py's cohort, its rank and ancestry
LR_N, LR_P, LR_M, LR_RANK, LR_ANCESTRY = 20_000, 50_000, 2_000, 2_048, 8
LR_PERM_TRAITS, LR_NPERMS = 256, 100  # phase 12 (b)'s bulkscan_perms cut
LR_STREAM_BLOCK = 8192  # phase 12 (b)'s marker block
RAYLEIGH_BAR = 0.05  # max_i ||K u_i - lam_i u_i|| / lam_1 (tests/test_lowrank.py:96)
#: phase 12's live sets: markers and rank of the (k,)-sized calls
LR_CAL_P, LR_CAL_RANK = 64, 2000


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


def ptxas_report(log: Path) -> dict:
    """{kernel entry: (registers, spill stores, spill loads, static shared
    bytes)} from a build log's ptxas report; the entry is the kernel's name
    with its template arguments as mangled (``ILi1ELi10ELi1ELb0E``: c = 1,
    10 depth steps, 1 step in flight, no effects)."""
    out, entry = {}, None
    for line in log.read_text().splitlines():
        found = re.search(r"Compiling entry function '\w*\d([a-z_]+_kernel(?:I(?:L[ib]\d+E)+)?)E", line)
        if found:
            entry = found.group(1)
            out[entry] = [0, 0, 0, 0]
        elif entry and (spills := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[entry][1:3] = [int(spills.group(1)), int(spills.group(2))]
        elif entry and (regs := re.search(r"Used (\d+) registers", line)):
            out[entry][0] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[entry][3] = int(smem.group(1)) if smem else 0
    return {k: tuple(v) for k, v in out.items()}


def build() -> dict:
    """Builds the library and prints the build time and ptxas's report;
    returns the report (:func:`ptxas_report`)."""
    from bulklmm_tpu_torch.kernels.build import BUILD_DIR, load_library

    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    log = BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            entry = re.search(
                r"Compiling entry function '\w*\d([a-z_]+_kernel(?:I(?:L[ib]\d+E)+)?)E", line)
            if entry:
                print("  ptxas:", entry.group(1))
            elif "registers" in line or "spill" in line:
                print("  ptxas:  ", line.replace("ptxas info    : ", "").strip())
        return ptxas_report(log)
    return {}


def check_ptxas(report: dict) -> None:
    """No kernel spills, and the LOD-only instantiations' figures are
    LOD_ONLY_PTXAS's. Checked at the end of the run, so that one run shows
    every phase."""
    spilled = sorted(k for k, (_, st, ld, _) in report.items() if st or ld)
    moved = {k: (report.get(k), want) for k, want in LOD_ONLY_PTXAS.items() if report.get(k) != want}
    print(f"  ptxas: kernels that spill {spilled}; LOD-only instantiations whose figures moved {moved}")
    check(not spilled, f"ptxas spills in {spilled}")
    check(not moved, f"the LOD-only instantiations' ptxas figures changed: {moved}")


def _kernel_inputs(n, p, m, c, rng, dev):
    f32 = np.float32
    Y0 = rng.normal(size=(n, m)).astype(f32)
    X0m = rng.normal(size=(n, p)).astype(f32)
    C0 = np.concatenate([np.ones((n, 1))] + [rng.normal(size=(n, 1)) for _ in range(c - 1)], 1)
    lam = rng.uniform(0.1, 2.0, n).astype(f32)
    h2 = rng.uniform(0.0, 0.9, m).astype(f32)
    return [torch.from_numpy(np.asarray(a, dtype=f32)).to(dev) for a in (Y0, X0m, C0, lam, h2)]


def kernel_checks(dev) -> None:
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    rng = np.random.default_rng(3)
    cases = [(48, 96, 64, c, False) for c in (1, 2, 3, 4, 8)] + [
        (48, 70, 45, 1, False), (79, 129, 65, 1, False), (80, 129, 65, 2, False),
        (81, 129, 65, 3, False), (88, 321, 130, 1, False), (89, 96, 64, 1, False),
        (79, 1000, 131, 2, False), (79, 129, 65, 3, True), (2000, 96, 64, 2, False),
    ]
    for n, p, m, c, general in cases:
        path = lf.kernel_path(n, c)
        check((path == "resident") == bool(lf._library().bulklmm_liteqtl_is_resident(n, c, 0)),
              f"the launcher and kernel_path disagree on the LOD kernel at n={n}, c={c}")
        ops = lf.prepare_inputs(*_kernel_inputs(n, p, m, c, rng, dev))
        out = lf.liteqtl_lod_cuda(*ops, general=general)
        torch.cuda.synchronize()
        ref = lf.liteqtl_lod_plain(*ops)
        split_err = (out - lf.liteqtl_split_reference(*ops)).abs().max().item()
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        err = (out - ref).abs().max().item()
        print(f"  LOD kernel ({'general' if general else path}) vs plain n={n} p={p} m={m} c={c}: "
              f"max|dLOD| = {err:.3e} (bar {bar:.2e}); vs its split reference {split_err:.3e}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "kernel output not finite")
        check(err <= bar, f"kernel disagrees with its plain version at {(n, p, m, c)}")
    check(lf.kernel_path(88, 3) == "resident" and lf.kernel_path(89, 1) == "general"
          and lf.kernel_path(79, 4) == "general",
          "the resident limits moved: bring the shapes above up to date")


def _effects_errors(eff, ref):
    """(max |dLOD|, max |d effect| / (|effect| + SE), max |dSE| / SE) of the
    kernel's effects variant against its plain version."""
    (L, b, s), (Lr, br, sr) = eff, ref
    lod = (L - Lr).abs().max().item()
    beta = ((b.double() - br.double()).abs() / (br.double().abs() + sr.double())).max().item()
    se = ((s.double() - sr.double()).abs() / sr.double()).max().item()
    return lod, beta, se


def effects_checks(dev) -> None:
    """The LOD kernel's effects variant against its plain version and
    against the LOD-only kernel on the same operands."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    rng = np.random.default_rng(9)
    cases = [(48, 96, 64, c, False) for c in (1, 2, 3, 4, 8)] + [
        (48, 70, 45, 1, False), (79, 129, 65, 1, False), (79, 1000, 131, 2, False),
        (88, 321, 130, 3, False), (89, 96, 64, 1, False), (79, 129, 65, 3, True),
        (2000, 96, 64, 2, False),
    ]
    for n, p, m, c, general in cases:
        path = lf.kernel_path(n, c, effects=True)
        check(path == lf.kernel_path(n, c), f"the effects variant takes another path at n={n}, c={c}")
        check((path == "resident") == bool(lf._library().bulklmm_liteqtl_is_resident(n, c, 1)),
              f"the launcher and kernel_path disagree on the effects variant at n={n}, c={c}")
        ops = lf.prepare_inputs(*_kernel_inputs(n, p, m, c, rng, dev), effects=True)
        eff = lf.liteqtl_lod_cuda(*ops, general=general, effects=True)
        only = lf.liteqtl_lod_cuda(*ops[:4], ops[4][:-1], general=general)
        torch.cuda.synchronize()
        ref = lf.liteqtl_lod_plain(*ops, effects=True)
        split = lf.liteqtl_split_reference(*ops, effects=True)
        torch.cuda.synchronize()
        check(all(t.shape == (p, m) and bool(torch.isfinite(t).all()) for t in eff),
              "effects variant output not finite")
        lod_err, beta_err, se_err = _effects_errors(eff, ref)
        split_errs = _effects_errors(eff, split)
        same = (eff[0] - only).abs().max().item()
        bar = KERNEL_BAR * max(1.0, n / 48)
        print(f"  LOD kernel, effects variant ({'general' if general else path}) vs plain n={n} p={p} "
              f"m={m} c={c}: max|dLOD| = {lod_err:.3e} (bar {bar:.2e}), max|d effect|/(|effect|+SE) "
              f"= {beta_err:.3e}, max|dSE|/SE = {se_err:.3e} (bars {EFFECT_BAR:.0e}); its LOD vs the "
              f"LOD-only kernel's {same:.3e} (bar {SAME_LOD_BAR:.0e}); vs its split reference "
              + ", ".join(f"{e:.3e}" for e in split_errs))
        check(lod_err <= bar and beta_err <= EFFECT_BAR and se_err <= EFFECT_BAR,
              f"the effects variant disagrees with its plain version at {(n, p, m, c)}")
        check(same <= SAME_LOD_BAR, f"the effects variant's LOD is not the LOD kernel's at {(n, p, m, c)}")


def _index_flips(kk, kp) -> int:
    return int((kk != kp).sum())


def altgrid_checks(dev) -> None:
    from bulklmm_tpu_torch.kernels import altgrid_fused as af

    rng = np.random.default_rng(4)
    cases = [(48, 96, 64, c, 10, True) for c in (1, 2, 3)] + [
        (48, 96, 64, 1, 1, True), (48, 96, 64, 2, 1, False), (48, 70, 45, 2, 10, True),
        (48, 70, 45, 3, 10, False), (79, 129, 65, 1, 10, True), (80, 129, 65, 2, 10, True),
        (81, 129, 65, 3, 10, True), (2000, 96, 64, 2, 10, True),
    ]
    for n, p, m, c, g, panel in cases:
        Y0, X0m, C0, lam, _ = _kernel_inputs(n, p, m, c, rng, dev)
        grid = torch.as_tensor(GRID[:g] if g > 1 else [0.3], dtype=torch.float32, device=dev)
        ops = af.prepare_inputs(Y0, X0m, C0, lam, grid, prior=PRIOR)
        out, kk = af.altgrid_cuda(*ops, panel=panel)
        torch.cuda.synchronize()
        ref, kp = af.altgrid_plain(*ops, panel=panel)
        split_ref, _ = af.altgrid_split_reference(*ops, panel=False)
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        err = (out - ref).abs().max().item()
        flips = _index_flips(kk, kp) if panel else 0
        print(f"  alt-grid kernel vs plain n={n} p={p} m={m} c={c} g={g} panel={panel}: "
              f"max|dLOD| = {err:.3e} (bar {bar:.2e}), index flips {flips} of {p * m}; "
              f"vs its split reference {(out - split_ref).abs().max().item():.3e}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "alt-grid output not finite")
        check(err <= bar, f"alt-grid kernel disagrees with its plain version at {(n, p, m, c, g)}")
        check((kk is None) == (not panel), "alt-grid index returned against the panel flag")
        check(flips <= INDEX_FLIP_SHARE * p * m, f"alt-grid index flips at {(n, p, m, c, g)}")
        if panel:
            other, _ = af.altgrid_cuda(*ops, panel=False)
            check(torch.equal(other, out), "alt-grid L depends on the panel flag")


def _perm_operands(n, p, mb, c, K, rng, dev):
    """The permutation kernel's operands from random rotated data, through
    the package's own preparation."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.ops import bulkperm as ob

    Y0, X0m, C0, lam, h2 = _kernel_inputs(n, p, mb, c, rng, dev)
    S, Q, wrn = ob.perm_trait_parts(Y0, C0, lam, h2, precision=bt.FAST32)
    sw, Qs = S.T.contiguous(), torch.stack(Q, 0).permute(2, 0, 1).contiguous()
    idx = ob.permutation_indices(n, K - 1, 5).to(dev)
    S2 = bf.prepare_chunk_inputs(sw, Qs, wrn, idx)
    return X0m.contiguous(), S2, bf.prepare_trait_block(X0m, sw, Qs, precision=bt.FAST32)


def _perm_kernel_errors(ops, n):
    """(max |d max r^2|, max |dLOD|, kernel result, plain result)."""
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod

    out = bf.bulkperm_maxr2_cuda(*ops)
    torch.cuda.synchronize()
    ref = bf.bulkperm_maxr2_plain(*ops)
    torch.cuda.synchronize()
    check(out.shape == ref.shape and bool(torch.isfinite(out).all()), "max r^2 not finite")
    lod_err = (maxr2_to_lod(out, n) - maxr2_to_lod(ref, n)).abs().max().item()
    return (out - ref).abs().max().item(), lod_err, out, ref


def bulkperm_checks(dev) -> None:
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf

    rng = np.random.default_rng(6)
    cases = [(48, 96, 8, c, 24) for c in (1, 2, 3)] + [
        (48, 96, 8, 1, 1), (48, 65, 8, 2, 257), (48, 70, 5, 2, 130), (79, 96, 8, 1, 24),
        (80, 96, 8, 2, 24), (81, 96, 8, 1, 24), (88, 96, 8, 1, 24), (89, 96, 8, 3, 257),
        (2000, 96, 8, 2, 24),
    ]
    for n, p, mb, c, K in cases:
        path = bf.kernel_path(n)
        check((path == "resident") == bool(bf._library().bulklmm_bulkperm_is_resident(n)),
              f"the launcher and kernel_path disagree on the path at n={n}")
        ops = _perm_operands(n, p, mb, c, K, rng, dev)
        r2_err, lod_err, out, _ = _perm_kernel_errors(ops, n)
        split_err = (out - bf.bulkperm_maxr2_split_reference(*ops)).abs().max().item()
        bar = KERNEL_BAR * max(1.0, n / 48)
        print(f"  permutation kernel ({path}) vs plain n={n} p={p} mb={mb} c={c} K={K}: "
              f"max|d r2| = {r2_err:.3e} (bar {R2_BAR:.0e}), max|dLOD| = {lod_err:.3e} "
              f"(bar {bar:.2e}); vs its split reference max|d r2| = {split_err:.3e}")
        check(r2_err <= R2_BAR and lod_err <= bar,
              f"permutation kernel disagrees with its plain version at {(n, p, mb, c, K)}")
    check(bf.kernel_path(88) == "resident" and bf.kernel_path(89) == "chunked",
          "the resident limit moved: bring the shapes above up to date")
    # a masked trait (all-zero S2) gives 0 exactly; a masked marker cannot win
    for n in (48, 89):
        X, S2, inv = _perm_operands(n, 70, 5, 2, 130, rng, dev)
        S2[1] = 0.0
        inv[:, 3] = 0.0
        r2_err, _, out, ref = _perm_kernel_errors((X, S2, inv), n)
        check(bool((out[1] == 0).all()) and bool((ref[1] == 0).all()), "a masked trait is not 0")
        check(r2_err <= R2_BAR, "permutation kernel disagrees on the masked block")
    print("  permutation kernel, masked trait and masked marker, both paths: "
          "max r2 = 0 exactly on the masked trait")


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
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    lf.launches = lf.effects_launches = af.launches = bf.launches = 0


def _counts():
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    return {"liteqtl_lod": lf.launches, "liteqtl_lod_effects": lf.effects_launches,
            "altgrid": af.launches, "bulkperm_maxr2": bf.launches}


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
    lod_max = res.L.max(0).values  # the permutation phase's observed column

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
    path = lf.kernel_path(N, C0.shape[1])
    print(f"  kernel ({path}) vs plain at BXD scale: max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}); "
          f"kernel vs the scan's L: {same_as_scan:.3e}")
    check(path == "resident", "the main path's shape does not take the resident kernel")
    check(kerr <= KERNEL_BAR, "kernel disagrees with its plain version at BXD scale")
    Lg = lf.liteqtl_lod_cuda(*ops, general=True)
    gerr = _max_abs_diff_cols(Lg, Lp, all_cols)
    del Lg
    Ls = lf.liteqtl_split_reference(*ops)
    serr = _max_abs_diff_cols(Lk, Ls, all_cols)
    print(f"  at BXD scale, reported: kernel vs its split reference {serr:.3e}; "
          f"general kernel vs plain {gerr:.3e} (bar {KERNEL_BAR:.0e})")
    check(gerr <= KERNEL_BAR, "the general kernel disagrees with the plain version at BXD scale")
    del Lp, Ls

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
    return Yd, Gd, K, ops, launches, kerr, lod_max


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
        "LOD general kernel alone": lambda: lf.liteqtl_lod_cuda(*lod_ops, general=True),
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
    # the LOD step with more covariate columns, random operands at the same shape
    rng = np.random.default_rng(8)
    for c in (2, 3, 4):
        ops = lf.prepare_inputs(*_kernel_inputs(N, P, M, c, rng, Yd.device))
        fns = {lf.kernel_path(N, c): lambda: lf.liteqtl_lod_cuda(*ops),
               "general": lambda: lf.liteqtl_lod_cuda(*ops, general=True)}
        for fn in fns.values():
            _time_ms(fn)
        took = {name: statistics.median(_time_ms(fn) for _ in range(5)) for name, fn in fns.items()}
        print(f"    LOD kernel alone, c = {c}: "
              + ", ".join(f"{name} {t:.3f} ms" for name, t in took.items()))
    return med


def _perm_block_operands(prep, idx, lo, hi):
    """The kernel's operands for traits lo..hi of ``_bulkperm_prep``'s state."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf

    X0m, _, _, sqrtw, Qstack, wrn = prep
    sw, Q = sqrtw[lo:hi], Qstack[lo:hi]
    S2 = bf.prepare_chunk_inputs(sw, Q, wrn[:, lo:hi], idx)
    inv_xn = bf.prepare_trait_block(X0m, sw, Q, precision=bt.BALANCED)
    return X0m.to(torch.float32).contiguous(), S2, inv_xn


def perms_at_bxd(dev, Yd, Gd, K, lod_max):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.models import bulkperm as mp
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod, permutation_indices
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    res, counts = _drive(
        "BALANCED bulkscan_perms",
        lambda: bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED),
    )
    launches = counts["bulkperm_maxr2"]
    check(launches > 0, "the BALANCED bulkscan_perms did not launch the permutation kernel")
    ml = res.maxlods
    check(tuple(ml.shape) == (M, NPERMS + 1), f"maxlods has shape {tuple(ml.shape)}")
    check(ml.is_cuda and ml.dtype == torch.float32, "maxlods is not float32 on the card")
    check(bool(torch.isfinite(ml).all()), "maxlods is not finite")
    check(tuple(res.log10_adj_pvals.shape) == (M,) and bool(torch.isfinite(res.log10_adj_pvals).all()),
          "adjusted p-values are not finite")
    obs_err = (res.lod_max.double() - lod_max.double()).abs().max().item()
    print(f"  observed column vs the null-grid scan's per-trait max LOD: max|dLOD| = {obs_err:.3e} "
          f"(bar {ORACLE_BAR:.0e})")
    check(obs_err <= ORACLE_BAR, "column 0 strays from the null-grid scan's maxima")
    thr = bt.get_thresholds_bulk(res.perm_maxima, [0.10, 0.05])
    check(thr.thrs.shape == (2, M) and bool(np.isfinite(thr.thrs).all()), "thresholds not finite")
    print(f"  genome-wide LOD thresholds, median over {M} traits: "
          f"{np.median(thr.thrs[0]):.4f} (10 %), {np.median(thr.thrs[1]):.4f} (5 %); "
          f"traits with an adjusted p <= 0.05: {int((res.log10_adj_pvals >= -np.log10(0.05)).sum())}")

    # the kernel against its plain version on the scan's own operands,
    # the first trait block
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    grid = torch.as_tensor(GRID, dtype=torch.float64, device=dev)
    ones = torch.ones((N, 1), dtype=torch.float64, device=dev)
    with with_highest_matmul():
        prep = mp._bulkperm_prep(
            Yd.double(), Gd.double(), ones, dec.Ut, dec.lam, grid, prior=PRIOR, reml=False,
            method="null-grid", optim_interval=1, precision=bt.BALANCED,
        )
    idx = permutation_indices(N, NPERMS, 0).to(dev)
    ops = _perm_block_operands(prep, idx, 0, PERM_BLOCK)
    r2_err, kerr, out, _ = _perm_kernel_errors(ops, N)
    same_as_scan = (maxr2_to_lod(out, N) - ml[:PERM_BLOCK]).abs().max().item()
    split_err = (out - bf.bulkperm_maxr2_split_reference(*ops)).abs().max().item()
    print(f"  permutation kernel vs plain at BXD scale, traits 0..{PERM_BLOCK}: max|d r2| = {r2_err:.3e} "
          f"(bar {R2_BAR:.0e}), max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}); "
          f"vs its split reference max|d r2| = {split_err:.3e}; "
          f"kernel vs the scan's maxlods: {same_as_scan:.3e}")
    check(r2_err <= R2_BAR and kerr <= KERNEL_BAR,
          "permutation kernel disagrees with its plain version at BXD scale")
    check(same_as_scan <= KERNEL_BAR, "the scan's maxlods are not the kernel's on its own operands")

    # other block shapes and the other method, on the first traits: ragged
    # trait blocks and permutation chunks must not show in the maxima
    sub = slice(0, OPTION_TRAITS)
    chunked = bt.bulkscan_perms(Yd[:, sub], Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED,
                                trait_chunk=500, perm_chunk=300)
    cerr = (chunked.maxlods - ml[sub]).abs().max().item()
    exact_fit = bt.bulkscan_perms(Yd[:, sub], Gd, K, nperms=100, rndseed=0, method="null-exact",
                                  precision=bt.BALANCED)
    exact_ref = bt.bulkscan_perms(Yd[:, sub], Gd, K, nperms=100, rndseed=0, method="null-exact",
                                  precision=bt.EXACT64)
    nerr = (exact_fit.maxlods.double() - exact_ref.maxlods).abs().max().item()
    dh2 = (exact_fit.h2_null_list - exact_ref.h2_null_list).abs().max().item()
    print(f"  traits 0..{OPTION_TRAITS}: trait blocks of 500 and permutation chunks of 300 vs the "
          f"default blocks: max|dLOD| = {cerr:.3e} (bar {KERNEL_BAR:.0e}); null-exact with 100 "
          f"permutations, BALANCED vs EXACT64: max|dLOD| = {nerr:.3e} (bar {ORACLE_BAR:.0e}), "
          f"max|dh2| = {dh2:.3e}")
    check(cerr <= KERNEL_BAR, "the maxima depend on the trait and permutation chunking")
    check(bool(torch.isfinite(exact_fit.maxlods).all()) and nerr <= ORACLE_BAR,
          "null-exact bulkscan_perms strays from its EXACT64 run")
    del chunked, exact_fit, exact_ref

    # the float64 oracle, block by block until its time is spent
    t0 = time.perf_counter()
    oerr, nflip, done = 0.0, 0, 0
    while done < M and time.perf_counter() - t0 < ORACLE_SECONDS:
        hi = min(done + ORACLE_BLOCK, M)
        exact = bt.bulkscan_perms(Yd[:, done:hi], Gd, K, nperms=NPERMS, rndseed=0,
                                  precision=bt.EXACT64)
        same = exact.h2_null_list == res.h2_null_list[done:hi].double()
        nflip += int((~same).sum())
        oerr = max(oerr, (ml[done:hi].double() - exact.maxlods)[same].abs().max().item())
        done = hi
    print(f"  BALANCED vs EXACT64 (plain engine, float64) on traits 0..{done} of {M} "
          f"({time.perf_counter() - t0:.1f} s): {nflip} traits with a different grid h2; "
          f"max|dLOD| on the rest = {oerr:.3e} (bar {ORACLE_BAR:.0e}; BASELINE.md's "
          f"{PARITY_BAR:.0e}: {'met' if oerr <= PARITY_BAR else 'NOT met'})")
    check(done >= min(ORACLE_BLOCK, M), "the EXACT64 oracle covered no trait block")
    check(oerr <= ORACLE_BAR, "BALANCED bulkscan_perms strays from the EXACT64 oracle")
    del exact, res, ml
    return prep, idx, ops, launches, r2_err


def _event_ms(fn) -> float:
    """One run by CUDA events; the caller reads the result."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end)


def perm_times(card, Yd, Gd, K, prep, idx, first_ops):
    """Median of 3 runs after one warm-up. The kernel and its plain version
    run in turns on each trait block's operands, prepared outside the timed
    region; the totals are sums over the blocks of one repeat."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf

    scan = lambda: bt.bulkscan_perms(  # noqa: E731
        Yd, Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED).maxlods
    _time_ms(scan)
    scan_ms = [_time_ms(scan) for _ in range(3)]

    variants = {
        "kernel": lambda ops: bf.bulkperm_maxr2_cuda(*ops),
        "plain": lambda ops: bf.bulkperm_maxr2_plain(*ops),
    }
    first = {name: [] for name in variants}
    total = {name: [0.0] * 3 for name in variants}
    for lo in range(0, M, PERM_BLOCK):
        ops = first_ops if lo == 0 else _perm_block_operands(prep, idx, lo, min(lo + PERM_BLOCK, M))
        for rep in range(-1, 3):  # rep -1 warms up
            for name, fn in variants.items():
                ms = _event_ms(lambda: fn(ops))
                if rep >= 0:
                    total[name][rep] += ms
                    if lo == 0:
                        first[name].append(ms)
        del ops
    nblocks = -(-M // PERM_BLOCK)
    med = statistics.median
    flops = 2.0 * N * P * M * (NPERMS + 1)
    print(f"  times on {card}, median of 3 (ms):")
    print(f"    {'BALANCED bulkscan_perms':44s} {med(scan_ms):10.3f}   runs {[round(x, 3) for x in scan_ms]}")
    for name, t in first.items():
        print(f"    {name + ', traits 0..' + str(PERM_BLOCK):44s} {med(t):10.3f}   runs {[round(x, 3) for x in t]}")
    for name, t in total.items():
        print(f"    {name + ', all ' + str(nblocks) + ' trait blocks':44s} {med(t):10.3f}   runs {[round(x, 3) for x in t]}")
    print(f"  permutation kernel: {flops / med(total['kernel']) / 1e9:.1f} TFLOP/s over all trait blocks "
          f"({flops:.3e} flops; tile of {bf.TILE_K} permutations, {bf.kernel_path(N)} operand)")
    out = {name: med(first[name]) for name in variants}
    out["product_only"] = _product_only_ms(first_ops)
    print(f"  cuBLAS batched float32 product alone at the permutation kernel's shape, scaled to "
          f"{PERM_BLOCK} traits, not called by the port (ms): TF32 off "
          f"{out['product_only']['float32']:.3f}, TF32 on {out['product_only']['tf32']:.3f}")
    return out


def _product_only_ms(ops, traits=36):
    """cuBLAS's batched product (p, n) x (traits, n, K) alone, median of 3
    after a warm-up, scaled to the kernel's trait block; TF32 off and on."""
    X0m, S2, _ = ops
    Xt, Sb = X0m.T.contiguous(), S2[:traits].contiguous()
    before = torch.backends.cuda.matmul.allow_tf32
    out = {}
    try:
        for name, flag in (("float32", False), ("tf32", True)):
            torch.backends.cuda.matmul.allow_tf32 = flag
            _event_ms(lambda: Xt @ Sb)
            ms = statistics.median(_event_ms(lambda: Xt @ Sb) for _ in range(3))
            out[name] = ms * S2.shape[0] / traits
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return out


def _planted_trait(G, Y, seed=SEED):
    """Trait 0 with an effect at one marker drawn from the seed, half of the
    trait's variance: y + b (g_j - mean g_j) with b sd(g_j) = sd(y)."""
    j = int(np.random.default_rng(seed).integers(G.shape[1]))
    g = G[:, j].astype(np.float64)
    y = Y[:, 0].astype(np.float64)
    return y + (g - g.mean()) * (y.std() / g.std()), j


def _single_trait_calls(y, Gd, K, precision, nperms=SCAN_NPERMS):
    """The port's single-trait entry points as a user calls them."""
    import bulklmm_tpu_torch as bt

    return {
        "null": lambda: bt.scan(y, Gd, K, precision=precision, output_effects=True,
                                output_pvals=True),
        "alt": lambda: bt.scan(y, Gd, K, assumption="alt", output_effects=True,
                               precision=precision),
        "perms": lambda: bt.scan(y, Gd, K, permutation_test=True, nperms=nperms,
                                 prior_variance=1.0, precision=precision),
        "perms_lite": lambda: bt.scan_perms_lite(y, Gd, np.ones((len(y), 0)), K, nperms=nperms,
                                                 prior_variance=1.0, precision=precision),
    }


def _scan_finite(res, what):
    for name in ("lod", "h2_each_marker", "L_perms", "beta", "beta_se", "log10pvals"):
        t = getattr(res, name)
        if t is not None:
            check(t.is_cuda and bool(torch.isfinite(t).all()), f"{what}: {name} not finite on the card")
    check(res.h2_null.dtype == torch.float64 and res.h2_null.ndim == 0, f"{what}: h2_null")


def single_trait_at(dev, card, G, Gd, K, Y, label, lod_scale, profile=False):
    """Phase 9 at one size: BALANCED and EXACT64 runs of every single-trait
    entry point, their gates, and the times. At BXD width the runs take the
    raw K (a host eigendecomposition each); above it the cached
    decomposition, whose eigendecomposition is timed once on its own."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops import brent

    n, p = G.shape
    y, j = _planted_trait(G, Y)
    t0 = time.perf_counter()
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    torch.cuda.synchronize()
    eigh_ms = 1e3 * (time.perf_counter() - t0)
    Kin = K if n <= N else dec
    bal = _single_trait_calls(y, Gd, Kin, bt.BALANCED)
    ex = _single_trait_calls(y, Gd, Kin, bt.EXACT64)
    out, iters = {}, {}
    for name, fn in bal.items():
        out[name], _ = _drive(f"{label}: BALANCED scan {name}", fn)
        iters[name] = brent.iterations
    ref = {}
    for name, fn in ex.items():
        ref[name] = fn()
        iters[name + " EXACT64"] = brent.iterations
    torch.cuda.synchronize()
    bar = ORACLE_BAR * lod_scale
    for name in bal:
        _scan_finite(out[name], f"{label} {name}")
        check(float(out[name].h2_null) == float(ref[name].h2_null),
              f"{label} {name}: h2_null differs between BALANCED and EXACT64")
        pairs = [("lod", out[name].lod, ref[name].lod)]
        if out[name].L_perms is not None:
            pairs.append(("L_perms", out[name].L_perms, ref[name].L_perms))
        for what, a, b in pairs:
            err = (a.double() - b.double()).abs().max().item()
            scale = 1.0 if name == "alt" else lod_scale  # alt runs in float64 under both
            print(f"  {label} {name} {what}: BALANCED vs EXACT64 max|dLOD| = {err:.3e} "
                  f"(bar {ORACLE_BAR * scale:.2e}; BASELINE.md's {PARITY_BAR:.0e}: "
                  f"{'met' if err <= PARITY_BAR else 'NOT met'})")
            check(err <= ORACLE_BAR * scale, f"{label} {name} {what} strays from EXACT64")
    dh2 = (out["alt"].h2_each_marker - ref["alt"].h2_each_marker).abs().max().item()
    print(f"  {label} alt: max|dh2| BALANCED vs EXACT64 = {dh2:.3e}; Brent iterations "
          f"{iters['alt']} (BALANCED), {iters['alt EXACT64']} (EXACT64); h2_null "
          f"{float(out['null'].h2_null)!r} under both")
    check(torch.equal(out["perms"].L_perms, out["perms_lite"].L_perms),
          f"{label}: scan(permutation_test=True) and scan_perms_lite disagree")
    c0 = (out["perms"].lod.double() - out["null"].lod.double()).abs().max().item()
    print(f"  {label} permutation column 0 vs the null scan: max|dLOD| = {c0:.3e} (bar {bar:.2e}); "
          f"planted marker {j}, null argmax {int(torch.argmax(out['null'].lod))}, its LOD "
          f"{float(out['null'].lod[j]):.2f}, next best "
          f"{float(torch.topk(out['null'].lod, 2).values[1]):.2f}")
    check(c0 <= bar, f"{label}: permutation column 0 strays from the null scan")
    check(int(torch.argmax(out["null"].lod)) == j, f"{label}: the planted marker is not the argmax")
    if profile:
        res, prof = bt.scan(y, Gd, K, profile_ll=True, marker_id=j + 1, precision=bt.BALANCED)
        check(tuple(prof.ll_list_alt.shape) == (20,) and prof.ll_list_alt.is_cuda
              and bool(torch.isfinite(prof.ll_list_alt).all())
              and bool(torch.isfinite(prof.ll_list_null).all()), f"{label}: profile not finite")
        check(bool((prof.ll_list_alt >= prof.ll_list_null).all()),
              f"{label}: the planted marker's profile lies below the null's")
        print(f"  {label} profile of marker {j}: max over the grid of ll_alt - ll_null = "
              f"{(prof.ll_list_alt - prof.ll_list_null).max().item():.3f}")
    del out, ref

    cached = _single_trait_calls(y, Gd, dec, bt.BALANCED)
    runs = {f"{name} (cached K)": cached[name] for name in ("null", "alt", "perms_lite")}
    ms = {name: [] for name in runs}
    for fn in runs.values():
        _time_ms(lambda: fn().lod)
    for _ in range(5):
        for name, fn in runs.items():
            ms[name].append(_time_ms(lambda: fn().lod))
    host_fit = _host_fit_ms(y, dec)
    if n <= N:
        raw = {f"{name} (raw K)": bal[name] for name in ("null", "alt", "perms_lite")}
        for name, fn in raw.items():
            ms[name] = [_time_ms(lambda: fn().lod) for _ in range(3)]
    else:
        ms["decompose_kinship (host eigh, upload), once"] = [eigh_ms]
    print(f"  {label} times on {card} (ms; median of 5 after a warm-up with the cached "
          f"decomposition{', of 3 with the raw K' if n <= N else ''}):")
    for name, t in ms.items():
        print(f"    {name:42s} {statistics.median(t):10.3f}   runs {[round(x, 3) for x in t]}")
    print(f"    {'host float64 null fit alone, host clock':42s} {statistics.median(host_fit):10.3f}   "
          f"runs {[round(x, 3) for x in host_fit]}")


def _host_fit_ms(y, dec, reps=5):
    """The scans' host null fit alone (rotation of y and the intercept,
    numpy Brent), by the host clock, after a warm-up."""
    import importlib

    scan_module = importlib.import_module("bulklmm_tpu_torch.models.scan")
    C = np.ones((len(y), 1))
    fit = lambda: scan_module._host_null_fit(  # noqa: E731
        y[:, None], C, dec.Ut_host, dec.lam_host, (0.0, 0.0), False, 1)
    fit()
    out = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fit()
        out.append(1e3 * (time.perf_counter() - t0))
    return out


def single_trait(dev, card, Gd, K, Y) -> None:
    """Phase 9: the single-trait scans at BXD width and at cohort size. The
    cohort's data come from synth_bxd's generator, its kinship (the same
    formula) from the port's calc_kinship on the card."""
    import bulklmm_tpu_torch as bt

    t0 = time.perf_counter()
    single_trait_at(dev, card, Gd.cpu().numpy(), Gd, K, Y, f"BXD {N} x {P}", 1.0, profile=True)
    t1 = time.perf_counter()
    rng = np.random.default_rng(SEED)
    G2 = rng.uniform(0.0, 1.0, (COHORT_N, COHORT_P)).astype(np.float32)
    Y2 = rng.normal(size=(COHORT_N, 1)).astype(np.float32)
    G2d = torch.from_numpy(G2).to(dev)
    K2 = bt.calc_kinship(G2d, precision=bt.EXACT64).cpu().numpy()
    scale = COHORT_N / N
    print(f"  cohort: LOD gates of the float32 products scaled by n/{N} = {scale:.2f}")
    single_trait_at(dev, card, G2, G2d, K2, Y2, f"cohort {COHORT_N} x {COHORT_P}", scale)
    print(f"  phase 9 took {t1 - t0:.1f} s at BXD width and {time.perf_counter() - t1:.1f} s "
          "at cohort size, data included")
    del G2, G2d, K2, Y2
    torch.cuda.empty_cache()


def _effects_err_cols(eff, ref, cols, block=4096):
    """(max |d effect| / (|effect| + SE), max |dSE| / SE) of the (p, m)
    effects ``eff`` = (beta, se) against ``ref`` over the columns ``cols``,
    in float64, block by block."""
    worst_b = worst_s = 0.0
    idx = torch.nonzero(cols).flatten()
    for s in range(0, idx.numel(), block):
        j = idx[s : s + block]
        b, se = (t[:, j].double() for t in eff)
        br, sr = (t[:, j].double() for t in ref)
        worst_b = max(worst_b, ((b - br).abs() / (br.abs() + sr)).max().item())
        worst_s = max(worst_s, ((se - sr).abs() / sr).max().item())
    return worst_b, worst_s


def _peak_over(fn):
    """(result, the call's peak device memory above what was allocated
    before it, bytes)."""
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = fn()
    torch.cuda.synchronize()
    return res, torch.cuda.max_memory_allocated() - before


def _plant_nans(Y, rng, share=MASK_SHARE, patterns=MASK_PATTERNS):
    """NaNs in ``share`` of the traits, each trait taking one of
    ``patterns`` sets of 1-4 individuals."""
    Ym = Y.copy()
    n, m = Y.shape
    sets = [rng.choice(n, size=int(rng.integers(1, 5)), replace=False) for _ in range(patterns)]
    traits = rng.choice(m, size=int(share * m), replace=False)
    for k, j in enumerate(traits):
        Ym[sets[k % patterns], j] = np.nan
    return Ym, traits


def bulk_options_at_bxd(dev, card, Yd, Gd, K):
    """Phase 10: output_effects, missing="mask"/"drop", memory sizing and
    host blocks, and marker streaming, at BXD scale."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils import memory

    t_phase = time.perf_counter()
    base = bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED)  # phase 4's call
    torch.cuda.synchronize()

    # effects: the effects variant on the main path, its LOD the LOD kernel's
    res, counts = _drive("BALANCED null-grid bulkscan, output_effects",
                         lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED, output_effects=True))
    check(counts["liteqtl_lod_effects"] > 0, "output_effects did not launch the effects variant")
    check(all(t.is_cuda and t.dtype == torch.float32 and t.shape == (P, M)
              for t in (res.L, res.beta_mat, res.beta_se_mat)), "effects outputs' shape or dtype")
    check(bool(torch.isfinite(res.beta_mat).all()) and bool(torch.isfinite(res.beta_se_mat).all()),
          "effects not finite")
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    same = _max_abs_diff_cols(res.L, base.L, all_cols)
    exact = bt.bulkscan(Yd, Gd, K, precision=bt.EXACT64, output_effects=True)
    torch.cuda.synchronize()
    eq = exact.h2_null_list == res.h2_null_list.double()
    lod_err = _max_abs_diff_cols(res.L, exact.L, eq)
    b_err, s_err = _effects_err_cols((res.beta_mat, res.beta_se_mat),
                                     (exact.beta_mat, exact.beta_se_mat), eq)
    print(f"  effects: L vs the LOD-only scan {same:.3e} (bar {SAME_LOD_BAR:.0e}); against EXACT64 on "
          f"{int(eq.sum())} equal-h2 traits max|dLOD| = {lod_err:.3e} (bar {ORACLE_BAR:.0e}), "
          f"max|d effect|/(|effect|+SE) = {b_err:.3e}, max|dSE|/SE = {s_err:.3e} (bars {EFFECT_BAR:.0e})")
    check(same <= SAME_LOD_BAR, "the effects scan's L is not the LOD-only scan's")
    check(lod_err <= ORACLE_BAR and b_err <= EFFECT_BAR and s_err <= EFFECT_BAR,
          "BALANCED effects stray from EXACT64")
    del res, exact

    # the effects variant's kernel time beside its plain version, at the scan's shape
    ops = lf.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev), base.h2_null_list, effects=True)
    fns = {"kernel": lambda: lf.liteqtl_lod_cuda(*ops, effects=True)[2],
           "plain": lambda: lf.liteqtl_lod_plain(*ops, effects=True)[2]}
    for fn in fns.values():
        _time_ms(fn)
    ems = {name: [] for name in fns}
    for _ in range(5):
        for name, fn in fns.items():
            ems[name].append(_time_ms(fn))
    eff_times = {name: statistics.median(t) for name, t in ems.items()}
    print(f"  effects variant on {card}, median of 5 (ms): kernel {eff_times['kernel']:.3f} "
          f"runs {[round(x, 3) for x in ems['kernel']]}, plain {eff_times['plain']:.3f}")
    eff_ops = ops
    del ops

    # missing="mask" and "drop": NaNs in 5 % of the traits, 8 patterns
    rng = np.random.default_rng(SEED)
    Ym, masked = _plant_nans(Yd.cpu().numpy(), rng)
    Ymd = torch.from_numpy(Ym).to(dev)
    masked_call = lambda: bt.bulkscan(Ymd, Gd, K, precision=bt.BALANCED, missing="mask")  # noqa: E731
    res, counts = _drive("BALANCED null-grid bulkscan, missing='mask'", masked_call)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    masked_call()
    torch.cuda.synchronize()
    mask_s = time.perf_counter() - t0
    check(counts["liteqtl_lod"] > 0 and bool(torch.isfinite(res.L).all()), "masked L")
    ref = bt.bulkscan(Ymd, Gd, K, precision=bt.EXACT64, missing="mask")
    torch.cuda.synchronize()
    eq = ref.h2_null_list == res.h2_null_list.double()
    mask_err = _max_abs_diff_cols(res.L, ref.L, eq)
    t0 = time.perf_counter()
    bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    groups = len(np.unique(np.isfinite(Ym).T, axis=0))
    print(f"  missing='mask': {len(masked)} traits with NaNs, {groups} pattern groups; against the "
          f"EXACT64 masked run on {int(eq.sum())} equal-h2 traits max|dLOD| = {mask_err:.3e} "
          f"(bar {ORACLE_BAR:.0e}); {1e3 * mask_s:.1f} ms (second call, host clock) against "
          f"{1e3 * plain_s:.1f} ms unmasked")
    check(mask_err <= ORACLE_BAR, "masked BALANCED strays from the EXACT64 masked run")
    rows = np.flatnonzero(np.isfinite(Ym).all(axis=1))
    drop = bt.bulkscan(Ymd, Gd, K, precision=bt.BALANCED, missing="drop")
    sub = bt.bulkscan(Ymd[torch.as_tensor(rows, device=dev)], Gd[torch.as_tensor(rows, device=dev)],
                      K[np.ix_(rows, rows)], precision=bt.BALANCED)
    check(_max_abs_diff_cols(drop.L, sub.L, all_cols) <= SAME_LOD_BAR,
          "missing='drop' is not the scan of the complete individuals")
    print(f"  missing='drop': {len(rows)} of {N} individuals kept, equal to the scan of those rows")
    del res, ref, drop, sub

    sub_m = slice(0, OPTION_TRAITS)
    res, counts = _drive(
        f"BALANCED bulkscan_perms, missing='mask', {MASK_NPERMS} permutations, {OPTION_TRAITS} traits",
        lambda: bt.bulkscan_perms(Ymd[:, sub_m], Gd, K, nperms=MASK_NPERMS, precision=bt.BALANCED,
                                  missing="mask"))
    check(counts["bulkperm_maxr2"] > 0, "masked bulkscan_perms did not launch the permutation kernel")
    ref = bt.bulkscan_perms(Ymd[:, sub_m], Gd, K, nperms=MASK_NPERMS, precision=bt.EXACT64,
                            missing="mask")
    eq = ref.h2_null_list == res.h2_null_list.double()
    perr = (res.maxlods.double() - ref.maxlods)[eq].abs().max().item()
    print(f"  masked bulkscan_perms: {int(np.isin(masked, np.arange(OPTION_TRAITS)).sum())} masked "
          f"traits; against EXACT64 on {int(eq.sum())} equal-h2 traits max|dLOD| = {perr:.3e} "
          f"(bar {ORACLE_BAR:.0e})")
    check(bool(torch.isfinite(res.maxlods).all()) and perr <= ORACLE_BAR,
          "masked bulkscan_perms strays from EXACT64")
    del res, ref, Ymd

    # memory sizing: the card's own budget, then a forced 2 GiB one
    budget = memory.device_memory_budget(dev)
    dims = dict(n=N, p=P, m=M, c=1, itemsize=8)
    decisions = {f"{what}": memory.auto_trait_chunk(**dims, n_outputs=nout, budget=budget)
                 for what, nout in (("null-grid", 1), ("alt-grid", 2), ("effects", 3))}
    print(f"  device memory budget {budget / 2**30:.2f} GiB (free + reserved-but-unallocated, x "
          f"{memory._USABLE_FRACTION}); auto_trait_chunk at BXD scale: {decisions} (None: one block)")
    forced = FORCED_BUDGET
    real_budget = memory.device_memory_budget
    memory.device_memory_budget = lambda device=None: forced
    try:
        hb, peak = _peak_over(lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED))
    finally:
        memory.device_memory_budget = real_budget
    check(isinstance(hb.L, np.ndarray), "the forced budget did not take host blocks")
    mh = memory.auto_host_block(**dims, budget=forced)
    herr = _max_abs_diff_cols(torch.from_numpy(hb.L).to(dev), base.L, all_cols)
    print(f"  forced budget {forced / 2**30:.0f} GiB: host blocks of {mh} traits "
          f"({-(-M // mh)} blocks); L vs the one-block scan max|dLOD| = {herr:.3e} (bar "
          f"{KERNEL_BAR:.0e}, phase 7's for other blocks: the per-trait float32 scalars are summed "
          f"by cuBLAS in an order that depends on the block's width); the call's peak device "
          f"memory {peak / 2**30:.3f} GiB")
    check(herr <= KERNEL_BAR, "host-blocked L strays from the one-block scan")
    check(peak <= forced, "the host-blocked call's peak device memory passed its budget")
    del hb

    # marker streaming at BXD scale: alt-grid and the permutation sweep
    G_host = Gd.cpu().numpy()
    alt = bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.BALANCED)  # phase 5's call
    res, counts = _drive(
        f"BALANCED alt-grid bulkscan_streamed, blocks of {STREAM_BLOCK} markers",
        lambda: bt.bulkscan_streamed(Yd, G_host, K, method="alt-grid", precision=bt.BALANCED,
                                     marker_block=STREAM_BLOCK))
    check(counts["altgrid"] == -(-P // STREAM_BLOCK), "the streamed alt-grid did not launch its kernel "
          "once a block")
    serr = _max_abs_diff_cols(torch.from_numpy(res.L).to(dev), alt.L, all_cols)
    flips = int((torch.from_numpy(res.h2_panel).to(dev) != alt.h2_panel).sum())
    print(f"  streamed alt-grid vs in-memory: max|dLOD| = {serr:.3e} (bar {STREAM_BAR:.0e}), "
          f"h2 panel flips {flips} of {P * M}")
    check(serr <= STREAM_BAR and flips <= INDEX_FLIP_SHARE * P * M,
          "streamed alt-grid strays from the in-memory scan")
    del alt, res
    Ysub = Yd[:, sub_m]
    inmem = bt.bulkscan_perms(Ysub, Gd, K, nperms=MASK_NPERMS, precision=bt.BALANCED)
    res, counts = _drive(
        f"BALANCED bulkscan_perms_streamed, {MASK_NPERMS} permutations, {OPTION_TRAITS} traits",
        lambda: bt.bulkscan_perms_streamed(Ysub, G_host, K, nperms=MASK_NPERMS,
                                           precision=bt.BALANCED, marker_block=STREAM_BLOCK))
    check(counts["bulkperm_maxr2"] > 0, "the streamed sweep did not launch the permutation kernel")
    perr = (res.maxlods - inmem.maxlods).abs().max().item()
    print(f"  streamed permutation maxima vs bulkscan_perms: max|dLOD| = {perr:.3e} "
          f"(bar {KERNEL_BAR:.0e})")
    check(perr <= KERNEL_BAR, "streamed permutation maxima stray from bulkscan_perms")
    print(f"  phase 10 took {time.perf_counter() - t_phase:.1f} s")
    del base, res, inmem
    torch.cuda.empty_cache()
    return eff_ops, eff_times


def calibrate_memory(dev, Yd, Gd, K) -> None:
    """The live sets behind utils/memory.py's multipliers: each call's peak
    device memory above its inputs, in (p, m) arrays of the widest dtype at
    BXD width (the (p,)-sized copies a trait holds), and in (n, m) arrays at
    n = 2,000 with 64 markers (the (n,)-sized ones). Printed beside the
    model's (p, m)-sized outputs and multipliers."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.utils import memory

    m = CALIBRATION_TRAITS
    Ys = Yd[:, :m].contiguous()
    calls = [
        (f"{name} {preset}{' effects' if eff else ''}", nout,
         (lambda name=name, preset=preset, eff=eff: bt.bulkscan(
             Ys, Gd, K, method=name, precision=bt.precision_by_name(preset), output_effects=eff,
             trait_chunk=m)))
        for name, preset, eff, nout in (
            ("null-grid", "BALANCED", False, 1), ("null-grid", "BALANCED", True, 3),
            ("null-grid", "EXACT64", False, 1), ("null-grid", "EXACT64", True, 3),
            ("alt-grid", "BALANCED", False, 2), ("alt-grid", "EXACT64", False, 2),
            ("null-exact", "BALANCED", False, 1))
    ]
    worst = 0.0
    for what, nout, fn in calls:
        _, extra = _peak_over(fn)
        copies = extra / (8 * P * m) - nout
        worst = max(worst, copies)
        print(f"  live set of {what} at {N} x {P} x {m}: {extra / 2**30:.3f} GiB = "
              f"{extra / (8 * P * m):.2f} (p, m) float64 arrays, {copies:.2f} beyond its {nout} outputs")
    rng = np.random.default_rng(SEED)
    n2 = COHORT_N
    G2 = torch.from_numpy(rng.uniform(0.0, 1.0, (n2, 64)).astype(np.float32)).to(dev)
    Y2 = torch.from_numpy(rng.normal(size=(n2, m)).astype(np.float32)).to(dev)
    dec = bt.decompose_kinship(bt.calc_kinship(G2, precision=bt.EXACT64), dtype=torch.float64,
                               device=dev)
    worst_n = worst_alt = 0.0
    for name, preset in (("null-grid", "BALANCED"), ("null-grid", "EXACT64"),
                         ("null-exact", "BALANCED"), ("alt-grid", "BALANCED")):
        _, extra = _peak_over(lambda: bt.bulkscan(
            Y2, G2, dec, method=name, precision=bt.precision_by_name(preset), trait_chunk=m))
        # the rotated traits (one (n, m) array) are the model's resident
        copies = extra / (8 * n2 * m) - 1
        if name == "alt-grid":
            worst_alt = max(worst_alt, copies / len(GRID))
        else:
            worst_n = max(worst_n, copies)
        print(f"  live set of {name} {preset} at {n2} x 64 x {m}: {extra / 2**30:.3f} GiB = "
              f"{copies:.2f} (n, m) float64 arrays beyond the rotated traits")
    print(f"  memory model: the most (p,)-sized copies a trait held {worst:.2f} (model "
          f"{memory._P_CHUNK_COPIES}), the most (n,)-sized {worst_n:.2f} (model "
          f"{memory._N_CHUNK_COPIES}), alt-grid {worst_alt:.2f} a grid point (model "
          f"{memory._ALT_GRID_N_COPIES})")
    check(worst <= memory._P_CHUNK_COPIES and worst_n <= memory._N_CHUNK_COPIES
          and worst_alt <= memory._ALT_GRID_N_COPIES,
          "a call's live set passed the memory model's multipliers")
    del G2, Y2, dec


def _busy_ms(fn) -> float:
    """The device's busy time over one call of ``fn``, ms: the profiler's
    sum of kernels' and copies' own times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bulklmm_tpu_torch.profile_paths import _device_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(_device_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    check(busy > 0.0, "the profiler recorded no device time")
    return busy / 1e3


def streaming_at_biobank_n(dev, card) -> None:
    """Phase 11: null-grid over a 2,000 x 100,000 host panel (800 MB float32)
    and 2,048 traits, streamed into a memmap, against the in-memory scan."""
    import tempfile

    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    G = rng.random((BIOBANK_N, BIOBANK_P), dtype=np.float32)
    Y = rng.standard_normal((BIOBANK_N, BIOBANK_M), dtype=np.float32)
    Yd = torch.from_numpy(Y).to(dev)
    K = bt.calc_kinship(torch.from_numpy(G).to(dev), precision=bt.EXACT64).cpu().numpy()
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    print(f"  data: {G.nbytes / 1e6:.0f} MB host panel, kinship and its decomposition in "
          f"{time.perf_counter() - t_phase:.1f} s; LOD kernel path {lf.kernel_path(BIOBANK_N, 1)}")
    with tempfile.TemporaryDirectory() as tmp:
        out = np.lib.format.open_memmap(Path(tmp) / "L.npy", mode="w+", dtype=np.float32,
                                        shape=(BIOBANK_P, BIOBANK_M))
        stream = lambda: bt.bulkscan_streamed(Yd, G, dec, precision=bt.BALANCED, out=out)  # noqa: E731
        res, counts = _drive("BALANCED null-grid bulkscan_streamed at biobank n", stream)
        check(counts["liteqtl_lod"] > 0 and res.L is out, "the streamed scan did not launch the LOD kernel")
        check(bool(np.isfinite(out).all()), "streamed L is not finite")
        Gd = torch.from_numpy(G).to(dev)
        inmem = lambda: bt.bulkscan(Yd, Gd, dec, precision=bt.BALANCED)  # noqa: E731
        ref, _ = _drive("BALANCED null-grid bulkscan in memory at biobank n", inmem)
        all_cols = torch.ones(BIOBANK_M, dtype=torch.bool, device=dev)
        err = _max_abs_diff_cols(torch.from_numpy(np.asarray(out)).to(dev), ref.L, all_cols)
        bar = ORACLE_BAR * BIOBANK_N / N
        print(f"  streamed vs in-memory: max|dLOD| = {err:.3e} (bar {bar:.2e})")
        check(err <= bar, "the streamed scan strays from the in-memory one at biobank n")
        del ref
        times_s = {"streamed": [], "in memory": []}
        for _ in range(3):
            for name, fn in (("streamed", stream), ("in memory", inmem)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                times_s[name].append(time.perf_counter() - t0)
        med = {name: statistics.median(t) for name, t in times_s.items()}
        busy = _busy_ms(stream)
        print(f"  times on {card}, median of 3 after the first calls, host clock (ms): streamed "
              f"{1e3 * med['streamed']:.1f} {[round(1e3 * x, 1) for x in times_s['streamed']]}, in "
              f"memory {1e3 * med['in memory']:.1f} {[round(1e3 * x, 1) for x in times_s['in memory']]}; "
              f"streamed / in memory {med['streamed'] / med['in memory']:.2f}; the streamed call's "
              f"device busy {busy:.1f} ms (profiler on), idle {100 * (1 - busy / (1e3 * med['streamed'])):.0f} %")
        del out, res
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    del G, Gd, Yd, dec
    torch.cuda.empty_cache()


def _host_ms(fn) -> float:
    """One call by the host clock, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _no_kernel(counts, what) -> None:
    """The rank-k engine runs none of the three kernels, in either package."""
    check(not any(counts.values()), f"{what} launched a kernel: {counts}")


def _null_errors(res, ref, method):
    """(max |dLOD|, what it was taken over, max |dh2|) of a null-method scan
    against its oracle: null-grid on the traits whose grid h2 agrees,
    null-exact (a continuous h2) on all of them."""
    dh2 = (res.h2_null_list.double() - ref.h2_null_list).abs().max().item()
    if method == "null-exact":
        cols = torch.ones_like(ref.h2_null_list, dtype=torch.bool)
        return _max_abs_diff_cols(res.L, ref.L, cols), "on all traits", dh2
    same = ref.h2_null_list == res.h2_null_list.double()
    err = _max_abs_diff_cols(res.L, ref.L, same) if bool(same.any()) else 0.0
    return err, f"on the equal-h2 traits ({int((~same).sum())} with another h2)", dh2


def lowrank_at_bxd(dev, Yd, Gd, K) -> None:
    """Phase 12 (a): the rank-k engine at k = n on phase 4's data, against
    the rotated engine's EXACT64 scans."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops.bulkperm import permutation_indices

    n, m = Yd.shape
    p = Gd.shape[1]
    lr = bt.kinship_lowrank_exact(K, n, dtype=torch.float64, device=dev)
    all_cols = torch.ones(m, dtype=torch.bool, device=dev)
    for method in ("null-grid", "null-exact", "alt-grid"):
        call = lambda method=method: bt.bulkscan(Yd, Gd, lr, method=method,  # noqa: E731
                                                 precision=bt.BALANCED)
        res, counts = _drive(f"BALANCED rank-{n} {method} bulkscan", call)
        _no_kernel(counts, f"the rank-{n} {method} scan")
        check(tuple(res.L.shape) == (p, m) and res.L.device.type == dev.type and bool(torch.isfinite(res.L).all()),
              f"rank-{n} {method} L is not finite of shape ({p}, {m}) on the card")
        ms = _host_ms(call)
        ref = bt.bulkscan(Yd, Gd, K, method=method, precision=bt.EXACT64)
        torch.cuda.synchronize()
        if method == "alt-grid":
            err = _max_abs_diff_cols(res.L, ref.L, all_cols)
            flips = int((res.h2_panel != ref.h2_panel).sum())
            extra = f"on all pairs; h2 panel flips {flips} of {p * m}"
        else:
            err, over, dh2 = _null_errors(res, ref, method)
            extra = f"{over}, max|dh2| = {dh2:.3e}"
        print(f"  rank-{n} {method} BALANCED vs the rotated engine's EXACT64: max|dLOD| = "
              f"{err:.3e} {extra} (bar {ORACLE_BAR:.0e}); second call {ms:.1f} ms (host clock)")
        check(err <= ORACLE_BAR, f"rank-{n} {method} strays from the rotated EXACT64 scan")
        if method == "null-grid":
            rot_h2, rot_max = ref.h2_null_list, ref.L.max(0).values
        del res, ref

    # permutations: phase 10's cut and indices; column 0 is the scan's
    # per-trait maximum, the others a rank-k statistic (whitening in sample
    # coordinates), held against the rank-k EXACT64 sweep
    sub = slice(0, OPTION_TRAITS)
    idx = permutation_indices(n, MASK_NPERMS, 0)
    call = lambda: bt.bulkscan_perms(Yd[:, sub], Gd, lr, nperms=MASK_NPERMS, perm_idx=idx,  # noqa: E731
                                     precision=bt.BALANCED)
    res, counts = _drive(f"BALANCED rank-{n} bulkscan_perms, {MASK_NPERMS} permutations, "
                         f"{OPTION_TRAITS} traits", call)
    _no_kernel(counts, f"the rank-{n} bulkscan_perms")
    check(bool(torch.isfinite(res.maxlods).all()), "rank-k maxlods are not finite")
    ms = _host_ms(call)
    ref = bt.bulkscan_perms(Yd[:, sub], Gd, lr, nperms=MASK_NPERMS, perm_idx=idx,
                            precision=bt.EXACT64)
    same = ref.h2_null_list == res.h2_null_list.double()
    err = (res.maxlods.double() - ref.maxlods)[same].abs().max().item()
    same_rot = rot_h2[sub] == res.h2_null_list.double()
    obs = (res.maxlods[:, 0].double() - rot_max[sub])[same_rot].abs().max().item()
    print(f"  rank-{n} bulkscan_perms BALANCED vs its EXACT64 sweep: max|dLOD| = {err:.3e} on "
          f"{int(same.sum())} equal-h2 traits; column 0 vs the rotated EXACT64 scan's maxima "
          f"{obs:.3e} on {int(same_rot.sum())} (bar {ORACLE_BAR:.0e}); second call {ms:.1f} ms")
    check(err <= ORACLE_BAR and obs <= ORACLE_BAR, "rank-k bulkscan_perms strays from EXACT64")
    del res, ref, lr


def _lowrank_cohort(dev, n, p, m, ancestry=LR_ANCESTRY, seed=SEED, block=8192):
    """benchmarks/lowrank_cohort.py's cohort, drawn on the card: 0/1
    genotypes whose frequencies follow ``ancestry`` directions through a
    sigmoid load, and normal traits. Returns (G, Y), float32."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    F = torch.randn((n, ancestry), generator=gen, device=dev)
    W = torch.randn((ancestry, p), generator=gen, device=dev)
    G = torch.empty((n, p), device=dev)
    for s in range(0, p, block):
        load = torch.sigmoid(0.5 * (F @ W[:, s : s + block]))
        G[:, s : s + block] = (torch.rand(load.shape, generator=gen, device=dev) < load).float()
    Y = torch.randn((n, m), generator=gen, device=dev)
    return G, Y


def _rayleigh_residual(G, lr, block=8192) -> float:
    """max_i ||K u_i - lam_i u_i|| / lam_1 for K = calc_kinship(G) (2 X X'/p
    + 0.5, X = G - 0.5, unit diagonal), applied a block of markers at a time
    in float64: the (n, n) matrix is never formed."""
    n, p = G.shape
    U, lam = lr.U.double(), lr.lam.double()
    XXtU = torch.zeros_like(U)
    sq = torch.zeros(n, dtype=torch.float64, device=U.device)
    for s in range(0, p, block):
        X = G[:, s : s + block].double() - 0.5
        XXtU += X @ (X.T @ U)
        sq += (X * X).sum(1)
    KU = (2.0 / p) * XXtU + 0.5 * U.sum(0, keepdim=True) + (0.5 - 2.0 * sq / p)[:, None] * U
    return ((KU - U * lam).norm(dim=0).max() / lam[0]).item()


def _where_time_goes(what, fn, wall_ms, top=3) -> None:
    """Prints one call's device busy time and idle share against ``wall_ms``
    (a call with the profiler off), its kernel launches and its ``top``
    device kernels by time, from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bulklmm_tpu_torch.profile_paths import _device_us

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    on_device = sorted((e for e in events if e.device_type == DeviceType.CUDA),
                       key=_device_us, reverse=True)
    busy = sum(_device_us(e) for e in on_device) / 1e3
    launches = int(sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")))
    tops = "; ".join(f"{_device_us(e) / 1e3:.1f} ms x{e.count} {e.key[:48]}" for e in on_device[:top])
    print(f"    {what}: device busy {busy:.1f} ms (profiler on) of {wall_ms:.1f} ms, idle "
          f"{100 * (1 - busy / wall_ms):.0f} %, {launches} kernel launches; top: {tops}")


def lowrank_cohort(dev, card, n=LR_N, p=LR_P, m=LR_M, k=LR_RANK) -> None:
    """Phase 12 (b): the cohort the rank-k engine exists for, from the
    genotypes to the scans, each BALANCED call against EXACT64 on the same
    factors."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops import brent

    t_phase = time.perf_counter()
    G, Y = _lowrank_cohort(dev, n, p, m)
    torch.cuda.synchronize()
    print(f"  cohort {n} x {p} x {m} drawn on the card in {time.perf_counter() - t_phase:.1f} s "
          f"({G.numel() * 4 / 1e9:.1f} GB float32 panel)")
    peak = 0.0
    bar = ORACLE_BAR * n / N
    t0 = time.perf_counter()
    lr, counts = _drive(f"BALANCED kinship_lowrank_from_geno, k = {k}",
                        lambda: bt.kinship_lowrank_from_geno(G, k, precision=bt.BALANCED))
    construct_s = time.perf_counter() - t0
    _where_time_goes("kinship_lowrank_from_geno", lambda: bt.kinship_lowrank_from_geno(
        G, k, precision=bt.BALANCED), 1e3 * construct_s)
    peak = max(peak, torch.cuda.max_memory_allocated())
    _no_kernel(counts, "kinship_lowrank_from_geno")
    check(lr.U.shape == (n, k) and lr.U.device.type == dev.type and lr.U.dtype == torch.float64,
          "the factors are not (n, k) float64 on the card")
    check(bool(torch.isfinite(lr.U).all()) and bool((lr.lam[:-1] >= lr.lam[1:]).all()),
          "the factors are not finite or their eigenvalues not descending")
    res_k = _rayleigh_residual(G, lr)
    print(f"  constructor {construct_s:.2f} s (first call, host clock); lam_1 = "
          f"{lr.lam[0].item():.2f}, lam_k = {lr.lam[-1].item():.4f}; Rayleigh residual "
          f"max_i ||K u_i - lam_i u_i|| / lam_1 = {res_k:.3e} (bar {RAYLEIGH_BAR})")
    check(res_k <= RAYLEIGH_BAR, "the randomized factors are not eigenpairs of K")

    all_cols = torch.ones(m, dtype=torch.bool, device=dev)
    times_ms = {}
    for method, eff in (("null-grid", False), ("null-exact", False), ("alt-grid", False),
                        ("null-grid", True)):
        what = f"{method}{' effects' if eff else ''}"
        call = lambda method=method, eff=eff: bt.bulkscan(  # noqa: E731
            Y, G, lr, method=method, precision=bt.BALANCED, output_effects=eff)
        res, counts = _drive(f"BALANCED rank-{k} {what} bulkscan", call)
        peak = max(peak, torch.cuda.max_memory_allocated())
        _no_kernel(counts, f"the rank-{k} {what} scan")
        check(tuple(res.L.shape) == (p, m) and res.L.device.type == dev.type and bool(torch.isfinite(res.L).all()),
              f"rank-{k} {what} L is not finite of shape ({p}, {m}) on the card")
        iters = brent.iterations
        times_ms[what] = _host_ms(call)
        ref = bt.bulkscan(Y, G, lr, method=method, precision=bt.EXACT64, output_effects=eff)
        torch.cuda.synchronize()
        if method == "alt-grid":
            err = _max_abs_diff_cols(res.L, ref.L, all_cols)
            flips = int((res.h2_panel != ref.h2_panel).sum())
            extra = f"on all pairs; h2 panel flips {flips} of {p * m}"
        else:
            err, over, dh2 = _null_errors(res, ref, method)
            extra = f"{over}, max|dh2| = {dh2:.3e}"
        if method == "null-exact":
            extra += f"; Brent iterations {iters}"
        if eff:
            same = ref.h2_null_list == res.h2_null_list.double()
            eb, es = _effects_err_cols((res.beta_mat, res.beta_se_mat),
                                       (ref.beta_mat, ref.beta_se_mat), same)
            extra += f"; |d effect| / (|effect| + SE) {eb:.3e}, |dSE| / SE {es:.3e}"
            check(_max_abs_diff_cols(res.L, lod_ng, all_cols) <= SAME_LOD_BAR,
                  "the effects scan's L is not the null-grid scan's")
        print(f"  rank-{k} {what} BALANCED vs EXACT64: max|dLOD| = {err:.3e} {extra} "
              f"(bar {bar:.2e}); second call {times_ms[what]:.1f} ms (host clock)")
        _where_time_goes(what, call, times_ms[what])
        check(err <= bar, f"rank-{k} {what} strays from EXACT64")
        if method == "null-grid" and not eff:
            lod_ng = res.L
        del res, ref

    # the single-trait permutation scan of trait 0
    y = Y[:, :1]
    call = lambda: bt.scan(y, G, lr, permutation_test=True, nperms=SCAN_NPERMS,  # noqa: E731
                           precision=bt.BALANCED)
    res, counts = _drive(f"BALANCED rank-{k} scan, {SCAN_NPERMS} permutations", call)
    peak = max(peak, torch.cuda.max_memory_allocated())
    _no_kernel(counts, "the rank-k permutation scan")
    check(tuple(res.L_perms.shape) == (p, SCAN_NPERMS) and bool(torch.isfinite(res.L_perms).all())
          and bool(torch.isfinite(res.lod).all()), "the rank-k permutation scan is not finite")
    times_ms["scan perms"] = _host_ms(call)
    ref = bt.scan(y, G, lr, permutation_test=True, nperms=SCAN_NPERMS, precision=bt.EXACT64)
    err = max((res.lod.double() - ref.lod).abs().max().item(),
              (res.L_perms.double() - ref.L_perms).abs().max().item())
    print(f"  rank-{k} scan with {SCAN_NPERMS} permutations BALANCED vs EXACT64: max|dLOD| = "
          f"{err:.3e} over every column (bar {bar:.2e}); h2_null {float(res.h2_null):.6f} vs "
          f"{float(ref.h2_null):.6f}; second call {times_ms['scan perms']:.1f} ms")
    check(err <= bar, "the rank-k permutation scan strays from EXACT64")
    _where_time_goes("scan perms", call, times_ms["scan perms"])
    del res, ref

    sub = slice(0, LR_PERM_TRAITS)
    call = lambda: bt.bulkscan_perms(Y[:, sub], G, lr, nperms=LR_NPERMS,  # noqa: E731
                                     precision=bt.BALANCED)
    res, counts = _drive(f"BALANCED rank-{k} bulkscan_perms, {LR_PERM_TRAITS} traits x "
                         f"{LR_NPERMS} permutations", call)
    peak = max(peak, torch.cuda.max_memory_allocated())
    _no_kernel(counts, "the rank-k bulkscan_perms")
    check(bool(torch.isfinite(res.maxlods).all()), "rank-k maxlods are not finite")
    times_ms["bulkscan_perms"] = _host_ms(call)
    ref = bt.bulkscan_perms(Y[:, sub], G, lr, nperms=LR_NPERMS, precision=bt.EXACT64)
    same = ref.h2_null_list == res.h2_null_list.double()
    err = (res.maxlods.double() - ref.maxlods)[same].abs().max().item()
    obs = (res.maxlods[:, 0] - lod_ng[:, sub].max(0).values).abs().max().item()
    print(f"  rank-{k} bulkscan_perms BALANCED vs EXACT64: max|dLOD| = {err:.3e} on "
          f"{int(same.sum())} equal-h2 traits (bar {bar:.2e}); column 0 vs the scan's maxima "
          f"{obs:.3e}; second call {times_ms['bulkscan_perms']:.1f} ms")
    check(err <= bar and obs <= bar, "the rank-k bulkscan_perms strays")
    _where_time_goes("bulkscan_perms", call, times_ms["bulkscan_perms"])
    del res, ref

    G_host = G.cpu().numpy()
    call = lambda: bt.bulkscan_streamed(Y, G_host, lr, precision=bt.BALANCED,  # noqa: E731
                                        marker_block=LR_STREAM_BLOCK)
    res, counts = _drive(f"BALANCED rank-{k} bulkscan_streamed, host panel in blocks of "
                         f"{LR_STREAM_BLOCK}", call)
    peak = max(peak, torch.cuda.max_memory_allocated())
    _no_kernel(counts, "the rank-k streamed scan")
    times_ms["streamed"] = _host_ms(call)
    err = _max_abs_diff_cols(torch.from_numpy(res.L).to(dev), lod_ng, all_cols)
    print(f"  rank-{k} streamed vs in-memory null-grid: max|dLOD| = {err:.3e} (bar {bar:.2e}); "
          f"second call {times_ms['streamed']:.1f} ms against {times_ms['null-grid']:.1f} ms in memory")
    check(err <= bar, "the rank-k streamed scan strays from the in-memory one")
    _where_time_goes("streamed", call, times_ms["streamed"])
    print(f"  phase 12 (b) on {card}: peak device memory {peak / 2**30:.2f} GiB; times (ms, host "
          f"clock, second call): {json.dumps({w: round(t, 1) for w, t in times_ms.items()})}; "
          f"the whole part {time.perf_counter() - t_phase:.1f} s")
    del G, Y, G_host, lr, lod_ng, res
    torch.cuda.empty_cache()


def calibrate_lowrank_memory(dev, Yd, Gd, K) -> None:
    """The rank-k engine's live sets against utils/memory.py's model: each
    call's peak device memory above its inputs, at BXD width in (p, m)
    arrays of the widest dtype (the (p,)-sized copies a trait holds), and
    at n = 2,000 with 64 markers and rank 2,000 against the model's whole
    footprint, with the (k,)-sized copies a trait holds beside it."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.utils import memory

    m = CALIBRATION_TRAITS
    n, p = Gd.shape
    Ys = Yd[:, :m].contiguous()
    lr = bt.kinship_lowrank_exact(K, n, dtype=torch.float64, device=dev)
    worst = 0.0
    for name, preset, eff, nout in (
            ("null-grid", "BALANCED", False, 1), ("null-grid", "BALANCED", True, 3),
            ("null-grid", "EXACT64", False, 1), ("null-grid", "EXACT64", True, 3),
            ("alt-grid", "BALANCED", False, 2), ("alt-grid", "EXACT64", False, 2),
            ("null-exact", "BALANCED", False, 1)):
        _, extra = _peak_over(lambda: bt.bulkscan(
            Ys, Gd, lr, method=name, precision=bt.precision_by_name(preset), output_effects=eff,
            trait_chunk=m))
        copies = extra / (8 * p * m) - nout
        worst = max(worst, copies)
        print(f"  rank-{n} live set of {name} {preset}{' effects' if eff else ''} at {n} x {p} x "
              f"{m}: {extra / 2**30:.3f} GiB, {copies:.2f} (p, m) float64 arrays beyond its "
              f"{nout} outputs")
    rng = np.random.default_rng(SEED)
    n2, p2, k2 = COHORT_N, LR_CAL_P, LR_CAL_RANK
    G2 = torch.from_numpy(rng.uniform(0.0, 1.0, (n2, p2)).astype(np.float32)).to(dev)
    Y2 = torch.from_numpy(rng.normal(size=(n2, m)).astype(np.float32)).to(dev)
    lr2 = bt.kinship_lowrank_exact(bt.calc_kinship(G2, precision=bt.EXACT64), k2,
                                   dtype=torch.float64, device=dev)
    worst_k, fits = 0.0, True
    for name, preset in (("null-grid", "BALANCED"), ("null-grid", "EXACT64"),
                         ("null-exact", "BALANCED"), ("alt-grid", "BALANCED")):
        _, extra = _peak_over(lambda: bt.bulkscan(
            Y2, G2, lr2, method=name, precision=bt.precision_by_name(preset), trait_chunk=m))
        nout = 2 if name == "alt-grid" else 1
        model = (memory.lowrank_static_bytes(n2, p2, m, 1, k2, 8, n_outputs=nout)
                 + memory.lowrank_chunk_bytes(n2, p2, k2, m, len(GRID), 8))
        # beyond the model's (n,)-sized terms (the traits, their cast and two
        # more copies a trait) and (p,)-sized ones, per (k,) of a trait
        k_copies = (extra / (8 * m) - 4 * n2 - (memory._LR_P_CHUNK_COPIES + nout) * p2) / k2
        worst_k = max(worst_k, k_copies)
        fits = fits and extra <= model
        print(f"  rank-{k2} live set of {name} {preset} at {n2} x {p2} x {m}: {extra / 2**30:.3f} "
              f"GiB against the model's {model / 2**30:.3f} GiB; {k_copies:.2f} (k,)-sized float64 "
              f"copies a trait beyond the (n,)- and (p,)-sized terms")
    print(f"  rank-k memory model: the most (p,)-sized copies a trait held {worst:.2f} (model "
          f"{memory._LR_P_CHUNK_COPIES}), the most (k,)-sized {worst_k:.2f} (model "
          f"{memory._LR_K_CHUNK_COPIES})")
    check(worst <= memory._LR_P_CHUNK_COPIES and worst_k <= memory._LR_K_CHUNK_COPIES and fits,
          "a rank-k call's live set passed the memory model")
    del G2, Y2, lr2, lr, Ys
    torch.cuda.empty_cache()


def lowrank_engine(dev, card, Yd, Gd, K) -> None:
    """Phase 12: the rank-k kinship engine (no kernel in either package)."""
    t_phase = time.perf_counter()
    lowrank_at_bxd(dev, Yd, Gd, K)
    print(f"  phase 12 (a) took {time.perf_counter() - t_phase:.1f} s")
    lowrank_cohort(dev, card)
    calibrate_lowrank_memory(dev, Yd, Gd, K)
    print(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")


def _bound(flops, operands, out_bytes):
    """The least time the card could take, ms: the larger of the bytes moved
    once over the memory rate and the operations over the faster unit's
    rate for float32-grade products (CUDA cores, or three TF32 tensor-core
    passes). Returns bound_ms, bound_by, bound_unit and simt_bound_ms, the
    operations' time on the CUDA cores."""
    nbytes = out_bytes + sum(t.numel() * t.element_size() for t in operands)
    by_bytes = nbytes / PEAK_BYTES * 1e3
    simt, tensor = flops / PEAK_FLOPS * 1e3, SPLIT_PASSES * flops / PEAK_TF32 * 1e3
    by_ops = min(simt, tensor)
    unit = "3 x TF32 tensor-core operations" if tensor < simt else "float32 CUDA-core operations"
    bound = {"bound_ms": max(by_bytes, by_ops), "simt_bound_ms": max(by_bytes, simt)}
    if by_bytes > by_ops:
        return bound | {"bound_by": "bytes", "bound_unit": "HBM bytes"}
    return bound | {"bound_by": "operations", "bound_unit": unit}


def main() -> None:
    import_port()
    print("[1] device check")
    card = device_check()
    dev = torch.device("cuda", 0)
    print("[2] build")
    report = build()
    check(bool(report), "the build left no ptxas report")
    print("[3] kernels vs their plain versions on the card")
    kernel_checks(dev)
    effects_checks(dev)
    altgrid_checks(dev)
    bulkperm_checks(dev)
    print(f"[4] BALANCED null-grid bulkscan at BXD scale ({N} x {P} x {M})")
    Yd, Gd, K, lod_ops, lod_launches, lod_err, lod_max = slice_at_bxd(dev)
    print(f"[5] BALANCED alt-grid bulkscan at BXD scale ({N} x {P} x {M}, g = {len(GRID)})")
    alt_ops, alt_launches, alt_err = altgrid_at_bxd(dev, Yd, Gd, K)
    print(f"[6] BALANCED null-exact bulkscan at BXD scale ({N} x {P} x {M})")
    nullexact_at_bxd(dev, Yd, Gd, K)
    print(f"[7] BALANCED bulkscan_perms at BXD scale ({N} x {P} x {M}, {NPERMS} permutations)")
    prep, idx, perm_ops, perm_launches, perm_err = perms_at_bxd(dev, Yd, Gd, K, lod_max)
    print("[8] times")
    med = times(card, Yd, Gd, K, lod_ops, alt_ops)
    pmed = perm_times(card, Yd, Gd, K, prep, idx, perm_ops)
    print(f"[9] single-trait scan: BXD width ({N} x {P}) and cohort size ({COHORT_N} x {COHORT_P})")
    del prep, idx
    single_trait(dev, card, Gd, K, Yd[:, :1].cpu().numpy())
    import_port()  # the single-trait path imported no jax either
    print(f"[10] bulk options at BXD scale ({N} x {P} x {M}): output_effects, missing, memory "
          "sizing and host blocks, marker streaming")
    eff_ops, eff_times = bulk_options_at_bxd(dev, card, Yd, Gd, K)
    print(f"[11] marker streaming at biobank n ({BIOBANK_N} x {BIOBANK_P} x {BIOBANK_M})")
    streaming_at_biobank_n(dev, card)
    print("[10, last] the memory model's live sets")
    calibrate_memory(dev, Yd, Gd, K)
    print(f"[12] the low-rank engine: rank {N} at BXD scale, rank {LR_RANK} at {LR_N} x {LR_P} x "
          f"{LR_M}")
    lowrank_engine(dev, card, Yd, Gd, K)
    import_port()
    kernels = [{
        "name": "liteqtl_lod",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/liteqtl_fused.cu",
        "replaces": "bulklmm_tpu/pallas/liteqtl_fused.py:106",
        "launches": lod_launches,
        "max_abs_err": lod_err,
        "ms": med["LOD kernel alone"],
        "plain_ms": med["LOD plain version"],
        "general_kernel_ms": med["LOD general kernel alone"],
        "effects_ms": eff_times["kernel"],
        "effects_plain_ms": eff_times["plain"],
        "effects_bound_ms": _bound(2.0 * N * P * M * (lod_ops[1].shape[1] + 2), eff_ops,
                                   3 * 4 * P * M)["bound_ms"],
        "bound": _bound(2.0 * N * P * M * (lod_ops[1].shape[1] + 2), lod_ops, 4 * P * M),
    }, {
        "name": "altgrid",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/altgrid_fused.cu",
        "replaces": "bulklmm_tpu/pallas/altgrid_fused.py:177",
        "launches": alt_launches,
        "max_abs_err": alt_err,
        "ms": med["alt-grid kernel alone"],
        "plain_ms": med["alt-grid plain version"],
        "bound": _bound(2.0 * N * P * M * len(GRID), alt_ops, 8 * P * M),
    }, {
        "name": "bulkperm_maxr2",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/bulkperm_fused.cu",
        "replaces": "bulklmm_tpu/pallas/bulkperm_fused.py:141",
        "launches": perm_launches,
        "max_abs_err": perm_err,
        "ms": pmed["kernel"],
        "plain_ms": pmed["plain"],
        "product_only_ms": pmed["product_only"],
        "bound": _bound(2.0 * N * P * PERM_BLOCK * (NPERMS + 1), perm_ops, 4 * PERM_BLOCK * (NPERMS + 1)),
    }]
    for k in kernels:
        k.update(k.pop("bound"))
        k["library_ms"] = None  # no single PyTorch call computes this function
        k.setdefault("product_only_ms", None)  # timed for the permutation kernel alone
        k.setdefault("general_kernel_ms", None)  # the LOD kernel's other path at the same shape
        for key in ("effects_ms", "effects_plain_ms", "effects_bound_ms"):
            k.setdefault(key, None)  # the LOD kernel's effects variant
        share = 100 * k["bound_ms"] / k["ms"]
        print(f"  {k['name']}: {k['ms']:.3f} ms per launch, bound {k['bound_ms']:.3f} ms by "
              f"{k['bound_unit']} ({k['simt_bound_ms']:.3f} ms on the CUDA cores; the kernel runs "
              f"at {share:.1f} % of the bound's rate), {k['launches']} launches on its path")
        check(share <= 100.0, f"{k['name']} runs faster than its bound")
    check_ptxas(report)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
