#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
exits nonzero:

1. Device check: refuses to run without CUDA; prints the card's name and
   power limit as nvidia-smi reports them.
2. Build: compiles ``bulklmm_tpu_torch/csrc/*.cu`` for sm_90a from the
   checkout's sources and prints the build time.
2b. The accumulate probe (``csrc/accumulate_probe.cu``,
   ``kernels/accumulate_probe.py``): one ``mma.sync`` m16n8k8 and one
   ``wgmma`` m64n64k8 TF32 product, and their bf16 forms m16n8k16 and
   m64n64k16, on crafted operands (accumulators 1.0, 1.5 and their
   negatives, products at known fractions of 1.0's last place, both signs;
   seeded random tiles beside them) print how the tensor cores finish a
   float32 sum; the models of ``kernels/split.py::tensor_core_sum`` that
   give every result bit for bit are printed, and the twin's
   (``TENSOR_CORE_SUM``: cut toward zero, each addend cut 2 bits below
   float32's last place of the largest term; ``BF16_TENSOR_CORE_SUM`` for
   the bf16 forms) must be among them for each form.
3. Each kernel vs its plain version on the card, at small shapes. The LOD
   kernel: c = 1, 2 and 3 covariate columns on the resident kernel and 4 and
   8 on the wide one, a ragged 70 x 45 tile edge, n = 79, 80, 81, 88 (the
   deepest resident operand) and 89 (the first general one), 129 and 321
   markers x 65 and 130 traits (one past a tile each way, an odd row length
   of the output, several marker groups), n = 2,000 to cross many sample
   chunks (c = 2 on the general kernel, 4 and 8 on the wide one), and the
   general kernel forced at a resident shape; the launcher's rule must be
   the wrapper module's. The alt-grid
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
   index (near-ties under another summation order); at n = 2,000 the LOD
   kernels stay within LONG_DEPTH_BAR (twice the float32 fmaf kernels'
   largest distance from their plain version at n = 2,000). Every kernel takes its products as three TF32 passes on
   the tensor cores under every preset but THROUGHPUT (phase 17 holds its
   bf16x3 products); each is also held, reported and not gated, against its
   split reference, which repeats that arithmetic in plain torch. The LOD kernel's effects variant (LOD, effect and standard
   error from the same products) at the same kind of shapes (c = 1, 2, 3
   resident and 4, 8 wide; n = 48, 79, 88, 89 and 2,000; the ragged edge;
   the general kernel forced): max |dLOD| within the bar above, its LOD
   within 1e-6 of the LOD-only kernel's on the same operands, |d effect| <=
   1e-4 (|effect| + SE) and |dSE| <= 1e-4 SE. The run fails, at its end, if
   ptxas reported a spill in any kernel, serialized the wgmma products of
   any 3 x TF32 instantiation (C7510-C7515), or if the LOD-only
   instantiations' registers or shared memory moved from LOD_ONLY_PTXAS.
4. The null-grid path at BXD scale (79 samples x 7,321 markers x 35,554
   traits, synthetic, seed 2026): BALANCED ``bulkscan`` on CUDA tensors must
   launch the LOD kernel and give a finite (7321, 35554) L; the kernel must
   match its plain version on the scan's own rotated inputs and h2 within
   5e-5 (its split reference and the general kernel are reported beside
   it); and L must stay within 1e-4 of the EXACT64 scan (the float64
   oracle) on the traits whose grid h2 agrees. BASELINE.md's bar is a gate
   here and in phases 5-7 (``_parity_gate``): the kernel's call at most
   max(1e-5, the plain engine's distance on the same inputs) from EXACT64,
   with no h2 flip, beside the decomposition of the distance: the kernel's
   call, the plain version on the same operands (exact float32 products),
   the split reference with round-to-nearest sums (the 3 x TF32 products
   without the tensor cores' cuts) and, for the LOD kernel, the general
   kernel (its exact epilogue) on the same operands. A failed gate is
   raised at the end of the run.
5. The alt-grid path at BXD scale, default 10-point grid: BALANCED
   ``bulkscan(method="alt-grid")`` must launch the alt-grid kernel and give
   a finite float64 L and h2 panel (the JAX package's dtypes); the kernel
   must match its plain version on the scan's own rotated inputs within
   5e-5; L must stay within 1e-4 of EXACT64 alt-grid on all pairs (the
   JAX package's 2e-5 reported) and within phase 4's parity gate with no h2
   panel flip; the peak device memory reported.
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
   shuffle indices) on the traits whose grid h2 agrees, and within phase
   4's parity gate there, the plain version and the split reference with
   round-to-nearest sums taken on the same blocks' operands. The oracle
   runs over blocks of 4,096 traits until 20 s are spent and prints how
   many traits it covered. On the first 2,048 traits, trait blocks of 500 and
   permutation chunks of 300 must give the default blocks' maxima within
   5e-5, and ``method="null-exact"`` with 100 permutations must stay
   within 1e-4 of its EXACT64 run. The medians over traits of
   ``get_thresholds_bulk``'s thresholds and the peak device memory are
   reported.
8. Times, printed and not gated, by CUDA events around the work and then a
   checksum fetch: the median of 5 runs after one warm-up of each BALANCED
   ``bulkscan`` (host eigendecomposition included) and of the LOD and
   alt-grid kernels alone and their plain versions at the scan's shape, the
   general LOD kernel at that shape (S1) beside the resident one, both with
   2 and 3 covariate columns, and the wide kernel with 4 and 8 (S2, S3;
   random operands), each of S1-S3 beside its bound; the
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
    (n, m) ones at n = 2,000 with 64 markers (alt-grid's a grid point, and
    null-grid with c = 4 covariate columns, the wide kernel's first count),
    beside ``utils/memory.py``'s multipliers, which must cover them.
11. Marker streaming at biobank n: null-grid, BALANCED, 2,000 samples x
    100,000 markers (an 800 MB float32 host panel, never on the card) x
    2,048 traits, the general LOD kernel, into an ``np.memmap`` in a
    temporary directory: within 1e-4 x n / 79 of the in-memory scan of the
    same data. Printed: both times (median of 3, host clock), their ratio
    (the upload overlap) and the streamed call's device idle share. Then
    the general LOD kernel alone at that shape (S4, the scan's own operands)
    by CUDA events beside its bound; against its plain version on the first
    8,192 markers (phase 3's bar scaled by n/48, and LONG_DEPTH_BAR);
    and that block's BALANCED scan against its EXACT64 scan (1e-4 x n / 79;
    BASELINE.md's 1e-5 reported).
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
13. LOCO, the file readers and the CLI at BXD scale: phase 4's data with
    20 contiguous chromosomes ("1".."19", "X"), their marker counts in
    proportion to the mouse chromosomes' lengths (170 to 542 markers, none
    a multiple of 64). (a) ``loco_kinship`` within 1e-12 of
    ``calc_kinship`` of each leave-out panel. (b) BALANCED
    ``bulkscan_loco``, null-grid, alt-grid and null-exact on all traits:
    exactly 20 launches of its kernel (the LOD kernel, the alt-grid kernel),
    float64 L, each chromosome's rows within 1e-6 of its own ``bulkscan``
    on its leave-out kinship (the h2 flips printed), and within 1e-4 of the
    EXACT64 LOCO call (null-grid on the equal-h2 traits). (c)
    ``bulkscan_perms_loco`` with 1,000 permutations on all traits: 35 x 20
    permutation-kernel launches, the maxima within 1e-6 of the elementwise
    max of the per-chromosome ``bulkscan_perms`` runs at seeds 0..19, and
    on phase 10's cut (2,048 traits, 100 permutations) within 1e-4 of
    EXACT64. (d) ``scan_loco`` of trait 0 with 1,000 permutations within
    1e-4 of EXACT64. (e) ``lowrank_k = 79`` LOCO null-grid within 1e-4 of
    the dense EXACT64 LOCO call (no kernel). (f) the genotype
    probabilities as complement pairs (79 x 14,642), a phenotype CSV of the
    first 2,048 traits (the cut: a compressed 35,554-trait ``.npz`` of
    float64 L would take most of the phase) and a marker map in a
    temporary directory; the native CSV parser must have built, and both
    parsers are timed and must agree; ``python3 -m bulklmm_tpu_torch
    bulkscan --loco --nperms 100``, ``kinship`` and ``scan --loco`` run in
    processes of their own, side by side, and their outputs must equal the
    same calls in this process on the parsed arrays (1e-6; kinship 1e-12).
    Second-call times of the LOCO calls beside the whole-genome calls'.

14. The device mesh at BXD scale (phase 4's data; ``parallel/``). (a)
    ``make_mesh()`` (one position a card: 1 x 1 here) and a virtual 2 x 2
    mesh, ``make_mesh(devices=[cuda:0] * 4, marker_shards=2)``. (b)
    BALANCED ``bulkscan_sharded``, null-grid, alt-grid and null-exact on
    all traits in global trait blocks of 16,384, on both meshes: within
    5e-5 of the single-device call (other trait batches: phase 10's bar),
    no null-grid h2 flip, alt-grid panel flips within phase 3's share,
    within 1e-4 of EXACT64 (null-grid on the equal-h2 traits). (c)
    ``bulkscan_perms_sharded`` with 1,000 permutations on all traits, under
    the same bars, EXACT64 on the first 2,048 traits. (d) Each call's
    launches must equal its tiles x trait blocks a tile (x permutation
    chunks a tile). (e) A two-process pod on this card (gloo handshake,
    ``python3 -m bulklmm_tpu_torch podscan`` twice, ``merge-shards``, then
    with ``--nperms 100``, the two pods side by side) on phase 10's cut
    (2,048 traits) against the same calls in this process, within 5e-5. (f) On the virtual mesh:
    ``bulkscan_streamed`` alt-grid in blocks of 2,048 markers (blocks x
    tiles launches), ``bulkscan_perms_streamed`` (2,048 traits, 100
    permutations), ``bulkscan_loco`` null-grid (20 chromosomes x 4 tiles
    launches, no h2 flip) and ``bulkscan_perms_loco`` (2,048 traits, 100
    permutations), each within 5e-5 of the call without the mesh. Times
    (second calls, host clock) and peak device memory are printed.

15. Wide covariates (the LOD kernel's wide path, ``csrc/liteqtl_wide.cu``,
    c > 3): (a) the kernel and its effects variant against their plain
    version (bar as phase 3's, scaled by n/48; LONG_DEPTH_BAR at n = 2,000)
    at c = 9, 12, 16, 32, 4 and 8 and n = 79 and 2,000 on 129 x 130 (one
    past two tiles each way), with the plain version on the general kernel's
    operands (the packed factor and the substitution) under the same bar,
    and the launcher's rule against ``kernel_path``; (b) BALANCED null-grid and null-exact ``bulkscan`` at
    BXD scale with 11 random covariates and the intercept (c = 12, seed
    2026) against their EXACT64 runs: max |dLOD| <= 1e-4 with no grid h2
    flip (BASELINE.md's 1e-5 reported), launches counted, and null-grid
    with three of those covariates (c = 4) the same way; the effects
    within phase 10's bars; (c) the kernel alone at that shape (S5), its
    time by CUDA events beside its bound and its plain version's time, and
    at 2,000 x 20,000 x 2,048 with c = 12 (S6, random operands) beside its
    bound and against its plain version (phase 3's bar scaled by n/48, and
    LONG_DEPTH_BAR); (d) a c = 32
    null-grid call under a forced 8 GiB budget must stay under it; (e)
    ``bulkscan_streamed`` (phase 10's blocks) and ``bulkscan_loco`` (phase
    13's chromosomes) at c = 12 against the in-memory call (1e-5) and the
    per-chromosome calls (1e-6), with their launches.
16. The validation sweep: ``bulklmm_tpu_torch/validation.py::main`` in this
    process (the 41 paths of ``benchmarks/tpu_validation.py`` and two at
    c = 12, BALANCED on the card against the port's own CPU EXACT64
    goldens, under the JAX sweep's bars); any path that misses its bar
    fails the run.
17. THROUGHPUT on the card: the "high" products, bf16x3 (three bf16
    passes, ``csrc/mma_bf16x3.cuh``), in every LOD kernel (resident,
    general and wide; LOD and effects), both paths of the permutation
    kernel and the alt-grid kernel. (a) Each bf16x3 kernel against its
    bf16x3 plain version (``liteqtl_bf16x3_reference``, ``altgrid_plain``
    and ``bulkperm_maxr2_plain`` with ``dot_precision="high"``) at phase
    3's shapes, n <= 88 for the resident kernels (n = 88 pads to 96) and
    n = 89 and 2,000 for the chunked permutation path, under phase 3's
    bars; the general LOD kernel at n = 89, 150 and 2,000 (c = 1, 2, 3) and
    the wide one at c = 4, 8 and 12 (n = 48, 79 and 2,000) against
    ``liteqtl_bf16x3_chunked_reference`` within CHUNKED_BF16_BAR (1e-5,
    whatever n) and within a quarter of the distance of a 3 x TF32 launch
    on the same operands from the same plain version, each bf16x3 launch
    counted as bf16x3; the distance from the float32 plain version is
    printed and must be above 0. (b)
    THROUGHPUT ``bulkscan`` null-grid and with effects at BXD scale against EXACT64
    (max |dLOD| <= 4e-3 on the equal-h2 traits, the effects relative
    errors too, the JAX package's THROUGHPUT bar), alt-grid (< 2e-2, h2
    panel flips under 20 % of the pairs) and ``bulkscan_perms`` with 1,000
    permutations (< 2e-2 on the first 4,096 traits, EXACT64 by the plain
    engine), each distance above 0; every call launches exactly its
    BALANCED call's count of its kernel (phases 4, 5, 7), every launch
    with bf16x3 products, and phases 4-16 count no bf16x3 launch at all
    (``_drive``). Each bf16x3 kernel on the main path's operands against
    its bf16x3 plain version (phase 3's bars). (c) Times by CUDA events,
    median of 5 after a warm-up, each bf16x3 kernel and its 3 x TF32 twin
    in turns on the same operands, beside the bf16x3 bound (the larger of
    three bf16 passes at 989 TFLOP/s and the bytes at 3.35 TB/s). The
    general and wide LOD kernels: THROUGHPUT null-grid against EXACT64 on
    phase 11's 2,000-sample block and at phase 15's c = 12 (4e-3 x
    max(1, n / 79), every LOD launch bf16x3), a THROUGHPUT
    ``bulkscan_streamed`` over phase 11's panel launching bf16x3 general
    kernels alone, on both main paths' operands the kernel against
    ``liteqtl_bf16x3_reference`` and on their first 512 markers and traits
    against ``liteqtl_bf16x3_chunked_reference`` (KERNEL_BAR, and
    BF16_LONG_DEPTH_BAR at 2,000, and on the corner a mean distance within
    a quarter of a 3 x TF32 launch's), and each kernel's time at S1, S4,
    S5 and S6 beside its 3 x TF32 twin in turns and its bf16x3 bound.
18. The measurement drivers (``bulklmm_tpu_torch/throughput_fwer.py``,
    ``biobank.py``, ``lowrank_cohort.py``, the ports of the JAX package's
    ``benchmarks/`` scripts of those names). (a) The FWER study at the JAX
    script's size (79 x 7,321 x 256, 10 seeds, BALANCED and THROUGHPUT
    ``bulkscan_perms`` with 1,000 permutations, ``get_thresholds_bulk`` at
    five alphas): every row printed, and at every alpha the paired tier
    difference over the seed-to-seed spread (``delta_over_spread_max``)
    under 0.1; the engine table (THROUGHPUT on the card against the port's
    CPU EXACT64 at 79 x 512 x 64), null-grid, null-exact and streamed
    within 4e-3 and alt-grid and permutations within 2e-2 (phase 17's bars),
    the rest reported, every kernel launched in bf16x3; the time of
    ``get_thresholds_bulk`` on 35,554 x 1,001 maxima (median of 5, host
    clock). (b) ``biobank --full`` (5,000 x 100,000 x 20,000, the cohort
    drawn on the host, the decomposition cached in a temporary directory,
    the general LOD kernel): its line under BALANCED; the first 8,192
    markers' BALANCED scan on the float64 factors against EXACT64 (1e-4 x
    n/79, BASELINE.md's 1e-5 reported); then ``--perms 256 --perm-traits
    128`` (the chunked permutation kernel) under BALANCED and THROUGHPUT,
    their lines, and on the float64 factors each against the EXACT64 plain
    engine on the same shuffle indices (1e-4 x n/79 and 2e-2 x n/79 on the
    equal-h2 traits). (c) ``lowrank_cohort --compare-full`` under BALANCED
    at 5,000 x 20,000 x 512, k = 1,024: its lines and fidelity line, the
    grid h2 of the traits, and the full-rank scan against EXACT64 on the
    same factors (1e-4 x n/79). The phase's time and the run's are printed.

Every path runs with the launch record (``utils/profiling.py::launch_counts``,
launches by route) cleared just before it and read just after. The second-to-last line is one JSON object describing
each kernel, with its bound on this card (``loco_launches`` is its launch
count on phase 13's LOCO path: the null-grid call for the LOD kernel): the larger of its bytes (each
operand read once, each result written once) over 3.35 TB/s and the least
time either unit takes for float32-grade products of its operations, the
smaller of flops over 67 TFLOP/s (CUDA cores) and 3 x flops over 495
TFLOP/s (three TF32 passes on the tensor cores); ``bound_unit`` names the
unit and ``simt_bound_ms`` keeps the CUDA cores' time;
``general_kernel_ms`` is the LOD step's general kernel at the same shape;
``mesh_launches`` its launches in one call on phase 14's virtual 2 x 2
mesh (null-grid for the LOD kernel);
``effects_ms``, ``effects_plain_ms`` and ``effects_bound_ms`` are its effects
variant's time, its plain version's and its bound (the same operations,
three (p, m) float32 outputs written); ``wide_c``, ``wide_launches``,
``wide_ms``, ``wide_plain_ms``, ``wide_bound_ms``, ``wide_simt_bound_ms``
and ``wide_max_abs_err`` are its wide kernel's, at BXD scale with c = 12
(phase 15); ``shapes`` holds, for each of LOD_SHAPES' S1-S6, the time of
the kernel that takes it (``ms``), its bound (``bound_ms``, ``bound_by``)
and the share of the bound (``share``; phases 8, 11 and 15). Phase 17 adds
to every kernel ``bf16x3_launches`` (its THROUGHPUT call's launches, all
bf16x3), ``bf16x3_max_abs_err`` (the bf16x3 kernel against its bf16x3
plain version at BXD scale), ``throughput_vs_exact64`` (and for the LOD
kernel ``throughput_effects_vs_exact64``: LOD, effect and SE), and
``bf16x3_ms``, ``tf32x3_ms`` (its 3 x TF32 twin in the same turns),
``bf16x3_bound_ms``, ``bf16x3_bound_by`` and ``bf16x3_share``, and the LOD
kernel ``bf16x3_chunked``: the general and wide kernels' THROUGHPUT
launches and distances from EXACT64, on the main paths' operands
(``vs_bf16x3_plain``) their distances from the bf16x3 plain versions
beside the 3 x TF32 launch's and the float32 plain version's, in
``kernel_checks`` phase 17 (a)'s largest distance from the chunked bf16x3
plain version beside the 3 x TF32 launches' least, and their times at S1,
S4, S5, S6. Phase 18 adds ``drivers_launches``: its launches in each of the
measurement drivers' paths that launched it. No
single PyTorch call computes any of the three kernels' functions, so
``library_ms`` is null. The last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import fnmatch
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from kernel_times import LOD_SHAPES, SHAPE_SEED, bound_ms

N, P, M = 79, 7321, 35554
NPERMS = 1000
PERM_BLOCK = 1024  # bulkscan_perms' trait block under the kernel's engine
ORACLE_BLOCK, ORACLE_SECONDS = 4096, 20.0
OPTION_TRAITS = 2048  # traits of the chunking and null-exact checks of the permutation path
SPLIT_TRAITS = 8  # traits of the permutation kernel's split reference at BXD scale
SEED = 2026
PEAK_FLOPS, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12  # H100 SXM: float32 SIMT, TF32, HBM3
PEAK_BF16 = 989e12  # H100 SXM: dense bf16 on the tensor cores
SPLIT_PASSES = 3  # TF32 tensor-core passes of one float32-grade product
KERNEL_BAR = 5e-5  # max |dLOD|, kernel vs plain, n <= 79
#: max |dLOD|, kernel vs plain at n = 2,000: twice the float32 fmaf kernels'
#: (PR 1's general, PR 11's wide) largest distance from their plain version
#: at n = 2,000, on phase 11's block and S4, S4e, S6 and S7
#: (``kernel_times.py``, NVIDIA H100 80GB HBM3, 700.00 W): one unit in the
#: last place of 1 - r2 scaled by n / (2 ln 10), near 2.62e-5
FMAF_LONG_DEPTH = 2.6703e-5
LONG_DEPTH_BAR = 2 * FMAF_LONG_DEPTH
#: max |dLOD| at n = 2,000 of a bf16x3 general or wide kernel from a bf16x3
#: plain version that sums in another order: four units in the LOD's last
#: place there. The kernels keep one accumulator over the walk under bf16x3
#: (no running totals), and read 7.915e-5 on phase 11's block from
#: ``liteqtl_bf16x3_reference`` and 1.054e-4 at S4 from the float32 plain
#: version (NVIDIA H100 80GB HBM3, 700.00 W)
BF16_LONG_DEPTH_BAR = 4 * FMAF_LONG_DEPTH
R2_BAR = 1e-5  # max |d max r^2|, permutation kernel vs plain
ORACLE_BAR = 1e-4  # max |dLOD|, BALANCED vs EXACT64 on equal-h2 traits
#: BASELINE.md's accuracy bar: at BXD scale under BALANCED the null-grid,
#: null-exact, alt-grid and permutation paths stay within max(PARITY_BAR,
#: the plain engine's distance on the same inputs) of EXACT64 (gated,
#: :func:`_parity_gate`); elsewhere reported
PARITY_BAR = 1e-5
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
BIOBANK_BLOCK = 8192  # phase 11: markers of the kernel-vs-plain and EXACT64 checks
#: a kernel entry in ptxas's report: its name and its template arguments as
#: mangled, integers and booleans (``Li1E``, ``Lb0E``) and the products'
#: policy (``N6tf32x36PolicyE``, ``N6bf16x36PolicyE``)
ENTRY_RE = re.compile(r"Compiling entry function '\w*\d([a-z_]+_kernel(?:I(?:L[ib]\d+E|N\w+?E)+)?)E")
#: ptxas's note that it serialized a function's wgmma products (C7510-C7515)
SERIAL_RE = re.compile(r"\(C751[0-5]\)[^\n]*?function '(\w+)'")
#: ptxas's note that it injected a warpgroup.wait (C7517) or a
#: warpgroup.arrive (C7519) around a function's wgmma products
INJECTED_RE = re.compile(r"\((C751[79])\)[^\n]*?function '(\w+)'")
#: ptxas's (registers, spill stores, spill loads, static shared bytes) of the
#: LOD kernel's LOD-only 3 x TF32 instantiations, as phase 2 printed them
#: (NVIDIA H100, CUDA 12.8's nvcc): the resident kernel's with its leading
#: terms a depth step at a time into a scratch set, the general and wide
#: kernels' for their chunked 3 x TF32 sources (every entry named with the
#: products' policy since the bf16x3 instantiations came beside them); a
#: change to their sources must bring them up to date
LOD_ONLY_PTXAS = {
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi3ELi0ELb0ELb0E": (247, 0, 0, 0),
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi3ELi0ELb0ELb1E": (255, 0, 0, 128),
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi2ELi1ELb0ELb0E": (239, 0, 0, 0),
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi2ELi1ELb0ELb1E": (255, 0, 0, 128),
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi1ELi1ELb0ELb0E": (205, 0, 0, 0),
    "liteqtl_general_wgmma_kernelIN6tf32x36PolicyELi1ELi1ELb0ELb1E": (254, 0, 0, 128),
    "liteqtl_wide_wgmma_kernelIN6tf32x36PolicyELi1ELb0ELb0E": (236, 0, 0, 0),
    "liteqtl_wide_wgmma_kernelIN6tf32x36PolicyELi1ELb0ELb1E": (254, 0, 0, 128),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi11ELi1ELb0E": (224, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi10ELi1ELb0E": (224, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi8ELi1ELb0E": (224, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi6ELi1ELb0E": (224, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi4ELi1ELb0E": (223, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi1ELi2ELi1ELb0E": (228, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi11ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi10ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi8ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi6ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi4ELi1ELb0E": (232, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi2ELi2ELi1ELb0E": (229, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi11ELi0ELb0E": (239, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi10ELi0ELb0E": (239, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi8ELi0ELb0E": (241, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi6ELi0ELb0E": (240, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi4ELi0ELb0E": (245, 0, 0, 0),
    "liteqtl_resident_kernelIN6tf32x36PolicyELi3ELi2ELi0ELb0E": (250, 0, 0, 0),
}
GRID = np.arange(0.0, 0.91, 0.1)  # bulkscan's default h2 grid
PRIOR = (1.0, 0.0)  # bulkscan's default prior
SCAN_NPERMS = 1024  # permutations of the single-trait scans
COHORT_N, COHORT_P = 2000, 20000  # the single-trait cohort size
#: phase 12 (b): benchmarks/lowrank_cohort.py's cohort and its rank
LR_N, LR_P, LR_M, LR_RANK = 20_000, 50_000, 2_000, 2_048
LR_PERM_TRAITS, LR_NPERMS = 256, 100  # phase 12 (b)'s bulkscan_perms cut
LR_STREAM_BLOCK = 8192  # phase 12 (b)'s marker block
RAYLEIGH_BAR = 0.05  # max_i ||K u_i - lam_i u_i|| / lam_1 (tests/test_lowrank.py:96)
#: phase 12's live sets: markers and rank of the (k,)-sized calls
LR_CAL_P, LR_CAL_RANK = 64, 2000
#: phase 13: the mouse chromosomes (GRCm38 lengths in Mb, 1..19 and X); the
#: BXD markers are split among them in proportion
MOUSE_CHROMS = tuple(str(i) for i in range(1, 20)) + ("X",)
MOUSE_MB = (195, 182, 160, 157, 152, 150, 145, 129, 125, 131, 122, 120, 120, 125, 104, 98, 95, 91,
            61, 171)
LOCO_BAR = 1e-6  # max |dLOD|, a LOCO call vs its per-chromosome calls, and the CLI vs in-process
#: phase 14: max |dLOD| of a call on a mesh against the same call on one
#: device (other trait batches: phase 10's bar for host blocks), and the
#: global trait block of its scans (so that its launches are predictable)
MESH_BAR = 5e-5
MESH_TRAIT_CHUNK = 16384
KINSHIP_BAR = 1e-12  # max |dK|, leave-out kinships vs calc_kinship of the subset panel
CLI_TRAITS, CLI_NPERMS = 2048, 100  # phase 13 (f): the CLI run's traits and permutations
CLI_SECONDS = 600  # a CLI subprocess's time limit
#: phase 15: the wide LOD kernel's covariate columns against its plain
#: version, and the scans' (11 random covariates and the intercept)
WIDE_COVARIATES = (9, 12, 16, 32, 4, 8)
WIDE_C = 12
#: the LOD kernel's shapes timed here beside their bounds, from
#: kernel_times.py's LOD_SHAPES: S1 the general kernel forced at BXD scale,
#: S2 / S3 / S5 BXD with 4, 8 and 12 covariate columns, S4 phase 11's panel
#: (c = 1), S6 a 2,000-sample cohort with 12
SMOKE_SHAPES = ("S1", "S2", "S3", "S4", "S5", "S6")
#: phase 15: a c = 32 null-grid call sized by the memory model under this
#: forced budget must stay under it
WIDE_BUDGET = 8 * 2**30
#: phase 17, THROUGHPUT against EXACT64 at BXD scale: the JAX package's
#: bars for its THROUGHPUT preset, 4e-3 in LOD for the null-grid scan
#: (tests/test_bulkscan.py:138; here also the effects, relative as phase 10
#: holds them) and 2e-2 for alt-grid and the permutation maxima
#: (tests/test_pallas_altgrid.py:70-72, tests/test_bulkperm.py:121), and the
#: share of alt-grid h2 panel pairs that may take another grid step
THROUGHPUT_LOD_BAR = 4e-3
THROUGHPUT_BAR = 2e-2
THROUGHPUT_FLIP_SHARE = 0.2
#: phase 18 (a), benchmarks/throughput_fwer.py's claim as a gate: at every
#: alpha the tiers' paired threshold difference, trait by trait, stays under
#: this share of the seed-to-seed spread of BALANCED's thresholds
FWER_SPREAD_BAR = 0.1
#: phase 18 (a)'s engine table: phase 17's THROUGHPUT bars where phase 17
#: has one for the path; the other engines are reported
ENGINE_BARS = {"bulk_null_grid": THROUGHPUT_LOD_BAR, "bulk_null_exact": THROUGHPUT_LOD_BAR,
               "streamed": THROUGHPUT_LOD_BAR, "bulk_alt_grid": THROUGHPUT_BAR,
               "bulk_perms": THROUGHPUT_BAR}
#: phase 18 (b): benchmarks/refresh_all.sh's permutation run of the driver
DRIVER_PERMS, DRIVER_PERM_TRAITS = 256, 128
#: phase 18 (c): the cohort driver cut so that its host eigh stays within seconds
COHORT_CUT_N, COHORT_CUT_P, COHORT_CUT_M, COHORT_CUT_K = 5000, 20_000, 512, 1024


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke failed: {what}")


#: the parity gates that failed, raised at the end of the run so that one
#: run shows every phase
_PARITY_FAILED: list[str] = []


def _parity_gate(path: str, parts: dict, flips: int = 0, flips_what: str = "h2 flips") -> None:
    """BASELINE.md's bar as a gate on one BXD path: ``parts`` holds the
    distances from EXACT64 of the kernel's call ("kernel"), the port's plain
    engine on the same inputs ("plain engine") and the other calls of the
    decomposition; the kernel's must be at most max(PARITY_BAR, the plain
    engine's), with no flip. Prints the decomposition; a failure is
    recorded and raised at the end of the run."""
    bar = max(PARITY_BAR, parts["plain engine"])
    ok = parts["kernel"] <= bar and flips == 0
    print(f"  {path}, BALANCED vs EXACT64 at BXD scale: "
          + ", ".join(f"{name} {err:.3e}" for name, err in parts.items())
          + f"; {flips_what} {flips}; gate max(BASELINE.md's {PARITY_BAR:.0e}, plain engine) = "
          f"{bar:.3e}: {'met' if ok else 'NOT met'}")
    if not ok:
        _PARITY_FAILED.append(path)


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
    with its template arguments as mangled (``IN6tf32x36PolicyELi1ELi10ELi1ELb0E``:
    3 x TF32 products, c = 1, 10 depth steps, 1 step in flight, no
    effects; ``N6bf16x36PolicyE`` for bf16x3)."""
    out, entry = {}, None
    for line in log.read_text().splitlines():
        found = ENTRY_RE.search(line)
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


def build() -> tuple:
    """Builds the library and prints the build time and ptxas's report;
    returns the report (:func:`ptxas_report`), the entries whose wgmma
    products ptxas serialized (:func:`serialized_wgmma`) and its injected
    warpgroup barriers (:func:`injected_barriers`)."""
    from bulklmm_tpu_torch.kernels.build import BUILD_DIR, load_library

    t0 = time.perf_counter()
    load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s")
    log = BUILD_DIR / "build.log"
    if log.exists():
        for line in log.read_text().splitlines():
            entry = ENTRY_RE.search(line)
            if entry:
                print("  ptxas:", entry.group(1))
            elif "registers" in line or "spill" in line:
                print("  ptxas:  ", line.replace("ptxas info    : ", "").strip())
        return ptxas_report(log), serialized_wgmma(log), injected_barriers(log)
    return {}, [], {}


def serialized_wgmma(log: Path) -> list:
    """The kernel entries (mangled) for which a build log's ptxas report says
    that it serialized the wgmma products (C7510 to C7515)."""
    return sorted({m.group(1) for m in SERIAL_RE.finditer(log.read_text())})


def injected_barriers(log: Path) -> dict:
    """{(code, mangled entry): count} of a build log's injected
    warpgroup.wait (C7517) and warpgroup.arrive (C7519) notes."""
    out = {}
    for m in INJECTED_RE.finditer(log.read_text()):
        out[m.groups()] = out.get(m.groups(), 0) + 1
    return out


#: a resident 3 x TF32 LOD kernel entry: covariate columns, depth steps,
#: steps in flight, effects
RESIDENT_TF32_RE = re.compile(r"liteqtl_resident_kernelIN6tf32x36PolicyELi(\d+)ELi(\d+)ELi\d+ELb([01])")
#: a chunked (general or wide) bf16x3 LOD kernel entry
CHUNKED_BF16_RE = re.compile(r"liteqtl_(?:general|wide)_wgmma_kernel\w*N6bf16x36PolicyE")
#: the chunked bf16x3 instantiations: the general kernel's c = 1, 2, 3 and the
#: wide kernel's, each LOD alone and effects, none of them folding
CHUNKED_BF16_BUILT = 8
#: the chunked permutation kernel's entries (n > 88): one a products' policy
PERM_CHUNKED_BUILT = ("bulkperm_chunked_kernelIN6tf32x36PolicyE",
                      "bulkperm_chunked_kernelIN6bf16x36PolicyE")


def check_ptxas(report: dict, serialized: list, injected: dict) -> None:
    """No kernel spills, no 3 x TF32 instantiation and no chunked bf16x3
    one (the chunked permutation kernel's under both policies,
    PERM_CHUNKED_BUILT, among them) serializes its wgmma products (``serialized``:
    :func:`serialized_wgmma`), the LOD-only 3 x TF32 instantiations'
    figures are LOD_ONLY_PTXAS's, the chunked bf16x3 instantiations are
    CHUNKED_BF16_BUILT, none with more injected warpgroup waits or arrives
    (``injected``: :func:`injected_barriers`, C7517 and C7519) than the most
    of a chunked 3 x TF32 instantiation, and for every resident 3 x TF32 instantiation that
    ptxas reports the CPU twin's ``liteqtl_fused.py::lead_runs`` is the
    kernel's ``lead_runs()``. Checked at the end of the run, so that one run
    shows every phase."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    resident = sorted({tuple(int(g) for g in found.groups())
                       for k in report if (found := RESIDENT_TF32_RE.search(k))})
    lib = lf._library()
    twin_off = [r for r in resident if lf.lead_runs(*r) != bool(lib.bulklmm_liteqtl_lead_runs(*r))]
    print(f"  resident 3 x TF32 instantiations (c, steps, effects) {len(resident)}, leading terms "
          f"straight into their sets at {[r for r in resident if not lf.lead_runs(*r)]}; the twin's "
          f"lead_runs differs from the kernel's at {twin_off}")
    built = 2 * lf.RESIDENT_COVARIATES * len({lf.resident_steps(n) for n in range(1, 89)})
    check(len(resident) == built, f"ptxas reports {len(resident)} resident 3 x TF32 "
          f"instantiations, not {built}")
    check(not twin_off, f"liteqtl_fused.lead_runs differs from the kernel's lead_runs() at {twin_off}")
    spilled = sorted(k for k, (_, st, ld, _) in report.items() if st or ld)
    moved = {k: (report.get(k), want) for k, want in LOD_ONLY_PTXAS.items() if report.get(k) != want}
    tf32 = [k for k in serialized if "bf16x3" not in k or CHUNKED_BF16_RE.search(k)
            or "bulkperm_chunked" in k]
    chunked = sorted(k for k in report if CHUNKED_BF16_RE.search(k))
    perm = {k: report.get(k) for k in PERM_CHUNKED_BUILT}
    print(f"  ptxas: the chunked permutation kernel's instantiations {perm}")
    check(all(perm.values()), f"ptxas reports no chunked permutation instantiation for {perm}")
    print(f"  ptxas: kernels that spill {spilled}; 3 x TF32 and chunked bf16x3 kernels whose wgmma "
          f"products are serialized {tf32} (other bf16x3: {len(serialized) - len(tf32)}); LOD-only "
          f"instantiations whose figures moved {moved}; chunked bf16x3 instantiations "
          + ", ".join(f"{k} {report[k]}" for k in chunked))
    check(not spilled, f"ptxas spills in {spilled}")
    check(not tf32, f"ptxas serializes the wgmma products of {tf32}")
    check(len(chunked) == CHUNKED_BF16_BUILT,
          f"ptxas reports {len(chunked)} chunked bf16x3 instantiations, not {CHUNKED_BF16_BUILT}")
    twins = {code: max((k for (c, e), k in injected.items() if c == code and "tf32x36Policy" in e
                        and re.search(r"liteqtl_(?:general|wide)_wgmma", e)), default=0)
             for code in ("C7517", "C7519")}
    more = sorted({e for (c, e), k in injected.items() if CHUNKED_BF16_RE.search(e) and k > twins[c]})
    print(f"  ptxas: injected warpgroup waits (C7517) and arrives (C7519) at most {twins} a chunked "
          f"3 x TF32 instantiation; chunked bf16x3 instantiations with more {more}")
    check(not more, f"ptxas injects more warpgroup barriers in {more} than in their 3 x TF32 twins")
    check(not moved, f"the LOD-only instantiations' ptxas figures changed: {moved}")


def accumulate_probe(dev) -> dict:
    """Phase 2b: how the tensor cores finish a float32 sum, for mma.sync
    m16n8k8 and wgmma m64n64k8 TF32 and their bf16 forms m16n8k16 and
    m64n64k16 (``kernels/accumulate_probe.py``): the documented cases, and
    the models of ``split.py::tensor_core_sum`` that give every result of
    those and of the random tiles bit for bit. Fails if no model does, or if
    the twin's model (``TENSOR_CORE_SUM``, ``BF16_TENSOR_CORE_SUM`` for the
    bf16 forms) is not among them."""
    from bulklmm_tpu_torch.kernels import accumulate_probe as ap
    from bulklmm_tpu_torch.kernels.split import BF16_TENSOR_CORE_SUM, TENSOR_CORE_SUM

    found = {}
    for form in ("mma", "wgmma", "mma_bf16", "wgmma_bf16"):
        res = ap.run(form, dev)
        twin = BF16_TENSOR_CORE_SUM if form.endswith("bf16") else TENSOR_CORE_SUM
        print(f"  {form}: accumulator + sum of {ap.DEPTHS[form]} products (in units of 2^-23) -> the "
              "card's result minus the accumulator, in units of 2^-23:")
        for name, acc, exact, got in res["documented"]:
            print(f"    {name:56s} acc {acc:+5.2f}: exact {exact:+.6f} -> {(got - acc) / ap.ULP:+.6f}")
        models = res["models"]
        print(f"  {form}: models that give all {len(res['documented'])} documented and "
              f"{ap.RANDOM_TILES[form]} random tiles' results bit for bit: {models}")
        check(bool(models), f"no model of the tensor cores' sum fits {form}")
        check(twin in models, f"the twin's model {twin} does not fit {form}")
        found[form] = models
    return found


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
        (2000, 96, 64, 4, False), (2000, 96, 64, 8, False),
    ]
    for n, p, m, c, general in cases:
        path = lf.kernel_path(n, c)
        check(path == lf.launcher_path(n, c),
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
        check(n < 2000 or err <= LONG_DEPTH_BAR,
              f"kernel strays past {LONG_DEPTH_BAR:.2e} from its plain version at {(n, p, m, c)}")
    check(lf.kernel_path(88, 3) == "resident" and lf.kernel_path(89, 1) == "general"
          and lf.kernel_path(79, 4) == "wide" and lf.kernel_path(2000, 3) == "general",
          "the LOD kernel's limits moved: bring the shapes above up to date")


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
        (2000, 96, 64, 2, False), (2000, 96, 64, 4, False), (2000, 96, 64, 8, False),
    ]
    for n, p, m, c, general in cases:
        path = lf.kernel_path(n, c, effects=True)
        check(path == lf.kernel_path(n, c), f"the effects variant takes another path at n={n}, c={c}")
        check(path == lf.launcher_path(n, c, effects=True),
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
        check(n < 2000 or lod_err <= LONG_DEPTH_BAR,
              f"the effects variant strays past {LONG_DEPTH_BAR:.2e} at {(n, p, m, c)}")
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
        (2000, 96, 8, 2, 24), (89, 300, 3, 2, 1001), (5000, 700, 2, 1, 1001),
    ]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, p, mb, c, K in cases:
        path = bf.kernel_path(n)
        check((path == "resident") == bool(bf._library().bulklmm_bulkperm_is_resident(n)),
              f"the launcher and kernel_path disagree on the path at n={n}")
        groups = bf._library().bulklmm_bulkperm_marker_groups(n, p, mb, 1001)
        check(groups == bf.marker_groups(n, p, mb, 1001, sms),
              f"the launcher and marker_groups disagree at {(n, p, mb)}: {groups}")
        ops = _perm_operands(n, p, mb, c, K, rng, dev)
        r2_err, lod_err, out, _ = _perm_kernel_errors(ops, n)
        split_err = (out - bf.bulkperm_maxr2_split_reference(*ops)).abs().max().item()
        bar = KERNEL_BAR * max(1.0, n / 48)
        print(f"  permutation kernel ({path}, {bf.marker_groups(n, p, mb, K, sms)} marker groups) "
              f"vs plain n={n} p={p} mb={mb} c={c} K={K}: "
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


def _total(counts, route="*") -> int:
    """The launches in ``counts`` (the launch record or a copy of it, keyed
    "<kernel>.<path>.<products>") whose route matches the pattern ``route``:
    "altgrid.*" every alt-grid launch, "*.*.bf16x3" every bf16x3 one; all of
    them by default."""
    return sum(v for k, v in counts.items() if fnmatch.fnmatchcase(k, route))


def _drive(what, fn, products="tf32x3"):
    """One path with the launch record (``utils/profiling.py::launch_counts``)
    cleared just before and copied just after; prints the first call's time
    and the peak device memory. Every launch must have taken ``products``
    (None: either): no bf16x3 launch outside THROUGHPUT's calls."""
    from bulklmm_tpu_torch.utils.profiling import launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    launch_counts.clear()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    counts = collections.Counter(launch_counts)
    print(f"  {what}, first call: {first_s:.3f} s, kernel launches: {dict(counts)}, "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    check(products is None or _total(counts, f"*.*.{products}") == _total(counts),
          f"{what} launched {dict(counts)}, not {products} products alone")
    return res, counts


def _rotated_bxd(K, Yd, Gd, dev, covar=None):
    """Phase 4's rotated operands (Y0, X0m, C0, lam); ``covar`` (n, k)
    beside the intercept."""
    from bulklmm_tpu_torch.ops.rotation import decompose_kinship
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    dec = decompose_kinship(K, dtype=torch.float64, device=dev)
    C = torch.ones((N, 1), dtype=torch.float64, device=dev)
    if covar is not None:
        C = torch.cat([C, covar.double()], 1)
    with with_highest_matmul():
        return dec.Ut @ Yd.double(), dec.Ut @ Gd.double(), dec.Ut @ C, dec.lam


def slice_at_bxd(dev):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.kernels.split import matmul_tf32x3

    G, K, Y = synth_bxd()
    Gd = torch.from_numpy(G).to(dev)
    Yd = torch.from_numpy(Y).to(dev)
    res, counts = _drive("BALANCED null-grid bulkscan",
                         lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED))
    launches = _total(counts, "liteqtl_lod.*")
    check(launches > 0, "the BALANCED bulkscan did not launch the CUDA kernel")
    check(tuple(res.L.shape) == (P, M), f"L has shape {tuple(res.L.shape)}")
    check(res.L.is_cuda and res.L.dtype == torch.float32, "L is not float32 on the card")
    check(bool(torch.isfinite(res.L).all()), "L is not finite")
    lod_max = res.L.max(0).values  # the permutation phase's observed column

    exact = bt.bulkscan(Yd, Gd, K, precision=bt.EXACT64)
    torch.cuda.synchronize()
    same = exact.h2_null_list == res.h2_null_list.double()
    nflip = int((~same).sum())

    def oracle(L):
        return _max_abs_diff_cols(L, exact.L, same)

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
    parts = {"kernel": oracle(res.L), "plain engine": oracle(Lp)}
    Lg = lf.liteqtl_lod_cuda(*ops, general=True)
    gerr = _max_abs_diff_cols(Lg, Lp, all_cols)
    parts["kernel with the exact epilogue (general)"] = oracle(Lg)
    del Lg
    Ls = lf.liteqtl_split_reference(*ops)
    serr = _max_abs_diff_cols(Lk, Ls, all_cols)
    del Ls
    # the split reference with round-to-nearest sums: the products' own
    # error, without the tensor cores' cuts
    Lr = lf._lod_with_product(*ops, matmul_tf32x3)
    parts["split reference, round-to-nearest sums"] = oracle(Lr)
    rerr = _max_abs_diff_cols(Lr, Lp, all_cols)
    del Lr, Lp
    print(f"  at BXD scale, reported: kernel vs its split reference (its tensor cores' sums "
          f"emulated) {serr:.3e}; general kernel vs plain {gerr:.3e} (bar {KERNEL_BAR:.0e}); the "
          f"split reference with round-to-nearest sums vs plain {rerr:.3e}")
    check(gerr <= KERNEL_BAR, "the general kernel disagrees with the plain version at BXD scale")
    print(f"  BALANCED vs EXACT64: {nflip} of {M} traits with a different grid h2; "
          f"max|dLOD| on the rest = {parts['kernel']:.3e} (bar {ORACLE_BAR:.0e})")
    check(parts["kernel"] <= ORACLE_BAR, "BALANCED strays from the EXACT64 oracle")
    _parity_gate("null-grid", parts, nflip)
    del exact
    return Yd, Gd, K, ops, launches, kerr, lod_max


def altgrid_at_bxd(dev, Yd, Gd, K):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels.split import matmul_tf32x3

    res, counts = _drive(
        "BALANCED alt-grid bulkscan",
        lambda: bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.BALANCED),
    )
    launches = _total(counts, "altgrid.*")
    check(launches > 0, "the BALANCED alt-grid bulkscan did not launch the alt-grid kernel")
    check(tuple(res.L.shape) == (P, M) and tuple(res.h2_panel.shape) == (P, M),
          f"alt-grid L {tuple(res.L.shape)}, panel {tuple(res.h2_panel.shape)}")
    check(res.L.is_cuda and res.L.dtype == res.h2_panel.dtype == torch.float64,
          "alt-grid L and h2_panel are not float64 on the card (the JAX package's dtypes)")
    check(bool(torch.isfinite(res.L).all()), "alt-grid L is not finite")
    grid = torch.as_tensor(GRID, dtype=torch.float64, device=dev)
    check(bool(torch.isin(res.h2_panel, grid).all()), "alt-grid h2_panel holds off-grid values")
    exact = bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.EXACT64)
    torch.cuda.synchronize()
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)

    def oracle(L):
        return _max_abs_diff_cols(L, exact.L, all_cols)

    # the kernel against its plain version on the scan's own rotated inputs
    ops = af.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev), grid, prior=PRIOR)
    Lk, kk = af.altgrid_cuda(*ops)
    torch.cuda.synchronize()
    Lp, kp = af.altgrid_plain(*ops)
    torch.cuda.synchronize()
    kerr = _max_abs_diff_cols(Lk, Lp, all_cols)
    flips = _index_flips(kk, kp)
    same_as_scan = _max_abs_diff_cols(Lk, res.L, all_cols)
    print(f"  alt-grid kernel vs plain at BXD scale: max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}), "
          f"index flips {flips} of {P * M}; kernel vs the scan's L: {same_as_scan:.3e}")
    check(kerr <= KERNEL_BAR, "alt-grid kernel disagrees with its plain version at BXD scale")
    check(flips <= INDEX_FLIP_SHARE * P * M, "alt-grid kernel index flips at BXD scale")
    parts = {"kernel": oracle(res.L), "plain engine": oracle(Lp)}
    del Lk, kk, kp
    Lr, _ = af._min_over_grid(*ops, False, matmul_tf32x3)
    parts["split reference, round-to-nearest sums"] = oracle(Lr)
    rerr = _max_abs_diff_cols(Lr, Lp, all_cols)
    del Lr, Lp
    print(f"  at BXD scale, reported: the split reference with round-to-nearest sums vs plain "
          f"{rerr:.3e}")

    pflips = int((res.h2_panel != exact.h2_panel).sum())
    print(f"  alt-grid BALANCED vs EXACT64 on all {P * M} pairs: max|dLOD| = {parts['kernel']:.3e} "
          f"(bar {ORACLE_BAR:.0e}; the JAX package's {JAX_ALTGRID_BAR:.0e}: "
          f"{'met' if parts['kernel'] <= JAX_ALTGRID_BAR else 'NOT met'}); "
          f"h2_panel flips {pflips} ({pflips / (P * M):.2e} of the pairs)")
    check(parts["kernel"] <= ORACLE_BAR, "alt-grid BALANCED strays from the EXACT64 oracle")
    _parity_gate("alt-grid", parts, pflips, "h2 panel flips")
    del exact, res
    return ops, launches, kerr


def nullexact_at_bxd(dev, Yd, Gd, K):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.kernels.split import matmul_tf32x3
    from bulklmm_tpu_torch.ops import brent

    res, counts = _drive(
        "BALANCED null-exact bulkscan",
        lambda: bt.bulkscan(Yd, Gd, K, method="null-exact", precision=bt.BALANCED),
    )
    iters = brent.iterations
    check(_total(counts, "liteqtl_lod.*") > 0,
          "the BALANCED null-exact bulkscan did not launch the LOD kernel")
    check(tuple(res.L.shape) == (P, M) and res.L.dtype == torch.float32, "null-exact L shape or dtype")
    check(res.h2_null_list.dtype == torch.float64, "null-exact h2 is not float64 under BALANCED")
    check(bool(torch.isfinite(res.L).all()), "null-exact L is not finite")
    exact = bt.bulkscan(Yd, Gd, K, method="null-exact", precision=bt.EXACT64)
    torch.cuda.synchronize()
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)

    def oracle(L):
        return _max_abs_diff_cols(L, exact.L, all_cols)

    # the decomposition on the scan's own inputs and h2
    ops = lf.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev), res.h2_null_list)
    parts = {"kernel": oracle(res.L), "plain engine": oracle(lf.liteqtl_lod_plain(*ops)),
             "kernel with the exact epilogue (general)": oracle(lf.liteqtl_lod_cuda(*ops, general=True)),
             "split reference, round-to-nearest sums": oracle(lf._lod_with_product(*ops, matmul_tf32x3))}
    del ops
    dh2 = (res.h2_null_list - exact.h2_null_list).abs().max().item()
    print(f"  null-exact BALANCED vs EXACT64: max|dLOD| = {parts['kernel']:.3e} (bar {ORACLE_BAR:.0e}); "
          f"max|dh2| = {dh2:.3e}; Brent iterations {iters} (BALANCED), "
          f"{brent.iterations} (EXACT64)")
    check(parts["kernel"] <= ORACLE_BAR, "null-exact BALANCED strays from the EXACT64 oracle")
    _parity_gate("null-exact", parts, int((res.h2_null_list != exact.h2_null_list).sum()),
                 "traits with another h2")
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
    shapes = {"S1": _shape_entry(med["LOD general kernel alone"], "S1")}
    print(f"    LOD general kernel alone at S1: {_shape_line(shapes['S1'])}")
    # the LOD step with more covariate columns, random operands at the same
    # shape (c = 4 and 8: S2 and S3, the wide kernel)
    rng = np.random.default_rng(8)
    for c in (2, 3, 4, 8):
        ops = lf.prepare_inputs(*_kernel_inputs(N, P, M, c, rng, Yd.device))
        fns = {lf.kernel_path(N, c): lambda: lf.liteqtl_lod_cuda(*ops)}
        if c <= lf.GENERAL_COVARIATES:
            fns["general"] = lambda: lf.liteqtl_lod_cuda(*ops, general=True)
        for fn in fns.values():
            _time_ms(fn)
        took = {name: statistics.median(_time_ms(fn) for _ in range(5)) for name, fn in fns.items()}
        print(f"    LOD kernel alone, c = {c}: "
              + ", ".join(f"{name} {t:.3f} ms" for name, t in took.items()))
        for name in ("S2", "S3"):
            if LOD_SHAPES[name][:4] == (N, P, M, c):
                shapes[name] = _shape_entry(took["wide"], name)
                print(f"    LOD wide kernel alone at {name}: {_shape_line(shapes[name])}")
        del ops
    return med, shapes


def _shape_entry(ms, name) -> dict:
    """A LOD kernel time at LOD_SHAPES[name] beside its bound
    (kernel_times.bound_ms) and its share of it."""
    bound, by = bound_ms(LOD_SHAPES[name])
    return {"ms": ms, "bound_ms": bound, "bound_by": by, "share": bound / ms}


def _shape_line(entry) -> str:
    return (f"{entry['ms']:.3f} ms a launch (CUDA events, median of 5), bound "
            f"{entry['bound_ms']:.3f} ms by {entry['bound_by']}, {100 * entry['share']:.1f} % of it")


def _perm_block_operands(prep, idx, lo, hi):
    """The kernel's operands for traits lo..hi of ``_bulkperm_prep``'s state,
    the markers off the covariates' span as the kernel's route takes them
    (``models/bulkperm.py::_full_rank_block_lods``)."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.ops.smallchol import off_covariates

    X0m, C0, _, _, sqrtw, Qstack, wrn = prep
    X0m = off_covariates(X0m, C0)
    sw, Q = sqrtw[lo:hi], Qstack[lo:hi]
    S2 = bf.prepare_chunk_inputs(sw, Q, wrn[:, lo:hi], idx)
    inv_xn = bf.prepare_trait_block(X0m, sw, Q, precision=bt.BALANCED)
    return X0m.to(torch.float32).contiguous(), S2, inv_xn


def perms_at_bxd(dev, Yd, Gd, K, lod_max):
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.models import bulkperm as mp
    from bulklmm_tpu_torch.kernels.split import matmul_tf32x3
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod, permutation_indices
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    res, counts = _drive(
        "BALANCED bulkscan_perms",
        lambda: bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED),
    )
    launches = _total(counts, "bulkperm_maxr2.*")
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
    # the split reference expands every step's products: its first traits
    twin = tuple(t[:SPLIT_TRAITS] for t in ops[1:])
    split_err = (out[:SPLIT_TRAITS] - bf.bulkperm_maxr2_split_reference(ops[0], *twin)).abs().max().item()
    print(f"  permutation kernel vs plain at BXD scale, traits 0..{PERM_BLOCK}: max|d r2| = {r2_err:.3e} "
          f"(bar {R2_BAR:.0e}), max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e}); "
          f"vs its split reference (traits 0..{SPLIT_TRAITS}) max|d r2| = {split_err:.3e}; "
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

    # the float64 oracle, block by block until its time is spent; beside the
    # kernel's maxima, the plain version's and the split reference's with
    # round-to-nearest sums on the same blocks' operands
    t0 = time.perf_counter()
    parts = {"kernel": 0.0, "plain engine": 0.0, "split reference, round-to-nearest sums": 0.0}
    nflip, done = 0, 0
    while done < M and time.perf_counter() - t0 < ORACLE_SECONDS:
        hi = min(done + ORACLE_BLOCK, M)
        exact = bt.bulkscan_perms(Yd[:, done:hi], Gd, K, nperms=NPERMS, rndseed=0,
                                  precision=bt.EXACT64)
        same = exact.h2_null_list == res.h2_null_list[done:hi].double()
        nflip += int((~same).sum())
        block = {"kernel": ml[done:hi], "plain engine": [], "split reference, round-to-nearest sums": []}
        for lo in range(done, hi, PERM_BLOCK):
            bops = _perm_block_operands(prep, idx, lo, min(lo + PERM_BLOCK, hi))
            block["plain engine"].append(maxr2_to_lod(bf.bulkperm_maxr2_plain(*bops), N))
            block["split reference, round-to-nearest sums"].append(
                maxr2_to_lod(bf._maxr2_by_blocks(*bops, matmul_tf32x3), N))
            del bops
        for name, L in block.items():
            L = L if torch.is_tensor(L) else torch.cat(L)
            parts[name] = max(parts[name], (L.double() - exact.maxlods)[same].abs().max().item())
        done = hi
    print(f"  BALANCED vs EXACT64 (plain engine, float64) on traits 0..{done} of {M} "
          f"({time.perf_counter() - t0:.1f} s): {nflip} traits with a different grid h2; "
          f"max|dLOD| on the rest = {parts['kernel']:.3e} (bar {ORACLE_BAR:.0e})")
    check(done >= min(ORACLE_BLOCK, M), "the EXACT64 oracle covered no trait block")
    check(parts["kernel"] <= ORACLE_BAR, "BALANCED bulkscan_perms strays from the EXACT64 oracle")
    _parity_gate(f"permutations (traits 0..{done}, equal-h2 traits)", parts)
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
    check(_total(counts, "liteqtl_lod_effects.*") > 0,
          "output_effects did not launch the effects variant")
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
    check(_total(counts, "liteqtl_lod.*") > 0 and bool(torch.isfinite(res.L).all()), "masked L")
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
    check(_total(counts, "bulkperm_maxr2.*") > 0,
          "masked bulkscan_perms did not launch the permutation kernel")
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
    check(_total(counts, "altgrid.*") == -(-P // STREAM_BLOCK),
          "the streamed alt-grid did not launch its kernel "
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
    check(_total(counts, "bulkperm_maxr2.*") > 0,
          "the streamed sweep did not launch the permutation kernel")
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
    # c = 4, the wide LOD kernel's first count: its (c, n, m) operand and
    # preparation beside the chunk's (n,)-sized copies
    c4 = memory.WIDE_FROM
    covar = torch.from_numpy(rng.normal(size=(n2, c4 - 1))).to(dev)
    _, extra = _peak_over(lambda: bt.bulkscan(Y2, G2, dec, covar, precision=bt.BALANCED,
                                              trait_chunk=m))
    copies_c4 = extra / (8 * n2 * m) - 1
    # the wide kernel's route of the model, a trait's bytes in (n,) float64 copies
    model_c4 = memory.bulkscan_chunk_bytes(n2, 64, 1, len(GRID), c4, 8, kernel=True) / (8 * n2)
    print(f"  live set of null-grid BALANCED at {n2} x 64 x {m}, c = {c4}: {extra / 2**30:.3f} GiB = "
          f"{copies_c4:.2f} (n, m) float64 arrays beyond the rotated traits (model {model_c4:.2f})")
    print(f"  memory model: the most (p,)-sized copies a trait held {worst:.2f} (model "
          f"{memory._P_CHUNK_COPIES}), the most (n,)-sized {worst_n:.2f} (model "
          f"{memory._N_CHUNK_COPIES}), alt-grid {worst_alt:.2f} a grid point (model "
          f"{memory._ALT_GRID_N_COPIES})")
    check(worst <= memory._P_CHUNK_COPIES and worst_n <= memory._N_CHUNK_COPIES
          and worst_alt <= memory._ALT_GRID_N_COPIES and copies_c4 <= model_c4,
          "a call's live set passed the memory model's multipliers")
    del G2, Y2, dec, covar


def _device_us(event) -> float:
    """A ``key_averages()`` row's own device time, us."""
    # the attribute's name changed between PyTorch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("the profiler's events carry no device time")


def _busy_ms(fn) -> float:
    """The device's busy time over one call of ``fn``, ms: the profiler's
    sum of kernels' and copies' own times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    busy = sum(_device_us(e) for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    check(busy > 0.0, "the profiler recorded no device time")
    return busy / 1e3


def streaming_at_biobank_n(dev, card) -> dict:
    """Phase 11: null-grid over a 2,000 x 100,000 host panel (800 MB float32)
    and 2,048 traits, streamed into a memmap, against the in-memory scan;
    then the LOD kernel alone at that shape (S4) beside its bound, against
    its plain version on the first BIOBANK_BLOCK markers, and that block's
    BALANCED scan against its EXACT64 scan. Returns S4's entry."""
    import tempfile

    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

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
        check(_total(counts, "liteqtl_lod.*") > 0 and res.L is out,
              "the streamed scan did not launch the LOD kernel")
        check(bool(np.isfinite(out).all()), "streamed L is not finite")
        Gd = torch.from_numpy(G).to(dev)
        inmem = lambda: bt.bulkscan(Yd, Gd, dec, precision=bt.BALANCED)  # noqa: E731
        ref, _ = _drive("BALANCED null-grid bulkscan in memory at biobank n", inmem)
        all_cols = torch.ones(BIOBANK_M, dtype=torch.bool, device=dev)
        err = _max_abs_diff_cols(torch.from_numpy(np.asarray(out)).to(dev), ref.L, all_cols)
        bar = ORACLE_BAR * BIOBANK_N / N
        print(f"  streamed vs in-memory: max|dLOD| = {err:.3e} (bar {bar:.2e})")
        check(err <= bar, "the streamed scan strays from the in-memory one at biobank n")
        h2 = ref.h2_null_list
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

    # the LOD kernel alone at this shape (S4), on the scan's own operands
    with with_highest_matmul():
        ones = torch.ones((BIOBANK_N, 1), dtype=torch.float64, device=dev)
        ops = lf.prepare_inputs(dec.Ut @ Yd.double(), dec.Ut @ Gd.double(), dec.Ut @ ones, dec.lam, h2)
    check(lf.kernel_path(BIOBANK_N, 1) == "general", "biobank n does not take the general kernel")
    check(LOD_SHAPES["S4"][:4] == (BIOBANK_N, BIOBANK_P, BIOBANK_M, 1), "S4 is not this panel")
    _time_ms(lambda: lf.liteqtl_lod_cuda(*ops))
    s4 = _shape_entry(statistics.median(_time_ms(lambda: lf.liteqtl_lod_cuda(*ops)) for _ in range(5)),
                      "S4")
    print(f"  the general LOD kernel alone at S4 ({BIOBANK_N} x {BIOBANK_P} x {BIOBANK_M}, c = 1) "
          f"on {card}: {_shape_line(s4)}")
    block = (ops[0][:, :BIOBANK_BLOCK], *ops[1:])
    kerr = (lf.liteqtl_lod_cuda(*block) - lf.liteqtl_lod_plain(*block)).abs().max().item()
    kbar = KERNEL_BAR * BIOBANK_N / 48
    print(f"  the kernel vs its plain version on the first {BIOBANK_BLOCK} markers: max|dLOD| = "
          f"{kerr:.3e} (bars {kbar:.2e}, phase 3's scaled, and {LONG_DEPTH_BAR:.2e}, twice the "
          f"fmaf kernels' distance)")
    check(kerr <= kbar, "the general LOD kernel disagrees with its plain version at S4")
    check(kerr <= LONG_DEPTH_BAR, f"the general LOD kernel strays past {LONG_DEPTH_BAR:.2e} from "
          "its plain version at S4")
    del ops, block
    Gb = Gd[:, :BIOBANK_BLOCK].contiguous()
    bal = bt.bulkscan(Yd, Gb, dec, precision=bt.BALANCED)
    exact = bt.bulkscan(Yd, Gb, dec, precision=bt.EXACT64)
    same = exact.h2_null_list == bal.h2_null_list.double()
    oerr = _max_abs_diff_cols(bal.L, exact.L, same)
    obar = ORACLE_BAR * BIOBANK_N / N
    print(f"  BALANCED vs EXACT64 on that block: {int((~same).sum())} of {BIOBANK_M} traits with "
          f"another grid h2; max|dLOD| on the rest = {oerr:.3e} (bar {obar:.2e}; BASELINE.md's "
          f"{PARITY_BAR:.0e}: {'met' if oerr <= PARITY_BAR else 'NOT met'})")
    check(oerr <= obar, "BALANCED strays from EXACT64 at biobank n")
    del bal, exact, Gb
    print(f"  phase 11 took {time.perf_counter() - t_phase:.1f} s")
    del G, Gd, Yd, dec
    torch.cuda.empty_cache()
    return s4


def _host_ms(fn) -> float:
    """One call by the host clock, the device synchronized on both sides."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _no_kernel(counts, what) -> None:
    """The rank-k engine runs none of the three kernels, in either package."""
    check(not _total(counts), f"{what} launched a kernel: {dict(counts)}")


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
    from bulklmm_tpu_torch.lowrank_cohort import cohort
    from bulklmm_tpu_torch.ops import brent

    t_phase = time.perf_counter()
    G, Y = cohort(n, p, m, seed=SEED, device=dev)
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


def loco_chromosomes(p=P):
    """(p,) labels of 20 contiguous chromosomes, their marker counts in
    proportion to the mouse chromosomes' lengths (largest remainders)."""
    share = p * np.asarray(MOUSE_MB, dtype=np.float64) / sum(MOUSE_MB)
    counts = np.floor(share).astype(np.int64)
    counts[np.argsort(counts - share)[: p - int(counts.sum())]] += 1
    return np.repeat(MOUSE_CHROMS, counts)


def _masks(chrom, dev):
    return {c: torch.as_tensor(chrom == c, device=dev) for c in MOUSE_CHROMS}


def loco_bulkscan(dev, card, Yd, Gd, K, chrom, Ks, method):
    """Phase 13 (b), one method: the LOCO call's launches, its rows against
    its per-chromosome ``bulkscan`` calls, and EXACT64."""
    import bulklmm_tpu_torch as bt

    counter = "altgrid" if method == "alt-grid" else "liteqtl_lod"
    call = lambda: bt.bulkscan_loco(Yd, Gd, chrom, method=method, precision=bt.BALANCED)  # noqa: E731
    res, counts = _drive(f"BALANCED {method} bulkscan_loco", call)
    nchrom = len(MOUSE_CHROMS)
    check(_total(counts, f"{counter}.*") == nchrom and _total(counts) == nchrom,
          f"{method} bulkscan_loco launched {counts}, not {nchrom} {counter} launches")
    check(tuple(res.L.shape) == (P, M) and res.L.is_cuda and res.L.dtype == torch.float64,
          f"{method} LOCO L is not float64 ({P}, {M}) on the card")
    check(bool(torch.isfinite(res.L).all()), f"{method} LOCO L is not finite")
    check(list(res.h2_null_by_chrom) == list(MOUSE_CHROMS), "h2_null_by_chrom's chromosomes")
    loco_ms = _host_ms(call)
    whole_ms = _host_ms(lambda: bt.bulkscan(Yd, Gd, K, method=method, precision=bt.BALANCED))

    masks = _masks(chrom, dev)
    comp, flips = 0.0, 0
    for c in MOUSE_CHROMS:
        one = bt.bulkscan(Yd, Gd[:, masks[c]], Ks[c], method=method, precision=bt.BALANCED)
        comp = max(comp, (res.L[masks[c]] - one.L.double()).abs().max().item())
        h2 = one.h2_null_list if one.h2_null_list is not None else one.h2_panel
        flips += int((h2 != res.h2_null_by_chrom[c]).sum())
        del one
    print(f"  {method} LOCO vs its {nchrom} per-chromosome bulkscan calls on the leave-out "
          f"kinships: max|dLOD| = {comp:.3e} (bar {LOCO_BAR:.0e}), h2 flips {flips}")
    check(comp <= LOCO_BAR, f"{method} LOCO rows differ from the per-chromosome scans")

    exact = bt.bulkscan_loco(Yd, Gd, chrom, method=method, precision=bt.EXACT64)
    torch.cuda.synchronize()
    err, other, dh2 = 0.0, 0, 0.0
    for c in MOUSE_CHROMS:
        hb, he = res.h2_null_by_chrom[c].double(), exact.h2_null_by_chrom[c]
        Lb, Le = res.L[masks[c]], exact.L[masks[c]]
        if method == "null-grid":  # the traits whose grid h2 agrees
            same = hb == he
            other += int((~same).sum())
            err = max(err, _max_abs_diff_cols(Lb, Le, same) if bool(same.any()) else 0.0)
        else:
            err = max(err, (Lb - Le).abs().max().item())
            other += int((hb != he).sum()) if method == "alt-grid" else 0
            dh2 = max(dh2, (hb - he).abs().max().item())
    what = {"null-grid": f"on the equal-h2 traits ({other} chromosome-trait pairs with another "
                         f"grid h2)",
            "alt-grid": f"on all pairs; h2 panel flips {other} of {P * M}",
            "null-exact": f"on all pairs; max|dh2| = {dh2:.3e}"}[method]
    print(f"  {method} LOCO BALANCED vs EXACT64: max|dLOD| = {err:.3e} {what} (bar "
          f"{ORACLE_BAR:.0e}; BASELINE.md's {PARITY_BAR:.0e}: "
          f"{'met' if err <= PARITY_BAR else 'NOT met'})")
    check(err <= ORACLE_BAR, f"{method} LOCO BALANCED strays from the EXACT64 LOCO call")
    print(f"  {method} on {card}: bulkscan_loco {loco_ms:.1f} ms (second call, host clock; "
          f"{nchrom} chromosomes) against the whole-genome bulkscan's {whole_ms:.1f} ms")
    return res, exact, _total(counts, f"{counter}.*"), loco_ms, whole_ms


def loco_perms(dev, card, Yd, Gd, K, chrom, Ks):
    """Phase 13 (c): ``bulkscan_perms_loco`` with 1,000 permutations on
    every trait, and on phase 10's cut against EXACT64."""
    import bulklmm_tpu_torch as bt

    call = lambda: bt.bulkscan_perms_loco(Yd, Gd, chrom, nperms=NPERMS, rndseed=0,  # noqa: E731
                                          precision=bt.BALANCED)
    res, counts = _drive(f"BALANCED bulkscan_perms_loco, {NPERMS} permutations", call)
    nchrom = len(MOUSE_CHROMS)
    want = -(-M // PERM_BLOCK) * nchrom
    check(_total(counts, "bulkperm_maxr2.*") == want and _total(counts) == want,
          f"bulkscan_perms_loco launched {counts}, not {want} permutation-kernel launches")
    ml = res.maxlods
    check(tuple(ml.shape) == (M, NPERMS + 1) and ml.is_cuda and bool(torch.isfinite(ml).all()),
          "LOCO maxlods are not finite (M, 1 + nperms) on the card")
    check(bool(torch.isfinite(res.log10_adj_pvals).all()), "LOCO adjusted p-values are not finite")
    loco_ms = _host_ms(call)
    whole_ms = _host_ms(lambda: bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0,
                                                  precision=bt.BALANCED))
    masks = _masks(chrom, dev)
    stitched = None
    for i, c in enumerate(MOUSE_CHROMS):
        one = bt.bulkscan_perms(Yd, Gd[:, masks[c]], Ks[c], nperms=NPERMS, rndseed=i,
                                precision=bt.BALANCED).maxlods
        stitched = one if stitched is None else torch.maximum(stitched, one)
    comp = (stitched - ml).abs().max().item()
    print(f"  LOCO maxima vs the elementwise max of the {nchrom} per-chromosome bulkscan_perms "
          f"runs at seeds 0..{nchrom - 1}: max|dLOD| = {comp:.3e} (bar {LOCO_BAR:.0e})")
    check(comp <= LOCO_BAR, "the LOCO maxima are not the per-chromosome runs' maxima")
    del stitched, res, ml

    sub = slice(0, OPTION_TRAITS)
    kw = dict(nperms=MASK_NPERMS, rndseed=0)
    bal = bt.bulkscan_perms_loco(Yd[:, sub], Gd, chrom, precision=bt.BALANCED, **kw)
    ex = bt.bulkscan_perms_loco(Yd[:, sub], Gd, chrom, precision=bt.EXACT64, **kw)
    same = torch.stack([bal.h2_null_by_chrom[c].double() == ex.h2_null_by_chrom[c]
                        for c in MOUSE_CHROMS]).all(0)
    err = (bal.maxlods.double() - ex.maxlods)[same].abs().max().item()
    print(f"  bulkscan_perms_loco BALANCED vs EXACT64 on traits 0..{OPTION_TRAITS}, {MASK_NPERMS} "
          f"permutations: max|dLOD| = {err:.3e} on the {int(same.sum())} traits whose grid h2 "
          f"agrees on every chromosome (bar {ORACLE_BAR:.0e})")
    check(err <= ORACLE_BAR, "bulkscan_perms_loco strays from its EXACT64 run")
    print(f"  permutations on {card}: bulkscan_perms_loco {loco_ms:.1f} ms (second call, host "
          f"clock) against the whole-genome bulkscan_perms' {whole_ms:.1f} ms")
    return _total(counts, "bulkperm_maxr2.*"), loco_ms, whole_ms


def _write_csvs(tmp: Path, G, Y, chrom):
    """The genotype probabilities as complement pairs (p, 1 - p) with a
    marker header and strain ids, a phenotype file with a sex column, and
    the marker map."""
    n, p = G.shape
    pairs = np.empty((n, 2 * p), dtype=np.float64)
    pairs[:, 0::2], pairs[:, 1::2] = G, 1.0 - G.astype(np.float64)
    with open(tmp / "geno.csv", "w") as f:
        f.write("id," + ",".join(f"rs{j}_{a}" for j in range(p) for a in "BD") + "\n")
        for i, row in enumerate(pairs):
            f.write(f"BXD{i}," + ",".join(map("{:.9g}".format, row.tolist())) + "\n")
    with open(tmp / "pheno.csv", "w") as f:
        f.write("id," + ",".join(f"t{j}" for j in range(Y.shape[1])) + ",sex\n")
        for i, row in enumerate(Y):
            f.write(f"BXD{i}," + ",".join(map("{:.9g}".format, row.tolist())) + f",{i % 2}\n")
    with open(tmp / "gmap.csv", "w") as f:
        f.write("Locus,Chr,cM,Mb\n")
        for j, c in enumerate(chrom):
            f.write(f"rs{j},{c},{j * 0.01:.2f},{j * 0.3:.3f}\n")


def _cli(tmp: Path, *argv):
    """``python3 -m bulklmm_tpu_torch`` of this checkout, started in ``tmp``."""
    import os

    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent))
    return subprocess.Popen([sys.executable, "-m", "bulklmm_tpu_torch", *map(str, argv)],
                            cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _finish(proc, what):
    try:
        out, err = proc.communicate(timeout=CLI_SECONDS)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    check(proc.returncode == 0, f"the CLI's {what} exited {proc.returncode}: {err[-2000:]}")
    return out


def io_and_cli(dev, card, Gd, Yd, chrom):
    """Phase 13 (f): the CSV files, both parsers, and three CLI runs in
    processes of their own against the same calls in this one."""
    import tempfile

    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import _native
    from bulklmm_tpu_torch import io as bio

    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as name:
        tmp = Path(name)
        t0 = time.perf_counter()
        _write_csvs(tmp, Gd.cpu().numpy(), Yd[:, :CLI_TRAITS].cpu().numpy(), chrom)
        print(f"  wrote geno.csv ({(tmp / 'geno.csv').stat().st_size / 1e6:.1f} MB, {N} x {2 * P} "
              f"probabilities), pheno.csv ({CLI_TRAITS} traits) and gmap.csv in "
              f"{time.perf_counter() - t0:.1f} s")
        geno, pheno, gmap = tmp / "geno.csv", tmp / "pheno.csv", tmp / "gmap.csv"
        common = ("--geno", geno, "--exclude-complements")
        procs = {
            "bulkscan": _cli(tmp, "bulkscan", *common, "--pheno", pheno, "--loco", "--gmap", gmap,
                             "--nperms", CLI_NPERMS, "-o", tmp / "out.npz"),
            "kinship": _cli(tmp, "kinship", *common, "-o", tmp / "K.csv"),
            "scan": _cli(tmp, "scan", *common, "--pheno", pheno, "--loco", "--gmap", gmap,
                         "--trait", 0, "-o", tmp / "scan.npz"),
        }
        t_cli = time.perf_counter()

        check(_native.fastcsv_available(), "the native CSV parser did not build")
        t0 = time.perf_counter()
        G = bio.read_geno_prob_exclude_complements(geno)
        native_ms = 1e3 * (time.perf_counter() - t0)
        available = _native.fastcsv_available
        _native.fastcsv_available = lambda: False  # the pure-Python parser, timed
        try:
            t0 = time.perf_counter()
            G_py = bio.read_geno_prob_exclude_complements(geno)
            python_ms = 1e3 * (time.perf_counter() - t0)
        finally:
            _native.fastcsv_available = available
        check(G.shape == (N, P) and np.array_equal(G, G_py), "the two CSV parsers disagree")
        print(f"  parsing geno.csv on the host of {card}: native {native_ms:.1f} ms, pure Python "
              f"{python_ms:.1f} ms ({python_ms / native_ms:.1f}x); equal arrays")
        Y = bio.read_bxd_pheno(pheno)
        labels = bio.read_gmap(gmap).chromosome
        check(Y.shape == (N, CLI_TRAITS) and np.array_equal(labels, chrom), "pheno.csv or gmap.csv")
        check(np.abs(G - Gd.cpu().numpy()).max() < 1e-7, "geno.csv does not hold phase 4's panel")

        res = bt.bulkscan_loco(Y, G, labels, precision=bt.BALANCED, device=dev)
        pr = bt.bulkscan_perms_loco(Y, G, labels, nperms=CLI_NPERMS, rndseed=0,
                                    precision=bt.BALANCED, device=dev)
        thr = bt.get_thresholds_bulk(pr.perm_maxima, [0.10, 0.05, 0.01])
        K = bt.calc_kinship(G, bt.BALANCED, device=dev).cpu().numpy()
        one = bt.scan_loco(Y[:, 0], G, labels, precision=bt.BALANCED, device=dev)
        torch.cuda.synchronize()

        outs = {what: _finish(proc, what) for what, proc in procs.items()}
        cli_s = time.perf_counter() - t_cli
        z = np.load(tmp / "out.npz")
        want = {"L": res.L, "perm_maxlods": pr.maxlods, "thresholds": thr.thrs,
                "log10_adj_pvals": pr.log10_adj_pvals,
                **{f"h2_null_chr{c}": v for c, v in res.h2_null_by_chrom.items()}}
        check(sorted(z.files) == sorted(want), f"out.npz holds {sorted(z.files)}")
        err = max(np.abs(z[k].astype(np.float64) - np.asarray(
            v.cpu() if torch.is_tensor(v) else v, dtype=np.float64)).max() for k, v in want.items())
        kerr = np.abs(np.loadtxt(tmp / "K.csv", delimiter=",") - K).max()
        meta = json.loads(outs["scan"].strip().splitlines()[-1])
        serr = max(np.abs(np.load(tmp / "scan.npz")["lod"] - one.lod.cpu().numpy()).max(),
                   abs(meta["h2_null"] - float(one.h2_null)),
                   max(abs(meta["h2_null_by_chrom"][c] - one.h2_null_by_chrom[c])
                       for c in MOUSE_CHROMS))
        print(f"  CLI in processes of their own vs the same calls here, on the parsed arrays: "
              f"bulkscan --loco --nperms {CLI_NPERMS} ({CLI_TRAITS} traits; L, thresholds, "
              f"maxima, h2_null_chr*) max|d| = {err:.3e}, kinship {kerr:.3e}, scan --loco "
              f"{serr:.3e} (bars {LOCO_BAR:.0e}, {KINSHIP_BAR:.0e}, {LOCO_BAR:.0e}); the three "
              f"runs side by side took {cli_s:.1f} s on {card}")
        check(err <= LOCO_BAR and serr <= LOCO_BAR, "the CLI's scans differ from the in-process calls")
        check(kerr <= KINSHIP_BAR, "the CLI's kinship differs from calc_kinship")


def loco_io_cli(dev, card, Yd, Gd, K):
    """Phase 13: LOCO, the file readers and the CLI at BXD scale."""
    import bulklmm_tpu_torch as bt

    t_phase = time.perf_counter()
    chrom = loco_chromosomes(Gd.shape[1])
    sizes = [int((chrom == c).sum()) for c in MOUSE_CHROMS]
    print(f"  {len(MOUSE_CHROMS)} chromosomes of {min(sizes)} to {max(sizes)} markers "
          f"(sum {sum(sizes)}; none a multiple of 64: {all(s % 64 for s in sizes)})")

    # (a) the leave-out kinships, all 20, against the subset panels' kinships
    Ks = bt.loco_kinship(Gd, chrom, bt.BALANCED)
    masks = _masks(chrom, dev)
    kerr = max((Ks[c] - bt.calc_kinship(Gd[:, ~masks[c]], bt.BALANCED)).abs().max().item()
               for c in MOUSE_CHROMS)
    check(all(Ks[c].dtype == torch.float64 and Ks[c].is_cuda for c in MOUSE_CHROMS),
          "the leave-out kinships are not float64 on the card")
    print(f"  loco_kinship vs calc_kinship of each leave-out panel: max|dK| = {kerr:.3e} "
          f"(bar {KINSHIP_BAR:.0e})")
    check(kerr <= KINSHIP_BAR, "loco_kinship differs from calc_kinship of the subset panel")

    # (b) bulkscan_loco, each method
    launches, wall = {}, {}
    for method in ("null-grid", "alt-grid", "null-exact"):
        res, exact, launches[method], loco_ms, whole_ms = loco_bulkscan(
            dev, card, Yd, Gd, K, chrom, Ks, method)
        wall[method] = (loco_ms, whole_ms)
        if method == "null-grid":
            exact_grid = exact
        del res, exact
    torch.cuda.empty_cache()

    # (c) permutations
    launches["perms"], *wall["perms"] = loco_perms(dev, card, Yd, Gd, K, chrom, Ks)

    # (d) the single-trait scan of trait 0, permutations included
    call = lambda prec: bt.scan_loco(Yd[:, 0], Gd, chrom, permutation_test=True,  # noqa: E731
                                     nperms=NPERMS, rndseed=0, precision=prec)
    one, counts = _drive(f"BALANCED scan_loco of trait 0, {NPERMS} permutations",
                         lambda: call(bt.BALANCED))
    _no_kernel(counts, "scan_loco")
    ref = call(bt.EXACT64)
    err = max((one.lod - ref.lod).abs().max().item(),
              (one.L_perms.double() - ref.L_perms.double()).abs().max().item())
    dh2 = max(abs(one.h2_null_by_chrom[c] - ref.h2_null_by_chrom[c]) for c in MOUSE_CHROMS)
    print(f"  scan_loco BALANCED vs EXACT64: max|dLOD| = {err:.3e} over the LODs and all "
          f"{NPERMS} permutation columns (bar {ORACLE_BAR:.0e}), max|dh2| = {dh2:.3e}")
    check(err <= ORACLE_BAR, "scan_loco strays from its EXACT64 run")
    del one, ref

    # (e) the rank-k engine per chromosome at k = n against the dense LOCO oracle
    low, counts = _drive(f"BALANCED rank-{N} null-grid bulkscan_loco",
                         lambda: bt.bulkscan_loco(Yd, Gd, chrom, lowrank_k=N, precision=bt.BALANCED))
    _no_kernel(counts, "the rank-k bulkscan_loco")
    err, other = 0.0, 0
    for c in MOUSE_CHROMS:
        same = low.h2_null_by_chrom[c].double() == exact_grid.h2_null_by_chrom[c]
        other += int((~same).sum())
        if bool(same.any()):
            err = max(err, _max_abs_diff_cols(low.L[masks[c]], exact_grid.L[masks[c]], same))
    print(f"  rank-{N} LOCO null-grid vs the dense EXACT64 LOCO call: max|dLOD| = {err:.3e} on the "
          f"equal-h2 traits ({other} chromosome-trait pairs with another grid h2; bar "
          f"{ORACLE_BAR:.0e})")
    check(err <= ORACLE_BAR, "the rank-k LOCO scan strays from the dense EXACT64 LOCO scan")
    del low, exact_grid, Ks
    torch.cuda.empty_cache()

    # (f) the files and the command line
    io_and_cli(dev, card, Gd, Yd, chrom)
    print(f"  phase 13 on {card}: second calls (ms, host clock), LOCO against whole-genome: "
          + "; ".join(f"{k} {a:.1f} vs {b:.1f}" for k, (a, b) in wall.items()))
    print(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return launches


def _mesh_name(mesh) -> str:
    t, k = mesh.shape["traits"], mesh.shape["markers"]
    return f"{t} x {k} mesh on {', '.join(dict.fromkeys(str(d) for d in mesh.flat))}"


def _flips(a, b) -> int:
    return int((a != b).sum())


def mesh_scans(dev, card, Yd, Gd, K, meshes):
    """Phase 14 (b) and (d): BALANCED ``bulkscan_sharded``, the three
    methods, on each mesh: launches, against the single-device call and
    EXACT64. Returns the launches on the last mesh, by counter."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import bulkscan_sharded

    launches = {}
    for method, counter in (("null-grid", "liteqtl_lod"), ("alt-grid", "altgrid"),
                            ("null-exact", "liteqtl_lod")):
        one = bt.bulkscan(Yd, Gd, K, method=method, precision=bt.BALANCED)
        ex = bt.bulkscan(Yd, Gd, K, method=method, precision=bt.EXACT64)
        h2 = "h2_panel" if method == "alt-grid" else "h2_null_list"
        for mesh in meshes:
            call = lambda: bulkscan_sharded(Yd, Gd, K, mesh=mesh, method=method,  # noqa: E731
                                            precision=bt.BALANCED, trait_chunk=MESH_TRAIT_CHUNK)
            res, counts = _drive(f"{method} bulkscan_sharded, {_mesh_name(mesh)}", call)
            tiles = len(mesh.tiles())
            w = -(-M // mesh.shape["traits"])
            want = tiles * -(-w // -(-MESH_TRAIT_CHUNK // mesh.shape["traits"]))
            print(f"    {_total(counts, counter + '.*')} {counter} launches: {tiles} tiles x "
                  f"{want // tiles} trait chunks a tile")
            check(_total(counts, f"{counter}.*") == want and _total(counts) == want,
                  f"{method} on the mesh launched {counts}, not {want} {counter} launches")
            L = res.L
            check(tuple(L.shape) == (P, M) and L.device == dev and L.dtype == one.L.dtype
                  and bool(torch.isfinite(L).all()), f"{method}: L is not finite (P, M) on {dev}")
            flips = _flips(getattr(res, h2), getattr(one, h2))
            same = torch.ones(M, dtype=torch.bool, device=dev)
            if method == "null-grid":
                same = res.h2_null_list == one.h2_null_list
            diff = _max_abs_diff_cols(L, one.L, same)
            eq_ex = (res.h2_null_list.double() == ex.h2_null_list) if method == "null-grid" \
                else torch.ones(M, dtype=torch.bool, device=dev)
            oerr = _max_abs_diff_cols(L, ex.L, eq_ex)
            second = _host_ms(call)
            h2_what = (f"max|dh2| {(res.h2_null_list - one.h2_null_list).abs().max().item():.2e}"
                       if method == "null-exact" else f"{flips} h2 flips")
            print(f"    against the single-device call: max|dLOD| = {diff:.3e} (bar "
                  f"{MESH_BAR:.0e}), {h2_what}; against EXACT64: {oerr:.3e} (bar "
                  f"{ORACLE_BAR:.0e}); second call {second:.1f} ms (host clock) on {card}")
            check(diff <= MESH_BAR, f"{method} on the mesh strays from the single-device call")
            if method == "null-grid":
                check(flips == 0, "null-grid on the mesh flips a grid h2")
            elif method == "alt-grid":
                check(flips <= INDEX_FLIP_SHARE * P * M, "alt-grid on the mesh flips h2 panels")
            check(oerr <= ORACLE_BAR, f"{method} on the mesh strays from EXACT64")
            if method != "null-exact":  # the LOD kernel's count is null-grid's
                launches[counter] = _total(counts, f"{counter}.*")
            del res, L
        single = _host_ms(lambda: bt.bulkscan(Yd, Gd, K, method=method, precision=bt.BALANCED))
        print(f"    {method} on one device, second call: {single:.1f} ms (host clock)")
        del one, ex
    return launches


def mesh_perms(dev, card, Yd, Gd, K, meshes):
    """Phase 14 (c) and (d): BALANCED ``bulkscan_perms_sharded`` with 1,000
    permutations on all traits on each mesh; returns the last mesh's
    launches."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.parallel import bulkscan_perms_sharded
    from bulklmm_tpu_torch.models.bulkperm import _mesh_perm_tiling

    one = bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED)
    sub = slice(0, OPTION_TRAITS)
    ex = bt.bulkscan_perms(Yd[:, sub], Gd, K, nperms=NPERMS, rndseed=0, precision=bt.EXACT64)
    for mesh in meshes:
        call = lambda: bulkscan_perms_sharded(Yd, Gd, K, mesh=mesh, nperms=NPERMS,  # noqa: E731
                                              rndseed=0, precision=bt.BALANCED)
        res, counts = _drive(f"bulkscan_perms_sharded, {NPERMS} permutations, "
                             f"{_mesh_name(mesh)}", call)
        eng, tc, pc, _, rq = _mesh_perm_tiling(mesh, engine="auto", n=N, m=M, p=P,
                                               precision=bt.BALANCED, interpret=False,
                                               trait_chunk=None, perm_chunk=2048)
        rows = -(-(NPERMS + 1) // rq) * rq // mesh.shape["markers"]
        tiles = len(mesh.tiles())
        want = -(-M // tc) * tiles * -(-rows // pc)
        print(f"    {_total(counts, 'bulkperm_maxr2.*')} permutation-kernel launches: "
              f"{-(-M // tc)} trait "
              f"blocks of {tc} x {tiles} tiles x {-(-rows // pc)} permutation chunks of "
              f"{rows} rows a tile ({eng})")
        check(eng == "pallas" and _total(counts, "bulkperm_maxr2.*") == want
              and _total(counts) == want,
              f"the sharded permutations launched {counts}, not {want} kernel launches")
        ml = res.maxlods
        check(tuple(ml.shape) == (M, NPERMS + 1) and ml.device == dev
              and bool(torch.isfinite(ml).all()), "sharded maxlods are not finite on the card")
        flips = _flips(res.h2_null_list, one.h2_null_list)
        same = res.h2_null_list == one.h2_null_list
        diff = (ml - one.maxlods)[same].abs().max().item()
        eq = res.h2_null_list[sub].double() == ex.h2_null_list
        oerr = (ml[sub].double() - ex.maxlods)[eq].abs().max().item()
        second = _host_ms(call)
        print(f"    against the single-device sweep: max|dLOD| = {diff:.3e} (bar {MESH_BAR:.0e}), "
              f"{flips} h2 flips; against EXACT64 on traits 0..{OPTION_TRAITS}: {oerr:.3e} (bar "
              f"{ORACLE_BAR:.0e}); second call {second:.1f} ms (host clock) on {card}")
        check(flips == 0 and diff <= MESH_BAR, "the sharded sweep strays from the single device")
        check(oerr <= ORACLE_BAR, "the sharded sweep strays from EXACT64")
        del res, ml
    single = _host_ms(lambda: bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0,
                                                precision=bt.BALANCED))
    print(f"    bulkscan_perms on one device, second call: {single:.1f} ms (host clock)")
    return _total(counts, "bulkperm_maxr2.*")


def mesh_pod(dev, card, Yd, Gd, K):
    """Phase 14 (e): a two-process pod on this card (gloo handshake):
    ``podscan`` twice, ``merge-shards``, then the permutation pod, on phase
    10's cut, against the same calls in this process."""
    import socket
    import tempfile

    import bulklmm_tpu_torch as bt

    sub = slice(0, OPTION_TRAITS)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        np.savez(tmp / "geno.npz", geno=Gd.cpu().numpy())
        np.savez(tmp / "pheno.npz", pheno=Yd[:, sub].cpu().numpy())
        files = ["--geno", tmp / "geno.npz", "--pheno", tmp / "pheno.npz",
                 "--precision", "balanced", "--device", str(dev)]
        t0 = time.perf_counter()
        procs = {}
        # the two pods (LODs, permutations) side by side: four processes,
        # two process groups, each process its own CUDA context on the card
        for kind, extra in (("lod", []), ("perm", ["--nperms", MASK_NPERMS])):
            with socket.socket() as sk:
                sk.bind(("127.0.0.1", 0))
                coord = f"127.0.0.1:{sk.getsockname()[1]}"
            procs[kind] = [_cli(tmp, "podscan", *files, "--coordinator", coord, "--nproc", 2,
                                "--pid", i, "--save-shards", tmp / kind, "-o", tmp / "pod.npz",
                                *extra) for i in range(2)]
        for kind, ps in procs.items():
            metas = [json.loads(_finish(p, f"podscan {kind} {i}").strip().splitlines()[-1])
                     for i, p in enumerate(ps)]
            check(sorted(tuple(mt["traits"]) for mt in metas)
                  == [(0, OPTION_TRAITS // 2), (OPTION_TRAITS // 2, OPTION_TRAITS)],
                  f"the pod's processes took the traits {metas}")
        merges = [_cli(tmp, "merge-shards", "--shards-dir", tmp / kind, "-o",
                       tmp / f"{kind}.npz", *(["--perms"] if kind == "perm" else []))
                  for kind in procs]
        for kind, p in zip(procs, merges):
            _finish(p, f"merge-shards {kind}")
        pod_s = time.perf_counter() - t0
        L = np.load(tmp / "lod.npz")["L"]
        P_ = np.load(tmp / "perm.npz")["perm_maxlods"]
    Kb = bt.calc_kinship(Gd, bt.BALANCED)
    one = bt.bulkscan(Yd[:, sub], Gd, Kb, precision=bt.BALANCED)
    ones = bt.bulkscan_perms(Yd[:, sub], Gd, Kb, nperms=MASK_NPERMS, rndseed=0,
                             precision=bt.BALANCED)
    lerr = float(np.abs(L - one.L.double().cpu().numpy()).max())
    perr = float(np.abs(P_ - ones.maxlods.double().cpu().numpy()).max())
    print(f"  two-process pod on {dev} ({OPTION_TRAITS} traits, {MASK_NPERMS} permutations): "
          f"merged LODs vs the in-process bulkscan max|dLOD| = {lerr:.3e}, merged maxima vs "
          f"bulkscan_perms {perr:.3e} (bar {MESH_BAR:.0e}); both pods side by side, then both "
          f"merges, {pod_s:.1f} s (host clock, process start-up included) on {card}")
    check(lerr <= MESH_BAR and perr <= MESH_BAR, "the pod's merged results stray")


def mesh_streamed_loco(dev, card, Yd, Gd, K, mesh):
    """Phase 14 (f): the streamed engines and LOCO with ``mesh=``, on phase
    10's and 13's cuts, against the same calls without it."""
    import bulklmm_tpu_torch as bt

    Gh = Gd.cpu().numpy()
    tiles = len(mesh.tiles())
    blocks = -(-P // STREAM_BLOCK)
    call = lambda m: bt.bulkscan_streamed(Yd, Gh, K, method="alt-grid",  # noqa: E731
                                          marker_block=STREAM_BLOCK, precision=bt.BALANCED,
                                          **({"mesh": m} if m else {}))
    st, counts = _drive(f"streamed alt-grid, blocks of {STREAM_BLOCK}, {_mesh_name(mesh)}",
                        lambda: call(mesh))
    check(_total(counts, "altgrid.*") == blocks * tiles and _total(counts) == blocks * tiles,
          f"the streamed alt-grid on the mesh launched {counts}, not {blocks} x {tiles}")
    one = call(None)
    err = float(np.abs(st.L - one.L).max())
    flips = int((st.h2_panel != one.h2_panel).sum())
    print(f"    against the single-device streamed call: max|dLOD| = {err:.3e} (bar "
          f"{MESH_BAR:.0e}), {flips} h2 panel flips")
    check(err <= MESH_BAR and flips <= INDEX_FLIP_SHARE * P * M, "streamed on the mesh strays")
    del st, one
    sub = slice(0, OPTION_TRAITS)
    kw = dict(nperms=MASK_NPERMS, rndseed=0, marker_block=STREAM_BLOCK, precision=bt.BALANCED)
    sp, counts = _drive("streamed permutations on the mesh",
                        lambda: bt.bulkscan_perms_streamed(Yd[:, sub], Gh, K, mesh=mesh, **kw))
    check(_total(counts, "bulkperm_maxr2.*") > 0, "the streamed permutations on the mesh ran no kernel")
    ref = bt.bulkscan_perms_streamed(Yd[:, sub], Gh, K, **kw).maxlods
    err = (sp.maxlods - ref).abs().max().item()
    print(f"    against the single-device streamed sweep: max|dLOD| = {err:.3e}")
    check(err <= MESH_BAR, "the streamed permutations on the mesh stray")

    chrom = loco_chromosomes(P)
    nchrom = len(MOUSE_CHROMS)
    res, counts = _drive(f"bulkscan_loco null-grid, {_mesh_name(mesh)}",
                         lambda: bt.bulkscan_loco(Yd, Gd, chrom, mesh=mesh,
                                                  precision=bt.BALANCED))
    want = nchrom * tiles
    check(_total(counts, "liteqtl_lod.*") == want and _total(counts) == want,
          f"LOCO on the mesh launched {counts}, not {nchrom} x {tiles}")
    one = bt.bulkscan_loco(Yd, Gd, chrom, precision=bt.BALANCED)
    same = torch.stack([res.h2_null_by_chrom[c] == one.h2_null_by_chrom[c]
                        for c in MOUSE_CHROMS]).all(0)
    err = _max_abs_diff_cols(res.L, one.L, same)
    print(f"    against the single-device LOCO call: max|dLOD| = {err:.3e} (bar {MESH_BAR:.0e}), "
          f"{int((~same).sum())} traits with a flipped h2 on some chromosome")
    check(bool(same.all()) and err <= MESH_BAR, "LOCO on the mesh strays")
    del res, one
    kw = dict(nperms=MASK_NPERMS, rndseed=0, precision=bt.BALANCED)
    pl, counts = _drive("bulkscan_perms_loco on the mesh",
                        lambda: bt.bulkscan_perms_loco(Yd[:, sub], Gd, chrom, mesh=mesh, **kw))
    check(_total(counts, "bulkperm_maxr2.*") > 0, "bulkscan_perms_loco on the mesh ran no kernel")
    ref = bt.bulkscan_perms_loco(Yd[:, sub], Gd, chrom, **kw).maxlods
    err = (pl.maxlods - ref).abs().max().item()
    print(f"    against the single-device LOCO sweep: max|dLOD| = {err:.3e}")
    check(err <= MESH_BAR, "bulkscan_perms_loco on the mesh strays")


def device_mesh(dev, card, Yd, Gd, K):
    """Phase 14: the device mesh on the card."""
    from bulklmm_tpu_torch.parallel import make_mesh

    t_phase = time.perf_counter()
    meshes = (make_mesh(), make_mesh(devices=[dev] * 4, marker_shards=2))
    check(meshes[0].shape == {"traits": torch.cuda.device_count(), "markers": 1},
          f"make_mesh() is {meshes[0].shape}")
    print(f"  (a) make_mesh(): {_mesh_name(meshes[0])}; the virtual mesh: {_mesh_name(meshes[1])}")
    launches = mesh_scans(dev, card, Yd, Gd, K, meshes)
    launches["bulkperm_maxr2"] = mesh_perms(dev, card, Yd, Gd, K, meshes)
    t_pod = time.perf_counter()
    mesh_pod(dev, card, Yd, Gd, K)
    t_pod = time.perf_counter() - t_pod
    mesh_streamed_loco(dev, card, Yd, Gd, K, meshes[1])
    print(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s ({t_pod:.1f} s of it the pod)")
    return launches


def wide_kernel_checks(dev) -> None:
    """Phase 15 (a): the wide LOD kernel (c > 8) and its effects variant
    against their plain version, on the card, at n = 79 and 2,000, with the
    plain version on the general kernel's operands (the packed factor and
    the substitution) beside it; the launcher's rule."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    for n in (79, 2000):
        for c in (1, 3, 4, 8, 9, 32):
            for effects in (False, True):
                check(lf.kernel_path(n, c, effects) == lf.launcher_path(n, c, effects),
                      f"the launcher and kernel_path disagree at n={n}, c={c}")
        check(lf.kernel_path(n, 4) == "wide" and lf.kernel_path(n, 3) != "wide",
              "the wide kernel's range moved: bring the shapes below up to date")
    rng = np.random.default_rng(15)
    p, m = 129, 130  # one past two tiles each way
    for n in (79, 2000):
        for c in WIDE_COVARIATES:
            args = _kernel_inputs(n, p, m, c, rng, dev)
            ops = lf.prepare_inputs(*args)
            check(ops[1].shape == (c, n, m), "prepare_inputs did not give the wide operands")
            out = lf.liteqtl_lod_cuda(*ops)
            torch.cuda.synchronize()
            plain = lf.liteqtl_lod_plain(*ops)
            general = lf.fused_lods_per_trait_reference(*args)
            eops = lf.prepare_inputs(*args, effects=True)
            eff = lf.liteqtl_lod_cuda(*eops, effects=True)
            torch.cuda.synchronize()
            eref = lf.liteqtl_lod_plain(*eops, effects=True)
            bar = KERNEL_BAR * max(1.0, n / 48)
            err = (out - plain).abs().max().item()
            gerr = (out - general).abs().max().item()
            lod_err, beta_err, se_err = _effects_errors(eff, eref)
            same = (eff[0] - out).abs().max().item()
            print(f"  wide LOD kernel n={n} p={p} m={m} c={c}: vs plain max|dLOD| = {err:.3e}, vs "
                  f"the plain version on the general operands {gerr:.3e} (bar {bar:.2e}); effects "
                  f"variant max|dLOD| {lod_err:.3e}, max|d effect|/(|effect|+SE) {beta_err:.3e}, "
                  f"max|dSE|/SE {se_err:.3e} (bars {EFFECT_BAR:.0e}), its LOD vs the LOD-only "
                  f"kernel's {same:.3e} (bar {SAME_LOD_BAR:.0e})")
            check(out.shape == (p, m) and bool(torch.isfinite(out).all()),
                  "wide kernel output not finite")
            check(err <= bar and gerr <= bar, f"the wide kernel disagrees at {(n, p, m, c)}")
            check(lod_err <= bar and beta_err <= EFFECT_BAR and se_err <= EFFECT_BAR,
                  f"the wide kernel's effects variant disagrees at {(n, p, m, c)}")
            check(n < 2000 or max(err, lod_err) <= LONG_DEPTH_BAR,
                  f"the wide kernel strays past {LONG_DEPTH_BAR:.2e} at {(n, p, m, c)}")
            check(same <= SAME_LOD_BAR, f"the wide effects variant's LOD moved at {(n, p, m, c)}")


def wide_at_bxd(dev, card, Yd, Gd, K) -> dict:
    """Phase 15 (b)-(e): BALANCED null-grid, null-exact and effects at BXD
    scale with c = WIDE_C against their EXACT64 runs; the kernel's time and
    bound; a c = 32 call under a forced budget; streamed and LOCO at
    c = WIDE_C against their in-memory and per-chromosome counterparts."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils import memory

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED)
    covar = torch.from_numpy(rng.normal(size=(N, WIDE_C - 1))).to(dev)
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    out = {}
    for method in ("null-grid", "null-exact"):
        res, counts = _drive(f"BALANCED {method} bulkscan, c = {WIDE_C}",
                             lambda: bt.bulkscan(Yd, Gd, K, covar, method=method,
                                                 precision=bt.BALANCED))
        check(0 < _total(counts, "liteqtl_lod.wide.*") == _total(counts),
              f"the c = {WIDE_C} {method} bulkscan launched {dict(counts)}")
        check(tuple(res.L.shape) == (P, M) and bool(torch.isfinite(res.L).all()),
              f"the c = {WIDE_C} {method} L is not finite ({P}, {M})")
        exact = bt.bulkscan(Yd, Gd, K, covar, method=method, precision=bt.EXACT64)
        torch.cuda.synchronize()
        same = exact.h2_null_list == res.h2_null_list.double()
        flips = int((~same).sum())
        if method == "null-grid":
            err = _max_abs_diff_cols(res.L, exact.L, same)
            what = f"{flips} of {M} traits with another grid h2"
        else:
            err = _max_abs_diff_cols(res.L, exact.L, all_cols)
            dh2 = (exact.h2_null_list - res.h2_null_list.double()).abs().max().item()
            what = f"all pairs; max|dh2| = {dh2:.3e}"
            flips = 0  # Brent's h2 is continuous: no flip to count
        print(f"  c = {WIDE_C} {method} BALANCED vs EXACT64: max|dLOD| = {err:.3e} ({what}; bar "
              f"{ORACLE_BAR:.0e}; BASELINE.md's {PARITY_BAR:.0e}: "
              f"{'met' if err <= PARITY_BAR else 'NOT met'}); {_total(counts, 'liteqtl_lod.*')} launches")
        check(flips == 0 and err <= ORACLE_BAR, f"the c = {WIDE_C} {method} scan strays from EXACT64")
        out[method] = (_total(counts, "liteqtl_lod.*"), err)
        del exact
        if method == "null-grid":
            base = res
        else:
            del res

    # c = 4 (three of those covariates and the intercept), the wide kernel's first count
    covar4 = covar[:, :3].contiguous()
    res4, counts4 = _drive("BALANCED null-grid bulkscan, c = 4",
                           lambda: bt.bulkscan(Yd, Gd, K, covar4, precision=bt.BALANCED))
    check(0 < _total(counts4, "liteqtl_lod.wide.*") == _total(counts4),
          f"the c = 4 null-grid bulkscan launched {counts4}")
    exact4 = bt.bulkscan(Yd, Gd, K, covar4, precision=bt.EXACT64)
    torch.cuda.synchronize()
    same4 = exact4.h2_null_list == res4.h2_null_list.double()
    flips4 = int((~same4).sum())
    err4 = _max_abs_diff_cols(res4.L, exact4.L, same4)
    print(f"  c = 4 null-grid BALANCED vs EXACT64: max|dLOD| = {err4:.3e} ({flips4} of {M} traits with "
          f"another grid h2; bar {ORACLE_BAR:.0e}; BASELINE.md's {PARITY_BAR:.0e}: "
          f"{'met' if err4 <= PARITY_BAR else 'NOT met'}); {_total(counts4, 'liteqtl_lod.*')} launches")
    check(flips4 == 0 and err4 <= ORACLE_BAR, "the c = 4 null-grid scan strays from EXACT64")
    out["c4"] = (_total(counts4, "liteqtl_lod.*"), err4)
    del res4, exact4

    res, counts = _drive(f"BALANCED null-grid bulkscan, c = {WIDE_C}, output_effects",
                         lambda: bt.bulkscan(Yd, Gd, K, covar, precision=bt.BALANCED,
                                             output_effects=True))
    check(_total(counts, "liteqtl_lod_effects.*") > 0,
          "the c = 12 effects call did not launch the variant")
    exact = bt.bulkscan(Yd, Gd, K, covar, precision=bt.EXACT64, output_effects=True)
    same = exact.h2_null_list == res.h2_null_list.double()
    beta_err, se_err = _effects_err_cols((res.beta_mat, res.beta_se_mat),
                                         (exact.beta_mat, exact.beta_se_mat), same)
    lsame = _max_abs_diff_cols(res.L, base.L, all_cols)
    print(f"  c = {WIDE_C} effects BALANCED vs EXACT64: max|d effect|/(|effect|+SE) = "
          f"{beta_err:.3e}, max|dSE|/SE = {se_err:.3e} (bars {EFFECT_BAR:.0e}); its L vs the "
          f"LOD-only scan's {lsame:.3e} (bar {SAME_LOD_BAR:.0e})")
    check(beta_err <= EFFECT_BAR and se_err <= EFFECT_BAR and lsame <= SAME_LOD_BAR,
          f"the c = {WIDE_C} effects stray")
    out["effects"] = _total(counts, "liteqtl_lod_effects.*")
    del res, exact

    # the kernel alone at the main-path shape, beside its plain version
    ops = lf.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev, covar), base.h2_null_list)
    check(lf.kernel_path(N, WIDE_C) == "wide" and ops[1].shape == (WIDE_C, N, M),
          "the c = 12 main path does not take the wide kernel")
    Lk = lf.liteqtl_lod_cuda(*ops)
    kerr = _max_abs_diff_cols(Lk, base.L, all_cols)
    Lp = lf.liteqtl_lod_plain(*ops)
    perr = _max_abs_diff_cols(Lk, Lp, all_cols)
    del Lk, Lp
    kernel_ms = statistics.median(_time_ms(lambda: lf.liteqtl_lod_cuda(*ops)) for _ in range(5))
    plain_ms = statistics.median(_time_ms(lambda: lf.liteqtl_lod_plain(*ops)) for _ in range(3))
    bound = _bound(2.0 * N * P * M * (WIDE_C + 2), ops, 4 * P * M)
    print(f"  wide kernel at BXD scale, c = {WIDE_C}, on {card}: {kernel_ms:.3f} ms per launch "
          f"(CUDA events, median of 5), plain version {plain_ms:.3f} ms; bound "
          f"{bound['bound_ms']:.3f} ms by {bound['bound_unit']} (CUDA cores "
          f"{bound['simt_bound_ms']:.3f} ms), {100 * bound['simt_bound_ms'] / kernel_ms:.1f} % of "
          f"the CUDA cores' bound; vs plain max|dLOD| = {perr:.3e} (bar {KERNEL_BAR:.0e}); vs the "
          f"scan's L {kerr:.3e}")
    check(perr <= KERNEL_BAR, "the wide kernel disagrees with its plain version at BXD scale")
    out["kernel"] = dict(ms=kernel_ms, plain_ms=plain_ms, err=perr, bound=bound)
    out["shapes"] = {"S5": _shape_entry(kernel_ms, "S5")}
    del ops, base

    # S6: a 2,000-sample cohort with 12 covariate columns, random operands
    n6, p6, m6, c6 = LOD_SHAPES["S6"][:4]
    ops = lf.prepare_inputs(*_kernel_inputs(n6, p6, m6, c6, np.random.default_rng(SHAPE_SEED), dev))
    check(lf.kernel_path(n6, c6) == "wide", "S6 does not take the wide kernel")
    err6 = (lf.liteqtl_lod_cuda(*ops) - lf.liteqtl_lod_plain(*ops)).abs().max().item()
    _time_ms(lambda: lf.liteqtl_lod_cuda(*ops))
    out["shapes"]["S6"] = _shape_entry(
        statistics.median(_time_ms(lambda: lf.liteqtl_lod_cuda(*ops)) for _ in range(5)), "S6")
    bar6 = KERNEL_BAR * n6 / 48
    print(f"  wide kernel at S6 ({n6} x {p6} x {m6}, c = {c6}) on {card}: "
          f"{_shape_line(out['shapes']['S6'])}; vs plain max|dLOD| = {err6:.3e} (bars {bar6:.2e} "
          f"and {LONG_DEPTH_BAR:.2e})")
    check(err6 <= bar6, "the wide kernel disagrees with its plain version at S6")
    check(err6 <= LONG_DEPTH_BAR, f"the wide kernel strays past {LONG_DEPTH_BAR:.2e} at S6")
    del ops

    # c = 32 under a forced budget: the memory model sizes the trait chunks
    covar32 = torch.from_numpy(rng.normal(size=(N, 31))).to(dev)
    real_budget = memory.device_memory_budget
    memory.device_memory_budget = lambda device=None: WIDE_BUDGET
    try:
        (r32, peak) = _peak_over(lambda: bt.bulkscan(Yd, Gd, K, covar32, precision=bt.BALANCED))
    finally:
        memory.device_memory_budget = real_budget
    on_card = torch.is_tensor(r32.L)
    check(bool(np.isfinite(np.asarray(r32.L.cpu() if on_card else r32.L)).all()),
          "the c = 32 L is not finite")
    print(f"  c = 32 null-grid under a forced {WIDE_BUDGET / 2**30:.0f} GiB budget: "
          f"{'trait chunks on the card' if on_card else 'host blocks'}, peak device memory "
          f"{peak / 2**30:.3f} GiB")
    check(peak <= WIDE_BUDGET, "the c = 32 call's peak device memory passed its budget")
    del r32

    # streamed (phase 10's blocks) and LOCO (phase 13's chromosomes) at c = 12
    G_host = Gd.cpu().numpy()
    inmem = bt.bulkscan(Yd, Gd, K, covar, precision=bt.BALANCED)
    res, counts = _drive(f"BALANCED bulkscan_streamed, c = {WIDE_C}, blocks of {STREAM_BLOCK}",
                         lambda: bt.bulkscan_streamed(Yd, G_host, K, covar, precision=bt.BALANCED,
                                                      marker_block=STREAM_BLOCK))
    blocks = -(-P // STREAM_BLOCK)
    check(_total(counts, "liteqtl_lod.*") == blocks, f"the c = 12 streamed call launched {counts}")
    serr = _max_abs_diff_cols(torch.from_numpy(np.asarray(res.L)).to(dev), inmem.L, all_cols)
    print(f"  c = {WIDE_C} streamed vs in-memory: max|dLOD| = {serr:.3e} (bar {STREAM_BAR:.0e})")
    check(serr <= STREAM_BAR, "the c = 12 streamed scan strays from the in-memory one")
    out["streamed"] = _total(counts, "liteqtl_lod.*")
    del res, inmem

    chrom = loco_chromosomes(P)
    masks = _masks(chrom, dev)
    res, counts = _drive(f"BALANCED bulkscan_loco, c = {WIDE_C}",
                         lambda: bt.bulkscan_loco(Yd, Gd, chrom, covar, precision=bt.BALANCED))
    nchrom = len(MOUSE_CHROMS)
    check(_total(counts, "liteqtl_lod.*") == nchrom, f"the c = 12 LOCO call launched {counts}")
    Ks = bt.loco_kinship(Gd, chrom, bt.BALANCED)
    comp = 0.0
    for c in MOUSE_CHROMS:
        one = bt.bulkscan(Yd, Gd[:, masks[c]], Ks[c], covar, precision=bt.BALANCED)
        comp = max(comp, (res.L[masks[c]] - one.L.double()).abs().max().item())
        del one
    print(f"  c = {WIDE_C} LOCO vs its {nchrom} per-chromosome bulkscan calls: max|dLOD| = "
          f"{comp:.3e} (bar {LOCO_BAR:.0e})")
    check(comp <= LOCO_BAR, "the c = 12 LOCO rows differ from the per-chromosome scans")
    out["loco"] = _total(counts, "liteqtl_lod.*")
    del res, Ks
    torch.cuda.empty_cache()
    print(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return out


def _bf16x3_bound(flops, operands, out_bytes):
    """The least time of the same work with bf16x3 products, ms: the larger
    of three bf16 passes of its operations at 989 TFLOP/s and its bytes
    (each operand read once, each output written once) at 3.35 TB/s."""
    nbytes = out_bytes + sum(t.numel() * t.element_size() for t in operands)
    by_bytes, by_ops = nbytes / PEAK_BYTES * 1e3, SPLIT_PASSES * flops / PEAK_BF16 * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


#: phase 17 (a): the shapes (n, p, m, c) of the bf16x3 general LOD kernel
#: (n = 89, 150 and 2,000 at c = 1, 2, 3) and of the bf16x3 wide one (c = 4,
#: 8 and 12 at n = 48, 79 and 2,000) against their chunked bf16x3 plain
#: version; ragged tiles at n = 150 and 79
CHUNKED_BF16_SHAPES = [(n, 129 if n == 150 else 96, 65 if n == 150 else 64, c)
                       for n in (89, 150, 2000) for c in (1, 2, 3)] + [
    (n, 129 if n == 79 else 96, 65 if n == 79 else 64, c) for c in (4, 8, 12) for n in (48, 79, 2000)]


#: phase 17 (a): max |dLOD| of a bf16x3 general or wide LOD kernel (and of
#: its effects variant) from its chunked bf16x3 plain version at every n of
#: CHUNKED_BF16_SHAPES. Their readings were 7.2e-7 to 2.03e-6 at n <= 150
#: and 0.0 at 2,000; a 3 x TF32 launch on the same operands read 2.12e-5 to
#: 4.48e-5 from the same plain version (the products' own distance), so the
#: bar fails the 3 x TF32 kernel where phase 3's (5e-5 x n / 48) does not
#: (NVIDIA H100 80GB HBM3, 700.00 W)
CHUNKED_BF16_BAR = 1e-5
#: phase 17 (a) and (b): the largest share of the 3 x TF32 launch's distance
#: from the chunked bf16x3 plain version, on the same operands, that the
#: bf16x3 launch's distance may take (the largest in (a), the mean in (b)):
#: the check that the products ran as bf16x3 whatever the bar's room
BF16_TWIN_SHARE = 0.25


def chunked_bf16x3_checks(dev) -> dict:
    """Phase 17 (a), the general and wide LOD kernels under "high": each
    bf16x3 instantiation, LOD and effects, against its plain version
    ``liteqtl_bf16x3_chunked_reference`` at CHUNKED_BF16_SHAPES, within
    CHUNKED_BF16_BAR (tighter than phase 3's bars, which a 3 x TF32 launch
    would pass) and within BF16_TWIN_SHARE of the 3 x TF32 launch's distance
    from the same plain version on the same operands; the distance from the
    float32 plain version must be above 0, and each launch is counted as
    bf16x3, the 3 x TF32 one not. Returns, for each path, the largest
    distance of the bf16x3 kernel and the least of the 3 x TF32 one."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils.profiling import launch_counts

    rng = np.random.default_rng(16)
    seen = {}
    for n, p, m, c in CHUNKED_BF16_SHAPES:
        path = lf.kernel_path(n, c)
        check(path == ("wide" if c > 3 else "general")
              and lf.kernel_route(n, c, dot_precision="high") == (path, "bf16x3"),
              f"n={n}, c={c} does not take the bf16x3 {path} kernel")
        ops = lf.prepare_inputs(*_kernel_inputs(n, p, m, c, rng, dev), effects=True)
        lod_ops = (*ops[:4], ops[4][:-1])
        launch_counts.clear()
        out = lf.liteqtl_lod_cuda(*lod_ops, dot_precision="high")
        eff = lf.liteqtl_lod_cuda(*ops, effects=True, dot_precision="high")
        tf32 = lf.liteqtl_lod_cuda(*lod_ops)  # the 3 x TF32 twin on the same operands
        torch.cuda.synchronize()
        check(launch_counts == {f"liteqtl_lod.{path}.bf16x3": 1, f"liteqtl_lod.{path}.tf32x3": 1,
                                f"liteqtl_lod_effects.{path}.bf16x3": 1},
              f"the chunked LOD launches were not counted by route: {dict(launch_counts)}")
        twin = lf.liteqtl_bf16x3_chunked_reference(*lod_ops)
        err = (out - twin).abs().max().item()
        tf32_err = (tf32 - twin).abs().max().item()
        from32 = (out - lf.liteqtl_lod_plain(*lod_ops)).abs().max().item()
        lod_err, beta_err, se_err = _effects_errors(
            eff, lf.liteqtl_bf16x3_chunked_reference(*ops, effects=True))
        same = (eff[0] - out).abs().max().item()
        torch.cuda.synchronize()
        print(f"  bf16x3 LOD kernel ({path}) vs its chunked bf16x3 plain version n={n} p={p} m={m} "
              f"c={c}: max|dLOD| = {err:.3e} (bars {CHUNKED_BF16_BAR:.0e} and {BF16_TWIN_SHARE} x the "
              f"3 x TF32 launch's {tf32_err:.3e}); from the float32 plain version {from32:.3e}; "
              f"effects variant {lod_err:.3e}, {beta_err:.3e}, {se_err:.3e} (bars "
              f"{CHUNKED_BF16_BAR:.0e}, {EFFECT_BAR:.0e}, {EFFECT_BAR:.0e}), its LOD vs the LOD-only "
              f"kernel's {same:.3e}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all())
              and all(bool(torch.isfinite(t).all()) for t in eff), "bf16x3 chunked LOD output not finite")
        check(max(err, lod_err) <= CHUNKED_BF16_BAR and beta_err <= EFFECT_BAR and se_err <= EFFECT_BAR,
              f"the bf16x3 {path} LOD kernel disagrees with its plain version at {(n, p, m, c)}")
        check(max(err, lod_err) <= BF16_TWIN_SHARE * tf32_err,
              f"the bf16x3 {path} LOD kernel is no nearer its plain version than the 3 x TF32 "
              f"launch at {(n, p, m, c)}")
        check(same <= SAME_LOD_BAR, f"the bf16x3 effects variant's LOD is not the LOD kernel's at {(n, p, m, c)}")
        check(from32 > 0, f"the bf16x3 {path} LOD kernel gave the float32 result at {(n, p, m, c)}")
        worst, least = seen.get(path, (0.0, float("inf")))
        seen[path] = (max(worst, err, lod_err), min(least, tf32_err))
    return {path: {"max_abs_err": worst, "tf32x3_min_err": least}
            for path, (worst, least) in seen.items()}


def throughput_kernel_checks(dev) -> dict:
    """Phase 17 (a): each bf16x3 kernel (``dot_precision="high"``) against
    its bf16x3 plain version at phase 3's shapes, under phase 3's bars; the
    distance from the float32 plain version is printed and must be above 0
    (the products were split). The general and wide LOD kernels:
    :func:`chunked_bf16x3_checks`, whose readings this returns."""
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils.profiling import launch_counts

    rng = np.random.default_rng(13)
    for n, p, m, c in [(48, 96, 64, 1), (48, 96, 64, 2), (48, 96, 64, 3), (48, 70, 45, 1),
                       (79, 129, 65, 1), (80, 129, 65, 2), (81, 129, 65, 3), (88, 321, 130, 1),
                       (88, 129, 65, 3), (79, 1000, 131, 2)]:
        check(lf.kernel_route(n, c, dot_precision="high") == ("resident", "bf16x3"),
              f"the LOD kernel takes no bf16x3 products at n={n}, c={c}")
        ops = lf.prepare_inputs(*_kernel_inputs(n, p, m, c, rng, dev), effects=True)
        lod_ops = (*ops[:4], ops[4][:-1])
        launch_counts.clear()
        out = lf.liteqtl_lod_cuda(*lod_ops, dot_precision="high")
        eff = lf.liteqtl_lod_cuda(*ops, effects=True, dot_precision="high")
        torch.cuda.synchronize()
        check(launch_counts == {"liteqtl_lod.resident.bf16x3": 1,
                                "liteqtl_lod_effects.resident.bf16x3": 1},
              f"the bf16x3 LOD launches were not counted by route: {dict(launch_counts)}")
        ref = lf.liteqtl_bf16x3_reference(*lod_ops)
        err = (out - ref).abs().max().item()
        from32 = (out - lf.liteqtl_lod_plain(*lod_ops)).abs().max().item()
        lod_err, beta_err, se_err = _effects_errors(eff, lf.liteqtl_bf16x3_reference(*ops, effects=True))
        same = (eff[0] - out).abs().max().item()
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        print(f"  bf16x3 LOD kernel (resident) vs its bf16x3 plain version n={n} p={p} m={m} c={c}: "
              f"max|dLOD| = {err:.3e} (bar {bar:.2e}); from the float32 plain version {from32:.3e}; "
              f"effects variant {lod_err:.3e}, {beta_err:.3e}, {se_err:.3e} (bars {bar:.2e}, "
              f"{EFFECT_BAR:.0e}, {EFFECT_BAR:.0e}), its LOD vs the LOD-only kernel's {same:.3e}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all())
              and all(bool(torch.isfinite(t).all()) for t in eff), "bf16x3 LOD output not finite")
        check(err <= bar and lod_err <= bar and beta_err <= EFFECT_BAR and se_err <= EFFECT_BAR,
              f"the bf16x3 LOD kernel disagrees with its plain version at {(n, p, m, c)}")
        check(same <= SAME_LOD_BAR, f"the bf16x3 effects variant's LOD is not the LOD kernel's at {(n, p, m, c)}")
        check(from32 > 0, f"the bf16x3 LOD kernel gave the float32 result at {(n, p, m, c)}")
    chunked = chunked_bf16x3_checks(dev)

    rng = np.random.default_rng(14)
    for n, p, m, c, g in [(48, 96, 64, 1, 10), (48, 96, 64, 2, 10), (48, 96, 64, 3, 10),
                          (48, 96, 64, 1, 1), (48, 70, 45, 2, 10), (79, 129, 65, 1, 10),
                          (80, 129, 65, 2, 10), (81, 129, 65, 3, 10), (2000, 96, 64, 2, 10)]:
        Y0, X0m, C0, lam, _ = _kernel_inputs(n, p, m, c, rng, dev)
        grid = torch.as_tensor(GRID[:g] if g > 1 else [0.3], dtype=torch.float32, device=dev)
        ops = af.prepare_inputs(Y0, X0m, C0, lam, grid, prior=PRIOR)
        out, kk = af.altgrid_cuda(*ops, dot_precision="high")
        torch.cuda.synchronize()
        ref, kp = af.altgrid_plain(*ops, dot_precision="high")
        from32 = (out - af.altgrid_plain(*ops, panel=False)[0]).abs().max().item()
        torch.cuda.synchronize()
        bar = KERNEL_BAR * max(1.0, n / 48)
        err = (out - ref).abs().max().item()
        flips = _index_flips(kk, kp)
        print(f"  bf16x3 alt-grid kernel vs its bf16x3 plain version n={n} p={p} m={m} c={c} g={g}: "
              f"max|dLOD| = {err:.3e} (bar {bar:.2e}), index flips {flips} of {p * m}; from the "
              f"float32 plain version {from32:.3e}")
        check(out.shape == (p, m) and bool(torch.isfinite(out).all()), "bf16x3 alt-grid output not finite")
        check(err <= bar and flips <= INDEX_FLIP_SHARE * p * m,
              f"the bf16x3 alt-grid kernel disagrees with its plain version at {(n, p, m, c, g)}")
        check(from32 > 0, f"the bf16x3 alt-grid kernel gave the float32 result at {(n, p, m, c, g)}")

    rng = np.random.default_rng(15)
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod

    for n, p, mb, c, K in [(48, 96, 8, 1, 24), (48, 96, 8, 3, 24), (48, 65, 8, 2, 257),
                           (48, 70, 5, 2, 130), (79, 96, 8, 1, 24), (80, 96, 8, 2, 24),
                           (81, 96, 8, 1, 24), (88, 96, 8, 1, 24), (89, 96, 8, 3, 257),
                           (2000, 96, 8, 2, 24)]:
        ops = _perm_operands(n, p, mb, c, K, rng, dev)
        route = bf.kernel_route(n, "high")
        out = bf.bulkperm_maxr2_cuda(*ops, dot_precision="high")
        torch.cuda.synchronize()
        ref = bf.bulkperm_maxr2_plain(*ops, dot_precision="high")
        from32 = (out - bf.bulkperm_maxr2_plain(*ops)).abs().max().item()
        torch.cuda.synchronize()
        r2_err = (out - ref).abs().max().item()
        lod_err = (maxr2_to_lod(out, n) - maxr2_to_lod(ref, n)).abs().max().item()
        bar = KERNEL_BAR * max(1.0, n / 48)
        print(f"  bf16x3 permutation kernel ({route[0]}) vs its bf16x3 plain version n={n} p={p} "
              f"mb={mb} c={c} K={K}: max|d r2| = {r2_err:.3e} (bar {R2_BAR:.0e}), max|dLOD| = "
              f"{lod_err:.3e} (bar {bar:.2e}); from the float32 plain version max|d r2| = {from32:.3e}")
        check(route[1] == "bf16x3" and out.shape == ref.shape and bool(torch.isfinite(out).all()),
              "bf16x3 permutation output not finite")
        check(r2_err <= R2_BAR and lod_err <= bar,
              f"the bf16x3 permutation kernel disagrees with its plain version at {(n, p, mb, c, K)}")
        check(from32 > 0, f"the bf16x3 permutation kernel gave the float32 result at {(n, p, mb, c, K)}")
    return chunked


def _throughput_perm_decomposition(dev, Yd, Gd, K, ml, exact, same) -> None:
    """Phase 17 (d), reported: the THROUGHPUT permutation maxima's distance
    from EXACT64 (``exact``, traits 0..ORACLE_BLOCK; ``same``: the traits of
    equal grid h2), taken apart on the main path's trait-side operands: the
    bf16x3 kernel on the markers off the covariates' span (the main path;
    ``ml`` its maxima from the scan), on the raw rotated markers, and the
    bf16x3 and float32 plain versions on the main path's operands. Each as
    the largest, the 99.99th percentile and the mean of |dLOD| over the
    traits' columns."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.models import bulkperm as mp
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod, permutation_indices
    from bulklmm_tpu_torch.ops.rotation import resolve_kinship
    from bulklmm_tpu_torch.ops.smallchol import off_covariates
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    # the scan's own preparation: every trait, in THROUGHPUT's solve dtype
    # (float32); bf16x3 carries an operand's last-place change far
    dtype = bt.THROUGHPUT.resolve_solve()
    Ut, lam = resolve_kinship(K, "eigen", dtype, dev)
    grid = torch.as_tensor(GRID, dtype=dtype, device=dev)
    ones = torch.ones((N, 1), dtype=dtype, device=dev)
    with with_highest_matmul():
        X0m, C0, _, _, sqrtw, Qstack, wrn = mp._bulkperm_prep(
            Yd.to(dtype), Gd.to(dtype), ones, Ut, lam, grid, prior=PRIOR, reml=False,
            method="null-grid", optim_interval=1, precision=bt.THROUGHPUT,
        )
    idx = permutation_indices(N, NPERMS, 0).to(dev)
    off = off_covariates(X0m, C0)
    high = dict(dot_precision="high")
    runs = {
        "bf16x3 kernel, markers off the covariates (main path)": (off, bf.bulkperm_maxr2_cuda, high),
        "bf16x3 kernel, raw rotated markers": (X0m, bf.bulkperm_maxr2_cuda, high),
        "bf16x3 plain version, markers off the covariates": (off, bf.bulkperm_maxr2_plain, high),
        "float32 plain version, markers off the covariates": (off, bf.bulkperm_maxr2_plain, {}),
    }
    print(f"  THROUGHPUT bulkscan_perms vs EXACT64, traits 0..{ORACLE_BLOCK} of equal grid h2, taken "
          "apart (max, 99.99th percentile, mean of |dLOD|; reported):")
    for name, (Xm, fn, kw) in runs.items():
        cols = []
        for lo in range(0, ORACLE_BLOCK, PERM_BLOCK):
            hi = min(lo + PERM_BLOCK, ORACLE_BLOCK)
            sw, Q = sqrtw[lo:hi], Qstack[lo:hi]
            S2 = bf.prepare_chunk_inputs(sw, Q, wrn[:, lo:hi], idx)
            inv_xn = bf.prepare_trait_block(Xm, sw, Q, precision=bt.THROUGHPUT)
            cols.append(maxr2_to_lod(fn(Xm.to(torch.float32).contiguous(), S2, inv_xn, **kw), N))
            del S2, inv_xn
        L = torch.cat(cols, 0)
        d = (L.double() - exact)[same].abs()
        line = (f"    {name:54s} {d.max().item():.3e}  {torch.quantile(d, 0.9999).item():.3e}  "
                f"{d.mean().item():.3e}")
        if name.endswith("(main path)"):
            line += f"; vs the scan's maxima {(L - ml).abs().max().item():.3e}"
        print(line)
        del L, d, cols
    torch.cuda.empty_cache()


def throughput_at_bxd(dev, card, Yd, Gd, K, lod_ops, alt_ops, perm_ops, launches) -> dict:
    """Phase 17 (b)-(d): THROUGHPUT at BXD scale through the entry points,
    each with its launch counts, against EXACT64; each bf16x3 kernel alone
    on the main path's operands against its bf16x3 plain version; and the
    times of each bf16x3 kernel beside its 3 x TF32 twin, in turns."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.ops.bulkperm import maxr2_to_lod

    out = {}
    all_cols = torch.ones(M, dtype=torch.bool, device=dev)
    # (b) null-grid, and with effects
    res, counts = _drive("THROUGHPUT null-grid bulkscan",
                         lambda: bt.bulkscan(Yd, Gd, K, precision=bt.THROUGHPUT), "bf16x3")
    want = launches["liteqtl_lod"]
    check(_total(counts, "liteqtl_lod.*") == _total(counts) == want,
          f"THROUGHPUT null-grid launched {dict(counts)}, not {want} bf16x3 LOD launches alone")
    check(tuple(res.L.shape) == (P, M) and bool(torch.isfinite(res.L).all()), "THROUGHPUT L not finite")
    exact = bt.bulkscan(Yd, Gd, K, precision=bt.EXACT64, output_effects=True)
    same = exact.h2_null_list == res.h2_null_list.double()
    err = _max_abs_diff_cols(res.L, exact.L, same)
    print(f"  THROUGHPUT vs EXACT64 null-grid: {int((~same).sum())} of {M} traits with another grid h2; "
          f"max|dLOD| on the rest = {err:.3e} (bar {THROUGHPUT_LOD_BAR:.0e})")
    check(0 < err <= THROUGHPUT_LOD_BAR, "THROUGHPUT null-grid strays from EXACT64")
    out["lod_launches"], out["lod_vs_exact64"] = _total(counts, "liteqtl_lod.*"), err
    del res
    eff, counts = _drive("THROUGHPUT null-grid bulkscan, output_effects",
                         lambda: bt.bulkscan(Yd, Gd, K, precision=bt.THROUGHPUT, output_effects=True),
                         "bf16x3")
    check(_total(counts, "liteqtl_lod_effects.*") == _total(counts) == want,
          f"THROUGHPUT effects launched {dict(counts)}")
    same = exact.h2_null_list == eff.h2_null_list.double()
    lod_err = _max_abs_diff_cols(eff.L, exact.L, same)
    beta_err, se_err = _effects_err_cols((eff.beta_mat, eff.beta_se_mat),
                                         (exact.beta_mat, exact.beta_se_mat), same)
    print(f"  THROUGHPUT vs EXACT64 with effects: max|dLOD| = {lod_err:.3e}, max|d effect|/(|effect|+SE) "
          f"= {beta_err:.3e}, max|dSE|/SE = {se_err:.3e} (bars {THROUGHPUT_LOD_BAR:.0e})")
    check(0 < lod_err <= THROUGHPUT_LOD_BAR and beta_err <= THROUGHPUT_LOD_BAR
          and se_err <= THROUGHPUT_LOD_BAR, "THROUGHPUT effects stray from EXACT64")
    out["effects_vs_exact64"] = (lod_err, beta_err, se_err)
    del eff, exact
    Lk = lf.liteqtl_lod_cuda(*lod_ops, dot_precision="high")
    kerr = _max_abs_diff_cols(Lk, lf.liteqtl_bf16x3_reference(*lod_ops), all_cols)
    from32 = _max_abs_diff_cols(Lk, lf.liteqtl_lod_plain(*lod_ops), all_cols)
    print(f"  bf16x3 LOD kernel vs its bf16x3 plain version at BXD scale: max|dLOD| = {kerr:.3e} "
          f"(bar {KERNEL_BAR:.0e}); from the float32 plain version {from32:.3e}")
    check(kerr <= KERNEL_BAR and from32 > 0, "the bf16x3 LOD kernel disagrees at BXD scale")
    out["lod_err"] = kerr
    del Lk

    # (c) alt-grid
    res, counts = _drive("THROUGHPUT alt-grid bulkscan",
                         lambda: bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.THROUGHPUT),
                         "bf16x3")
    want = launches["altgrid"]
    check(_total(counts, "altgrid.*") == _total(counts) == want,
          f"THROUGHPUT alt-grid launched {dict(counts)}")
    exact = bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.EXACT64)
    err = _max_abs_diff_cols(res.L, exact.L, all_cols)
    flips = int((res.h2_panel != exact.h2_panel).sum())
    print(f"  THROUGHPUT vs EXACT64 alt-grid: max|dLOD| = {err:.3e} (bar {THROUGHPUT_BAR:.0e}), h2 panel "
          f"flips {flips} ({flips / (P * M):.3e} of the pairs, bar {THROUGHPUT_FLIP_SHARE})")
    check(0 < err < THROUGHPUT_BAR and flips < THROUGHPUT_FLIP_SHARE * P * M,
          "THROUGHPUT alt-grid strays from EXACT64")
    out["alt_launches"], out["alt_vs_exact64"] = _total(counts, "altgrid.*"), err
    del res, exact
    Lk, kk = af.altgrid_cuda(*alt_ops, dot_precision="high")
    Lp, kp = af.altgrid_plain(*alt_ops, dot_precision="high")
    kerr = _max_abs_diff_cols(Lk, Lp, all_cols)
    kflips = _index_flips(kk, kp)
    print(f"  bf16x3 alt-grid kernel vs its bf16x3 plain version at BXD scale: max|dLOD| = {kerr:.3e} "
          f"(bar {KERNEL_BAR:.0e}), index flips {kflips} of {P * M}")
    check(kerr <= KERNEL_BAR and kflips <= INDEX_FLIP_SHARE * P * M,
          "the bf16x3 alt-grid kernel disagrees at BXD scale")
    out["alt_err"] = kerr
    del Lk, kk, Lp, kp

    # (d) permutations
    res, counts = _drive("THROUGHPUT bulkscan_perms",
                         lambda: bt.bulkscan_perms(Yd, Gd, K, nperms=NPERMS, rndseed=0,
                                                   precision=bt.THROUGHPUT), "bf16x3")
    want = launches["bulkperm_maxr2"]
    check(_total(counts, "bulkperm_maxr2.*") == _total(counts) == want,
          f"THROUGHPUT bulkscan_perms launched {dict(counts)}")
    check(bool(torch.isfinite(res.maxlods).all()), "THROUGHPUT maxlods not finite")
    cut = slice(0, ORACLE_BLOCK)
    exact = bt.bulkscan_perms(Yd[:, cut], Gd, K, nperms=NPERMS, rndseed=0, precision=bt.EXACT64)
    same = exact.h2_null_list == res.h2_null_list[cut].double()
    err = (res.maxlods[cut].double() - exact.maxlods)[same].abs().max().item()
    print(f"  THROUGHPUT vs EXACT64 bulkscan_perms on traits 0..{ORACLE_BLOCK}: {int((~same).sum())} "
          f"traits with another grid h2; max|dLOD| on the rest = {err:.3e} (bar {THROUGHPUT_BAR:.0e})")
    check(0 < err < THROUGHPUT_BAR, "THROUGHPUT bulkscan_perms strays from EXACT64")
    out["perm_launches"], out["perm_vs_exact64"] = _total(counts, "bulkperm_maxr2.*"), err
    _throughput_perm_decomposition(dev, Yd, Gd, K, res.maxlods[cut], exact.maxlods, same)
    del res, exact
    r2 = bf.bulkperm_maxr2_cuda(*perm_ops, dot_precision="high")
    ref = bf.bulkperm_maxr2_plain(*perm_ops, dot_precision="high")
    r2_err = (r2 - ref).abs().max().item()
    kerr = (maxr2_to_lod(r2, N) - maxr2_to_lod(ref, N)).abs().max().item()
    print(f"  bf16x3 permutation kernel vs its bf16x3 plain version at BXD scale, traits 0..{PERM_BLOCK}: "
          f"max|d r2| = {r2_err:.3e} (bar {R2_BAR:.0e}), max|dLOD| = {kerr:.3e} (bar {KERNEL_BAR:.0e})")
    check(r2_err <= R2_BAR and kerr <= KERNEL_BAR, "the bf16x3 permutation kernel disagrees at BXD scale")
    out["perm_err"] = kerr
    del r2, ref

    # (e) times: each bf16x3 kernel beside its 3 x TF32 twin, in turns
    runs = {
        "liteqtl_lod": lambda dp: lf.liteqtl_lod_cuda(*lod_ops, dot_precision=dp),
        "altgrid": lambda dp: af.altgrid_cuda(*alt_ops, dot_precision=dp)[0],
        "bulkperm_maxr2": lambda dp: bf.bulkperm_maxr2_cuda(*perm_ops, dot_precision=dp),
    }
    works = {
        "liteqtl_lod": (2.0 * N * P * M * (lod_ops[1].shape[1] + 2), lod_ops, 4 * P * M),
        "altgrid": (2.0 * N * P * M * len(GRID), alt_ops, 8 * P * M),
        "bulkperm_maxr2": (2.0 * N * P * PERM_BLOCK * (NPERMS + 1), perm_ops,
                           4 * PERM_BLOCK * (NPERMS + 1)),
    }
    ms = {(name, dp): [] for name in runs for dp in ("highest", "high")}
    for (name, dp) in ms:
        _time_ms(lambda: runs[name](dp))
    for _ in range(5):
        for (name, dp), t in ms.items():
            t.append(_time_ms(lambda: runs[name](dp)))
    print(f"  times on {card}, median of 5, in turns (ms a launch):")
    for name, fn in runs.items():
        tf32 = statistics.median(ms[(name, "highest")])
        bf16 = statistics.median(ms[(name, "high")])
        bound, by = _bf16x3_bound(*works[name])
        out[name] = {"bf16x3_ms": bf16, "tf32x3_ms": tf32, "bf16x3_bound_ms": bound,
                     "bf16x3_bound_by": by, "bf16x3_share": bound / bf16}
        print(f"    {name:16s} bf16x3 {bf16:9.3f} (runs {[round(x, 3) for x in ms[(name, 'high')]]}), "
              f"3 x TF32 {tf32:9.3f} (runs {[round(x, 3) for x in ms[(name, 'highest')]]}); bf16x3 bound "
              f"{bound:.3f} ms by {by}, {100 * bound / bf16:.1f} % of it")
        check(bound <= bf16, f"the bf16x3 {name} kernel runs faster than its bound")
    return out


#: phase 17 (c): the shapes at which each bf16x3 general and wide LOD kernel
#: is timed beside its 3 x TF32 twin, from kernel_times.py's LOD_SHAPES
CHUNKED_BF16_TIMED = ("S1", "S4", "S5", "S6")


#: phase 17 (b): markers and traits of the corner of a main path's operands
#: on which the bf16x3 general or wide kernel is held against its chunked
#: bf16x3 plain version (an emulation: it takes every depth step's products
#: apart)
TWIN_CORNER = 512


def _corner(ops, k: int):
    """The first k markers and k traits of the LOD kernels' operands."""
    X, C, W, WY, scal = ops
    return (X[:, :k], C[:, :, :k].contiguous() if C.dim() == 3 else C, W[:, :k].contiguous(),
            WY[:, :k].contiguous(), scal[:, :k].contiguous())


def _chunked_vs_bf16x3_plain(ops, what: str) -> dict:
    """Phase 17 (b): the bf16x3 general or wide kernel on a main path's
    operands ``ops``, beside a 3 x TF32 launch on the same operands. Whole,
    against ``liteqtl_bf16x3_reference`` (the resident kernel's order:
    float32 sums over the whole depth) within KERNEL_BAR, and
    BF16_LONG_DEPTH_BAR at 2,000 samples. There the 3 x TF32 launch is
    nearer that plain version than the bf16x3 one, whose one accumulator
    over the walk drifts further than the order of the sums, and one unit
    in the LOD's last place is 2.6e-5. So on the TWIN_CORNER corner the
    kernel is held against ``liteqtl_bf16x3_chunked_reference``, its own
    order, under the same bar and with a mean |dLOD| at most
    BF16_TWIN_SHARE of the 3 x TF32 launch's: the check that the products
    ran as bf16x3. Each bf16x3 launch is counted, the 3 x TF32 one not."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils.profiling import launch_counts

    n = ops[0].shape[0]
    bar = BF16_LONG_DEPTH_BAR if n >= BIOBANK_N else KERNEL_BAR
    out = {}
    for name, args, plain in (("whole", ops, lf.liteqtl_bf16x3_reference),
                              ("corner", _corner(ops, TWIN_CORNER), lf.liteqtl_bf16x3_chunked_reference)):
        ref = plain(*args)
        launch_counts.clear()
        d16 = (lf.liteqtl_lod_cuda(*args, dot_precision="high") - ref).abs()
        d32 = (lf.liteqtl_lod_cuda(*args) - ref).abs()
        from32 = (lf.liteqtl_lod_plain(*args) - ref).abs().max().item()
        torch.cuda.synchronize()
        check((_total(launch_counts, "liteqtl_lod.*.bf16x3"), _total(launch_counts)) == (1, 2),
              f"the bf16x3 launch on {what} was not counted alone: {dict(launch_counts)}")
        err, mean, tf32_err, tf32_mean = (d16.max().item(), d16.mean().item(), d32.max().item(),
                                          d32.mean().item())
        print(f"  the bf16x3 kernel on {what} ({name}: {tuple(args[0].shape)[1]} markers x "
              f"{tuple(args[2].shape)[1]} traits) vs {plain.__name__}: max|dLOD| = {err:.3e} (bar "
              f"{bar:.2e}), mean {mean:.3e}; the 3 x TF32 launch's {tf32_err:.3e}, mean "
              f"{tf32_mean:.3e}; the float32 plain version's max {from32:.3e}")
        check(err <= bar, f"the bf16x3 kernel disagrees with {plain.__name__} on {what}")
        if name == "corner":
            check(mean <= BF16_TWIN_SHARE * tf32_mean,
                  f"the bf16x3 kernel on {what} is no nearer its chunked plain version than the 3 x "
                  "TF32 launch")
        out[name] = {"bf16x3_max_abs_err": err, "bf16x3_mean_abs_err": mean, "tf32x3_max_abs_err": tf32_err,
                     "tf32x3_mean_abs_err": tf32_mean, "float32_plain_max_abs_err": from32}
        del ref, d16, d32
    torch.cuda.empty_cache()
    return {"vs_bf16x3_plain": out}


def throughput_chunked(dev, card, Yd, Gd, K) -> dict:
    """Phase 17 (b) and (c) for the general and wide LOD kernels: THROUGHPUT
    null-grid ``bulkscan`` against EXACT64 on phase 11's 2,000-sample block
    (the general kernel) and at phase 15's c = WIDE_C at BXD scale (the wide
    kernel), max |dLOD| on the traits of equal grid h2 within
    THROUGHPUT_LOD_BAR x max(1, n / 79), every LOD launch with bf16x3
    products; a THROUGHPUT ``bulkscan_streamed`` over phase 11's panel that
    launches bf16x3 general kernels alone, its first block against the
    in-memory call; on both main paths' operands the kernel against its
    bf16x3 plain version (:func:`_chunked_vs_bf16x3_plain`); then each
    kernel's time at CHUNKED_BF16_TIMED beside its 3 x TF32 twin, in turns,
    and its bf16x3 bound."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    t_phase = time.perf_counter()
    out = {}

    def lod_only(counts, what, path):
        check(0 < _total(counts, f"liteqtl_lod.{path}.*") == _total(counts),
              f"{what} launched {dict(counts)}, not {path} LOD launches alone")

    # phase 11's panel and its block
    rng = np.random.default_rng(SEED)
    G = rng.random((BIOBANK_N, BIOBANK_P), dtype=np.float32)
    Yb = torch.from_numpy(rng.standard_normal((BIOBANK_N, BIOBANK_M), dtype=np.float32)).to(dev)
    Kb = bt.calc_kinship(torch.from_numpy(G).to(dev), precision=bt.EXACT64).cpu().numpy()
    dec = bt.decompose_kinship(Kb, dtype=torch.float64, device=dev)
    Gb = torch.from_numpy(np.ascontiguousarray(G[:, :BIOBANK_BLOCK])).to(dev)
    check(lf.kernel_path(BIOBANK_N, 1) == "general", "biobank n does not take the general kernel")
    res, counts = _drive(f"THROUGHPUT null-grid bulkscan at biobank n, the first {BIOBANK_BLOCK} markers",
                         lambda: bt.bulkscan(Yb, Gb, dec, precision=bt.THROUGHPUT), "bf16x3")
    lod_only(counts, "the THROUGHPUT block call", "general")
    exact = bt.bulkscan(Yb, Gb, dec, precision=bt.EXACT64)
    same = exact.h2_null_list == res.h2_null_list.double()
    err = _max_abs_diff_cols(res.L, exact.L, same)
    bar = THROUGHPUT_LOD_BAR * BIOBANK_N / N
    print(f"  THROUGHPUT vs EXACT64 at biobank n ({BIOBANK_N} x {BIOBANK_BLOCK} x {BIOBANK_M}, the "
          f"general kernel): {int((~same).sum())} of {BIOBANK_M} traits with another grid h2; "
          f"max|dLOD| on the rest = {err:.3e} (bar {bar:.3e})")
    check(0 < err <= bar, "THROUGHPUT strays from EXACT64 at biobank n")
    out["general"] = {"launches": _total(counts, "liteqtl_lod.*"), "throughput_vs_exact64": err}
    block_L = res.L
    del exact
    with with_highest_matmul():
        ones = torch.ones((BIOBANK_N, 1), dtype=torch.float64, device=dev)
        ops = lf.prepare_inputs(dec.Ut @ Yb.double(), dec.Ut @ Gb.double(), dec.Ut @ ones, dec.lam,
                                res.h2_null_list)
    out["general"].update(_chunked_vs_bf16x3_plain(
        ops, f"the {BIOBANK_N} x {BIOBANK_BLOCK} x {BIOBANK_M} block"))
    del ops, res, Gb
    with tempfile.TemporaryDirectory() as tmp:
        L = np.lib.format.open_memmap(Path(tmp) / "L.npy", mode="w+", dtype=np.float32,
                                      shape=(BIOBANK_P, BIOBANK_M))
        res, counts = _drive("THROUGHPUT null-grid bulkscan_streamed at biobank n",
                             lambda: bt.bulkscan_streamed(Yb, G, dec, precision=bt.THROUGHPUT, out=L),
                             "bf16x3")
        lod_only(counts, "the THROUGHPUT streamed call", "general")
        check(res.L is L and bool(np.isfinite(L).all()), "THROUGHPUT streamed L is not finite")
        serr = (torch.from_numpy(np.asarray(L[:BIOBANK_BLOCK])).to(dev) - block_L).abs().max().item()
        print(f"  THROUGHPUT streamed: {_total(counts, 'liteqtl_lod.*')} bf16x3 general kernel launches; "
              f"its first {BIOBANK_BLOCK} markers vs the in-memory call's max|dLOD| = {serr:.3e} "
              f"(bar {ORACLE_BAR * BIOBANK_N / N:.2e})")
        check(serr <= ORACLE_BAR * BIOBANK_N / N, "the THROUGHPUT streamed scan strays from the in-memory one")
        out["general"]["streamed_launches"] = _total(counts, "liteqtl_lod.*")
        del res, L
    del G, Yb, dec, block_L
    torch.cuda.empty_cache()

    # phase 15's c = 12 at BXD scale: the wide kernel
    covar = torch.from_numpy(np.random.default_rng(SEED).normal(size=(N, WIDE_C - 1))).to(dev)
    res, counts = _drive(f"THROUGHPUT null-grid bulkscan, c = {WIDE_C}",
                         lambda: bt.bulkscan(Yd, Gd, K, covar, precision=bt.THROUGHPUT), "bf16x3")
    lod_only(counts, f"the THROUGHPUT c = {WIDE_C} call", "wide")
    exact = bt.bulkscan(Yd, Gd, K, covar, precision=bt.EXACT64)
    same = exact.h2_null_list == res.h2_null_list.double()
    err = _max_abs_diff_cols(res.L, exact.L, same)
    print(f"  THROUGHPUT vs EXACT64 at c = {WIDE_C} (the wide kernel): {int((~same).sum())} of {M} "
          f"traits with another grid h2; max|dLOD| on the rest = {err:.3e} (bar {THROUGHPUT_LOD_BAR:.0e})")
    check(0 < err <= THROUGHPUT_LOD_BAR, f"THROUGHPUT strays from EXACT64 at c = {WIDE_C}")
    out["wide"] = {"launches": _total(counts, "liteqtl_lod.*"), "throughput_vs_exact64": err}
    ops = lf.prepare_inputs(*_rotated_bxd(K, Yd, Gd, dev, covar), res.h2_null_list)
    out["wide"].update(_chunked_vs_bf16x3_plain(ops, f"BXD scale at c = {WIDE_C}"))
    del res, exact, ops
    torch.cuda.empty_cache()

    # (c) each kernel beside its 3 x TF32 twin, in turns
    out["shapes"] = {}
    print(f"  the bf16x3 general and wide LOD kernels on {card}, median of 5 in turns with the 3 x "
          "TF32 twin (ms a launch):")
    for name in CHUNKED_BF16_TIMED:
        shape = LOD_SHAPES[name]
        ops = lf.prepare_inputs(*_kernel_inputs(*shape[:4], np.random.default_rng(SHAPE_SEED), dev))
        launch = {dp: (lambda dp=dp: lf.liteqtl_lod_cuda(*ops, general=shape.general, dot_precision=dp))
                  for dp in ("high", "highest")}
        ms = {dp: [] for dp in launch}
        for dp in launch:
            _time_ms(launch[dp])
        for _ in range(5):
            for dp in launch:
                ms[dp].append(_time_ms(launch[dp]))
        bf16, tf32 = statistics.median(ms["high"]), statistics.median(ms["highest"])
        bound, by = bound_ms(shape, "bf16x3")
        kind = "general" if shape.general or shape.c <= 3 else "wide"
        out["shapes"][name] = {"kernel": kind, "bf16x3_ms": bf16, "tf32x3_ms": tf32,
                               "bf16x3_bound_ms": bound, "bf16x3_bound_by": by,
                               "bf16x3_share": bound / bf16}
        print(f"    {name} ({kind}, {shape.n} x {shape.p} x {shape.m}, c = {shape.c}): bf16x3 "
              f"{bf16:.3f} {[round(x, 3) for x in ms['high']]}, 3 x TF32 {tf32:.3f} "
              f"{[round(x, 3) for x in ms['highest']]}, {tf32 / bf16:.2f}x; bf16x3 bound {bound:.3f} "
              f"ms by {by}, {100 * bound / bf16:.1f} % of it")
        check(bound <= bf16, f"the bf16x3 {kind} LOD kernel runs faster than its bound at {name}")
        del ops, launch
        torch.cuda.empty_cache()
    print(f"  phase 17's general and wide kernels took {time.perf_counter() - t_phase:.1f} s")
    return out


def validation_sweep(card) -> None:
    """Phase 16: ``python -m bulklmm_tpu_torch.validation``'s sweep in this
    process; fails if any path misses its bar."""
    from bulklmm_tpu_torch import validation

    t0 = time.perf_counter()
    rc = validation.main()
    print(f"  phase 16 took {time.perf_counter() - t0:.1f} s on {card}")
    check(rc == 0, "a path of the validation sweep missed its bar")


def fwer_study(dev, card) -> dict:
    """Phase 18 (a): ``throughput_fwer``'s study at the JAX script's size,
    its engine table, and ``get_thresholds_bulk`` at BXD scale. Returns the
    paths' launch counts."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import throughput_fwer as tf

    t0 = time.perf_counter()
    G, K, Y = tf.synth()
    rows, counts = _drive(f"the FWER study, {Y.shape[1]} traits x {G.shape[1]} markers, "
                          f"{tf.NSEEDS} seeds x BALANCED and THROUGHPUT x {tf.NPERMS} permutations",
                          lambda: tf.fwer_measurement(G, K, Y, device=dev), None)
    check(_total(counts, "bulkperm_maxr2.*") == 2 * _total(counts, "bulkperm_maxr2.*.bf16x3") > 0,
          f"the FWER study did not launch the permutation kernel in both products: {counts}")
    for row in rows:
        print(f"  {json.dumps(row)}")
    worst = max(row["delta_over_spread_max"] for row in rows)
    print(f"  the tiers' threshold difference over the seed-to-seed spread: at most {worst:.3e} "
          f"(bar {FWER_SPREAD_BAR} at every alpha)")
    check(worst < FWER_SPREAD_BAR, "THROUGHPUT's thresholds stray past a tenth of the seed spread")
    launches = {"fwer_study": counts}

    table, counts = _drive("the THROUGHPUT engine table (79 x 512 x 64, CPU EXACT64 goldens)",
                           lambda: tf.engine_accuracy_table(dev), "bf16x3")
    check(all(_total(counts, f"{k}.*") > 0 for k in ("liteqtl_lod", "altgrid", "bulkperm_maxr2")),
          f"the engine table did not launch every kernel, each in bf16x3 products: {counts}")
    launches["engine_table"] = counts
    for name, err in table.items():
        bar = ENGINE_BARS.get(name)
        print(f"  THROUGHPUT {name}: max|dLOD| vs EXACT64 = {err:.3e}"
              + (f" (bar {bar:.0e})" if bar else " (reported)"))
        check(bar is None or err <= bar, f"THROUGHPUT {name} strays from EXACT64")

    peaks = torch.rand((M, NPERMS + 1), device=dev) * 4  # BXD-scale maxima
    bt.get_thresholds_bulk(peaks, tf.ALPHAS)
    ms = [_host_ms(lambda: bt.get_thresholds_bulk(peaks, tf.ALPHAS)) for _ in range(5)]
    print(f"  get_thresholds_bulk at {M} x {NPERMS + 1}, {len(tf.ALPHAS)} levels, on {card}: "
          f"{statistics.median(ms):.2f} ms (median of 5, host clock: {[round(x, 2) for x in ms]})")
    print(f"  phase 18 (a) took {time.perf_counter() - t0:.1f} s")
    return launches


def biobank_full(dev, card) -> dict:
    """Phase 18 (b): ``biobank --full`` under BALANCED, a block against
    EXACT64 on the float64 factors, then ``--perms 256 --perm-traits 128``
    under BALANCED and THROUGHPUT against the EXACT64 plain engine on the
    same shuffle indices. Returns the paths' launch counts."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import biobank as bb
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.ops.bulkperm import permutation_indices
    from bulklmm_tpu_torch.ops.rotation import decomposition_from_numpy

    t0 = time.perf_counter()
    n, p, m = bb.FULL
    check(lf.kernel_path(n, 1) == "general" and bf.kernel_path(n) == "chunked",
          "biobank n does not take the general LOD kernel and the chunked permutation kernel")
    G, Y = bb.synth_cohort(n, p, m)
    synth_s = time.perf_counter() - t0
    Gd, Yd = torch.from_numpy(G).to(dev), torch.from_numpy(Y).to(dev)
    del G, Y
    with tempfile.TemporaryDirectory() as cache:
        K32, eigh_s = bb.kinship_for_run(Gd, cache_dir=cache)
        Ut, lam, _ = bb.host_decomposition(Gd, cache)
    dec = decomposition_from_numpy(Ut, lam, device=dev, dtype=torch.float64)
    del Ut, lam
    print(f"  cohort {n} x {p} x {m} drawn on the host in {synth_s:.1f} s; kinship and host eigh "
          f"{eigh_s:.1f} s")
    launches = {}
    dt, counts = _drive("biobank --full, BALANCED, warm-up and timed call",
                        lambda: bb.timed(lambda: bb.scan_checksum(Yd, Gd, K32,
                                                                  precision=bt.BALANCED)))
    check(_total(counts, "liteqtl_lod.*") > 0,
          f"biobank --full did not launch the LOD kernel: {counts}")
    launches["biobank_scan"] = counts
    print(f"  {json.dumps(bb.bulkscan_line(n, p, m, dt, eigh_s, 0))} on {card}")

    Gb = Gd[:, :BIOBANK_BLOCK].contiguous()
    bal = bt.bulkscan(Yd, Gb, dec, precision=bt.BALANCED)
    exact = bt.bulkscan(Yd, Gb, dec, precision=bt.EXACT64)
    same = exact.h2_null_list == bal.h2_null_list.double()
    err = _max_abs_diff_cols(bal.L, exact.L, same)
    bar = ORACLE_BAR * n / N
    print(f"  BALANCED vs EXACT64 on the first {BIOBANK_BLOCK} markers (float64 factors): "
          f"{int((~same).sum())} of {m} traits with another grid h2; max|dLOD| on the rest = "
          f"{err:.3e} (bar {bar:.2e}; BASELINE.md's {PARITY_BAR:.0e}: "
          f"{'met' if err <= PARITY_BAR else 'NOT met'})")
    check(err <= bar, "BALANCED strays from EXACT64 at n = 5,000")
    del bal, exact, Gb
    torch.cuda.empty_cache()

    Yp = Yd[:, :DRIVER_PERM_TRAITS]
    idx = permutation_indices(n, DRIVER_PERMS, 0)  # the driver's rndseed
    exact = bt.bulkscan_perms(Yp, Gd, dec, nperms=DRIVER_PERMS, precision=bt.EXACT64, perm_idx=idx)
    for name, prec, pbar in (("BALANCED", bt.BALANCED, ORACLE_BAR),
                             ("THROUGHPUT", bt.THROUGHPUT, THROUGHPUT_BAR)):
        run = lambda prec=prec: float(bt.bulkscan_perms(  # noqa: E731
            Yp, Gd, K32, nperms=DRIVER_PERMS, precision=prec).maxlods.sum())
        dt, counts = _drive(f"biobank --full --perms {DRIVER_PERMS} --perm-traits "
                            f"{DRIVER_PERM_TRAITS}, {name}, warm-up and timed call",
                            lambda run=run: bb.timed(run),
                            "bf16x3" if prec is bt.THROUGHPUT else "tf32x3")
        check(_total(counts, "bulkperm_maxr2.*") > 0,
              f"the {name} permutation run launched {counts}")
        launches[f"biobank_perms_{name.lower()}"] = counts
        print(f"  {json.dumps(bb.bulkperms_line(n, p, DRIVER_PERM_TRAITS, DRIVER_PERMS, dt, eigh_s, 0))}"
              f" on {card}")
        res = bt.bulkscan_perms(Yp, Gd, dec, nperms=DRIVER_PERMS, precision=prec, perm_idx=idx)
        same = exact.h2_null_list == res.h2_null_list.double()
        err = (res.maxlods.double() - exact.maxlods)[same].abs().max().item()
        bar = pbar * n / N
        print(f"  {name} vs EXACT64 (plain engine, the same indices, float64 factors): "
              f"{int((~same).sum())} of {DRIVER_PERM_TRAITS} traits with another grid h2; max|dLOD| "
              f"on the rest = {err:.3e} (bar {bar:.2e}; BASELINE.md's {PARITY_BAR:.0e} reported)")
        check(0 < err <= bar, f"{name} bulkscan_perms strays from EXACT64 at n = 5,000")
        del res
    print(f"  phase 18 (b) took {time.perf_counter() - t0:.1f} s")
    del Gd, Yd, Yp, K32, dec, exact
    torch.cuda.empty_cache()
    return launches


def cohort_compare_full(dev, card) -> dict:
    """Phase 18 (c): ``lowrank_cohort --compare-full`` under BALANCED at a
    cut size, the full-rank scan against EXACT64 on the same factors.
    Returns the path's launch counts."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch import lowrank_cohort as lc

    t0 = time.perf_counter()
    n = COHORT_CUT_N
    G, Y = lc.cohort(n, COHORT_CUT_P, COHORT_CUT_M, device=dev)
    out, counts = _drive(f"lowrank_cohort --n {n} --p {COHORT_CUT_P} --m {COHORT_CUT_M} --k "
                         f"{COHORT_CUT_K} --compare-full, BALANCED",
                         lambda: lc.drive(G, Y, COHORT_CUT_K, compare_full=True,
                                          precision=bt.BALANCED, log=lambda s: print(f"  {s}")))
    check(_total(counts, "liteqtl_lod.*") > 0,
          f"the full-rank scan did not launch the LOD kernel: {counts}")
    h2 = out["full"].h2_null_list
    print(f"  the full-rank grid h2: {int((h2 == 0).sum())} of {COHORT_CUT_M} traits at 0, the "
          f"largest {h2.max().item():.1f}")
    exact = bt.bulkscan(Y, G, out["decomp"], precision=bt.EXACT64)
    same = exact.h2_null_list == h2.double()
    err = _max_abs_diff_cols(out["full"].L, exact.L, same)
    bar = ORACLE_BAR * n / N
    print(f"  full-rank BALANCED vs EXACT64 at n = {n}: {int((~same).sum())} traits with another "
          f"grid h2; max|dLOD| on the rest = {err:.3e} (bar {bar:.2e}; BASELINE.md's "
          f"{PARITY_BAR:.0e}: {'met' if err <= PARITY_BAR else 'NOT met'})")
    check(err <= bar, "the cohort's full-rank BALANCED scan strays from EXACT64")
    print(f"  phase 18 (c) took {time.perf_counter() - t0:.1f} s on {card}")
    del G, Y, out, exact
    torch.cuda.empty_cache()
    return {"cohort_full_rank": counts}


def measurement_drivers(dev, card) -> dict:
    """Phase 18: the three measurement drivers on the card. Returns each
    kernel's launches in them, by path."""
    t0 = time.perf_counter()
    print("[18a] throughput_fwer: the FWER study and the engine table")
    launches = fwer_study(dev, card)
    print("[18b] biobank --full, then --perms 256 --perm-traits 128")
    launches |= biobank_full(dev, card)
    print("[18c] lowrank_cohort --compare-full at a cut size")
    launches |= cohort_compare_full(dev, card)
    print(f"  phase 18 took {time.perf_counter() - t0:.1f} s")
    return launches


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
    t_start = time.perf_counter()
    import_port()
    print("[1] device check")
    card = device_check()
    dev = torch.device("cuda", 0)
    print("[2] build")
    report, serialized, injected = build()
    check(bool(report), "the build left no ptxas report")
    print("[2b] the accumulate probe: how the tensor cores finish a float32 sum")
    accumulate_probe(dev)
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
    med, lod_shapes = times(card, Yd, Gd, K, lod_ops, alt_ops)
    pmed = perm_times(card, Yd, Gd, K, prep, idx, perm_ops)
    print(f"[9] single-trait scan: BXD width ({N} x {P}) and cohort size ({COHORT_N} x {COHORT_P})")
    del prep, idx
    single_trait(dev, card, Gd, K, Yd[:, :1].cpu().numpy())
    import_port()  # the single-trait path imported no jax either
    print(f"[10] bulk options at BXD scale ({N} x {P} x {M}): output_effects, missing, memory "
          "sizing and host blocks, marker streaming")
    eff_ops, eff_times = bulk_options_at_bxd(dev, card, Yd, Gd, K)
    print(f"[11] marker streaming at biobank n ({BIOBANK_N} x {BIOBANK_P} x {BIOBANK_M})")
    lod_shapes["S4"] = streaming_at_biobank_n(dev, card)
    print("[10, last] the memory model's live sets")
    calibrate_memory(dev, Yd, Gd, K)
    print(f"[12] the low-rank engine: rank {N} at BXD scale, rank {LR_RANK} at {LR_N} x {LR_P} x "
          f"{LR_M}")
    lowrank_engine(dev, card, Yd, Gd, K)
    print(f"[13] LOCO, the file readers and the CLI at BXD scale ({N} x {P} x {M}, "
          f"{len(MOUSE_CHROMS)} chromosomes)")
    loco = loco_io_cli(dev, card, Yd, Gd, K)
    print(f"[14] the device mesh at BXD scale ({N} x {P} x {M}): make_mesh(), a virtual 2 x 2 "
          "mesh on the card, a two-process pod, streaming and LOCO on the mesh")
    mesh = device_mesh(dev, card, Yd, Gd, K)
    print(f"[15] wide covariates: the wide LOD kernel at c in {WIDE_COVARIATES}, and c = {WIDE_C} "
          f"scans at BXD scale ({N} x {P} x {M})")
    wide_kernel_checks(dev)
    wide = wide_at_bxd(dev, card, Yd, Gd, K)
    print("[16] the validation sweep (python -m bulklmm_tpu_torch.validation)")
    validation_sweep(card)
    print("[17] THROUGHPUT on the card: the bf16x3 kernels vs their bf16x3 plain versions, THROUGHPUT "
          f"at BXD scale ({N} x {P} x {M}) against EXACT64, times beside the 3 x TF32 twins")
    kernel_readings = throughput_kernel_checks(dev)
    tp = throughput_at_bxd(dev, card, Yd, Gd, K, lod_ops, alt_ops, perm_ops, {
        "liteqtl_lod": lod_launches, "altgrid": alt_launches, "bulkperm_maxr2": perm_launches})
    chunked = throughput_chunked(dev, card, Yd, Gd, K)
    for path, readings in kernel_readings.items():
        chunked[path]["kernel_checks"] = readings
    torch.cuda.empty_cache()
    print("[18] the measurement drivers: throughput_fwer, biobank --full, lowrank_cohort "
          "--compare-full")
    drivers = measurement_drivers(dev, card)
    import_port()
    kernels = [{
        "name": "liteqtl_lod",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/liteqtl_fused.cu",
        "replaces": "bulklmm_tpu/pallas/liteqtl_fused.py:106",
        "launches": lod_launches,
        "loco_launches": loco["null-grid"],
        "mesh_launches": mesh["liteqtl_lod"],
        "max_abs_err": lod_err,
        "ms": med["LOD kernel alone"],
        "plain_ms": med["LOD plain version"],
        "general_kernel_ms": med["LOD general kernel alone"],
        "effects_ms": eff_times["kernel"],
        "effects_plain_ms": eff_times["plain"],
        "effects_bound_ms": _bound(2.0 * N * P * M * (lod_ops[1].shape[1] + 2), eff_ops,
                                   3 * 4 * P * M)["bound_ms"],
        "wide_c": WIDE_C,
        "wide_launches": wide["null-grid"][0],
        "wide_ms": wide["kernel"]["ms"],
        "wide_plain_ms": wide["kernel"]["plain_ms"],
        "wide_bound_ms": wide["kernel"]["bound"]["bound_ms"],
        "wide_simt_bound_ms": wide["kernel"]["bound"]["simt_bound_ms"],
        "wide_max_abs_err": wide["kernel"]["err"],
        "shapes": {name: lod_shapes[name] if name in lod_shapes else wide["shapes"][name]
                   for name in SMOKE_SHAPES},
        "bf16x3_chunked": chunked,
        "bound": _bound(2.0 * N * P * M * (lod_ops[1].shape[1] + 2), lod_ops, 4 * P * M),
    }, {
        "name": "altgrid",
        "route": "cuda",
        "source": "bulklmm_tpu_torch/csrc/altgrid_fused.cu",
        "replaces": "bulklmm_tpu/pallas/altgrid_fused.py:177",
        "launches": alt_launches,
        "loco_launches": loco["alt-grid"],
        "mesh_launches": mesh["altgrid"],
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
        "loco_launches": loco["perms"],
        "mesh_launches": mesh["bulkperm_maxr2"],
        "max_abs_err": perm_err,
        "ms": pmed["kernel"],
        "plain_ms": pmed["plain"],
        "product_only_ms": pmed["product_only"],
        "bound": _bound(2.0 * N * P * PERM_BLOCK * (NPERMS + 1), perm_ops, 4 * PERM_BLOCK * (NPERMS + 1)),
    }]
    for k, short in zip(kernels, ("lod", "alt", "perm")):
        k.update(k.pop("bound"))
        k.update({"bf16x3_launches": tp[f"{short}_launches"], "bf16x3_max_abs_err": tp[f"{short}_err"],
                  "throughput_vs_exact64": tp[f"{short}_vs_exact64"], **tp[k["name"]],
                  "throughput_effects_vs_exact64": tp["effects_vs_exact64"] if short == "lod" else None})
        k["library_ms"] = None  # no single PyTorch call computes this function
        launched = {path: _total(c, k["name"] + ".*") for path, c in drivers.items()}
        k["drivers_launches"] = {path: v for path, v in launched.items() if v}
        k.setdefault("product_only_ms", None)  # timed for the permutation kernel alone
        k.setdefault("general_kernel_ms", None)  # the LOD kernel's other path at the same shape
        k.setdefault("shapes", None)  # the LOD kernel's general and wide paths, S1-S6
        k.setdefault("bf16x3_chunked", None)  # their bf16x3 instantiations
        for key in ("effects_ms", "effects_plain_ms", "effects_bound_ms", "wide_c", "wide_launches",
                    "wide_ms", "wide_plain_ms", "wide_bound_ms", "wide_simt_bound_ms",
                    "wide_max_abs_err"):
            k.setdefault(key, None)  # the LOD kernel's effects variant and wide kernel
        share = 100 * k["bound_ms"] / k["ms"]
        print(f"  {k['name']}: {k['ms']:.3f} ms per launch, bound {k['bound_ms']:.3f} ms by "
              f"{k['bound_unit']} ({k['simt_bound_ms']:.3f} ms on the CUDA cores; the kernel runs "
              f"at {share:.1f} % of the bound's rate), {k['launches']} launches on its path")
        check(share <= 100.0, f"{k['name']} runs faster than its bound")
    check_ptxas(report, serialized, injected)
    check(not _PARITY_FAILED, f"BASELINE.md's bar is not met on {_PARITY_FAILED}")
    print(f"chip_smoke took {time.perf_counter() - t_start:.1f} s on {card}")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
