"""Device-memory sizing of the bulk scan engines.

Counterpart of ``bulklmm_tpu/utils/memory.py``. When ``trait_chunk`` or
``marker_block`` is not given, the engines size them from the device's free
memory and a footprint model, so that the default call does not run out of
device memory: small problems stay one block, larger ones take a trait
chunk, and a (p, m) result that cannot live on the device goes to host
trait blocks (:func:`auto_host_block`) or marker streaming
(:func:`auto_marker_block`). All sizes are bytes.

The model is a handful of linear terms: the chunk-independent residents,
and per trait of a chunk some (p,)- and (n,)-sized live copies. Its
multipliers were measured on an NVIDIA H100 with
``torch.cuda.max_memory_allocated`` (``chip_smoke.py`` phase 10 prints the
live sets it measures beside the model); they state how many (p, m) and
(n, m) arrays of the preset's widest dtype a call holds at its peak beyond
the residents. Two faults of the JAX package's module are not carried over:
the budget is read from the device (no fixed 16 GiB when the backend
reports nothing), and host blocks are charged two blocks' outputs, since one
block's outputs are copied to the host while the next block runs.
"""

from __future__ import annotations

import collections
import os

import torch

from .profiling import span

#: share of the free device memory the model may plan for: the caching
#: allocator rounds every block up (to 2 MiB segments for large ones) and
#: fragments; the forced-budget run of ``chip_smoke.py`` phase 10 checks
#: that a call planned at this share stays under its budget
_USABLE_FRACTION = 0.9

#: headroom on the chunk-independent residents (short-lived copies around
#: the largest buffers: the casts of the (p, m) result)
_STATIC_HEADROOM = 1.1

#: (p,)-sized live copies a trait of a chunk holds beyond its outputs, in
#: the widest dtype, at c = 1. Measured on an H100 at 79 x 7,321 x 8,192,
#: c = 1 (chip_smoke.py phase 10, peak device memory above the inputs):
#: EXACT64 null-grid 7.07 (the plain path's (c + 2) products and their
#: combines, the most of any path), with effects 6.05, alt-grid EXACT64
#: 3.55, BALANCED alt-grid 2.15; the LOD kernel's paths (BALANCED null-grid,
#: null-exact) below their outputs
_P_CHUNK_COPIES = 8

#: (p,)-sized copies more for each covariate column past the first: the
#: plain LOD step holds its U_k and Z_k products, (p, m) each
_P_COPIES_A_COVARIATE = 2

#: (n,)-sized live copies a trait of a chunk holds beyond the rotated
#: traits (weights, weighted traits, the grid likelihoods' and the Brent
#: fit's temporaries), per pair of covariate columns. Measured on an H100 at
#: 2,000 x 64 x 8,192, c = 1: null-exact BALANCED 7.07, null-grid 4.05
#: (BALANCED) and 4.02 (EXACT64); more covariate columns are not measured
_N_CHUNK_COPIES = 12

#: (n,)-sized live copies a trait holds per covariate column on the wide LOD
#: kernel's route (the float32 presets' fused LOD step at c >= :data:`WIDE_FROM`):
#: its (c, n, m) float32 operand and its preparation in the solve dtype (the
#: whitened covariates, their weighted product and one temporary), in the
#: widest dtype. Measured on an H100 at 706 x 20,000 x 20,000, c = 69, BALANCED
#: null-grid in one trait chunk: peak 16.44 GB, 812 KB a trait, 2.09 such
#: copies a column with everything else a trait holds (two float64 (c, n)
#: arrays live at once in the whitening); at 2,000 x 64 x 8,192, c = 4: 10.0
#: (n,)-sized copies in all (chip_smoke.py phase 10)
_WIDE_N_COPIES = 3

#: (p,)-sized live copies a trait holds on the wide kernel's route beyond its
#: outputs, in the widest dtype: the kernel holds none of the plain step's U_k
#: and Z_k, only its chunk's float32 (p,) result (0.5); its plain version on the
#: CPU holds B, D1, N, D and one Z_k at a time in float32 (~3)
_WIDE_P_COPIES = 3

#: the covariate count from which the LOD step takes the wide kernel
#: (``kernels/liteqtl_fused.py::GENERAL_COVARIATES`` + 1)
WIDE_FROM = 4

#: (n,)-sized live copies a trait holds per h2 grid point on the alt-grid
#: kernel's path: its (g, n, m) operands and their preparation. Measured on
#: an H100 at 2,000 x 64 x 8,192 with the 10-point grid: 41.08 in all, 4.1 a
#: grid point
_ALT_GRID_N_COPIES = 5

#: (p,)-sized live copies a trait of a chunk holds on the rank-k engine
#: (``ops/lowrank.py``) beyond its outputs, in the widest dtype: the (p, m)
#: base product X'Y and the Woodbury corrections, (c + 2) panels with their
#: combines, or alt-grid's running maxima and one grid step's panels.
#: Measured on an NVIDIA H100 (chip_smoke.py phase 12, 79 x 7,321 x 8,192,
#: rank 79): at most 8.57, EXACT64 alt-grid (BALANCED 3.54)
_LR_P_CHUNK_COPIES = 10

#: (k,)-sized live copies a trait holds on the rank-k engine: its
#: projections and corrections, and null-exact's Brent lanes (a factor
#: vector a lane and its products). Measured as above at 2,000 x 64 x 8,192,
#: rank 2,000: at most 3.16, BALANCED null-exact
_LR_K_CHUNK_COPIES = 4

#: trait tile of the CUDA kernels: chunks are whole tiles
TRAIT_QUANTUM = 64


def device_memory_budget(device=None) -> int:
    """Bytes the engines may plan for on ``device`` (default: the current
    CUDA device, else the CPU).

    On a CUDA device: the free memory (``torch.cuda.mem_get_info``) plus what
    the caching allocator holds reserved but unallocated, which it hands out
    again before it asks the device, times :data:`_USABLE_FRACTION`. On the
    CPU: half of the host's RAM (the host side of a run holds the other
    copy).
    """
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type == "cuda":
        with span("bulklmm.sync.mem_get_info"):
            free, _ = torch.cuda.mem_get_info(device)
        cached = torch.cuda.memory_reserved(device) - torch.cuda.memory_allocated(device)
        return int((free + cached) * _USABLE_FRACTION)
    return os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") // 2


def mesh_position_budget(devices) -> int:
    """Bytes the tile of one position of a device mesh may plan for.

    A device that a mesh names r times (a virtual mesh such as
    ``[cuda:0] * 4``) holds the tiles of all r positions, so each position
    gets its :func:`device_memory_budget` divided by r; otherwise a virtual
    mesh on one card would size every tile for the whole card. The least
    such share over the mesh's devices, so that one tile width fits every
    position.
    """
    counts = collections.Counter(torch.device(d) for d in devices)
    return min(device_memory_budget(d) // r for d, r in counts.items())


def bulkscan_static_bytes(n: int, p: int, m: int, c: int, itemsize: int, *, n_outputs: int = 1) -> int:
    """Device-resident bytes independent of the trait chunk: the marker
    panel and its rotation (2 x (n, p)), the eigenvectors (n, n), the traits
    and their rotation (2 x (n, m)), the covariates, and ``n_outputs``
    (p, m) results (L; +1 for alt-grid's h2 panel, +2 with effects, +1 with
    p-values)."""
    return itemsize * (2 * n * p + n * n + 2 * n * m + 2 * n * c + n_outputs * p * m)


def bulkscan_chunk_bytes(n: int, p: int, mc: int, grid: int, c: int, itemsize: int,
                         *, alt_grid: bool = False, kernel: bool = False) -> int:
    """Modelled live temporaries of one trait chunk of ``mc`` traits;
    ``alt_grid`` adds the alt-grid path's (g, n)-sized operands a trait.
    ``kernel`` (the null methods' LOD step on the fused kernel's route, the
    float32 presets) at c >= :data:`WIDE_FROM` takes the wide LOD kernel's
    live set instead of the plain step's: its (c, n) operand and whitening a
    trait, and none of the plain step's per-covariate (p,) products."""
    per_grid_point = 1 + (_ALT_GRID_N_COPIES * n if alt_grid else 0)
    if kernel and c >= WIDE_FROM and not alt_grid:
        return itemsize * mc * (_WIDE_P_COPIES * p + (_N_CHUNK_COPIES + _WIDE_N_COPIES * c) * n
                                + grid)
    p_copies = _P_CHUNK_COPIES + _P_COPIES_A_COVARIATE * (c - 1)
    return itemsize * mc * (
        p_copies * p + _N_CHUNK_COPIES * n * max(1, (c + 2) // 2) + grid * per_grid_point
    )


def lowrank_static_bytes(n: int, p: int, m: int, c: int, k: int, itemsize: int, *,
                         n_outputs: int = 1) -> int:
    """Chunk-independent device residents of the rank-k engine: the marker
    panel and its cast (2 x (n, p)), the factor U (n, k), the traits and
    their cast (2 x (n, m)), the covariates, the marker-side parts (U'X
    (k, p), X'C and the marker norms) and ``n_outputs`` (p, m) results. No
    (n, n) array exists."""
    return itemsize * (2 * n * p + n * k + 2 * n * m + 2 * n * c + k * p + (c + 1) * p
                       + n_outputs * p * m)


def lowrank_chunk_bytes(n: int, p: int, k: int, mc: int, grid: int, itemsize: int) -> int:
    """Modelled live temporaries of one trait chunk of ``mc`` traits on the
    rank-k engine."""
    return itemsize * mc * (_LR_P_CHUNK_COPIES * p + _LR_K_CHUNK_COPIES * k + 2 * n + grid)


def _footprint(n, p, m, c, itemsize, n_outputs, grid, alt_grid, rank, kernel):
    """(static bytes, bytes of a chunk of ``mc`` traits as a function) of
    the rotated engine, or of the rank-k engine when ``rank`` is given."""
    if rank is None:
        static = bulkscan_static_bytes(n, p, m, c, itemsize, n_outputs=n_outputs)
        return static, lambda mc: bulkscan_chunk_bytes(n, p, mc, grid, c, itemsize,
                                                       alt_grid=alt_grid, kernel=kernel)
    static = lowrank_static_bytes(n, p, m, c, rank, itemsize, n_outputs=n_outputs)
    return static, lambda mc: lowrank_chunk_bytes(n, p, rank, mc, grid, itemsize)


def _whole_tiles(width: int, m: int) -> int:
    return min((width // TRAIT_QUANTUM) * TRAIT_QUANTUM, m)


def auto_trait_chunk(n: int, p: int, m: int, *, grid: int = 10, c: int = 1, itemsize: int = 4,
                     n_outputs: int = 1, alt_grid: bool = False, budget: int | None = None,
                     device=None, rank: int | None = None, kernel: bool = False) -> int | None:
    """Trait-chunk width of the in-memory ``bulkscan``; ``rank`` (k) sizes
    the rank-k engine's instead of the rotated one's; ``kernel`` as for
    :func:`bulkscan_chunk_bytes`.

    None when the whole problem fits in one block; else the widest chunk of
    whole 64-trait tiles (the CUDA kernels' trait tile; no wider quantum is
    needed) whose modelled footprint fits the budget. Raises, naming the
    ways out, when the chunk-independent residents alone leave no room for
    one tile: no chunk can save a (p, m) result that does not fit, but host
    trait blocks (:func:`auto_host_block`) or marker streaming can.
    """
    if budget is None:
        budget = device_memory_budget(device)
    static, chunk = _footprint(n, p, m, c, itemsize, n_outputs, grid, alt_grid, rank, kernel)
    static = int(static * _STATIC_HEADROOM)
    if static + chunk(m) <= budget:
        return None
    mc = int((budget - static) // chunk(1))
    if mc < TRAIT_QUANTUM:
        raise ValueError(
            f"bulkscan at n={n}, p={p}, m={m} needs ~{static / 1e9:.1f} GB of "
            f"chunk-independent device residents against a ~{budget / 1e9:.1f} GB "
            "budget: no trait_chunk fits. Use bulkscan_streamed (the panel on "
            "the host, a memmap output) or host trait blocks "
            "(utils/memory.py::auto_host_block)."
        )
    return _whole_tiles(mc, m)


def auto_host_block(n: int, p: int, m: int, *, grid: int = 10, c: int = 1, itemsize: int = 4,
                    n_outputs: int = 1, alt_grid: bool = False, budget: int | None = None,
                    device=None, rank: int | None = None, kernel: bool = False) -> int:
    """Traits of one sequential device call when the (p, m) result lives on
    the host. The device holds the marker-side residents and the whole
    trait matrix, and per trait of a block its chunk temporaries and
    ``n_outputs`` (p,) results of TWO blocks: the one being copied to the
    host and the next one, running. ``rank`` and ``kernel`` as for
    :func:`auto_trait_chunk`."""
    if budget is None:
        budget = device_memory_budget(device)
    static, chunk = _footprint(n, p, 0, c, itemsize, n_outputs, grid, alt_grid, rank, kernel)
    base = int((static + 2 * n * m * itemsize) * _STATIC_HEADROOM)
    per_trait = chunk(1) + int(
        2 * n_outputs * p * itemsize * _STATIC_HEADROOM
    )
    mh = int((budget - base) // per_trait)
    if mh < TRAIT_QUANTUM:
        raise ValueError(
            f"even one {TRAIT_QUANTUM}-trait host block overflows the ~{budget / 1e9:.1f} GB "
            f"device budget at n={n}, p={p}: stream markers instead (bulkscan_streamed)."
        )
    return _whole_tiles(mh, m)


def auto_marker_block(n: int, m: int, *, itemsize: int = 4, n_outputs: int = 1,
                      budget: int | None = None, default: int = 32_768, device=None,
                      rank: int | None = None) -> int:
    """Marker-block width of the streamed engines. The device holds the
    trait-side residents (the eigenvectors and four (n, m) copies) and, per
    marker of a block, the uploaded and rotated block of two blocks in
    flight (2 x 2 x (n,)), ``n_outputs`` (m,) output rows and about four
    more (m,)-sized kernel temporaries. On the rank-k engine (``rank`` = k)
    the (n, k) factor takes the eigenvectors' place and a marker holds its
    (k,) projection and the rank-k step's (m,)-sized live set
    (:data:`_LR_P_CHUNK_COPIES`). The familiar default when it fits; else
    multiples of 1,024 markers, never fewer."""
    if budget is None:
        budget = device_memory_budget(device)
    if rank is None:
        trait_side = itemsize * (n * n + 4 * n * m)
        per_marker = itemsize * (2 * 2 * n + (n_outputs + 4) * m)
    else:
        trait_side = itemsize * (n * rank + 4 * n * m + rank * m)
        per_marker = itemsize * (2 * 2 * n + rank + (n_outputs + _LR_P_CHUNK_COPIES) * m)
    if budget - trait_side < per_marker * 1024:
        raise ValueError(
            f"bulkscan_streamed trait-side residents at n={n}, m={m} need "
            f"~{trait_side / 1e9:.1f} GB against a ~{budget / 1e9:.1f} GB budget: no "
            "marker block fits. Split the traits across calls."
        )
    blk = max(1024, min(int((budget - trait_side) // per_marker), 1 << 20))
    return default if blk >= default else (blk // 1024) * 1024
