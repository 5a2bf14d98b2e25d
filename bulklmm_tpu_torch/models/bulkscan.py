"""Multi-trait bulk genome scans: null-grid, null-exact and alt-grid.

Counterpart of ``bulklmm_tpu/models/bulkscan.py`` (reference ``bulkscan``,
src/bulkscan.jl:81-162, and its three engines). Every method runs, in
order: argument checks, optional heteroskedastic weights (host float64),
the intercept, the host float64 kinship eigendecomposition, three rotation
products, then its engine, over blocks of traits when ``trait_chunk`` is an
int:

- **null-grid** (src/bulkscan.jl:321-397): the (g x m) null log-likelihood
  grid in the kernel dtype, a per-trait argmax over h2 (:func:`_null_h2`),
  then the per-trait-weight correlation -> LOD step;
- **null-exact** (src/bulkscan.jl:188-313): a batched Brent fit of every
  trait's h2 (``ops/lmm.py::fit_h2_traits``), then the same LOD step;
- **alt-grid** (src/bulkscan.jl:428-527): for each grid h2, the shared-h2
  scan and null likelihoods, with a running max of the alternative
  log-likelihood per (marker, trait) and its true argmax (the reference's
  ``tmax!`` counter bug is fixed, COMPAT.md #8).

The LOD step of the null methods is decided by precision and device only:
under float32 products and combines (FAST32, BALANCED, THROUGHPUT) the
fused kernel, ``kernels/liteqtl_fused.py`` (the CUDA kernel on CUDA tensors,
its plain version on CPU tensors); otherwise (MIXED, EXACT64) plain
``ops/liteqtl.py::lods_per_trait`` in the preset's own dtypes.

The alt-grid engine is chosen by ``engine``, in :func:`takes_cuda_kernel`,
the one rule of ``engine=`` (the permutation sweep's too): "pallas" is the
CUDA kernel ``kernels/altgrid_fused.py`` (float32 products, CUDA tensors,
else a ``ValueError``); "auto" takes it on CUDA tensors under a float32 GEMM
dtype and the plain path otherwise; "xla" is always the plain path.

``output_effects=True`` (null methods) adds each (marker, trait) GLS effect
and its standard error from the same LOD step: the kernel's effects variant
under the float32 presets, ``ops/liteqtl.py::lods_and_effects_per_trait``
otherwise. ``missing="mask"/"drop"`` runs each missingness pattern as its own
call (``models/missing.py``). ``trait_chunk=None`` sizes the trait blocks
from the device's free memory (``utils/memory.py``); a (p, m) result that
cannot live on the device is assembled on the host from sequential trait
blocks (:func:`_host_blocked_bulkscan`).

A ``LowRankKinship`` (``ops/lowrank.py``; anything with ``U`` and ``lam``)
takes the rank-k engine in place of the rotation: all three methods,
effects, trait chunks, masks and host blocks, on plain products (the JAX
package's engine is XLA-only too, and ``engine="pallas"`` raises its
``ValueError``). Its trait chunks are sized from the rank-k live set
(``utils/memory.py``).

:func:`bulkscan_sharded` runs the same engine (:func:`_bulkscan_on_mesh`)
on a device mesh (``tiles.py``); ``bulkscan`` is that engine on a mesh of
one position, apart from its host trait blocks.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..kernels.altgrid_fused import fused_alt_grid
from ..kernels.liteqtl_fused import fused_lods_and_effects_per_trait, fused_lods_per_trait
from ..ops.liteqtl import lods_and_effects_per_trait, lods_per_trait, lods_shared
from ..ops.lmm import fit_h2_traits
from ..ops.lod import lod2log10p
from ..ops.lowrank import _bulkscan_lowrank_core, _trait_fit_lowrank, as_lowrank, is_lowrank
from ..ops.rotation import KinshipDecomposition, decompose_kinship, resolve_kinship
from ..ops.stats import check_covar_full_rank
from ..ops.weights import make_weights
from ..ops.wls import wls_ell
from ..utils import memory
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import PinnedCopies, to_device, to_numpy
from ..utils.profiling import span, spanned
from .missing import (
    _ncov_total, finite_flag, maybe_masked, raise_if_missing, subset_kinship,
    validate_missing_kwarg,
)
from .results import BulkScanResult
from .scan import _apply_weights, _refuse_weights_on_factors
from .tiles import (
    MARKERS_AXIS, TRAITS_AXIS, Mesh, _core_trait_chunks, _marker_shards, _per_device, make_mesh,
)

_LN10 = math.log(10.0)


def grid_null_ell(Y0, X0_cov, lam, h2_grid, prior, *, reml=False) -> torch.Tensor:
    """(g, m) null-model log-likelihoods over the h2 grid: one weighted
    least-squares likelihood per grid point, batched over the grid."""
    return wls_ell(Y0, X0_cov, make_weights(h2_grid, lam), prior, reml=reml)[0]


def _uses_kernel(precision: PrecisionConfig) -> bool:
    return (
        precision.resolve_gemm() == torch.float32
        and precision.resolve_kernel() == torch.float32
    )


def _lod_step(Y0, X0m, C0, lam, h2_list, precision):
    """(p, m) LOD with one h2 per trait: the fused kernel's entry under
    float32 products and combines, the plain float64-combine path otherwise."""
    if _uses_kernel(precision):
        return fused_lods_per_trait(Y0, X0m, C0, lam, h2_list, precision.gemm_precision)
    return lods_per_trait(Y0, X0m, C0, lam, h2_list, precision=precision)


def _lod_effects_step(Y0, X0m, C0, lam, h2_list, precision):
    """(L, beta, se), each (p, m), from one pass: the kernel's effects
    variant where :func:`_lod_step` takes the kernel, the plain effects
    otherwise."""
    if _uses_kernel(precision):
        return fused_lods_and_effects_per_trait(Y0, X0m, C0, lam, h2_list,
                                                precision.gemm_precision)
    return lods_and_effects_per_trait(Y0, X0m, C0, lam, h2_list, precision=precision)


def _lod_outputs(Y0, X0m, C0, lam, h2_list, precision, effects):
    """(L, h2_list), or (L, h2_list, beta, se) with ``effects``."""
    if effects:
        L, beta, se = _lod_effects_step(Y0, X0m, C0, lam, h2_list, precision)
        return L, h2_list, beta, se
    return _lod_step(Y0, X0m, C0, lam, h2_list, precision), h2_list


def _grid_h2(Y0, C0, lam, h2_grid, *, prior, reml, precision):
    """Each trait's grid h2: the grid likelihoods in the kernel dtype, as in
    the JAX package (float32 under BALANCED), then the first argmax."""
    kdt = precision.resolve_kernel()
    ells = grid_null_ell(
        Y0.to(kdt), C0.to(kdt), lam.to(kdt), h2_grid.to(kdt), prior, reml=reml
    )
    return h2_grid[torch.argmax(ells, dim=0)]  # first max wins


def _alt_grid_impl(Y0, X0m, C0, lam, h2_grid, *, prior, reml, precision):
    """(L, h2_panel) for one block of traits, the plain formulation: per
    grid step the shared-h2 LODs and null likelihoods, and (p, m) running
    maxima of the alternative log-likelihood carried in Y0's dtype."""
    p, m = X0m.shape[1], Y0.shape[1]
    dt = Y0.dtype
    logL1_max = torch.full((p, m), -math.inf, dtype=dt, device=Y0.device)
    kmax = torch.zeros((p, m), dtype=torch.int32, device=Y0.device)
    logL0_max = torch.full((m,), -math.inf, dtype=dt, device=Y0.device)
    for k in range(h2_grid.shape[0]):
        h2 = h2_grid[k]
        lod_k = lods_shared(Y0, X0m, C0, lam, h2, precision=precision)
        ell0 = wls_ell(Y0, C0, make_weights(h2, lam), prior, reml=reml)[0]
        logL1 = lod_k * _LN10 + ell0[None, :]
        upd = logL1 > logL1_max  # strict: the first maximum wins
        logL1_max = torch.where(upd, logL1, logL1_max)
        kmax.masked_fill_(upd, k)
        logL0_max = torch.maximum(logL0_max, ell0)
        del lod_k, logL1, upd
    L = (logL1_max - logL0_max[None, :]) / _LN10
    return L, h2_grid[kmax]


@spanned("bulklmm.prep.null_fit")
def _null_h2(method, Y0, C0, lam, h2_grid, *, prior, reml, optim_interval, precision):
    """Each trait's null h2 from the rotated traits: the grid argmax
    (:func:`_grid_h2`) or, for null-exact, a batched Brent fit in the solve
    dtype. No marker moves it, so a scan fits it once (on a mesh, once a
    trait shard) and the LOD step takes it."""
    if method == "null-exact":
        return fit_h2_traits(Y0, C0, lam, prior, reml=reml, optim_interval=optim_interval)
    return _grid_h2(Y0, C0, lam, h2_grid, prior=prior, reml=reml, precision=precision)


def _chunked(impl, Y0, trait_chunk, *per_trait):
    """``impl(Y0, *per_trait)`` for an int ``trait_chunk``: trait blocks of
    that width in turn (of Y0 and of each (m,) ``per_trait`` tensor), each
    written into one preallocated output per result (the traits are each
    result's last axis; a None result stays None). Each block, or the one
    block, runs under a ``bulklmm.entry.chunk`` span with its width."""
    m = Y0.shape[1]
    if trait_chunk is None or trait_chunk >= m:
        with span("bulklmm.entry.chunk", {"traits": m}):
            return impl(Y0, *per_trait)
    outs = None
    for s in range(0, m, trait_chunk):
        with span("bulklmm.entry.chunk", {"traits": min(trait_chunk, m - s)}):
            res = impl(Y0[:, s : s + trait_chunk], *(a[s : s + trait_chunk] for a in per_trait))
            if outs is None:
                outs = tuple(
                    None if r is None
                    else torch.empty(r.shape[:-1] + (m,), dtype=r.dtype, device=r.device)
                    for r in res
                )
            for o, r in zip(outs, res):
                if o is not None:
                    o[..., s : s + trait_chunk] = r
    return outs


class KernelTexts(NamedTuple):
    """What the refusals of ``engine="pallas"`` say of one kernel, which
    differ between the alt-grid scan and the permutation sweep as the JAX
    package's do: the kernel's name, what it needs and the advice in the
    CUDA refusal, and the reason in the rank-k one."""

    kernel: str
    needs: str
    advice: str
    lowrank: str


ALT_GRID_TEXTS = KernelTexts(
    kernel="fused alt-grid CUDA kernel", needs="tensors on a CUDA device",
    advice="use engine='xla' (or call kernels.altgrid_fused.fused_alt_grid_reference for "
           "the kernel's plain version).",
    lowrank="(the rank-k engine is XLA-only)",
)

PERM_TEXTS = KernelTexts(
    kernel="fused CUDA kernel", needs="a CUDA device",
    advice="pass interpret=True (the kernel's plain version, for tests) or use engine='xla'.",
    lowrank="(the fused kernel assumes the rotated basis's diagonal whitening); use "
            "engine='xla' or 'auto'.",
)


def takes_cuda_kernel(engine: str, precision: Optional[PrecisionConfig] = None, device=None, *,
                      lowrank: bool = False, interpret: bool = False,
                      texts: KernelTexts = ALT_GRID_TEXTS) -> bool:
    """Whether a call takes the CUDA kernel (True) or the plain engine: the
    one rule of ``engine=``, for the alt-grid scan and the permutation sweep
    (the null methods' LOD step follows the precision alone,
    :func:`_uses_kernel`).

    "auto" takes the kernel on a CUDA ``device`` under a float32 GEMM dtype,
    "xla" never, "pallas" always, or it raises instead of downgrading: under
    a GEMM dtype other than float32 (the kernel's) and off CUDA, unless
    ``interpret`` (the sweep's plain version of the kernel, on any device
    under any preset). Any other name raises, and so does "pallas" on a
    rank-k kinship (``lowrank``), which no kernel takes. Without a
    ``device`` (an entry point's argument checks) the rule stops after those
    two refusals. ``texts`` are the caller's kernel's."""
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
    if lowrank and engine == "pallas":
        raise ValueError(
            f"engine='pallas' is not available for LowRankKinship inputs {texts.lowrank}"
        )
    if lowrank or device is None:
        return False
    float32 = precision.resolve_gemm() == torch.float32
    cuda = torch.device(device).type == "cuda"
    if engine == "pallas" and not interpret:
        if not float32:
            raise ValueError(
                f"engine='pallas' runs the {texts.kernel} in float32; the current precision "
                "config resolves GEMMs to "
                f"{str(precision.resolve_gemm()).removeprefix('torch.')}, which it would "
                "silently downgrade. Use engine='xla' (honors the config) or a precision "
                "whose GEMM dtype is float32."
            )
        if not cuda:
            raise ValueError(f"engine='pallas' runs the {texts.kernel} and needs {texts.needs}, "
                             f"not {torch.device(device)}; {texts.advice}")
    return engine == "pallas" or (engine == "auto" and cuda and float32)


def _scan_common_inputs(Y, covar, h2_grid, add_intercept, *, method, engine, device):
    """Argument checks and trait/covariate preparation (JAX :152-182)."""
    _check_method_engine(method, engine)
    return _traits_covar_grid(Y, covar, h2_grid, add_intercept, device)


def _check_method_engine(method: str, engine: str) -> None:
    if method not in ("null-grid", "null-exact", "alt-grid"):
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    takes_cuda_kernel(engine)
    if engine == "pallas" and method != "alt-grid":
        raise ValueError(
            "engine='pallas' is only available for method='alt-grid' "
            "(the null methods have no engine choice: their LOD step follows "
            "the precision preset, see the docstring of "
            "bulklmm_tpu_torch.models.bulkscan)"
        )


def _traits_covar_grid(Y, covar, h2_grid, add_intercept, device):
    """(Y, covar, h2_grid, add_intercept) as tensors on ``device``: Y (n, m),
    the default grid and the default intercept-only covariates filled in, a
    rank-deficient covariate design refused."""
    Y = to_device(Y, device)
    Y = Y[:, None] if Y.ndim == 1 else Y
    n = Y.shape[0]
    if h2_grid is None:
        h2_grid = np.arange(0.0, 0.91, 0.1)  # the values of jnp.arange's grid
    if not torch.is_tensor(h2_grid):
        h2_grid = np.asarray(h2_grid, dtype=np.float64)  # no float32 detour
    h2_grid = to_device(h2_grid, device)
    if covar is None:
        covar = torch.ones((n, 1), dtype=Y.dtype, device=device)
        add_intercept = False
    else:
        check_covar_full_rank(covar, add_intercept)
        covar = to_device(covar, device)
        covar = covar[:, None] if covar.ndim == 1 else covar
    return Y, covar, h2_grid, add_intercept


def _check_output_effects(output_effects: bool, method: str) -> None:
    if output_effects and method == "alt-grid":
        raise ValueError(
            "output_effects applies to the null methods (one h2 per trait); "
            "for per-marker-h2 effects run scan(assumption='alt', "
            "output_effects=True) on the trait of interest"
        )


def _take_rows(a, rows):
    """Rows ``rows`` of an optional side input: a tensor stays on its
    device, anything else becomes a host array."""
    if a is None:
        return None
    if torch.is_tensor(a):
        return a[torch.as_tensor(rows, device=a.device)]
    return to_numpy(a)[rows]


@spanned("bulklmm.entry.bulkscan", numbered=True)
def bulkscan(
    Y,
    G,
    K,
    covar=None,
    *,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    solve_method: str = "qr",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    trait_chunk=None,
    engine: str = "auto",
    output_effects: bool = False,
    missing: str = "error",
    output_h2_panel: bool = True,
    device=None,
) -> BulkScanResult:
    """Genome scan for many traits at once: Y (n, m), G (n, p), K (n, n), a
    :class:`KinshipDecomposition` or a ``LowRankKinship``; returns L as
    (p, m).

    The keyword surface is the JAX package's ``bulkscan``. ``method`` is
    "null-grid" (default), "null-exact" or "alt-grid"; ``engine`` ("auto",
    "xla", "pallas") picks the alt-grid implementation, "pallas" being the
    CUDA kernel (see the module docstring). ``optim_interval`` applies to
    null-exact; ``solve_method`` ("qr"/"cholesky") only to coefficient
    solves, which no method returns, so it is checked and has no effect;
    ``output_h2_panel=False`` returns ``h2_panel=None`` from alt-grid and
    drops the kernel's index carry. ``output_effects`` (null methods) adds
    the (p, m) GLS effects and their standard errors at each trait's null h2
    (``beta_mat``, ``beta_se_mat``).

    ``trait_chunk``: an int runs trait blocks of that width (>= m: one
    block). None sizes them from the device's free memory and a footprint
    model (``utils/memory.py::auto_trait_chunk``): one block where the
    whole problem fits, else the widest chunk of whole 64-trait tiles that
    does. Where even the (p, m) results cannot live on the device, the call
    runs sequential host trait blocks (``auto_host_block``): the kinship is
    decomposed and G uploaded once, each block's outputs are copied to the
    host while the next block runs, and the result holds host numpy arrays.

    ``missing``: "error" (default) refuses a non-finite phenotype; "mask"
    runs each missingness pattern of the traits on its own rows (its own
    kinship subset and eigendecomposition) and stitches the traits back;
    "drop" keeps the individuals observed in every trait
    (``models/missing.py``, COMPAT.md #18).

    ``K`` may be a ``LowRankKinship`` (top-k eigenpairs, ``ops/lowrank.py``):
    the rank-k engine then runs every method on unrotated data, with no
    (n, n) array anywhere.

    ``device`` defaults to the first tensor's among ``Y``, ``G``, ``K`` and
    ``covar``; with numpy inputs only it is the current CUDA device, and
    without one the call raises (``device="cpu"`` runs the plain versions
    on the CPU; ``utils/device.py::resolve_device``).
    """
    validate_missing_kwarg(missing)
    _check_method_engine(method, engine)
    _check_output_effects(output_effects, method)
    takes_cuda_kernel(engine, lowrank=is_lowrank(K))  # "pallas" on a rank-k kinship raises
    device = resolve_device(device, Y, G, K, covar)
    kw = dict(
        method=method, h2_grid=h2_grid, add_intercept=add_intercept,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size, reml=reml,
        optim_interval=optim_interval, decomp_scheme=decomp_scheme,
        output_pvals=output_pvals, chisq_df=chisq_df, solve_method=solve_method,
        precision=precision, engine=engine, output_effects=output_effects,
        output_h2_panel=output_h2_panel, device=device,
    )
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan(
            Ys, _take_rows(G, rows), subset_kinship(K, rows), _take_rows(covar, rows),
            weights=_take_rows(weights, rows), trait_chunk=trait_chunk, **kw,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept, what="bulkscan",
    )
    if masked is not None:
        return masked
    if trait_chunk is None:
        m, dims = _chunk_dims(Y, G, K, covar, h2_grid, add_intercept, method=method,
                              precision=precision, output_effects=output_effects,
                              output_pvals=output_pvals)
        try:
            trait_chunk = _auto_chunk(Mesh.single(device), m=m, dims=dims)
        except ValueError:
            return _host_blocked_bulkscan(Y, G, K, covar, weights=weights, dims=dims,
                                          budget=memory.device_memory_budget(device), **kw)
    del kw["device"]
    return _bulkscan_on_mesh(Y, G, K, covar, mesh=Mesh.single(device), what="bulkscan",
                             weights=weights, trait_chunk=trait_chunk, **kw)


def _chunk_dims(Y, G, K, covar, h2_grid, add_intercept, *, method, precision, output_effects,
                output_pvals):
    """``(m, dims)``: the trait count and the other sizes of the trait-chunk
    footprint model (``utils/memory.py::auto_trait_chunk``), from the raw
    inputs."""
    shape = np.shape(Y)
    dims = dict(
        n=shape[0], p=np.shape(G)[1], grid=10 if h2_grid is None else len(h2_grid),
        c=_ncov_total(covar, add_intercept),
        itemsize=max(precision.resolve_solve().itemsize, precision.resolve_kernel().itemsize),
        # the (p, m) results on the device: L, the h2 panel, beta and SE, p-values
        n_outputs=1 + (method == "alt-grid") + 2 * int(output_effects) + int(output_pvals),
        alt_grid=method == "alt-grid", rank=np.shape(K.U)[1] if is_lowrank(K) else None,
        kernel=_uses_kernel(precision),
    )
    return 1 if len(shape) == 1 else shape[1], dims


@spanned("bulklmm.entry.budget")
def _auto_chunk(mesh: Mesh, *, m: int, dims: dict) -> Optional[int]:
    """The global ``trait_chunk`` when the caller gives none:
    ``utils/memory.py::auto_trait_chunk`` for one tile, (n, p / marker
    shards, m / trait shards), against the budget of one mesh position
    (``utils/memory.py::mesh_position_budget``; on a mesh of one position,
    the device's), scaled back to the global width. None where one block
    fits; a ``ValueError`` where not even one trait tile does."""
    tshards, mshards = mesh.shape[TRAITS_AXIS], mesh.shape[MARKERS_AXIS]
    mc = memory.auto_trait_chunk(
        **{**dims, "p": max(1, -(-dims["p"] // mshards))}, m=max(1, -(-m // tshards)),
        budget=memory.mesh_position_budget(mesh.flat),
    )
    return None if mc is None else mc * tshards


def _bulkscan_on_mesh(
    Y, G, K, covar, *, mesh: Mesh, what: str, method, h2_grid, add_intercept, weights,
    prior_variance, prior_sample_size, reml, optim_interval, decomp_scheme, output_pvals,
    chisq_df, solve_method, precision, trait_chunk, engine, output_effects, output_h2_panel,
) -> BulkScanResult:
    """The engine of :func:`bulkscan` (a mesh of one position) and
    :func:`bulkscan_sharded`, once the missingness groups and the trait
    chunk are settled.

    The kinship is decomposed and the traits and covariates rotated once, on
    the mesh's first device; each marker shard is rotated once, on the first
    device of its column. The null methods fit each trait's h2 once a trait
    shard (:func:`_null_h2`, or the rank-k fit), then every tile runs the
    LOD step at those h2s (the CUDA LOD kernel, or its effects variant,
    under the float32 presets); alt-grid runs the alt-grid kernel or the
    plain formulation on every tile (:func:`takes_cuda_kernel`, by the
    tile's device). ``what`` names the entry point in a missing-value error.
    """
    lowrank = is_lowrank(K)
    alt = method == "alt-grid"
    dev0 = mesh.first
    Y, covar, h2_grid, add_intercept = _traits_covar_grid(Y, covar, h2_grid, add_intercept, dev0)
    if method == "null-exact" and solve_method not in ("qr", "cholesky"):
        raise ValueError(f"unknown method {solve_method!r}; use 'qr' or 'cholesky'")
    finite = finite_flag(Y)
    n = Y.shape[0]
    if weights is not None:
        _refuse_weights_on_factors(K)
        Y, G, covar, K, add_intercept = _apply_weights(Y, G, covar, K, weights, add_intercept)
        Y, covar = torch.as_tensor(Y, device=dev0), torch.as_tensor(covar, device=dev0)
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=dev0), covar], 1)
    prior = (float(prior_variance), float(prior_sample_size))
    dtype = precision.resolve_solve()
    Gs, p = _marker_shards(G, mesh, dtype)
    grid = _per_device(mesh, lambda d: h2_grid.to(device=d, dtype=dtype))
    fit = None
    if lowrank:
        # no rotation: unrotated inputs and Woodbury weights (ops/lowrank.py)
        lr = _per_device(mesh, lambda d: as_lowrank(K, dtype, d))
        Cd = _per_device(mesh, lambda d: covar.to(device=d, dtype=dtype))
        if not alt:
            def fit(Yi, dev, chunk):
                return _chunked(lambda Yc: (_trait_fit_lowrank(
                    Yc, Cd[dev], lr[dev].U, lr[dev].lam, grid[dev], n=n, prior=prior, reml=reml,
                    method=method, optim_interval=optim_interval, precision=precision)[1],),
                    Yi, chunk)[0]

        def core(Yi, j, dev, chunk, *h2):
            return _bulkscan_lowrank_core(
                Yi, Gs[(j, dev)], Cd[dev], lr[dev].U, lr[dev].lam, grid[dev], *h2, n=n,
                prior=prior, reml=reml, precision=precision, trait_chunk=chunk, method=method,
                effects=output_effects,
            )

        Yt = Y.to(dtype)
    else:
        with span("bulklmm.prep.rotate"), with_highest_matmul():
            Ut, lam = resolve_kinship(K, decomp_scheme, dtype, dev0)
            Yt, C0 = Ut @ Y.to(dtype), Ut @ covar.to(dtype)
            X0m = {}
            for j, d in Gs:  # each marker shard rotated once
                col = mesh.devices[0][j]
                if (j, col) not in X0m:
                    X0m[(j, col)] = Ut.to(col) @ Gs[(j, col)]
                X0m[(j, d)] = X0m[(j, col)].to(d)
            lamd = _per_device(mesh, lambda d: lam.to(d))
            C0d = _per_device(mesh, lambda d: C0.to(d))
        del Gs
        if alt:
            kernel = {d: takes_cuda_kernel(engine, precision, d) for d in lamd}

            def core(Yi, j, dev, chunk):
                X, C, lm, g = X0m[(j, dev)], C0d[dev], lamd[dev], grid[dev]
                if kernel[dev]:
                    return _chunked(lambda Yc: fused_alt_grid(
                        Yc, X, C, lm, g, prior=prior, reml=reml, output_h2_panel=output_h2_panel,
                        dot_precision=precision.gemm_precision,
                    ), Yi, chunk)
                return _chunked(lambda Yc: _alt_grid_impl(
                    Yc, X, C, lm, g, prior=prior, reml=reml, precision=precision), Yi, chunk)
        else:
            def fit(Yi, dev, chunk):
                return _chunked(lambda Yc: (_null_h2(
                    method, Yc, C0d[dev], lamd[dev], grid[dev], prior=prior, reml=reml,
                    optim_interval=optim_interval, precision=precision),), Yi, chunk)[0]

            def core(Yi, j, dev, chunk, h2):
                X, C, lm = X0m[(j, dev)], C0d[dev], lamd[dev]
                return _chunked(lambda Yc, hc: _lod_outputs(Yc, X, C, lm, hc, precision,
                                                            output_effects), Yi, chunk, h2)
    outs = _core_trait_chunks(core, Yt, mesh, trait_chunk, fit=fit)
    if alt:
        # the plain paths compute the panel either way; the flag drops it
        result = BulkScanResult(L=outs[0][:p], h2_panel=outs[1][:p] if output_h2_panel else None)
    else:
        result = BulkScanResult(L=outs[0][:p], h2_null_list=outs[1])
        if output_effects:
            result.beta_mat, result.beta_se_mat = outs[2][:p], outs[3][:p]
    if output_pvals:
        result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
        result.chisq_df = chisq_df
    raise_if_missing(finite, what)
    return result


def bulkscan_sharded(
    Y,
    G,
    K,
    covar=None,
    *,
    mesh: Optional[Mesh] = None,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    output_pvals: bool = False,
    chisq_df: int = 1,
    solve_method: str = "qr",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    output_effects: bool = False,
    trait_chunk: Optional[int] = None,
    missing: str = "error",
) -> BulkScanResult:
    """Multi-trait scan sharded over a device mesh.

    The numerics of :func:`bulkscan` (the same engine, on ``mesh``, default
    ``make_mesh()``: each tile runs the LOD kernel or the alt-grid kernel on
    CUDA tiles under the float32 presets). ``output_effects`` (null methods)
    adds the (p, m) GLS effects and standard errors. ``trait_chunk`` is the
    global trait-block width (each device runs blocks of ceil(trait_chunk /
    trait shards) of its traits); None sizes it for one mesh position
    (:func:`_auto_chunk`), and one block where even one trait tile does not
    fit (a mesh has no host-block path: more devices are the fix).
    ``missing`` and ``weights`` as for ``bulkscan``; ``K`` may be a
    ``LowRankKinship`` (the rank-k engine on every tile, its (n, k) factor
    replicated).

    Returns a :class:`BulkScanResult` whose tensors lie on the mesh's first
    device.
    """
    validate_missing_kwarg(missing)
    _check_method_engine(method, "auto")
    _check_output_effects(output_effects, method)
    if mesh is None:
        mesh = make_mesh()
    kw = dict(
        method=method, h2_grid=h2_grid, add_intercept=add_intercept,
        prior_variance=prior_variance, prior_sample_size=prior_sample_size, reml=reml,
        optim_interval=optim_interval, decomp_scheme=decomp_scheme, output_pvals=output_pvals,
        chisq_df=chisq_df, solve_method=solve_method, precision=precision,
        output_effects=output_effects,
    )
    masked = maybe_masked(
        Y, missing,
        lambda Ys, rows, traits, gi: bulkscan_sharded(
            Ys, _take_rows(G, rows), subset_kinship(K, rows), _take_rows(covar, rows),
            mesh=mesh, weights=_take_rows(weights, rows), trait_chunk=trait_chunk, **kw,
        ),
        covar=covar, weights=weights, add_intercept=add_intercept, what="bulkscan_sharded",
    )
    if masked is not None:
        return masked
    if trait_chunk is None:
        m, dims = _chunk_dims(Y, G, K, covar, h2_grid, add_intercept, method=method,
                              precision=precision, output_effects=output_effects,
                              output_pvals=output_pvals)
        try:
            trait_chunk = _auto_chunk(mesh, m=m, dims=dims)
        except ValueError:
            trait_chunk = None
    return _bulkscan_on_mesh(Y, G, K, covar, mesh=mesh, what="bulkscan_sharded",
                             weights=weights, trait_chunk=trait_chunk, engine="auto",
                             output_h2_panel=True, **kw)


_RESULT_FIELDS = ("L", "h2_null_list", "h2_panel", "beta_mat", "beta_se_mat", "log10Pvals_mat")


def _host_blocked_bulkscan(Y, G, K, covar, *, weights, dims, budget, decomp_scheme, device,
                           add_intercept, **kw) -> BulkScanResult:
    """Sequential host trait blocks, for a (p, m) result that cannot live on
    the device (``utils/memory.py::auto_host_block``).

    The kinship is decomposed once and G uploaded once; each block runs the
    normal engine with a trait chunk fixed from the same budget (so no block
    sizes itself again against the memory its predecessor still holds).
    Each block's device outputs are copied into pinned host buffers by
    non-blocking copies (``utils/host.py::PinnedCopies``) while the next
    block is enqueued; the harvest waits on the copies' event and moves the
    slab into the host result. Output dtypes are the first block's.
    """
    n, p = dims["n"], dims["p"]
    m = 1 if np.ndim(Y) == 1 else np.shape(Y)[1]
    mh = memory.auto_host_block(m=m, budget=budget, **dims)
    block_chunk = memory.auto_trait_chunk(m=mh, budget=budget, **dims) or mh
    if weights is not None:
        # scale once on the host: every block then shares one decomposition
        _refuse_weights_on_factors(K)
        Yw = to_numpy(Y, np.float64)
        Yw = Yw[:, None] if Yw.ndim == 1 else Yw
        cv = np.ones((n, 1)) if covar is None else to_numpy(covar, np.float64)
        cv = cv[:, None] if cv.ndim == 1 else cv
        Y, G, covar, K, add_intercept = _apply_weights(
            Yw, G, cv, K, weights, add_intercept and covar is not None
        )
    if is_lowrank(K):
        K = as_lowrank(K, kw["precision"].resolve_solve(), device)  # uploaded once
    elif not isinstance(K, KinshipDecomposition):
        K = decompose_kinship(
            to_numpy(K), decomp_scheme, kw["precision"].resolve_solve(), device=device
        )
    G = torch.as_tensor(G, device=device)
    Yn = to_numpy(Y)
    Yn = Yn[:, None] if Yn.ndim == 1 else Yn
    copies = PinnedCopies(device)
    host = {}

    def harvest(ms, me, handle):
        for f, a in copies.wait(handle).items():
            if f not in host:
                host[f] = np.empty(a.shape[:-1] + (m,), dtype=a.dtype)
            host[f][..., ms:me] = a

    pending = None
    for ms in range(0, m, mh):
        me = min(ms + mh, m)
        res = bulkscan(Yn[:, ms:me], G, K, covar, trait_chunk=block_chunk, device=device,
                       decomp_scheme=decomp_scheme, add_intercept=add_intercept, **kw)
        handle = copies.start(
            {f: getattr(res, f) for f in _RESULT_FIELDS if getattr(res, f) is not None}
        )
        if pending is not None:
            harvest(*pending)  # the previous block's copies ran meanwhile
        pending = (ms, me, handle)
    harvest(*pending)
    result = BulkScanResult(**{f: host.get(f) for f in _RESULT_FIELDS})
    if kw["output_pvals"]:
        result.chisq_df = kw["chisq_df"]
    return result


def bulkscan_null(Y, G, K, covar=None, **kwargs) -> BulkScanResult:
    """Exact Null-LMM bulk scan (reference bulkscan_null, src/bulkscan.jl:188)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="null-exact", **kwargs)


def bulkscan_null_grid(Y, G, K, h2_grid=None, covar=None, **kwargs) -> BulkScanResult:
    """Grid-approximated Null-LMM bulk scan (reference src/bulkscan.jl:321)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="null-grid", h2_grid=h2_grid, **kwargs)


def bulkscan_alt_grid(Y, G, K, h2_grid=None, covar=None, **kwargs) -> BulkScanResult:
    """Grid-approximated Exact-LMM bulk scan (reference src/bulkscan.jl:428)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="alt-grid", h2_grid=h2_grid, **kwargs)
