"""Multi-trait bulk genome scans: null-grid, null-exact and alt-grid.

Counterpart of ``bulklmm_tpu/models/bulkscan.py`` (reference ``bulkscan``,
src/bulkscan.jl:81-162, and its three engines). Every method runs, in
order: argument checks, optional heteroskedastic weights (host float64),
the intercept, the host float64 kinship eigendecomposition, three rotation
products, then its engine, over blocks of traits when ``trait_chunk`` is an
int:

- **null-grid** (src/bulkscan.jl:321-397): the (g x m) null log-likelihood
  grid in the kernel dtype, a per-trait argmax over h2, then the
  per-trait-weight correlation -> LOD step;
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

The alt-grid engine is chosen by ``engine``: "pallas" is the CUDA kernel
``kernels/altgrid_fused.py`` (float32 products, CUDA tensors, else a
``ValueError``); "auto" takes it on CUDA tensors under a float32 GEMM dtype
and the plain path otherwise; "xla" is always the plain path.

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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..kernels.altgrid_fused import fused_alt_grid
from ..kernels.liteqtl_fused import (
    MAX_COVARIATES, fused_lods_and_effects_per_trait, fused_lods_per_trait,
)
from ..ops.liteqtl import lods_and_effects_per_trait, lods_per_trait, lods_shared
from ..ops.lmm import fit_h2_traits
from ..ops.lod import lod2log10p
from ..ops.lowrank import _bulkscan_lowrank_core, as_lowrank, is_lowrank, refuse_pallas
from ..ops.rotation import KinshipDecomposition, decompose_kinship, resolve_kinship
from ..ops.stats import check_covar_full_rank
from ..ops.weights import make_weights
from ..ops.wls import wls_ell
from ..utils import memory
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from ..utils.device import resolve_device
from ..utils.host import PinnedCopies, to_numpy
from .missing import (
    _ncov_total, finite_flag, maybe_masked, raise_if_missing, subset_kinship,
    validate_missing_kwarg,
)
from .results import BulkScanResult
from .scan import _TODO, _apply_weights, _refuse_weights_on_factors

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
        return fused_lods_per_trait(Y0, X0m, C0, lam, h2_list)
    return lods_per_trait(Y0, X0m, C0, lam, h2_list, precision=precision)


def _lod_effects_step(Y0, X0m, C0, lam, h2_list, precision):
    """(L, beta, se), each (p, m), from one pass: the kernel's effects
    variant where :func:`_lod_step` takes the kernel, the plain effects
    otherwise."""
    if _uses_kernel(precision):
        return fused_lods_and_effects_per_trait(Y0, X0m, C0, lam, h2_list)
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


def _null_grid_impl(Y0, X0m, C0, lam, h2_grid, *, prior, reml, precision, effects=False):
    """(L, h2_list[, beta, se]) for one block of traits.

    The grid likelihoods run in the kernel dtype, as in the JAX package
    (float32 under BALANCED), so the h2 selection is the same.
    """
    h2_list = _grid_h2(Y0, C0, lam, h2_grid, prior=prior, reml=reml, precision=precision)
    return _lod_outputs(Y0, X0m, C0, lam, h2_list, precision, effects)


def _null_exact_impl(Y0, X0m, C0, lam, *, prior, reml, optim_interval, precision, effects=False):
    """(L, h2_list[, beta, se]) for one block of traits: each trait's h2
    from a Brent fit in the solve dtype, then the LOD step."""
    h2_list = fit_h2_traits(Y0, C0, lam, prior, reml=reml, optim_interval=optim_interval)
    return _lod_outputs(Y0, X0m, C0, lam, h2_list, precision, effects)


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


def _chunked(impl, Y0, trait_chunk):
    """``impl(Y0)`` for an int ``trait_chunk``: trait blocks of that width in
    turn, each written into one preallocated output per result (the traits
    are each result's last axis; a None result stays None)."""
    m = Y0.shape[1]
    if trait_chunk is None or trait_chunk >= m:
        return impl(Y0)
    outs = None
    for s in range(0, m, trait_chunk):
        res = impl(Y0[:, s : s + trait_chunk])
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


@with_highest_matmul()
def _rotate_and_run(impl, Y, Xm, C, Ut, trait_chunk):
    """The three rotation products, then ``impl(Y0, X0m, C0)`` over trait
    blocks."""
    Y0, X0m, C0 = Ut @ Y, Ut @ Xm, Ut @ C
    return _chunked(lambda Yc: impl(Yc, X0m, C0), Y0, trait_chunk)


def _null_grid_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, precision, trait_chunk=None, effects=False
):
    """Rotation + grid fit + LOD step."""
    kw = dict(prior=prior, reml=reml, precision=precision, effects=effects)
    return _rotate_and_run(
        lambda Y0, X0m, C0: _null_grid_impl(Y0, X0m, C0, lam, h2_grid, **kw),
        Y, Xm, C, Ut, trait_chunk,
    )


def _null_exact_pipeline(
    Y, Xm, C, Ut, lam, *, prior, reml, optim_interval, precision, trait_chunk=None,
    effects=False,
):
    """Rotation + Brent fit + LOD step."""
    kw = dict(
        prior=prior, reml=reml, optim_interval=optim_interval, precision=precision,
        effects=effects,
    )
    return _rotate_and_run(
        lambda Y0, X0m, C0: _null_exact_impl(Y0, X0m, C0, lam, **kw),
        Y, Xm, C, Ut, trait_chunk,
    )


def _alt_grid_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, precision, trait_chunk=None,
    use_kernel=False, panel=True,
):
    """Rotation + the alt-grid engine: the fused kernel's entry when
    ``use_kernel`` (its index carry dropped when ``panel`` is False), the
    plain formulation otherwise."""
    if use_kernel:
        def impl(Y0, X0m, C0):
            return fused_alt_grid(
                Y0, X0m, C0, lam, h2_grid, prior=prior, reml=reml, output_h2_panel=panel
            )
    else:
        def impl(Y0, X0m, C0):
            return _alt_grid_impl(
                Y0, X0m, C0, lam, h2_grid, prior=prior, reml=reml, precision=precision
            )
    return _rotate_and_run(impl, Y, Xm, C, Ut, trait_chunk)


def _scan_common_inputs(Y, covar, h2_grid, add_intercept, *, method, engine, device):
    """Argument checks and trait/covariate preparation (JAX :152-182)."""
    _check_method_engine(method, engine)
    return _traits_covar_grid(Y, covar, h2_grid, add_intercept, device)


def _check_method_engine(method: str, engine: str) -> None:
    if method not in ("null-grid", "null-exact", "alt-grid"):
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
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
    Y = torch.as_tensor(Y, device=device)
    Y = Y[:, None] if Y.ndim == 1 else Y
    n = Y.shape[0]
    if h2_grid is None:
        h2_grid = np.arange(0.0, 0.91, 0.1)  # the values of jnp.arange's grid
    if not torch.is_tensor(h2_grid):
        h2_grid = np.asarray(h2_grid, dtype=np.float64)  # no float32 detour
    h2_grid = torch.as_tensor(h2_grid, device=device)
    if covar is None:
        covar = torch.ones((n, 1), dtype=Y.dtype, device=device)
        add_intercept = False
    else:
        check_covar_full_rank(covar, add_intercept)
        covar = torch.as_tensor(covar, device=device)
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


def _altgrid_uses_kernel(engine: str, precision: PrecisionConfig, device) -> bool:
    """Whether alt-grid runs the CUDA kernel; ``engine="pallas"`` refuses
    what the kernel cannot honour instead of downgrading it silently."""
    float32 = precision.resolve_gemm() == torch.float32
    cuda = torch.device(device).type == "cuda"
    if engine == "pallas":
        if not float32:
            raise ValueError(
                "engine='pallas' runs the fused alt-grid CUDA kernel in float32; "
                "the current precision config resolves GEMMs to "
                f"{str(precision.resolve_gemm()).removeprefix('torch.')}, which it "
                "would silently downgrade. Use engine='xla' (honors the config) or "
                "a precision whose GEMM dtype is float32."
            )
        if not cuda:
            raise ValueError(
                "engine='pallas' runs the fused alt-grid CUDA kernel and needs "
                f"tensors on a CUDA device, not {torch.device(device)}; use "
                "engine='xla' (or call kernels.altgrid_fused."
                "fused_alt_grid_reference for the kernel's plain version)."
            )
        return True
    return engine == "auto" and cuda and float32


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
    lowrank = is_lowrank(K)
    if lowrank:
        refuse_pallas(engine)
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
        shape = np.shape(Y)
        dims = dict(
            n=shape[0], p=np.shape(G)[1], grid=10 if h2_grid is None else len(h2_grid),
            c=_ncov_total(covar, add_intercept),
            itemsize=max(precision.resolve_solve().itemsize, precision.resolve_kernel().itemsize),
            # the (p, m) results on the device: L, the h2 panel, beta and SE, p-values
            n_outputs=1 + (method == "alt-grid") + 2 * int(output_effects) + int(output_pvals),
            alt_grid=method == "alt-grid", rank=np.shape(K.U)[1] if lowrank else None,
        )
        budget = memory.device_memory_budget(device)
        try:
            trait_chunk = memory.auto_trait_chunk(
                m=1 if len(shape) == 1 else shape[1], budget=budget, **dims
            )
        except ValueError:
            return _host_blocked_bulkscan(Y, G, K, covar, weights=weights, dims=dims,
                                          budget=budget, **kw)

    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine=engine, device=device
    )
    if method == "null-exact" and solve_method not in ("qr", "cholesky"):
        raise ValueError(f"unknown method {solve_method!r}; use 'qr' or 'cholesky'")
    use_altgrid_kernel = (
        method == "alt-grid" and not lowrank and _altgrid_uses_kernel(engine, precision, device)
    )
    finite = finite_flag(Y)
    if (
        method != "alt-grid"
        and not lowrank
        and torch.device(device).type == "cuda"
        and _uses_kernel(precision)
        and _ncov_total(covar, add_intercept) > MAX_COVARIATES
    ):
        raise ValueError(
            f"the CUDA LOD kernel takes at most {MAX_COVARIATES} covariate "
            "columns (intercept included); " + _TODO.format(5)
        )
    G = torch.as_tensor(G, device=device)
    n = Y.shape[0]

    if weights is not None:
        _refuse_weights_on_factors(K)
        Y, G, covar, K, add_intercept = _apply_weights(Y, G, covar, K, weights, add_intercept)
        Y, G, covar = (torch.as_tensor(a, device=device) for a in (Y, G, covar))

    prior = (float(prior_variance), float(prior_sample_size))
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=device), covar], 1)
    dtype = precision.resolve_solve()
    kw = dict(prior=prior, reml=reml, precision=precision, trait_chunk=trait_chunk)
    if lowrank:
        # no rotation: unrotated inputs and Woodbury weights (ops/lowrank.py)
        lr = as_lowrank(K, dtype, device)
        out = _bulkscan_lowrank_core(
            Y.to(dtype), G.to(dtype), covar.to(dtype), lr.U, lr.lam, h2_grid.to(dtype), n=n,
            method=method, optim_interval=optim_interval,
            effects=output_effects and method != "alt-grid", **kw,
        )
        if method == "alt-grid":
            L, h2_panel = out
            out = None
    else:
        Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
        args = (Y.to(dtype), G.to(dtype), covar.to(dtype), Ut, lam)
        if method == "null-grid":
            out = _null_grid_pipeline(*args, h2_grid.to(dtype), effects=output_effects, **kw)
        elif method == "null-exact":
            out = _null_exact_pipeline(
                *args, optim_interval=optim_interval, effects=output_effects, **kw
            )
        else:
            L, h2_panel = _alt_grid_pipeline(
                *args, h2_grid.to(dtype), use_kernel=use_altgrid_kernel,
                panel=output_h2_panel, **kw,
            )
            out = None
    if out is None:
        # the plain paths compute the panel either way; the flag drops it
        result = BulkScanResult(L=L, h2_panel=h2_panel if output_h2_panel else None)
    else:
        result = BulkScanResult(L=out[0], h2_null_list=out[1])
        if output_effects:
            result.beta_mat, result.beta_se_mat = out[2], out[3]
    if output_pvals:
        result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
        result.chisq_df = chisq_df
    raise_if_missing(finite, "bulkscan")
    return result


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
