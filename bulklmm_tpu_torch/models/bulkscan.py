"""Multi-trait bulk genome scan, null-grid method.

Counterpart of the null-grid path of ``bulklmm_tpu/models/bulkscan.py``
(reference ``bulkscan`` null-grid, src/bulkscan.jl:321-397). In order:
argument checks, optional heteroskedastic weights (host float64), the
intercept, the host float64 kinship eigendecomposition, three rotation
products, the (g x m) null log-likelihood grid in the kernel dtype, a
per-trait argmax over h2, and the per-trait-weight correlation -> LOD step.

That last step is decided by precision and device only:

- float32 products and float32 combines (FAST32, BALANCED, THROUGHPUT):
  the fused kernel, ``kernels/liteqtl_fused.py`` -- the CUDA kernel on CUDA
  tensors, its plain version on CPU tensors;
- otherwise (MIXED, EXACT64): plain ``ops/liteqtl.py::lods_per_trait`` in
  the preset's own dtypes. This is a choice of numerics (float64
  combines), as in the JAX package's XLA path.

What the slice does not implement raises ``NotImplementedError`` naming
its ROADMAP.md item ("Still to port").
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.liteqtl_fused import MAX_COVARIATES, fused_lods_per_trait
from ..ops.liteqtl import lods_per_trait
from ..ops.lod import lod2log10p
from ..ops.rotation import KinshipDecomposition, resolve_kinship
from ..ops.stats import check_covar_full_rank
from ..ops.weights import make_weights
from ..ops.wls import wls_ell
from ..utils.config import DEFAULT_PRECISION, PrecisionConfig, with_highest_matmul
from .missing import _ncov_total, finite_flag, raise_if_missing, validate_missing_kwarg
from .results import BulkScanResult
from .scan import _apply_weights

_TODO = 'not ported to bulklmm_tpu_torch yet (ROADMAP.md "Still to port" item {})'


def grid_null_ell(Y0, X0_cov, lam, h2_grid, prior, *, reml=False) -> torch.Tensor:
    """(g, m) null-model log-likelihoods over the h2 grid: one weighted
    least-squares likelihood per grid point, batched over the grid."""
    return wls_ell(Y0, X0_cov, make_weights(h2_grid, lam), prior, reml=reml)[0]


def _uses_kernel(precision: PrecisionConfig) -> bool:
    return (
        precision.resolve_gemm() == torch.float32
        and precision.resolve_kernel() == torch.float32
    )


def _null_grid_impl(Y0, X0m, C0, lam, h2_grid, *, prior, reml, precision):
    """(L, h2_list) for one block of traits.

    The grid likelihoods run in the kernel dtype, as in the JAX package
    (float32 under BALANCED), so the h2 selection is the same.
    """
    kdt = precision.resolve_kernel()
    ells = grid_null_ell(
        Y0.to(kdt), C0.to(kdt), lam.to(kdt), h2_grid.to(kdt), prior, reml=reml
    )
    h2_list = h2_grid[torch.argmax(ells, dim=0)]  # first max wins
    if _uses_kernel(precision):
        L = fused_lods_per_trait(Y0, X0m, C0, lam, h2_list)
    else:
        L = lods_per_trait(Y0, X0m, C0, lam, h2_list, precision=precision)
    return L, h2_list


@with_highest_matmul()
def _null_grid_pipeline(
    Y, Xm, C, Ut, lam, h2_grid, *, prior, reml, precision, trait_chunk=None
):
    """Rotation + grid fit + LOD step. An int ``trait_chunk`` runs trait
    blocks of that width in turn, each written into one preallocated L."""
    Y0, X0m, C0 = Ut @ Y, Ut @ Xm, Ut @ C
    kw = dict(prior=prior, reml=reml, precision=precision)
    m = Y0.shape[1]
    if trait_chunk is None or trait_chunk >= m:
        return _null_grid_impl(Y0, X0m, C0, lam, h2_grid, **kw)
    L = h2 = None
    for s in range(0, m, trait_chunk):
        Lb, hb = _null_grid_impl(Y0[:, s : s + trait_chunk], X0m, C0, lam, h2_grid, **kw)
        if L is None:
            L = torch.empty((Lb.shape[0], m), dtype=Lb.dtype, device=Lb.device)
            h2 = torch.empty((m,), dtype=hb.dtype, device=hb.device)
        L[:, s : s + trait_chunk] = Lb
        h2[s : s + trait_chunk] = hb
    return L, h2


def _scan_common_inputs(Y, covar, h2_grid, add_intercept, *, method, engine, device):
    """Argument checks and trait/covariate preparation (JAX :152-182)."""
    if method not in ("null-grid", "null-exact", "alt-grid"):
        raise ValueError(
            "method must be one of 'null-grid', 'null-exact', 'alt-grid'"
        )
    if engine not in ("auto", "xla", "pallas"):
        raise ValueError("engine must be one of 'auto', 'xla', 'pallas'")
    if engine == "pallas" and method != "alt-grid":
        raise ValueError(
            "engine='pallas' is only available for method='alt-grid' "
            "(the null engines are XLA-only; docs/PERF.md 'Pallas status')"
        )
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


def _refuse_unported(*, method, missing, K, output_effects):
    if method != "null-grid":
        raise NotImplementedError(f"method={method!r} is " + _TODO.format(6))
    if output_effects:
        raise NotImplementedError("output_effects=True is " + _TODO.format(1))
    if missing != "error":
        raise NotImplementedError(f"missing={missing!r} is " + _TODO.format(3))
    if hasattr(K, "U") and hasattr(K, "lam"):
        raise NotImplementedError("a LowRankKinship is " + _TODO.format(4))


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
    """Genome scan for many traits at once: Y (n, m), G (n, p), K (n, n) or
    a :class:`KinshipDecomposition`; returns L as (p, m).

    The keyword surface is the JAX package's ``bulkscan``. This slice runs
    ``method="null-grid"``; ``trait_chunk=None`` means one block of all
    traits (no sizing from device memory yet), an int runs trait blocks of
    that width. ``solve_method``, ``optim_interval`` and ``output_h2_panel``
    do not apply to null-grid and are accepted as in the JAX package.
    ``device`` defaults to ``Y``'s when it is a tensor, else the CPU.
    """
    validate_missing_kwarg(missing)
    _check_output_effects(output_effects, method)
    if device is None:
        device = Y.device if torch.is_tensor(Y) else torch.device("cpu")
    Y, covar, h2_grid, add_intercept = _scan_common_inputs(
        Y, covar, h2_grid, add_intercept, method=method, engine=engine, device=device
    )
    _refuse_unported(method=method, missing=missing, K=K, output_effects=output_effects)
    finite = finite_flag(Y)
    if (
        torch.device(device).type == "cuda"
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
        if isinstance(K, KinshipDecomposition):
            raise ValueError(
                "weights rescale the kinship matrix (K -> WKW); pass the raw "
                "K, not a cached decomposition."
            )
        Y, G, covar, K, add_intercept = _apply_weights(Y, G, covar, K, weights, add_intercept)
        Y, G, covar = (torch.as_tensor(a, device=device) for a in (Y, G, covar))

    prior = (float(prior_variance), float(prior_sample_size))
    if add_intercept:
        covar = torch.cat([torch.ones((n, 1), dtype=covar.dtype, device=device), covar], 1)
    dtype = precision.resolve_solve()
    Ut, lam = resolve_kinship(K, decomp_scheme, dtype, device)
    L, h2_list = _null_grid_pipeline(
        Y.to(dtype), G.to(dtype), covar.to(dtype), Ut, lam, h2_grid.to(dtype),
        prior=prior, reml=reml, precision=precision, trait_chunk=trait_chunk,
    )
    result = BulkScanResult(L=L, h2_null_list=h2_list)
    if output_pvals:
        result.log10Pvals_mat = lod2log10p(result.L, chisq_df)
        result.chisq_df = chisq_df
    raise_if_missing(finite, "bulkscan")
    return result


def bulkscan_null_grid(Y, G, K, h2_grid=None, covar=None, **kwargs) -> BulkScanResult:
    """Grid-approximated Null-LMM bulk scan (reference src/bulkscan.jl:321)."""
    kwargs.setdefault("prior_variance", 1.0)
    return bulkscan(Y, G, K, covar, method="null-grid", h2_grid=h2_grid, **kwargs)
