"""The alt-grid slice: the CUDA kernel's plain version against the Pallas
kernel (interpret mode), and ``bulklmm_tpu_torch.bulkscan(method="alt-grid")``
against the JAX package's plain (``engine="xla"``) alt-grid, on CPU.

Bars: the kernel's plain version gets tests/test_pallas_altgrid.py's 5e-5
(float32 products in other orders, scaled by n/2 in the LOD). The scan gets
test_torch_bulkscan.py's bars per preset (the JAX package's own bars
against its float64 oracle). The h2 panel must be identical under EXACT64;
under the float32 presets an argmax may flip where two grid steps tie
within float32 rounding, so the share of differing pairs is held at the
value measured here on ``bxd_like`` (0 of 1,920 under every preset).
The CUDA kernel itself runs only on the card, where chip_smoke.py holds it
against the same plain version.
"""

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.pallas.altgrid_fused import fused_alt_grid as jax_fused_alt_grid
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import altgrid_fused as af
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

KERNEL_BAR = 5e-5
L_BAR = {"EXACT64": 1e-9, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
# share of (marker, trait) pairs whose h2 panel differs from the JAX
# package's, measured on bxd_like; never above 1 %
PANEL_FLIP_SHARE = {"EXACT64": 0.0, "MIXED": 0.0, "BALANCED": 0.0, "FAST32": 0.0, "THROUGHPUT": 0.0}
GRID = np.arange(0.0, 0.91, 0.1)
PRIOR = (1.0, 0.0)


@pytest.fixture(scope="module")
def rotated():
    """tests/test_pallas_altgrid.py's fixture: n = 40, p = 96, m = 48, c = 2."""
    rng = np.random.default_rng(3)
    n, p, m = 40, 96, 48
    return dict(
        Y0=rng.normal(size=(n, m)),
        X0m=rng.normal(size=(n, p)),
        C0=np.column_stack([np.ones(n), rng.normal(size=n)]),
        lam=np.sort(rng.uniform(0.05, 3.0, n)),
    )


def _args(rotated, grid):
    names = ("Y0", "X0m", "C0", "lam")
    jargs = [jnp.asarray(rotated[k]) for k in names] + [jnp.asarray(grid)]
    targs = [torch.from_numpy(rotated[k]) for k in names] + [torch.from_numpy(np.asarray(grid))]
    return jargs, targs


def _maxdiff(port, ref):
    return float(np.max(np.abs(port.double().numpy() - np.asarray(ref, dtype=np.float64))))


@pytest.mark.parametrize("reml", [False, True])
def test_plain_version_matches_pallas(rotated, reml):
    jargs, targs = _args(rotated, GRID)
    L_pl, h2_pl = jax_fused_alt_grid(
        *jargs, prior=PRIOR, reml=reml, interpret=True, tile_p=32, tile_m=128
    )
    L, h2 = af.fused_alt_grid(*targs, prior=PRIOR, reml=reml)
    assert L.shape == (96, 48) and L.dtype == torch.float64 and h2.dtype == torch.float64
    assert _maxdiff(L, L_pl) < KERNEL_BAR
    assert np.array_equal(h2.numpy(), np.asarray(h2_pl))
    # on CPU tensors the dispatching entry is the plain version
    L_ref, h2_ref = af.fused_alt_grid_reference(*targs, prior=PRIOR, reml=reml)
    assert torch.equal(L, L_ref) and torch.equal(h2, h2_ref)
    assert not launch_counts


@pytest.mark.parametrize("reml", [False, True])
def test_bf16x3_plain_version_matches_pallas_at_high(rotated, reml):
    """Under ``dot_precision="high"`` (THROUGHPUT) the plain version takes the
    kernel's bf16x3 products, as the Pallas kernel's HIGH branch splits its
    dot in interpret mode. The two split different values (the port its
    normalized columns, the Pallas kernel the raw residuals), so each drops
    its own lo * lo terms: each stays within the kernel bar of the float64
    product of the same operands, they stay within twice it of each other,
    the h2 panel is identical, and the result is not the float32 one."""
    jargs, targs = _args(rotated, GRID)
    L_pl, h2_pl = jax_fused_alt_grid(
        *jargs, prior=PRIOR, reml=reml, interpret=True, tile_p=32, tile_m=128,
        dot_precision=jcfg.THROUGHPUT.gemm_precision,
    )
    L, h2 = af.fused_alt_grid(*targs, prior=PRIOR, reml=reml, dot_precision="high")
    assert L.shape == (96, 48) and L.dtype == torch.float64
    Xn, Yn, cmat = af.prepare_inputs(*targs, prior=PRIOR, reml=reml)
    exact, _ = af._min_over_grid(Xn.double(), Yn.double(), cmat.double(), False, torch.matmul)
    assert _maxdiff(L, exact.numpy()) < KERNEL_BAR and _maxdiff(exact, L_pl) < KERNEL_BAR
    assert _maxdiff(L, L_pl) < 2 * KERNEL_BAR
    assert np.array_equal(h2.numpy(), np.asarray(h2_pl))
    L_ref, h2_ref = af.fused_alt_grid_reference(*targs, prior=PRIOR, reml=reml,
                                                dot_precision="high")
    assert torch.equal(L, L_ref) and torch.equal(h2, h2_ref)
    L32, _ = af.fused_alt_grid(*targs, prior=PRIOR, reml=reml)
    assert float((L - L32).abs().max()) > 0
    assert not launch_counts


def test_plain_version_single_grid_point(rotated):
    """g = 1: the first and the last grid step are the same step."""
    jargs, targs = _args(rotated, np.asarray([0.3]))
    L_pl, _ = jax_fused_alt_grid(*jargs, prior=PRIOR, interpret=True, tile_p=32, tile_m=128)
    L, h2 = af.fused_alt_grid(*targs, prior=PRIOR)
    assert _maxdiff(L, L_pl) < KERNEL_BAR
    assert torch.all(h2 == 0.3)


def test_plain_version_without_panel(rotated):
    jargs, targs = _args(rotated, GRID)
    L_pl, none_pl = jax_fused_alt_grid(
        *jargs, prior=PRIOR, interpret=True, tile_p=32, tile_m=128, output_h2_panel=False
    )
    L_full, _ = af.fused_alt_grid(*targs, prior=PRIOR)
    L, none = af.fused_alt_grid(*targs, prior=PRIOR, output_h2_panel=False)
    assert none is None and none_pl is None
    assert torch.equal(L, L_full)
    assert _maxdiff(L, L_pl) < KERNEL_BAR


def test_prepare_inputs_layout(rotated):
    """Per-step operands are float32, contiguous, unit-norm columns; the
    trait factors are at least 1, with a 1 at each trait's best null step."""
    _, targs = _args(rotated, GRID)
    Xn, Yn, cmat = af.prepare_inputs(*targs, prior=PRIOR)
    assert [t.shape for t in (Xn, Yn, cmat)] == [(10, 40, 96), (10, 40, 48), (10, 48)]
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (Xn, Yn, cmat))
    assert torch.allclose((Xn * Xn).sum(1), torch.ones(10, 96), atol=1e-6)
    assert torch.all(cmat >= 1.0) and torch.all(cmat.min(0).values == 1.0)


def test_zero_marker_column_gives_zero_lod(rotated):
    """An all-zero marker is masked to r = 0 in every step, so its LOD is
    exactly 0, as on the JAX package's plain path."""
    data = dict(rotated, X0m=rotated["X0m"].copy())
    data["X0m"][:, 5] = 0.0
    _, targs = _args(data, GRID)
    L, _ = af.fused_alt_grid(*targs, prior=PRIOR)
    assert bool(torch.isfinite(L).all()) and torch.all(L[5] == 0)


def test_cuda_wrapper_refuses_cpu_tensors(rotated):
    _, targs = _args(rotated, GRID)
    ops = af.prepare_inputs(*targs, prior=PRIOR)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        af.altgrid_cuda(*ops)
    assert not launch_counts


def _run(data, preset, **kw):
    Y, G, K = data["Y"], data["G"], data["K"]
    ref = bl.bulkscan(Y, G, K, method="alt-grid", engine="xla", precision=getattr(jcfg, preset), **kw)
    port = bt.bulkscan(Y, G, K, method="alt-grid", precision=bt.precision_by_name(preset),
                       device="cpu", **kw)
    return port, ref


def _compare(port, ref, preset):
    assert port.L.shape == ref.L.shape
    assert _maxdiff(port.L, ref.L) < L_BAR[preset]
    assert port.h2_null_list is None
    if ref.h2_panel is not None:
        share = float(np.mean(port.h2_panel.numpy() != np.asarray(ref.h2_panel)))
        assert share <= PANEL_FLIP_SHARE[preset] <= 0.01


@pytest.mark.parametrize("preset", list(L_BAR))
def test_presets_match_jax(bxd_like, preset):
    port, ref = _run(bxd_like, preset)
    expect = {"FAST32": torch.float32, "THROUGHPUT": torch.float32}.get(preset, torch.float64)
    assert port.L.dtype == port.h2_panel.dtype == expect  # the JAX package's dtypes
    assert str(port.L.dtype).removeprefix("torch.") == str(ref.L.dtype)
    assert port.h2_panel.shape == (bxd_like["p"], bxd_like["m"])
    _compare(port, ref, preset)


def _option_kwargs(option, data):
    rng = np.random.default_rng(5)
    return {
        "covariates": dict(covar=rng.normal(size=(data["n"], 2))),
        "weights": dict(weights=np.random.default_rng(6).uniform(0.5, 2.0, data["n"])),
        "reml": dict(reml=True),
        "prior": dict(prior_sample_size=3.0, prior_variance=0.8),
        "trait_chunk": dict(trait_chunk=5),
        "h2_grid": dict(h2_grid=[0.05, 0.25, 0.45, 0.65, 0.85]),
    }[option]


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
@pytest.mark.parametrize("option", ["covariates", "weights", "reml", "prior", "trait_chunk", "h2_grid"])
def test_options_match_jax(bxd_like, option, preset):
    port, ref = _run(bxd_like, preset, **_option_kwargs(option, bxd_like))
    _compare(port, ref, preset)


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_output_pvals_and_no_panel_match_jax(bxd_like, preset):
    port, ref = _run(bxd_like, preset, output_pvals=True, output_h2_panel=False)
    assert port.h2_panel is None and ref.h2_panel is None
    _compare(port, ref, preset)
    pv = port.log10Pvals_mat.numpy()
    assert np.max(np.abs(pv - np.asarray(ref.log10Pvals_mat))) < 2 * L_BAR[preset] + 1e-12


def test_alias_and_engines_on_cpu(bxd_like):
    """``bulkscan_alt_grid`` is ``bulkscan(method="alt-grid")``; on CPU
    tensors "auto" is the plain path, as "xla" is, and launches nothing."""
    Y, G, K = bxd_like["Y"], bxd_like["G"], bxd_like["K"]
    a = bt.bulkscan(Y, G, K, method="alt-grid", precision=bt.BALANCED, device="cpu")
    b = bt.bulkscan_alt_grid(Y, G, K, precision=bt.BALANCED, device="cpu")
    c = bt.bulkscan(Y, G, K, method="alt-grid", precision=bt.BALANCED, engine="xla", device="cpu")
    for r in (b, c):
        assert torch.equal(a.L, r.L) and torch.equal(a.h2_panel, r.h2_panel)
    assert not launch_counts


def test_float32_gemm_presets_take_the_kernel_entry_only_on_cuda(bxd_like, monkeypatch):
    """On CPU tensors no preset takes the kernel's entry under "auto"."""
    calls = []
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    monkeypatch.setattr(mb, "fused_alt_grid", lambda *a, **k: calls.append(1))
    for preset in L_BAR:
        bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="alt-grid",
                    precision=bt.precision_by_name(preset), device="cpu")
    assert calls == []
    assert mb.takes_cuda_kernel("auto", bt.BALANCED, "cuda")
    assert mb.takes_cuda_kernel("auto", bt.MIXED, "cuda")
    assert not mb.takes_cuda_kernel("auto", bt.EXACT64, "cuda")
    assert not mb.takes_cuda_kernel("xla", bt.BALANCED, "cuda")


@pytest.mark.parametrize("panel", [True, False], ids=["panel", "no-panel"])
def test_kernel_entry_over_trait_blocks_matches_jax(bxd_like, monkeypatch, panel):
    """The path a CUDA scan takes (the kernel's entry, over trait blocks,
    with and without the index carry), run here through the kernel's plain
    version, against the JAX package's plain alt-grid."""
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    calls = []
    monkeypatch.setattr(mb, "takes_cuda_kernel", lambda *a, **k: True)
    monkeypatch.setattr(mb, "fused_alt_grid", lambda *a, **k: calls.append(1) or af.fused_alt_grid(*a, **k))
    port, ref = _run(bxd_like, "BALANCED", trait_chunk=7, output_h2_panel=panel)
    assert len(calls) == -(-bxd_like["m"] // 7)  # one entry per trait block
    assert port.L.dtype == torch.float64 and (port.h2_panel is None) == (not panel)
    _compare(port, ref, "BALANCED")
    assert not launch_counts


def _both_raise(data, **kw):
    with pytest.raises(ValueError) as ej:
        bl.bulkscan(data["Y"], data["G"], data["K"], **kw)
    with pytest.raises(ValueError) as et:
        bt.bulkscan(data["Y"], data["G"], data["K"], device="cpu", **kw)
    return str(ej.value), str(et.value)


@pytest.mark.parametrize("kw", [
    dict(method="alt-grid", engine="banana"),
    dict(method="null-grid", engine="pallas"),
    dict(method="alt-grid", output_effects=True),
], ids=["engine", "pallas-null-grid", "effects"])
def test_same_value_errors_as_jax(bxd_like, kw):
    j, t = _both_raise(bxd_like, **kw)
    if kw.get("engine") == "pallas":
        # the same refusal; each package then points at its own record of why
        head = "engine='pallas' is only available for method='alt-grid'"
        assert t.startswith(head) and j.startswith(head)
    else:
        assert t == j


@pytest.mark.parametrize("preset, match", [("BALANCED", "CUDA device"), ("EXACT64", "float64")])
def test_pallas_engine_refusals(bxd_like, preset, match):
    """engine="pallas" runs the CUDA kernel in float32 or raises: on CPU
    tensors, and under a float64 GEMM dtype."""
    with pytest.raises(ValueError, match=match):
        bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="alt-grid",
                    engine="pallas", precision=bt.precision_by_name(preset), device="cpu")
    assert not launch_counts
