"""The null-grid slice end to end: ``bulklmm_tpu_torch.bulkscan`` against
``bulklmm_tpu.bulkscan`` on the ``bxd_like`` fixture, fed the same data.

Bars on L, each the JAX package's own bar for that preset against its
float64 oracle (tests/test_pallas_fused.py:57-75), since the two packages
round in different orders: 1e-9 for EXACT64, 1e-4 for MIXED and BALANCED,
1e-3 for FAST32 and THROUGHPUT. The grid h2 must be identical wherever the
grid likelihoods keep float64 or BALANCED's float32 (EXACT64, MIXED,
BALANCED).
"""

import importlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops.lowrank import LowRankKinship
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

torch.set_num_threads(1)

L_BAR = {"EXACT64": 1e-9, "MIXED": 1e-4, "BALANCED": 1e-4, "FAST32": 1e-3, "THROUGHPUT": 1e-3}
SAME_H2 = ("EXACT64", "MIXED", "BALANCED")


def _compare(port, ref, preset):
    Lp = port.L.double().numpy()
    Lr = np.asarray(ref.L, dtype=np.float64)
    assert Lp.shape == Lr.shape
    assert np.max(np.abs(Lp - Lr)) < L_BAR[preset]
    if preset in SAME_H2:
        assert np.array_equal(port.h2_null_list.numpy(), np.asarray(ref.h2_null_list))


def _run(data, preset, **kw):
    Y, G, K = data["Y"], data["G"], data["K"]
    ref = bl.bulkscan(Y, G, K, precision=getattr(jcfg, preset), **kw)
    port = bt.bulkscan(Y, G, K, precision=bt.precision_by_name(preset), device="cpu", **kw)
    return port, ref


@pytest.mark.parametrize("preset", list(L_BAR))
def test_presets_match_jax(bxd_like, preset):
    port, ref = _run(bxd_like, preset)
    assert port.L.dtype == {"EXACT64": torch.float64}.get(preset, torch.float32)
    assert port.h2_null_list.shape == (bxd_like["m"],)
    _compare(port, ref, preset)


def _covar(data):
    rng = np.random.default_rng(5)
    return rng.normal(size=(data["n"], 2))


def _option_kwargs(option, data):
    if option == "covariates":  # c = 3 with the intercept
        return dict(covar=_covar(data))
    if option == "weights":
        return dict(weights=np.random.default_rng(6).uniform(0.5, 2.0, data["n"]))
    if option == "reml":
        return dict(reml=True)
    if option == "prior":
        return dict(prior_sample_size=3.0, prior_variance=0.8)
    if option == "h2_grid":
        return dict(h2_grid=[0.05, 0.25, 0.45, 0.65, 0.85])
    if option == "svd":
        return dict(decomp_scheme="svd")
    raise AssertionError(option)


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
@pytest.mark.parametrize("option", ["covariates", "weights", "reml", "prior", "h2_grid", "svd"])
def test_options_match_jax(bxd_like, option, preset):
    port, ref = _run(bxd_like, preset, **_option_kwargs(option, bxd_like))
    _compare(port, ref, preset)


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_output_pvals_match_jax(bxd_like, preset):
    port, ref = _run(bxd_like, preset, output_pvals=True, chisq_df=2)
    _compare(port, ref, preset)
    assert port.chisq_df == 2 and torch.is_tensor(port.log10Pvals_mat)
    pv = port.log10Pvals_mat.numpy()
    # -log10 p has slope ~2 ln10 / ln10 = 2 per LOD unit: twice L's bar
    assert np.max(np.abs(pv - np.asarray(ref.log10Pvals_mat))) < 2 * L_BAR[preset] + 1e-12


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_cached_decomposition_matches_jax(bxd_like, preset):
    dec = bl.decompose_kinship(bxd_like["K"])
    port_dec = bt.decomposition_from_numpy(
        dec.Ut_host, dec.lam_host, device="cpu", dtype=torch.float64
    )
    Y, G = bxd_like["Y"], bxd_like["G"]
    ref = bl.bulkscan(Y, G, dec, precision=getattr(jcfg, preset))
    port = bt.bulkscan(Y, G, port_dec, precision=bt.precision_by_name(preset), device="cpu")
    _compare(port, ref, preset)
    raw = bt.bulkscan(Y, G, bxd_like["K"], precision=bt.precision_by_name(preset), device="cpu")
    assert torch.equal(port.L, raw.L)  # the same host factors, the same result


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_trait_chunk_matches_unchunked(bxd_like, preset):
    port, ref = _run(bxd_like, preset, trait_chunk=5)
    _compare(port, ref, preset)
    whole = bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"],
                        precision=bt.precision_by_name(preset), device="cpu")
    # traits are independent: blocks of 5 give the unchunked result, exactly
    # in float64; float32 CPU products of another width block their sums
    # differently, which moves L by a few float32 ulps (~1e-6 LOD)
    assert torch.equal(port.h2_null_list, whole.h2_null_list)
    if preset == "EXACT64":
        assert torch.equal(port.L, whole.L)
    else:
        assert torch.allclose(port.L, whole.L, rtol=0, atol=1e-5)


def test_tensor_inputs_and_null_grid_alias(bxd_like):
    Y, G, K = (torch.from_numpy(bxd_like[k]) for k in ("Y", "G", "K"))
    a = bt.bulkscan(Y, G, K, precision=bt.EXACT64)
    b = bt.bulkscan_null_grid(Y, G, K, precision=bt.EXACT64)
    assert a.L.device == Y.device and torch.equal(a.L, b.L)
    ref = bl.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], precision=jcfg.EXACT64)
    _compare(a, ref, "EXACT64")


def test_float32_presets_go_through_the_kernel_entry(bxd_like, monkeypatch):
    """FAST32/BALANCED/THROUGHPUT take the fused entry; MIXED/EXACT64 the
    plain float64-combine path."""
    calls = []
    real = lf.fused_lods_per_trait
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    monkeypatch.setattr(mb, "fused_lods_per_trait", lambda *a: calls.append(1) or real(*a))
    for preset, expect in [("BALANCED", 1), ("FAST32", 1), ("THROUGHPUT", 1), ("MIXED", 0), ("EXACT64", 0)]:
        calls.clear()
        bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"],
                    precision=bt.precision_by_name(preset), device="cpu")
        assert len(calls) == expect, preset


def _both_raise(exc, data, **kw):
    Y = kw.pop("Y", data["Y"])
    with pytest.raises(exc) as ej:
        bl.bulkscan(Y, data["G"], data["K"], **kw)
    with pytest.raises(exc) as et:
        bt.bulkscan(Y, data["G"], data["K"], device="cpu", **kw)
    return str(ej.value), str(et.value)


@pytest.mark.parametrize("case", ["method", "nan", "rank", "engine", "missing"])
def test_same_value_errors_as_jax(bxd_like, case):
    if case == "method":
        kw = dict(method="banana")
    elif case == "nan":
        Y = bxd_like["Y"].copy()
        Y[3, 2] = np.nan
        kw = dict(Y=Y)
    elif case == "rank":
        c = _covar(bxd_like)
        kw = dict(covar=np.concatenate([c, c[:, :1]], axis=1))
    elif case == "engine":
        kw = dict(engine="pallas")
    else:
        kw = dict(missing="sometimes")
    j, t = _both_raise(ValueError, bxd_like, **kw)
    if case == "engine":
        # the same refusal; each package then points at its own record of why
        head = "engine='pallas' is only available for method='alt-grid'"
        assert t.startswith(head) and j.startswith(head)
        assert "bulklmm_tpu_torch.models.bulkscan" in t and "docs/PERF.md" not in t
    else:
        assert t == j


@pytest.mark.parametrize("kw", [
    dict(method="null-exact", output_effects=True), dict(method="alt-grid", missing="mask"),
    dict(missing="mask"), dict(missing="drop"), dict(output_effects=True), dict(lowrank=True),
], ids=["null-exact", "alt-grid", "mask", "drop", "effects", "lowrank"])
def test_unported_options_raise(bxd_like, kw):
    """Every option also runs on a LowRankKinship, the rank-k engine, and
    matches the JAX package's under EXACT64 (the option alone in the
    "lowrank" case, with a planted missing value under missing="mask");
    the dense K runs each option too (tests/test_torch_effects.py,
    test_torch_missing.py and test_torch_lowrank.py hold them against the
    JAX package). Bars: 1e-8, and 2e-7 for null-exact, whose Brent fits
    stop elsewhere inside their window on sums taken in another order
    (test_torch_lowrank.py's BRENT_BAR)."""
    lam, U = np.linalg.eigh(bxd_like["K"])
    lowrank = LowRankKinship(U=U[:, -10:], lam=lam[-10:])
    Y = bxd_like["Y"].copy()
    Y[3, 2] = np.nan
    only_lowrank = kw.pop("lowrank", False)
    if only_lowrank:
        kw = dict(missing="mask")
    if "missing" not in kw:
        Y = bxd_like["Y"]
    ref = bl.bulkscan(Y, bxd_like["G"], lowrank, precision=jcfg.EXACT64, **kw)
    port = bt.bulkscan(Y, bxd_like["G"], lowrank, precision=bt.EXACT64, device="cpu", **kw)
    bar = 2e-7 if kw.get("method") == "null-exact" else 1e-8
    for f in ("L", "h2_null_list", "h2_panel", "beta_mat", "beta_se_mat"):
        a, b = getattr(port, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert np.max(np.abs(a.numpy() - np.asarray(b))) < bar, f
    if only_lowrank:
        return
    res = bt.bulkscan(Y, bxd_like["G"], bxd_like["K"], device="cpu", **kw)
    assert res.L.shape == (bxd_like["p"], bxd_like["m"]) and bool(torch.isfinite(res.L).all())
    assert (res.beta_mat is not None) == bool(kw.get("output_effects"))


def test_weights_refuse_cached_decomposition(bxd_like):
    dec = bt.decompose_kinship(bxd_like["K"], dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="pass the raw"):
        bt.bulkscan(bxd_like["Y"], bxd_like["G"], dec, weights=np.ones(bxd_like["n"]))


def test_port_imports_no_jax():
    repo = Path(__file__).resolve().parent.parent
    code = (
        "import sys, bulklmm_tpu_torch, bulklmm_tpu_torch.kernels.altgrid_fused, "
        "bulklmm_tpu_torch.validation, "
        "bulklmm_tpu_torch.ops.brent, bulklmm_tpu_torch.ops.lmm; "
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in ('jax', 'jaxlib', 'bulklmm_tpu')); "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr


def _covar12(data):
    """11 covariates beside the intercept: c = 12, the LOD kernel's wide path."""
    return np.random.default_rng(12).normal(size=(data["n"], 11))


@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
@pytest.mark.parametrize("method", ["null-grid", "null-exact", "effects"])
def test_wide_covariates_match_jax(bxd_like, method, preset):
    """c = 12 through every null method and the effects, against the JAX
    package on the same numpy inputs: L at the preset's bar (null-exact
    under EXACT64 1e-6, test_torch_nullexact.py's bar for a Brent fit that
    stops elsewhere in its window), the grid h2 identical, the effects at
    test_torch_effects.py's bars (EXACT64 1e-9; BALANCED 1e-4 of |effect| +
    SE and of SE)."""
    kw = dict(method="null-grid" if method == "effects" else method,
              output_effects=method == "effects")
    port, ref = _run(bxd_like, preset, covar=_covar12(bxd_like), **kw)
    Lp, Lr = port.L.double().numpy(), np.asarray(ref.L, dtype=np.float64)
    bar = 1e-6 if (method, preset) == ("null-exact", "EXACT64") else L_BAR[preset]
    assert Lp.shape == Lr.shape and np.max(np.abs(Lp - Lr)) < bar
    if method != "null-exact":
        assert np.array_equal(port.h2_null_list.numpy(), np.asarray(ref.h2_null_list))
    if method == "effects":
        b, s = port.beta_mat.double().numpy(), port.beta_se_mat.double().numpy()
        br, sr = np.asarray(ref.beta_mat, np.float64), np.asarray(ref.beta_se_mat, np.float64)
        if preset == "EXACT64":
            assert np.max(np.abs(b - br)) < 1e-9 and np.max(np.abs(s - sr)) < 1e-9
        else:
            assert np.max(np.abs(b - br) / (np.abs(br) + sr)) < 1e-4
            assert np.max(np.abs(s - sr) / sr) < 1e-4
