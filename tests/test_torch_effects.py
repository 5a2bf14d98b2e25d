"""``bulkscan(output_effects=True)`` of the port against the JAX package and
against a direct GLS solve, on the ``bxd_like`` fixture with two degenerate
markers added: an all-zero one and a constant one (collinear with the
intercept), where the LOD step's keep mask and the effects' floor part.

Bars: EXACT64 1e-9 on L, the effects and their standard errors; BALANCED
1e-4 on L (the JAX package's own bar, tests/test_pallas_fused.py:57-75),
|d beta| <= 1e-4 (|beta| + SE) and |d SE| <= 1e-4 SE, since float32 effects
are good to a share of their standard error, not of themselves. The GLS
oracle holds EXACT64 to 1e-8, as the JAX package's tests/test_effects.py
holds its own. Null-exact under EXACT64 gets 1e-6 (test_torch_nullexact.py
says why: the two packages' Brent fits stop at different points of Brent's
tolerance window, and h2 moves the outputs with it).
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
from bulklmm_tpu_torch.ops import liteqtl as tl
from test_effects import _oracle_effects

torch.set_num_threads(1)

ZERO, CONSTANT = 5, 9  # the degenerate markers
BAR = {"EXACT64": 1e-9, "BALANCED": 1e-4}


@pytest.fixture(scope="module")
def eff_data(bxd_like):
    G = bxd_like["G"].copy()
    G[:, ZERO] = 0.0
    G[:, CONSTANT] = 0.7
    covar = np.random.default_rng(5).normal(size=(bxd_like["n"], 2))
    return dict(bxd_like, G=G, covar=covar)


_JAX = {}


def _jax(data, preset, method, ncov, **kw):
    key = (preset, method, ncov, tuple(sorted(kw.items())))
    if key not in _JAX:
        _JAX[key] = bl.bulkscan(
            data["Y"], data["G"], data["K"], data["covar"] if ncov == 3 else None,
            method=method, precision=getattr(jcfg, preset), output_effects=True, **kw,
        )
    return _JAX[key]


def _port(data, preset, method, ncov, **kw):
    return bt.bulkscan(
        data["Y"], data["G"], data["K"], data["covar"] if ncov == 3 else None,
        method=method, precision=bt.precision_by_name(preset), output_effects=True,
        device="cpu", **kw,
    )


def _np(x):
    return x.double().numpy() if torch.is_tensor(x) else np.asarray(x, dtype=np.float64)


def _check_effects(port, ref, preset, bar=None):
    keep = np.ones(port.L.shape[0], dtype=bool)
    keep[[ZERO, CONSTANT]] = False
    L, b, s = _np(port.L), _np(port.beta_mat), _np(port.beta_se_mat)
    Lr, br, sr = _np(ref.L), _np(ref.beta_mat), _np(ref.beta_se_mat)
    assert b.shape == br.shape and s.shape == sr.shape and port.beta_mat.dtype == port.L.dtype
    bar = BAR[preset] if bar is None else bar
    assert np.max(np.abs(L - Lr)) < bar
    if preset == "EXACT64":
        assert np.max(np.abs(b - br)[keep]) < bar
        assert np.max(np.abs(s - sr)[keep]) < bar
    else:
        assert np.max((np.abs(b - br) / (np.abs(br) + sr))[keep]) < bar
        assert np.max((np.abs(s - sr) / sr)[keep]) < bar
    # the degenerate markers: no effect; the all-zero one's SE is the floor's,
    # the constant one's far above every informative marker's, in both
    for bb, ss in ((b, s), (br, sr)):
        assert np.all(bb[[ZERO, CONSTANT]] == 0.0)
        assert np.all(ss[CONSTANT] > 10 * np.median(ss[keep], axis=0))
    assert np.max(np.abs(s[ZERO] - sr[ZERO]) / sr[ZERO]) < bar


@pytest.mark.parametrize("ncov", [1, 3])
@pytest.mark.parametrize("method", ["null-grid", "null-exact"])
@pytest.mark.parametrize("preset", ["EXACT64", "BALANCED"])
def test_effects_match_jax(eff_data, preset, method, ncov):
    port = _port(eff_data, preset, method, ncov)
    ref = _jax(eff_data, preset, method, ncov)
    exact_fit = method == "null-exact" and preset == "EXACT64"
    _check_effects(port, ref, preset, 1e-6 if exact_fit else None)
    h2p, h2r = _np(port.h2_null_list), _np(ref.h2_null_list)
    if method == "null-grid":
        assert np.array_equal(h2p, h2r)
    else:
        assert np.max(np.abs(h2p - h2r)) < 1e-6


def test_effects_match_gls_oracle(eff_data):
    """Each (marker, trait) effect and SE is the direct GLS solve at the
    trait's fitted null h2 (the JAX package's tests/test_effects.py:102)."""
    G = np.delete(eff_data["G"][:, :18], [ZERO, CONSTANT], axis=1)
    Y, K, n = eff_data["Y"][:, :3], eff_data["K"], eff_data["n"]
    res = bt.bulkscan(Y, G, K, precision=bt.EXACT64, output_effects=True, device="cpu")
    for j in range(Y.shape[1]):
        eb, es = _oracle_effects(Y[:, j], G, np.ones((n, 1)), K, float(res.h2_null_list[j]))
        assert np.max(np.abs(res.beta_mat[:, j].numpy() - eb)) < 1e-8, j
        assert np.max(np.abs(res.beta_se_mat[:, j].numpy() - es)) < 1e-8, j


@pytest.mark.parametrize("ncov", [1, 3])
def test_plain_epilogue_matches_nd_parts(eff_data, ncov):
    """The kernels' plain epilogue (``kernels/liteqtl_fused.py``) against the
    plain effects of ``ops/liteqtl.py`` (``_nd_parts_per_trait`` and
    ``_effects_from_nd``) on the same rotated float32 inputs; FAST32 takes
    both in float32, so they agree to float32 rounding."""
    dec = bt.decompose_kinship(eff_data["K"], dtype=torch.float64, device="cpu")
    n = eff_data["n"]
    C = np.ones((n, 1)) if ncov == 1 else np.concatenate([np.ones((n, 1)), eff_data["covar"]], 1)
    Y0, X0m, C0 = (dec.Ut @ torch.from_numpy(a) for a in (eff_data["Y"], eff_data["G"], C))
    h2 = torch.linspace(0.05, 0.85, Y0.shape[1], dtype=torch.float64)
    args = (Y0.float(), X0m.float(), C0.float(), dec.lam.float(), h2.float())
    L, b, s = lf.fused_lods_and_effects_per_trait(*args)
    Lr, br, sr = tl.lods_and_effects_per_trait(*args, precision=bt.FAST32)
    keep = torch.ones(L.shape[0], dtype=torch.bool)
    keep[[ZERO, CONSTANT]] = False
    assert torch.max((L - Lr).abs()) < 1e-4
    assert torch.max(((b - br).abs() / (br.abs() + sr))[keep]) < 1e-5
    assert torch.max(((s - sr).abs() / sr)[keep]) < 1e-5
    assert torch.all(b[[ZERO, CONSTANT]] == 0) and torch.all(br[[ZERO, CONSTANT]] == 0)
    # the effects variant's LOD is the LOD-only entry's
    assert torch.equal(L, lf.fused_lods_per_trait(*args))


@pytest.mark.parametrize("method", ["null-grid", "null-exact"])
def test_effects_trait_chunked_matches_unchunked(eff_data, method):
    """The effects ride the chunked LOD step (the JAX package's
    tests/test_effects.py:172): 7 traits in ragged chunks of 3."""
    Y, G, K = eff_data["Y"][:, :7], eff_data["G"][:, 10:30], eff_data["K"]
    kw = dict(method=method, precision=bt.EXACT64, output_effects=True, device="cpu")
    ref = bt.bulkscan(Y, G, K, trait_chunk=7, **kw)
    ch = bt.bulkscan(Y, G, K, trait_chunk=3, **kw)
    for f in ("L", "beta_mat", "beta_se_mat"):
        assert torch.max((getattr(ch, f) - getattr(ref, f)).abs()) < 1e-12, f


def test_effects_refused_for_alt_grid(eff_data):
    Y, G, K = eff_data["Y"], eff_data["G"], eff_data["K"]
    for call in (bt.bulkscan, bt.bulkscan_streamed):
        with pytest.raises(ValueError, match="null methods"):
            call(Y, G, K, method="alt-grid", output_effects=True, device="cpu")
