"""The per-trait LOD step: the CUDA kernels' plain version, their split
reference and the plain ``lods_per_trait`` against the JAX package, on CPU.

Mirrors tests/test_pallas_fused.py: the same generator, shapes and 5e-5 bar
(float32 products summed in different orders, scaled by n/2 in the LOD).
The CUDA kernels themselves run only on the card, where chip_smoke.py holds
them against the same plain version and split reference; the rule that
picks the kernel from (n, c) and the operands' layout are held here.
"""

import collections
import contextlib
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulklmm_tpu.ops.liteqtl import lods_and_effects_per_trait as jax_lods_and_effects
from bulklmm_tpu.ops.liteqtl import lods_per_trait as jax_lods_per_trait
from bulklmm_tpu.pallas import fused_lods_per_trait as jax_fused
from bulklmm_tpu.utils import config as jcfg
from bulklmm_tpu_torch.kernels import altgrid_fused as af
from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
from bulklmm_tpu_torch.ops.liteqtl import lods_per_trait
from bulklmm_tpu_torch.ops.smallchol import off_covariates
from bulklmm_tpu_torch.utils.config import precision_by_name
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

KERNEL_BAR = 5e-5
PRESETS = ["EXACT64", "MIXED", "BALANCED", "FAST32", "THROUGHPUT"]


def _mk(n=48, p=96, m=64, c=1, seed=3, dtype=np.float32):
    rng = np.random.default_rng(seed + 10 * c + p + m)
    Y0 = rng.normal(size=(n, m))
    X0m = rng.normal(size=(n, p))
    C0 = np.concatenate([np.ones((n, 1))] + [rng.normal(size=(n, 1)) for _ in range(c - 1)], 1)
    lam = rng.uniform(0.1, 2.0, n)
    h2 = rng.uniform(0.0, 0.9, m)
    return [a.astype(dtype) for a in (Y0, X0m, C0, lam, h2)]


def _both(args):
    return [jnp.asarray(a) for a in args], [torch.from_numpy(a) for a in args]


def _maxdiff(port, ref):
    return float(np.max(np.abs(port.double().numpy() - np.asarray(ref, dtype=np.float64))))


WIDE_SHAPES = [(40, 32, 24, 9), (40, 32, 24, 12), (40, 32, 24, 16)]


@pytest.mark.parametrize("shape", [(48, 96, 64, 1), (48, 96, 64, 2), (48, 96, 64, 3), (48, 70, 45, 1)]
                         + WIDE_SHAPES)
def test_kernel_plain_version_matches_jax(shape):
    """Plain version vs the Pallas kernel (interpret mode) and vs the XLA
    FAST32 path, c = 1..3, a non-divisible 70 x 45 shape, and c = 9, 12, 16
    (the wide kernel's covariate counts)."""
    n, p, m, c = shape
    jargs, targs = _both(_mk(n, p, m, c))
    ref = lf.fused_lods_per_trait_reference(*targs)
    assert ref.shape == (p, m) and ref.dtype == torch.float32
    pallas = jax_fused(*jargs, tile_p=32, tile_m=32, interpret=True)
    xla = jax_lods_per_trait(*jargs, precision=jcfg.FAST32)
    assert _maxdiff(ref, pallas) < KERNEL_BAR
    assert _maxdiff(ref, xla) < KERNEL_BAR
    # on CPU tensors the dispatching entry takes its kernel's plain version:
    # the same one up to c = 3, the wide kernel's arithmetic above
    port = lf.fused_lods_per_trait(*targs)
    if lf.kernel_path(n, c) == "wide":
        assert _maxdiff(port, pallas) < KERNEL_BAR
    else:
        assert torch.equal(port, ref)
    assert not launch_counts


@pytest.mark.parametrize("preset", PRESETS)
def test_plain_lods_per_trait_matches_jax(preset):
    """The port's plain ``lods_per_trait`` under each preset: 1e-10 at
    EXACT64 (float64 throughout), else the float32 kernel bar."""
    dtype = np.float64 if preset in ("EXACT64", "MIXED", "BALANCED") else np.float32
    jargs, targs = _both(_mk(c=2, dtype=dtype))
    port = lods_per_trait(*targs, precision=precision_by_name(preset))
    ref = jax_lods_per_trait(*jargs, precision=getattr(jcfg, preset))
    assert port.shape == ref.shape
    assert port.dtype == {jnp.float32: torch.float32, jnp.float64: torch.float64}[ref.dtype.type]
    assert _maxdiff(port, ref) < (1e-10 if preset == "EXACT64" else KERNEL_BAR)


def test_zero_marker_column_gives_zero_lod():
    """An all-zero marker has D = D1 = 0: the plain version (and the kernel)
    give r2 = 0 there, like the XLA path, where the Pallas form divides 0/0."""
    args = _mk(p=40, m=30)
    args[1][:, 7] = 0.0
    jargs, targs = _both(args)
    ref = lf.fused_lods_per_trait_reference(*targs)
    assert bool(torch.isfinite(ref).all())
    assert torch.all(ref[7] == 0)
    assert _maxdiff(ref, jax_lods_per_trait(*jargs, precision=jcfg.FAST32)) < KERNEL_BAR


@pytest.mark.parametrize("p, row", [(9, 12), (12, 12), (7321, 7324)])
def test_prepare_inputs_layout(p, row):
    """The scalar block's rows are the packed factor, zeta and inv_nrm2;
    every operand is float32 and contiguous, as the kernel's checks want, but
    X where p is no multiple of 4: its rows are then ``row`` floats apart,
    zero-padded, so that each starts at a multiple of 16 bytes. X is the
    markers off the covariates' span (``ops/smallchol.py::off_covariates``)."""
    n, m, c = 20, 11, 3
    _, targs = _both(_mk(n, p, m, c, dtype=np.float64))
    X, C, W, WY, scal = lf.prepare_inputs(*targs)
    assert [t.shape for t in (X, C, W, WY, scal)] == [
        (n, p), (n, c), (n, m), (n, m), (lf.scalar_rows(c), m)
    ]
    assert all(t.dtype == torch.float32 for t in (X, C, W, WY, scal))
    assert all(t.is_contiguous() for t in (C, W, WY, scal))
    assert X.stride() == (row, 1) and X.data_ptr() % 16 == 0
    assert torch.equal(X, off_covariates(targs[1], targs[2]).float())
    if row > p:  # the padding behind every row is zeros
        whole = torch.as_strided(X, (n, row), (row, 1))
        assert bool((whole[:, p:] == 0).all())
    assert lf.scalar_rows(c) == 10


def test_plain_version_takes_the_padded_view():
    """The padded layout of X does not show in the result."""
    _, targs = _both(_mk(20, 9, 11, 2))
    ops = lf.prepare_inputs(*targs)
    assert not ops[0].is_contiguous()
    packed = (ops[0].contiguous(), *ops[1:])
    assert torch.equal(lf.liteqtl_lod_plain(*ops), lf.liteqtl_lod_plain(*packed))
    assert torch.equal(lf.liteqtl_split_reference(*ops), lf.liteqtl_split_reference(*packed))


SPLIT_SHAPES = [(48, 96, 64, 1), (48, 96, 64, 2), (48, 96, 64, 3), (48, 70, 45, 1),
                (79, 96, 64, 1), (80, 96, 64, 2)]


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_reference_matches_plain(shape):
    """The resident kernel's arithmetic (X, X * X and X * C_k rounded to
    float32, then three TF32 passes) against exact float32 products: 5e-5
    in LOD."""
    n, p, m, c = shape
    _, targs = _both(_mk(n, p, m, c))
    ops = lf.prepare_inputs(*targs)
    out = lf.liteqtl_split_reference(*ops)
    assert out.shape == (p, m) and out.dtype == torch.float32
    assert bool(torch.isfinite(out).all())
    assert float((out - lf.liteqtl_lod_plain(*ops)).abs().max()) < KERNEL_BAR
    assert not launch_counts


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_split_reference_matches_jax(shape):
    """The same arithmetic against the Pallas kernel (interpret mode) and
    the XLA FAST32 path on the same numpy inputs: 5e-5 in LOD."""
    n, p, m, c = shape
    jargs, targs = _both(_mk(n, p, m, c))
    out = lf.liteqtl_split_reference(*lf.prepare_inputs(*targs))
    pallas = jax_fused(*jargs, tile_p=32, tile_m=32, interpret=True)
    xla = jax_lods_per_trait(*jargs, precision=jcfg.FAST32)
    assert _maxdiff(out, pallas) < KERNEL_BAR
    assert _maxdiff(out, xla) < KERNEL_BAR


@pytest.mark.parametrize("shape", SPLIT_SHAPES)
def test_bf16x3_reference_is_throughput_grade(shape):
    """The resident kernel's arithmetic under "high" (the forms rounded to
    float32, then three bf16 passes) against the JAX package's
    ``lods_per_trait`` under EXACT64 on the same numpy inputs: within 4e-3,
    the JAX package's THROUGHPUT bound against EXACT64
    (tests/test_bulkscan.py:138), and not equal to it; and farther from it
    than the float32 products are, as bf16x3 drops its lo * lo terms."""
    n, p, m, c = shape
    args = _mk(n, p, m, c)
    out = lf.liteqtl_bf16x3_reference(*lf.prepare_inputs(*[torch.from_numpy(a) for a in args]))
    assert out.shape == (p, m) and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    exact = jax_lods_per_trait(*[jnp.asarray(a.astype(np.float64)) for a in args],
                               precision=jcfg.EXACT64)
    gap = _maxdiff(out, exact)
    assert 0 < gap < 4e-3
    plain = lf.fused_lods_per_trait_reference(*[torch.from_numpy(a) for a in args])
    assert _maxdiff(plain, exact) < gap
    assert not launch_counts


@pytest.mark.parametrize("effects", [False, True], ids=["lod", "effects"])
def test_cpu_lod_step_keeps_float32_products_under_high(effects):
    """On CPU tensors the LOD step's plain version takes float32 products
    under both names, as XLA's HIGH computes on a CPU: "high" gives the
    "highest" result bit for bit, here and in the reference."""
    _, targs = _both(_mk(n=48, p=40, m=30, c=2))
    entry = lf.fused_lods_and_effects_per_trait if effects else lf.fused_lods_per_trait
    high, highest = entry(*targs, "high"), entry(*targs)
    for a, b in zip(*(t if effects else (t,) for t in (high, highest))):
        assert torch.equal(a, b)
    assert torch.equal(lf.fused_lods_per_trait_reference(*targs, dot_precision="high"),
                       lf.fused_lods_per_trait_reference(*targs))
    assert not launch_counts


@pytest.mark.parametrize("entry", ["fused", "effects", "reference", "cuda"])
def test_unknown_dot_precision_raises(entry):
    _, targs = _both(_mk(n=12, p=8, m=5))
    with pytest.raises(ValueError, match="GEMM precision"):
        if entry == "cuda":
            lf.liteqtl_lod_cuda(*lf.prepare_inputs(*targs), dot_precision="medium")
        else:
            fn = {"fused": lf.fused_lods_per_trait, "effects": lf.fused_lods_and_effects_per_trait,
                  "reference": lf.fused_lods_per_trait_reference}[entry]
            fn(*targs, dot_precision="medium")


def test_split_reference_zero_marker_column_gives_zero_lod():
    args = _mk(p=40, m=30, c=2)
    args[1][:, 7] = 0.0
    _, targs = _both(args)
    out = lf.liteqtl_split_reference(*lf.prepare_inputs(*targs))
    assert bool(torch.isfinite(out).all()) and torch.all(out[7] == 0)


@pytest.mark.parametrize("n", [1, 79, 80, 88, 89, 2000])
@pytest.mark.parametrize("c", [1, 3, 4, 8, 9, 32])
def test_kernel_path_by_samples_and_covariates(n, c):
    """The resident kernel takes n <= 88 (11 depth steps of 8) with at most
    3 covariate columns ((c + 2) accumulator sets of 32 registers); more
    than 3 columns take the wide kernel at any n; every other shape (n > 88,
    c <= 3) takes the general kernel. The effects variant takes the same
    paths."""
    want = "wide" if c > 3 else "resident" if n <= 88 else "general"
    assert lf.kernel_path(n, c) == want == lf.kernel_path(n, c, effects=True)
    if want == "resident":
        assert lf.resident_shared_bytes(n, c) <= lf.SHARED_LIMIT_BYTES


@pytest.mark.parametrize("n, steps", [(1, 2), (8, 2), (17, 4), (48, 6), (49, 8), (72, 10), (79, 10),
                                      (80, 10), (81, 11), (88, 11), (89, 12), (2000, 250)])
def test_resident_steps(n, steps):
    assert lf.resident_steps(n) == steps


@pytest.mark.parametrize("n", [1, 79, 88, 89, 2000])
@pytest.mark.parametrize("c", [1, 3, 4])
def test_kernel_route_names_the_products(n, c):
    """Under "high" every kernel, resident, general and wide, runs bf16x3;
    the path is the same under both names."""
    path = lf.kernel_path(n, c)
    assert lf.kernel_route(n, c) == (path, "tf32x3")
    assert lf.kernel_route(n, c, dot_precision="high") == (path, "bf16x3")
    assert lf.kernel_route(n, c, True, "high") == lf.kernel_route(n, c, dot_precision="high")
    if path == "resident":
        for effects in (False, True):
            assert lf.resident_shared_bytes(n, c, effects, "high") <= lf.SHARED_LIMIT_BYTES


@pytest.mark.parametrize("n, steps", [(1, 2), (16, 2), (32, 2), (33, 3), (48, 3), (79, 5), (80, 5),
                                      (81, 6), (88, 6)])
def test_resident_steps_bf16x3(n, steps):
    """bf16x3 depth steps are 16 samples, every count from 2 built: n = 88
    pads to 96."""
    assert lf.resident_steps(n, "high") == steps


def test_resident_shared_bytes_at_the_main_path_shape():
    # n = 79, c = 1: four 80 x 64 operand tiles, for each of two warpgroups two
    # stages of 80 x 72 and a finished tile of 64 x 68, 80 covariate values and
    # three rows of scalars
    want = 4 * (4 * 80 * 64 + 2 * (2 * 80 * 72 + 64 * 68) + 80 + 3 * 64)
    assert lf.resident_shared_bytes(79, 1) == want == 209_984
    assert want <= 227 * 1024 == lf.SHARED_LIMIT_BYTES
    assert lf.resident_shared_bytes(88, 3) <= lf.SHARED_LIMIT_BYTES
    # bf16x3: the operand tiles take half the bytes, the rest is the same
    assert lf.resident_shared_bytes(79, 1, dot_precision="high") == want - 4 * 2 * 80 * 64 == 169_024


def test_cuda_wrapper_refuses_cpu_tensors():
    _, targs = _both(_mk(n=12, p=8, m=5))
    ops = lf.prepare_inputs(*targs)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lf.liteqtl_lod_cuda(*ops)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lf.liteqtl_lod_cuda(*ops, general=True)
    assert not launch_counts
    # the dispatching entry takes the plain version for them
    assert torch.equal(lf.fused_lods_per_trait(*targs), lf.liteqtl_lod_plain(*ops))
    assert not launch_counts


# --- the wide kernel (c > 3) -----------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("c", [9, 12, 16, 69])
def test_wide_arithmetic_matches_plain(c, dtype):
    """The wide kernel's arithmetic (V = W C L^{-T} formed in the inputs'
    dtype, then Z_k = X^T V_k in float32, one column at a time) against the
    plain version on the general kernel's operands (the packed factor and
    the forward substitution, the TPU kernel's arithmetic): 5e-5 in LOD, and
    the effects within 1e-4 of (|effect| + SE) and of SE; the split
    reference on the wide operands within 5e-5 too. c = 69 is GTEx v8's
    covariate design (the intercept, 5 genotype PCs, 60 PEER factors,
    platform, protocol and sex), at 100 samples."""
    _, targs = _both(_mk(40 if c < 40 else 100, 32, 24, c, dtype=dtype))
    wide = lf.prepare_inputs(*targs, effects=True)
    general = lf.prepare_inputs(*targs, effects=True, path="general")
    assert wide[1].dim() == 3 and general[1].dim() == 2
    L, b, s = lf.liteqtl_lod_plain(*wide, effects=True)
    Lr, br, sr = lf.liteqtl_lod_plain(*general, effects=True)
    assert float((L - Lr).abs().max()) < KERNEL_BAR
    assert float(((b - br).abs() / (br.abs() + sr)).max()) < 1e-4
    assert float(((s - sr).abs() / sr).max()) < 1e-4
    # the LOD alone is the effects variant's LOD, on either operand form
    assert torch.equal(lf.liteqtl_lod_plain(*wide[:4], wide[4][:-1]), L)
    split = lf.liteqtl_split_reference(*wide[:4], wide[4][:-1])
    assert float((split - L).abs().max()) < KERNEL_BAR


def test_prepare_wide_records_the_whitening():
    """Under a profiler the wide operands' whitening (the Gram, the batched
    factorisation, the solve and V) records ``bulklmm.prep.whiten`` inside
    ``bulklmm.prep.inputs``, with the factorisation's wait,
    ``bulklmm.sync.cholesky``, inside it; the general operands record
    neither, and the operands are those formed with no profiler."""
    from torch.profiler import ProfilerActivity, profile

    _, targs = _both(_mk(40, 9, 11, 12, dtype=np.float64))
    off = lf.prepare_inputs(*targs)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = lf.prepare_inputs(*targs)
        lf.prepare_inputs(*targs, path="general")
    spans = sorted((e for e in prof.profiler.kineto_results.events()
                    if e.name().startswith("bulklmm.")), key=lambda e: (e.start_ns(), -e.end_ns()))
    names = [e.name() for e in spans]
    assert names.count("bulklmm.prep.whiten") == names.count("bulklmm.sync.cholesky") == 1
    assert names.count("bulklmm.prep.inputs") == 2

    def inside(inner, outer):
        return outer.start_ns() <= inner.start_ns() and inner.end_ns() <= outer.end_ns()

    whiten = names.index("bulklmm.prep.whiten")
    assert inside(spans[whiten], spans[names.index("bulklmm.prep.inputs")])
    assert inside(spans[names.index("bulklmm.sync.cholesky")], spans[whiten])
    assert all(torch.equal(a, b) for a, b in zip(off, on))


_ROUTES = [
    # (wrapper, n, c, keywords, marker groups, the route's key)
    ("liteqtl", 79, 1, {}, 1, "liteqtl_lod.resident.tf32x3"),
    ("liteqtl", 79, 1, dict(general=True), 1, "liteqtl_lod.general.tf32x3"),
    ("liteqtl", 300, 2, dict(dot_precision="high"), 1, "liteqtl_lod.general.bf16x3"),
    ("liteqtl", 706, 69, {}, 1, "liteqtl_lod.wide.tf32x3"),
    ("liteqtl", 706, 69, dict(effects=True), 1, "liteqtl_lod_effects.wide.tf32x3"),
    ("liteqtl", 706, 69, dict(effects=True, dot_precision="high"), 1,
     "liteqtl_lod_effects.wide.bf16x3"),
    ("bulkperm", 79, 1, {}, 1, "bulkperm_maxr2.resident.tf32x3"),
    ("bulkperm", 300, 1, {}, 1, "bulkperm_maxr2.chunked.tf32x3"),
    ("bulkperm", 300, 1, dict(dot_precision="high"), 3, "bulkperm_maxr2.chunked_split.bf16x3"),
    ("altgrid", 79, 1, dict(dot_precision="high"), 1, "altgrid.fused.bf16x3"),
]


@pytest.mark.parametrize("wrapper, n, c, kw, groups, key", _ROUTES,
                         ids=[r[-1] for r in _ROUTES])
def test_wide_launches_count_only_the_wide_kernel(monkeypatch, wrapper, n, c, kw, groups, key):
    """Each CUDA wrapper counts a successful launch in the launch record
    under the route that it launched, and under no other key: a wide,
    effects, bf16x3 or split launch under its own. The card is stood in for
    here (operand checks, library and stream), so the wrappers' own route
    and count lines run on the CPU."""
    module = {"liteqtl": lf, "bulkperm": bf, "altgrid": af}[wrapper]
    lib = SimpleNamespace(
        bulklmm_liteqtl_totals=lambda *a: 0, bulklmm_liteqtl_lod=lambda *a: 0,
        bulklmm_bulkperm_marker_groups=lambda *a: groups, bulklmm_bulkperm_maxr2=lambda *a: 0,
        bulklmm_altgrid=lambda *a: 0,
    )
    monkeypatch.setattr(module, "_library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda: SimpleNamespace(cuda_stream=0))
    t = torch.zeros(4, 8)
    if wrapper == "liteqtl":
        monkeypatch.setattr(lf, "_check_operands", lambda *a: (n, 8, 8, c))
        launch = lambda: lf.liteqtl_lod_cuda(t, t, t, t, t, **kw)  # noqa: E731
    elif wrapper == "bulkperm":
        monkeypatch.setattr(bf, "_check_operands", lambda *a: (n, 8, 1, 8))
        launch = lambda: bf.bulkperm_maxr2_cuda(t, t, t, **kw)  # noqa: E731
    else:
        monkeypatch.setattr(af, "_check_operands", lambda *a: (1, n, 8, 8))
        launch = lambda: af.altgrid_cuda(t[None], t[None], t, **kw)  # noqa: E731
    saved = collections.Counter(launch_counts)
    try:
        launch_counts.clear()
        launch()
        assert launch_counts == collections.Counter({key: 1})
        launch()
        assert launch_counts == collections.Counter({key: 2})
    finally:
        launch_counts.clear()
        launch_counts.update(saved)


def test_prepare_inputs_wide_layout():
    """The wide operands: V (c, n, m) with each trait's columns orthonormal
    in its weights (sum_s V_k V_l / w = delta_kl), zeta = V^T y, and a scalar
    block of zeta, inv_nrm2 and nrm2; X, W and WY as the general kernel's."""
    n, p, m, c = 40, 9, 11, 12
    _, targs = _both(_mk(n, p, m, c, dtype=np.float64))
    X, V, W, WY, scal = lf.prepare_inputs(*targs, effects=True)
    gX, _, gW, gWY, _ = lf.prepare_inputs(*targs, path="general")
    assert V.shape == (c, n, m) and scal.shape == (lf.scalar_rows(c, True, wide=True), m) == (c + 2, m)
    assert all(t.dtype == torch.float32 and t.is_contiguous() for t in (V, W, WY, scal))
    assert torch.equal(X, gX) and torch.equal(W, gW) and torch.equal(WY, gWY)
    w = W.double()
    gram = torch.einsum("ksj,lsj->jkl", V.double(), V.double() / w)
    assert float((gram - torch.eye(c, dtype=torch.float64)).abs().max()) < 1e-5
    Y0 = targs[0]
    zeta = (V.double() * Y0[None]).sum(1)
    assert float((zeta - scal[:c].double()).abs().max()) < 1e-4 * float(zeta.abs().max())


def test_wide_operands_refused_where_they_do_not_belong():
    """The CUDA wrapper refuses CPU tensors of either form; the general
    kernel is not asked for more than 3 columns; a plain call on the wide
    operands does not launch anything."""
    _, targs = _both(_mk(n=20, p=8, m=5, c=10))
    ops = lf.prepare_inputs(*targs)
    with pytest.raises(ValueError, match="not on a CUDA device"):
        lf.liteqtl_lod_cuda(*ops)
    assert torch.equal(lf.fused_lods_per_trait(*targs), lf.liteqtl_lod_plain(*ops))
    assert not launch_counts and lf.GENERAL_COVARIATES == 3


@pytest.mark.parametrize("c", [1, 12])
def test_descending_eigenvalues_reverse_the_samples(c):
    """Eigenvalues that fall (the svd scheme's order) are reversed with the
    samples before the products, so that the largest eigenvalue's terms are
    added last: the operands equal those of the reversed inputs."""
    args = _mk(30, 16, 12, c, dtype=np.float64)
    args[3] = np.sort(args[3])[::-1].copy()
    _, targs = _both(args)
    flipped = [targs[0].flip(0), targs[1].flip(0), targs[2].flip(0), targs[3].flip(0), targs[4]]
    for a, b in zip(lf.prepare_inputs(*targs), lf.prepare_inputs(*flipped)):
        assert torch.equal(a, b)
    assert lf._descending(targs[3]) and not lf._descending(flipped[3])


@pytest.mark.parametrize("c", [4, 5, 8])
def test_four_to_eight_covariates_take_the_wide_operands(c):
    """c = 4..8 took the general kernel's operands before the general kernel
    stopped at 3: on CPU tensors they now take the wide ones, and the result
    still matches the Pallas kernel (interpret mode) and the XLA FAST32 path
    within the kernel bar, with a ragged tile edge."""
    n, p, m = 48, 70, 45
    jargs, targs = _both(_mk(n, p, m, c))
    ops = lf.prepare_inputs(*targs)
    assert lf.kernel_path(n, c) == "wide" and ops[1].shape == (c, n, m)
    port = lf.fused_lods_per_trait(*targs)
    assert torch.equal(port, lf.liteqtl_lod_plain(*ops))
    assert _maxdiff(port, jax_fused(*jargs, tile_p=32, tile_m=32, interpret=True)) < KERNEL_BAR
    assert _maxdiff(port, jax_lods_per_trait(*jargs, precision=jcfg.FAST32)) < KERNEL_BAR
    assert not launch_counts


# --- the chunked kernels' arithmetic (general and wide paths) -----------------------

#: kernel-arithmetic twin vs the plain version: the kernel bar, and at
#: n = 2,000 twice one unit in the last place of 1 - r2 scaled by
#: n / (2 ln 10) (2.62e-5): both sides are float32, summed in other orders
TWIN_BAR = {200: KERNEL_BAR, 2000: 2 * 2.62e-5}


def _jax_bar(n):
    """Against the JAX package: the kernel bar, scaled by n / 79 past BXD's
    79 samples (the LOD is n / 2 times the log of a float32 quantity)."""
    return KERNEL_BAR * max(1.0, n / 79)


@pytest.mark.parametrize("effects", [False, True], ids=["lod", "effects"])
@pytest.mark.parametrize("c", [1, 3, 4, 8, 12])
@pytest.mark.parametrize("n", [200, 2000])
def test_chunked_reference_matches_plain_and_jax(n, c, effects):
    """The general and wide kernels' arithmetic (``liteqtl_chunked_reference``:
    the samples in chunks of 40, each chunk's three TF32 passes added to one
    float32 sum, small terms first, that sum added into a running total
    every FOLD_CHUNKS chunks) on the operands of the
    kernel's own path, against the plain version (TWIN_BAR) and against the
    JAX package on the same numpy inputs: the Pallas kernel in interpret mode
    at n = 200 and the XLA FAST32 path at n = 2,000 (``_jax_bar``); the
    effects against ``lods_and_effects_per_trait`` (FAST32) within 1e-4 of
    (|effect| + SE) and of SE. A ragged 70 x 45 tile edge."""
    p, m = 70, 45
    jargs, targs = _both(_mk(n, p, m, c))
    ops = lf.prepare_inputs(*targs, effects=effects)
    assert (ops[1].dim() == 3) == (c > lf.GENERAL_COVARIATES)
    assert lf.kernel_path(n, c) == ("wide" if c > 3 else "general")
    twin = lf.liteqtl_chunked_reference(*ops, effects=effects)
    plain = lf.liteqtl_lod_plain(*ops, effects=effects)
    L, Lp = (twin[0], plain[0]) if effects else (twin, plain)
    assert L.shape == (p, m) and L.dtype == torch.float32 and bool(torch.isfinite(L).all())
    assert float((L - Lp).abs().max()) < TWIN_BAR[n]
    if n <= 200:
        ref = jax_fused(*jargs, tile_p=32, tile_m=32, interpret=True)
    else:
        ref = jax_lods_per_trait(*jargs, precision=jcfg.FAST32)
    assert _maxdiff(L, ref) < _jax_bar(n)
    if effects:
        _, b, s = twin
        _, jb, js = (np.asarray(a, dtype=np.float64)
                     for a in jax_lods_and_effects(*jargs, precision=jcfg.FAST32))
        assert float((np.abs(b.double().numpy() - jb) / (np.abs(jb) + js)).max()) < 1e-4
        assert float((np.abs(s.double().numpy() - js) / js).max()) < 1e-4
    assert not launch_counts


# --- the chunked kernels under "high" (bf16x3) -----------------------------------------


@pytest.mark.parametrize("dot_precision, chunk", [("highest", 40), ("high", 32)])
def test_chunk_samples_by_products(dot_precision, chunk):
    """Five TF32 steps of 8 a chunk, or two bf16 steps of 16 (the wide
    kernel's shared memory allows no more)."""
    assert lf.chunk_samples(dot_precision) == chunk
    assert chunk % (16 if dot_precision == "high" else 8) == 0


@pytest.mark.parametrize("n, tf32, bf16", [(1, 40, 32), (40, 40, 64), (48, 80, 64), (79, 80, 96),
                                           (89, 120, 96), (150, 160, 160), (2000, 2000, 2016)])
def test_walk_samples_pad_to_whole_chunks(n, tf32, bf16):
    """The chunked kernels walk n up to a whole chunk, the rest zeros: BXD's
    79 samples take 80 under 3 x TF32 and 96 (17 padded) under bf16x3."""
    assert lf.walk_samples(n) == tf32 and lf.walk_samples(n, "high") == bf16


@pytest.mark.parametrize("n", [1, 79, 89, 200, 201, 2000])
def test_fold_chunks_by_products(n):
    """3 x TF32: a fold after every chunk up to 200 samples, every 5 chunks
    past them; bf16x3: no fold, the whole walk in one accumulator."""
    assert lf.fold_chunks(n) == (1 if n <= 200 else lf.FOLD_CHUNKS)
    assert lf.fold_chunks(n, "high") is None
    with pytest.raises(ValueError, match="GEMM precision"):
        lf.fold_chunks(n, "medium")


#: the chunked bf16x3 twin's shapes (n, c): the general kernel at 150 and
#: 2,000 samples, the wide one at c = 4 and 12
BF16_CHUNKED_SHAPES = [(150, 1), (150, 3), (2000, 1), (2000, 3), (150, 4), (150, 12)]


@pytest.mark.parametrize("n, c", BF16_CHUNKED_SHAPES)
def test_bf16x3_chunked_reference_is_throughput_grade(n, c):
    """The general and wide kernels' arithmetic under "high"
    (``liteqtl_bf16x3_chunked_reference``) on the operands of the kernel's
    own path, 120 markers x 80 traits from a numpy seed, against the JAX
    package's ``lods_per_trait`` under EXACT64: within its THROUGHPUT bound
    4e-3 (tests/test_bulkscan.py:138), scaled by n / 79 past BXD's 79
    samples as the chip smoke run scales its bars, and not equal to it.
    Against the resident kernel's bf16x3 plain version
    (``liteqtl_bf16x3_reference``, round-to-nearest sums in one order):
    TWIN_BAR, the bar of the 3 x TF32 twin against the float32 plain
    version (both sides bf16x3 float32 sums in other orders)."""
    p, m = 120, 80
    args = _mk(n, p, m, c)
    ops = lf.prepare_inputs(*[torch.from_numpy(a) for a in args])
    assert lf.kernel_path(n, c) == ("wide" if c > 3 else "general")
    out = lf.liteqtl_bf16x3_chunked_reference(*ops)
    assert out.shape == (p, m) and out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    exact = jax_lods_per_trait(*[jnp.asarray(a.astype(np.float64)) for a in args],
                               precision=jcfg.EXACT64)
    assert 0 < _maxdiff(out, exact) < 4e-3 * max(1.0, n / 79)
    assert float((out - lf.liteqtl_bf16x3_reference(*ops)).abs().max()) < TWIN_BAR[max(200, n)]
    assert not launch_counts


def test_bf16x3_chunked_reference_effects():
    """The effects variant of the same arithmetic: its LOD is the LOD-only
    reference's, and its effects stay within 1e-4 of (|effect| + SE) and of
    SE from the float32 plain version, as the kernels' effects are held."""
    _, targs = _both(_mk(150, 70, 45, 4))
    ops = lf.prepare_inputs(*targs, effects=True)
    L, b, s = lf.liteqtl_bf16x3_chunked_reference(*ops, effects=True)
    Lp, bp, sp = lf.liteqtl_lod_plain(*ops, effects=True)
    assert torch.equal(L, lf.liteqtl_bf16x3_chunked_reference(*ops[:4], ops[4][:-1]))
    assert float(((b - bp).abs() / (bp.abs() + sp)).max()) < 1e-4
    assert float(((s - sp).abs() / sp).max()) < 1e-4


# --- the markers off the covariates' span -----------------------------------------


@pytest.mark.parametrize("c", [1, 3])
def test_off_covariates_keeps_every_weighted_residual(c):
    """off_covariates takes out of each marker its part in the covariates'
    span and nothing else: the result is orthogonal to C, and its residual
    on C under any per-sample weights is the marker's own (float64, 1e-12);
    an all-zero, a constant and a covariate-combination marker come out as
    exact zeros."""
    rng = np.random.default_rng(20 + c)
    n, p = 40, 12
    C = torch.from_numpy(np.concatenate([np.ones((n, 1)), rng.normal(size=(n, c - 1))], 1))
    X = torch.from_numpy(rng.normal(size=(n, p)) + 3.0)
    X[:, 0] = 0.0
    X[:, 1] = 2.5
    X[:, 2] = C @ torch.from_numpy(rng.normal(size=c))
    Xr = off_covariates(X, C)
    assert bool((Xr[:, :3] == 0).all())
    assert float((C.T @ Xr).abs().max()) < 1e-12 * float(X.abs().max())
    for _ in range(3):
        w = torch.from_numpy(rng.uniform(0.1, 3.0, n))
        Cw = C * w.sqrt()[:, None]
        Q = torch.linalg.qr(Cw)[0]

        def residual(M):
            Mw = M * w.sqrt()[:, None]
            return Mw - Q @ (Q.T @ Mw)

        assert float((residual(Xr) - residual(X))[:, 3:].abs().max()) < 1e-12 * float(X.abs().max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("case", ["singleton", "small residual"])
def test_off_covariates_keeps_a_small_genuine_residual(case, dtype):
    """Only rounding noise is zeroed, in the markers' own dtype: a singleton
    coded by the major allele at n = 10,000 (residual norm^2 1e-4 of its
    own) and a marker whose residual is 1e-3 of its size (norm^2 1e-6) keep
    their residual, as the float64 model keeps their LOD; a constant marker
    beside them is zeroed."""
    n = 10_000 if case == "singleton" else 200
    rng = np.random.default_rng(4)
    C = torch.ones((n, 1), dtype=torch.float64)
    if case == "singleton":
        x = np.ones(n)
        x[17] = 0.0
    else:
        z = rng.normal(size=n)
        x = 1.0 + 1e-3 * (z - z.mean()) / z.std()
    X = torch.from_numpy(np.stack([x, np.full(n, 3.0)], 1)).to(dtype)
    Xr = off_covariates(X, C)
    want = X.double()[:, 0] - X.double()[:, 0].mean()
    assert float((Xr[:, 0].double() - want).abs().max()) < 1e-3 * float(want.abs().max())
    assert bool((Xr[:, 1] == 0).all())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_off_covariates_takes_the_cancellation_out(seed):
    """On a BXD-shaped rotated fixture (the intercept concentrated in the
    largest eigenvalue's sample, where the markers' means sit) the resident
    kernel's arithmetic (its split reference: the tensor cores' sums) is
    closer to the float64 LOD of the same weights with the prepared,
    off-covariates markers than with the raw rotated ones."""
    import chip_smoke

    n, p, m = 79, 128, 256
    G, K, Y = chip_smoke.synth_bxd(n, p, m, seed=seed)
    lam, U = np.linalg.eigh(K)
    X0m = torch.from_numpy(U.T @ G.astype(np.float64))
    Y0 = torch.from_numpy(U.T @ Y.astype(np.float64))
    C0 = torch.from_numpy(U.T @ np.ones((n, 1)))
    h2 = torch.from_numpy(np.random.default_rng(seed).uniform(0.0, 0.9, m))
    ops = lf.prepare_inputs(Y0, X0m, C0, torch.from_numpy(lam), h2)
    raw = (lf._marker_operand(X0m),) + tuple(ops[1:])
    exact = lf._lod_with_product(X0m, *[o.double() for o in ops[1:]], torch.matmul)

    def err(o):
        return float((lf.liteqtl_split_reference(*o).double() - exact).abs().max())

    assert err(ops) < err(raw)
