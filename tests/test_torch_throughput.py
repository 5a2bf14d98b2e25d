"""The THROUGHPUT preset's "high" products through the port's entry points,
on the CPU: every model that calls a kernel's entry passes the preset's
``gemm_precision`` where the JAX package passes it (``dot_precision`` of
its Pallas kernels), and nothing else changes what it computes.

On CPU tensors the alt-grid and permutation kernels' plain versions take
bf16x3 products under "high" (test_torch_altgrid.py and
test_torch_bulkperm.py hold them against the Pallas kernels in interpret
mode), while the LOD step keeps float32 products, as XLA's HIGH does on a
CPU: THROUGHPUT's null-grid scan is FAST32's bit for bit here. On the card
``chip_smoke.py`` holds each bf16x3 kernel against its bf16x3 plain version
and THROUGHPUT at BXD scale against EXACT64.
"""

import importlib

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import altgrid_fused as af
from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
from bulklmm_tpu_torch.utils import config as tcfg
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

PRECISIONS = {"BALANCED": "highest", "FAST32": "highest", "THROUGHPUT": "high"}


def _spy(monkeypatch, module, name):
    """Replace ``module.name`` by a wrapper that records each call's
    precision (its sixth positional argument or its ``dot_precision``)."""
    mod = importlib.import_module(module)
    real = getattr(mod, name)
    seen = []

    def spy(*a, **k):
        seen.append(k.get("dot_precision", a[5] if len(a) > 5 else "highest"))
        return real(*a, **k)

    monkeypatch.setattr(mod, name, spy)
    return seen


def test_presets_name_their_products_as_the_jax_package_does():
    """THROUGHPUT alone has "high" products (the JAX package's
    Precision.HIGH); the others "highest"."""
    for name in ("FAST32", "MIXED", "EXACT64", "BALANCED", "THROUGHPUT"):
        want = "high" if getattr(jcfg, name).gemm_precision == jcfg.THROUGHPUT.gemm_precision else "highest"
        assert tcfg.precision_by_name(name).gemm_precision == want
    assert tcfg.THROUGHPUT.gemm_precision == "high"


@pytest.mark.parametrize("name", ["medium", "HIGH", "tf32", ""])
def test_precision_config_refuses_other_products(name):
    with pytest.raises(ValueError, match="GEMM precision"):
        tcfg.PrecisionConfig(solve_dtype=torch.float32, gemm_precision=name)


@pytest.mark.parametrize("preset", list(PRECISIONS))
@pytest.mark.parametrize("effects", [False, True], ids=["lod", "effects"])
def test_lod_step_passes_the_products(bxd_like, monkeypatch, preset, effects):
    name = "fused_lods_and_effects_per_trait" if effects else "fused_lods_per_trait"
    seen = _spy(monkeypatch, "bulklmm_tpu_torch.models.bulkscan", name)
    bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], output_effects=effects,
                precision=bt.precision_by_name(preset), device="cpu")
    assert seen == [PRECISIONS[preset]]
    assert not launch_counts


def test_throughput_null_grid_is_fast32_on_the_cpu(bxd_like):
    """The CPU LOD step keeps float32 products under "high"."""
    args = (bxd_like["Y"], bxd_like["G"], bxd_like["K"])
    a = bt.bulkscan(*args, precision=bt.THROUGHPUT, device="cpu")
    b = bt.bulkscan(*args, precision=bt.FAST32, device="cpu")
    assert torch.equal(a.L, b.L) and torch.equal(a.h2_null_list, b.h2_null_list)


@pytest.mark.parametrize("preset", list(PRECISIONS))
def test_alt_grid_kernel_call_passes_the_products(bxd_like, monkeypatch, preset):
    """With the kernel's route forced on CPU tensors, the alt-grid entry gets
    the preset's products, and under THROUGHPUT its bf16x3 plain version
    runs (within the file's kernel bar of the Pallas kernel at HIGH on the
    JAX side of test_torch_altgrid.py)."""
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    monkeypatch.setattr(mb, "takes_cuda_kernel", lambda *a, **k: True)
    seen = _spy(monkeypatch, "bulklmm_tpu_torch.models.bulkscan", "fused_alt_grid")
    res = bt.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="alt-grid",
                      precision=bt.precision_by_name(preset), device="cpu")
    assert seen == [PRECISIONS[preset]] and bool(torch.isfinite(res.L).all())
    if preset == "THROUGHPUT":
        ref = bl.bulkscan(bxd_like["Y"], bxd_like["G"], bxd_like["K"], method="alt-grid",
                          precision=jcfg.EXACT64)
        gap = float(np.abs(res.L.double().numpy() - np.asarray(ref.L)).max())
        assert 0 < gap < 2e-2  # the JAX package's THROUGHPUT alt-grid bar (tests/test_pallas_altgrid.py)
    assert not launch_counts


@pytest.mark.parametrize("preset", ["BALANCED", "THROUGHPUT"])
def test_streamed_alt_grid_passes_the_products(bxd_like, monkeypatch, tmp_path, preset):
    mb = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
    seen = _spy(monkeypatch, "bulklmm_tpu_torch.models.streaming", "fused_alt_grid")
    monkeypatch.setattr(mb, "takes_cuda_kernel", lambda *a, **k: True)
    G = np.ascontiguousarray(bxd_like["G"])
    bt.bulkscan_streamed(bxd_like["Y"], G, bxd_like["K"], method="alt-grid", marker_block=16,
                         precision=bt.precision_by_name(preset), device="cpu")
    blocks = -(-G.shape[1] // 16)
    assert seen == [PRECISIONS[preset]] * blocks


@pytest.mark.parametrize("preset", list(PRECISIONS))
def test_permutation_kernel_call_passes_the_products(bxd_like, monkeypatch, preset):
    seen = _spy(monkeypatch, "bulklmm_tpu_torch.models.bulkperm", "fused_perm_maxlods_reference")
    res = bt.bulkscan_perms(bxd_like["Y"], bxd_like["G"], bxd_like["K"], nperms=8, engine="pallas",
                            interpret=True, precision=bt.precision_by_name(preset), device="cpu")
    assert seen == [PRECISIONS[preset]] and bool(torch.isfinite(res.maxlods).all())
    assert not launch_counts


@pytest.mark.parametrize("entry", ["alt-grid", "alt-grid reference", "alt-grid plain", "permutation",
                                   "permutation reference", "permutation plain"])
def test_unknown_dot_precision_raises(entry):
    rng = np.random.default_rng(1)
    t = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    with pytest.raises(ValueError, match="GEMM precision"):
        if entry.startswith("alt-grid"):
            grid = torch.tensor([0.2, 0.5])
            args = (t(12, 5), t(12, 7), torch.ones(12, 1), t(12).abs() + 0.1, grid)
            if entry == "alt-grid plain":
                af.altgrid_plain(t(2, 12, 7), t(2, 12, 5), t(2, 5).abs(), dot_precision="medium")
            else:
                fn = af.fused_alt_grid if entry == "alt-grid" else af.fused_alt_grid_reference
                fn(*args, prior=(1.0, 0.0), dot_precision="medium")
        else:
            X, S2, inv = t(12, 7), t(2, 12, 3), t(2, 7).abs()
            if entry == "permutation plain":
                bf.bulkperm_maxr2_plain(X, S2, inv, dot_precision="medium")
            else:
                fn = bf.fused_perm_maxlods if entry == "permutation" else bf.fused_perm_maxlods_reference
                fn(X, S2, inv, n=12, dot_precision="medium")
