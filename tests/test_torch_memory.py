"""Device-memory sizing of the port (``utils/memory.py``) and the host trait
blocks of ``bulkscan`` (``models/bulkscan.py::_host_blocked_bulkscan``).

The decisions are held at the shapes of the JAX package's
tests/test_memory.py, under that package's 13.1 GiB budget (16 GiB x 0.82)
and under an H100's (~71 GiB: 0.9 of 79 GiB free): the flagship stays one
block, a mid-size cohort takes a chunk, a biobank cohort takes host blocks
on the smaller card and a chunk on the H100, and an impossible one raises
with the ways out. Byte counts are not asserted: the H100 calibration of the
multipliers may differ from the TPU's. A host-blocked ``bulkscan``, forced
by patching the budget, must equal the one-block call to 1e-9 (EXACT64).
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.utils import memory as mem

torch.set_num_threads(1)

TPU_BUDGET = int(16 * 1024**3 * 0.82)
H100_BUDGET = int(0.9 * 79 * 1024**3)


@pytest.mark.parametrize("budget", [TPU_BUDGET, H100_BUDGET], ids=["16GiB", "H100"])
def test_flagship_shape_stays_one_block(budget):
    assert mem.auto_trait_chunk(79, 7321, 35554, budget=budget) is None


def test_midsize_shape_takes_a_chunk_that_fits():
    n, p, m = 5000, 50_000, 20_000
    mc = mem.auto_trait_chunk(n, p, m, budget=TPU_BUDGET)
    assert mc is not None and mem.TRAIT_QUANTUM <= mc < m and mc % mem.TRAIT_QUANTUM == 0
    used = (mem.bulkscan_static_bytes(n, p, m, 1, 4) * mem._STATIC_HEADROOM
            + mem.bulkscan_chunk_bytes(n, p, mc, 10, 1, 4))
    assert used <= TPU_BUDGET
    # one more tile would not fit
    assert (mem.bulkscan_static_bytes(n, p, m, 1, 4) * mem._STATIC_HEADROOM
            + mem.bulkscan_chunk_bytes(n, p, mc + 2 * mem.TRAIT_QUANTUM, 10, 1, 4)) > TPU_BUDGET


def test_biobank_shape_goes_host_blocked_on_a_small_card_and_chunks_on_the_h100():
    n, p, m = 5000, 100_000, 20_000
    with pytest.raises(ValueError):
        mem.auto_trait_chunk(n, p, m, budget=TPU_BUDGET)
    mh = mem.auto_host_block(n, p, m, budget=TPU_BUDGET)
    assert mem.TRAIT_QUANTUM <= mh < m and mh % mem.TRAIT_QUANTUM == 0
    assert mem.auto_trait_chunk(n, p, mh, budget=TPU_BUDGET) is None
    mc = mem.auto_trait_chunk(n, p, m, budget=H100_BUDGET)
    assert mc is not None and mc < m


def test_impossible_shape_raises_with_the_ways_out():
    with pytest.raises(ValueError, match="bulkscan_streamed"):
        mem.auto_trait_chunk(5000, 1_000_000, 200_000, budget=16 * 1024**3)
    with pytest.raises(ValueError, match="stream"):
        mem.auto_host_block(5000, 1_000_000, 50_000, budget=16 * 1024**3)
    with pytest.raises(ValueError, match="trait-side"):
        mem.auto_marker_block(50_000, 500_000, budget=4 * 1024**3)


def test_auto_host_block_charges_two_blocks_of_outputs():
    """One block's outputs are copied to the host while the next block runs,
    so a host block is charged two blocks' (p, mh) outputs."""
    n, p, m, nout = 5000, 150_000, 50_000, 3
    budget = 16 * 1024**3
    mh = mem.auto_host_block(n, p, m, n_outputs=nout, budget=budget)
    base = (mem.bulkscan_static_bytes(n, p, 0, 1, 4) + 2 * n * m * 4) * mem._STATIC_HEADROOM
    two = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 4) + 2 * nout * p * 4 * mem._STATIC_HEADROOM
    one = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 4) + nout * p * 4 * mem._STATIC_HEADROOM
    assert base + two * mh <= budget < base + two * (mh + mem.TRAIT_QUANTUM)
    assert mh < (budget - base) // one  # a one-block charge would plan wider blocks


def test_auto_marker_block():
    assert mem.auto_marker_block(5000, 20_000, budget=32 * 1024**3) == 32_768
    small = mem.auto_marker_block(5000, 20_000, budget=3 * 1024**3)
    assert 1024 <= small < 32_768 and small % 1024 == 0


def test_cpu_budget_is_half_the_host_ram():
    import os

    ram = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert mem.device_memory_budget("cpu") == ram // 2 > 1024**3


def test_mesh_position_budget_divides_a_repeated_device(monkeypatch):
    """A device named r times in a mesh gives each of its positions 1/r of
    its budget, and a mesh's tiles are sized for its least position: a
    virtual mesh on one card must not size every tile for the whole card."""
    budgets = {"cpu": 8 * 1024**3, "meta": 3 * 1024**3}
    monkeypatch.setattr(mem, "device_memory_budget", lambda d: budgets[torch.device(d).type])
    assert mem.mesh_position_budget(["cpu"]) == 8 * 1024**3
    assert mem.mesh_position_budget(["cpu"] * 4) == 2 * 1024**3
    assert mem.mesh_position_budget(["cpu"] * 2 + ["meta"]) == 3 * 1024**3
    assert mem.mesh_position_budget(["cpu"] * 2 + ["meta"] * 2) == 3 * 1024**3 // 2
    # the sharded scan sizes one tile (p / marker shards, m / trait shards)
    # against that share: the same decision as one device at that size
    from bulklmm_tpu_torch.models.bulkscan import _auto_chunk
    from bulklmm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(devices=["cpu"] * 4, marker_shards=2)
    dims = dict(grid=10, c=1, itemsize=8, n_outputs=1, alt_grid=False, rank=None)
    budgets["cpu"] = 4 * 600 * 1024**2
    got = _auto_chunk(mesh, m=4096, dims=dict(n=400, p=20_000, **dims))
    one = mem.auto_trait_chunk(400, 10_000, 2048, budget=600 * 1024**2, **dims)
    assert one is not None and got == 2 * one


@pytest.fixture(scope="module")
def small_data():
    """p large enough that the (p, m) outputs dominate the model: host blocks
    and not a trait chunk are the way out."""
    rng = np.random.default_rng(21)
    n, p, m = 40, 1000, 300
    G = rng.uniform(0, 1, (n, p))
    K = np.asarray(bl.calc_kinship(G))
    Y = rng.normal(size=(n, m))
    return G, Y, K


def _forcing_budget(n, p, m, nout, alt_grid=False):
    """A budget inside the window where auto_trait_chunk refuses (not one
    64-trait chunk fits beside the (p, m) outputs) but auto_host_block fits
    a few tiles: EXACT64's 8-byte model."""
    per_chunk = mem.bulkscan_chunk_bytes(n, p, 1, 10, 1, 8, alt_grid=alt_grid)
    static = mem.bulkscan_static_bytes(n, p, m, 1, 8, n_outputs=nout) * mem._STATIC_HEADROOM
    base = (mem.bulkscan_static_bytes(n, p, 0, 1, 8) + 2 * n * m * 8) * mem._STATIC_HEADROOM
    per_host = per_chunk + 2 * nout * p * 8 * mem._STATIC_HEADROOM
    lo = base + mem.TRAIT_QUANTUM * per_host
    hi = static + mem.TRAIT_QUANTUM * per_chunk
    assert lo < hi, "the data cannot force the host-block window"
    return int(lo + hi) // 2


@pytest.mark.parametrize("case", ["null-grid", "null-exact", "alt-grid", "effects", "weights"])
def test_host_blocked_bulkscan_equals_one_block(small_data, monkeypatch, case):
    G, Y, K = small_data
    n, p, m = G.shape[0], G.shape[1], Y.shape[1]
    kw = dict(precision=bt.EXACT64, device="cpu")
    if case in ("null-grid", "null-exact", "alt-grid"):
        kw.update(method=case, output_pvals=True)
        nout = 3 if case == "alt-grid" else 2
    elif case == "effects":
        kw.update(output_effects=True)
        nout = 3
    else:
        kw.update(weights=np.random.default_rng(2).uniform(0.5, 2.0, n))
        nout = 1
    ref = bt.bulkscan(Y, G, K, trait_chunk=m, **kw)
    alt = case == "alt-grid"
    budget = _forcing_budget(n, p, m, nout, alt)
    monkeypatch.setattr(mem, "device_memory_budget", lambda device=None: budget)
    with pytest.raises(ValueError):
        mem.auto_trait_chunk(n, p, m, itemsize=8, n_outputs=nout, alt_grid=alt)
    assert mem.auto_host_block(n, p, m, itemsize=8, n_outputs=nout, alt_grid=alt) < m  # several blocks
    res = bt.bulkscan(Y, G, K, **kw)
    assert isinstance(res.L, np.ndarray)  # assembled on the host
    for f in ("L", "h2_null_list", "h2_panel", "beta_mat", "beta_se_mat", "log10Pvals_mat"):
        a, b = getattr(res, f), getattr(ref, f)
        assert (a is None) == (b is None), f
        if a is not None:
            assert a.dtype == b.numpy().dtype and a.shape == tuple(b.shape), f
            np.testing.assert_allclose(a, b.numpy(), rtol=0, atol=1e-9, err_msg=f)


def test_wide_covariates_count_their_operand():
    """More covariate columns cost the plain LOD step its (p,)-sized U_k and
    Z_k products; on the fused kernel's route (``kernel``, the float32
    presets) past the general kernel's 3 they cost the wide kernel's (c, n)
    operand and whitening a trait instead, and no (p,)-sized products. Up to
    3 columns the two routes are charged alike. At c = 32 the flagship takes
    chunks on the plain route that fit the H100's budget, and GTEx v8's
    706 x 20,000 x 20,000 at c = 69 is one block on the kernel's route, as
    the card ran it (peak 16.44 GB in one chunk)."""
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf

    assert mem.WIDE_FROM == lf.GENERAL_COVARIATES + 1 == 4
    n, p = 79, 7321
    c0 = mem.WIDE_FROM

    def per_trait(c, kernel=False, alt_grid=False):
        return mem.bulkscan_chunk_bytes(n, p, 1, 10, c, 8, kernel=kernel, alt_grid=alt_grid)

    # the plain route: each column its (p,)-sized products, each pair of
    # columns its (n,)-sized copies, whatever c is
    assert per_trait(1) < per_trait(c0 - 1) < per_trait(c0) < per_trait(32)
    step = 8 * (mem._P_COPIES_A_COVARIATE * p
                + mem._N_CHUNK_COPIES * n * ((c0 + 2) // 2 - (c0 + 1) // 2))
    assert per_trait(c0) - per_trait(c0 - 1) == step
    assert per_trait(9) - per_trait(8) == 8 * (mem._P_COPIES_A_COVARIATE * p
                                               + mem._N_CHUNK_COPIES * n * (11 // 2 - 10 // 2))
    # the kernel's route is the plain route's up to 3 columns, bit for bit
    for c in range(1, c0):
        assert per_trait(c, kernel=True) == per_trait(c)
    # past them, the wide kernel's: each column its (n,)-sized operand alone
    wide = 8 * (mem._WIDE_P_COPIES * p + (mem._N_CHUNK_COPIES + mem._WIDE_N_COPIES * c0) * n + 10)
    assert per_trait(c0, kernel=True) == wide < per_trait(c0)
    assert per_trait(9, kernel=True) - per_trait(8, kernel=True) == 8 * mem._WIDE_N_COPIES * n
    # alt-grid takes no LOD kernel: its own route at any c
    for c in (c0, 32):
        assert per_trait(c, kernel=True, alt_grid=True) == per_trait(c, alt_grid=True)
    mc = mem.auto_trait_chunk(n, p, 35554, c=32, itemsize=8, budget=H100_BUDGET)
    assert mc is not None and mc % mem.TRAIT_QUANTUM == 0
    used = (mem.bulkscan_static_bytes(n, p, 35554, 32, 8) * mem._STATIC_HEADROOM
            + mem.bulkscan_chunk_bytes(n, p, mc, 10, 32, 8))
    assert used <= H100_BUDGET


@pytest.mark.parametrize("budget", [75_407_187_456, H100_BUDGET], ids=["card", "H100"])
def test_gtex_muscle_is_one_block_on_the_wide_kernel(budget):
    """GTEx v8 skeletal muscle (706 donors, 69 covariate columns) at 20,000
    markers x 20,000 genes under BALANCED: the card's budget as the
    benchmark read it (75.4 GB) and the nominal H100's keep the call in one
    block, whose charge lies above the 16.44 GB peak the card measured in
    one chunk (the rule before the wide route charged 27 MB a trait and
    took chunks of 2,624 traits, 8 a call, at a peak of 4.49 GB); the plain
    route (EXACT64) still takes chunks."""
    dims = dict(n=706, p=20_000, m=20_000, c=69, itemsize=8)
    assert mem.auto_trait_chunk(**dims, kernel=True, budget=budget) is None
    charged = (mem.bulkscan_static_bytes(706, 20_000, 20_000, 69, 8) * mem._STATIC_HEADROOM
               + mem.bulkscan_chunk_bytes(706, 20_000, 20_000, 10, 69, 8, kernel=True))
    assert 16.44e9 < charged <= budget
    assert mem.auto_trait_chunk(**dims, budget=budget) is not None
