"""The split products on the CPU: ``bulklmm_tpu_torch/kernels/split.py``
(the plain-torch twin of ``csrc/mma_tf32x3.cuh`` and of the THROUGHPUT
preset's bf16x3, ``csrc/mma_bf16x3.cuh``) and the three split references
that repeat the CUDA kernels' arithmetic. The bf16 rounding is held bit for
bit against JAX's ``astype(bfloat16)``.

The CUDA kernels themselves run only on the card, where chip_smoke.py holds
each against its plain version and its split reference. Here the split's
accuracy is held against float64, against the plain versions and against
the JAX package's Pallas kernels in interpret mode, on inputs made with numpy
from a seed, at small sizes; the rules that pick the permutation kernel's
path and pad a row to 16 bytes are held case by case.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bulklmm_tpu.ops import bulkperm as jops
from bulklmm_tpu.pallas import bulkperm_fused as jfused
from bulklmm_tpu.pallas.altgrid_fused import fused_alt_grid as jax_fused_alt_grid
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import accumulate_probe as ap
from bulklmm_tpu_torch.kernels import altgrid_fused as af
from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
from bulklmm_tpu_torch.kernels import split
from bulklmm_tpu_torch.ops import bulkperm as tops
from bulklmm_tpu_torch.utils.profiling import launch_counts

torch.set_num_threads(1)

GRID = np.arange(0.0, 0.91, 0.1)
PRIOR = (1.0, 0.0)


# --- the rounding and the split ------------------------------------------------


def _bits(x):
    return x.contiguous().view(torch.int32)


def test_tf32_round_zeroes_the_low_bits_and_rounds_to_nearest():
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 7, 4096)).astype(np.float32))
    r = split.tf32_round(x)
    assert r.dtype == torch.float32 and r.shape == x.shape
    assert bool(((_bits(r) & 0x1FFF) == 0).all())
    # nearest: within half a unit of TF32's last place, 2^-11 relative
    assert float(((r - x).abs() / x.abs()).max()) <= 2.0**-11
    # idempotent, odd, and exact on values that are TF32 already
    assert torch.equal(split.tf32_round(r), r)
    assert torch.equal(split.tf32_round(-x), -r)


@pytest.mark.parametrize("low, expected_low", [(0x0FFF, 0x0000), (0x1000, 0x2000), (0x1001, 0x2000)],
                         ids=["below-half-down", "tie-away-from-zero", "above-half-up"])
def test_tf32_round_at_the_half_way_point(low, expected_low):
    one = 0x3F800000  # 1.0f
    x = torch.tensor([one | low, (one | low) - 2**31], dtype=torch.int32).view(torch.float32)
    want = torch.tensor([one + expected_low, one + expected_low - 2**31], dtype=torch.int32)
    assert torch.equal(_bits(split.tf32_round(x)), want)


def test_tf32_round_refuses_other_dtypes():
    with pytest.raises(TypeError, match="float32"):
        split.tf32_round(torch.zeros(3, dtype=torch.float64))


def test_tf32_split_restores_the_value():
    rng = np.random.default_rng(1)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-6, 7, 4096)).astype(np.float32))
    big, small = split.tf32_split(x)
    assert bool(((_bits(big) & 0x1FFF) == 0).all()) and bool(((_bits(small) & 0x1FFF) == 0).all())
    rel = ((big.double() + small.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0**-21
    assert float((small.abs() / x.abs()).max()) <= 2.0**-11


def test_tf32_split_of_zeros_subnormals_and_infinities_stays_sane():
    tiny = float(np.finfo(np.float32).tiny)
    x = torch.tensor([0.0, -0.0, tiny, -tiny, tiny / 1024, 1e-45, np.inf, -np.inf], dtype=torch.float32)
    big, small = split.tf32_split(x)
    assert bool(torch.isfinite(big[:6]).all()) and bool(torch.isfinite(small[:6]).all())
    assert torch.equal(big[:2], x[:2]) and bool((small[:2] == 0).all())
    assert float(((big + small) - x)[2:6].abs().max()) <= tiny * 2.0**-10
    assert torch.equal(big[6:], x[6:])


# --- the bf16 rounding and split (bf16x3, "high") -------------------------------


def _jax_bf16(x):
    """JAX's float32 -> bfloat16 -> float32, the rounding of its HIGH."""
    return torch.from_numpy(np.asarray(jnp.asarray(x.numpy()).astype(jnp.bfloat16).astype(jnp.float32)))


def _bf16_cases(kind):
    one = 0x3F800000  # 1.0f; bf16 keeps the 7 high mantissa bits, 16 low bits go
    tiny = float(np.finfo(np.float32).tiny)
    if kind == "ties":  # half-way points below an even and an odd last bit, both signs
        ints = [one | 0x8000, one | 0x18000, one | 0x7FFF, one | 0x8001, 0x7F7F8000, 0x00018000]
        ints += [i | -(2**31) for i in ints]
        return torch.tensor(ints, dtype=torch.int32).view(torch.float32)
    if kind == "zeros":
        return torch.tensor([0.0, -0.0], dtype=torch.float32)
    if kind == "subnormals":
        return torch.tensor([1e-45, -1e-45, tiny / 3, -tiny / 3, tiny / 1024 * 3, tiny * (1 - 2**-10)],
                            dtype=torch.float32)
    if kind == "infinities":  # and the largest float32, which rounds up to inf
        return torch.tensor([np.inf, -np.inf, float(np.finfo(np.float32).max)], dtype=torch.float32)
    rng = np.random.default_rng(5)
    return torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)).astype(np.float32))


@pytest.mark.parametrize("kind", ["ties", "zeros", "subnormals", "infinities", "random"])
def test_bf16_round_equals_jax_astype_bit_for_bit(kind):
    x = _bf16_cases(kind)
    r = split.bf16_round(x)
    assert r.dtype == torch.float32 and r.shape == x.shape
    assert torch.equal(_bits(r), _bits(_jax_bf16(x)))
    assert bool(((_bits(r) & 0xFFFF) == 0).all())


def test_bf16_round_ties_to_even_where_tf32_rounds_away():
    one = 0x3F800000
    x = torch.tensor([one | 0x8000], dtype=torch.int32).view(torch.float32)  # 1 + 2^-8
    assert _bits(split.bf16_round(x)).item() == one  # the even neighbour, down
    with pytest.raises(TypeError, match="float32"):
        split.bf16_round(torch.zeros(3, dtype=torch.float64))


def test_bf16_split_restores_the_value():
    rng = np.random.default_rng(6)
    x = torch.from_numpy((rng.normal(size=4096) * 10.0 ** rng.integers(-20, 20, 4096)).astype(np.float32))
    hi, lo = split.bf16_split(x)
    assert bool(((_bits(hi) & 0xFFFF) == 0).all()) and bool(((_bits(lo) & 0xFFFF) == 0).all())
    rel = ((hi.double() + lo.double()) - x.double()).abs() / x.double().abs()
    assert float(rel.max()) <= 2.0**-16
    assert float((lo.abs() / x.abs()).max()) <= 2.0**-8
    assert torch.equal(hi, _jax_bf16(x)) and torch.equal(lo, _jax_bf16(x - hi))


@pytest.mark.parametrize("n", [52, 2000])
def test_matmul_bf16x3_is_the_jax_emulation_and_drops_the_small_term(n):
    """Against JAX's three bf16 dots of the Pallas kernels' HIGH branch, on
    the same halves: float32 rounding of another summation order. Against
    float64: within 2^-16 sum |a b| plus float32's own error, and apart from
    the exact float32 product by more than it (the dropped lo * lo term)."""
    rng = np.random.default_rng(n + 1)
    A = torch.from_numpy(rng.normal(size=(96, n)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32))
    out = split.matmul_bf16x3(A, B)
    bf16 = jnp.bfloat16
    jA, jB = jnp.asarray(A.numpy()), jnp.asarray(B.numpy())
    Ah, Bh = jA.astype(bf16), jB.astype(bf16)
    Al, Bl = (jA - Ah.astype(jnp.float32)).astype(bf16), (jB - Bh.astype(jnp.float32)).astype(bf16)
    dot = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)  # noqa: E731
    emulated = torch.from_numpy(np.asarray(dot(Ah, Bh) + dot(Ah, Bl) + dot(Al, Bh)))
    exact = A.double() @ B.double()
    err32 = float((A @ B - exact).abs().max())
    scale = (A.double().abs() @ B.double().abs())
    assert float((out - emulated).abs().max()) <= 4 * err32
    assert bool(((out.double() - exact).abs() <= 2.0**-16 * scale + 4 * err32).all())
    assert float((out.double() - exact).abs().max()) > err32
    with torch.no_grad():
        assert tuple(split.matmul_bf16x3(A[:7], B.expand(3, n, 40)).shape) == (3, 7, 40)


@pytest.mark.parametrize("name, bf16", [("highest", False), ("high", True)])
def test_uses_bf16x3_names_the_products(name, bf16):
    assert split.uses_bf16x3(name) is bf16
    with pytest.raises(ValueError, match="GEMM precision"):
        split.uses_bf16x3("medium")


# --- the product -----------------------------------------------------------------


@pytest.mark.parametrize("n", [52, 2000])
def test_matmul_tf32x3_is_float32_grade_and_one_term_is_not(n):
    """Against the float64 product: three terms stay within 4 x the exact
    float32 product's own error; the leading term alone misses that bar by
    more than 10 x, so the bar has force."""
    rng = np.random.default_rng(n)
    A = torch.from_numpy(rng.normal(size=(96, n)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32))
    exact = A.double() @ B.double()
    err32 = float((A @ B - exact).abs().max())
    err3 = float((split.matmul_tf32x3(A, B) - exact).abs().max())
    err1 = float((split.matmul_tf32x1(A, B) - exact).abs().max())
    assert err3 <= 4 * err32
    assert err1 > 10 * 4 * err32


def test_matmul_tf32x3_batches_like_matmul():
    rng = np.random.default_rng(2)
    A = torch.from_numpy(rng.normal(size=(30, 17)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(5, 17, 9)).astype(np.float32))
    out = split.matmul_tf32x3(A, B)
    assert tuple(out.shape) == (5, 30, 9) and out.dtype == torch.float32
    for t in range(5):
        assert torch.equal(out[t], split.matmul_tf32x3(A, B[t]))


@pytest.mark.parametrize("n", [52, 2000])
def test_matmul_tf32x3_chunked_is_float32_grade(n):
    """The chunked LOD kernels' form (chunks of 40, each run of
    ``fold_chunks(n)`` chunks added into a running total): within 4 x the
    exact float32 product's error of the float64 product, as the unchunked
    form."""
    rng = np.random.default_rng(n + 1)
    A = torch.from_numpy(rng.normal(size=(96, n)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32))
    exact = A.double() @ B.double()
    err32 = float((A @ B - exact).abs().max())
    out = split.matmul_tf32x3_emulated(A, B, chunk=lf.CHUNK_SAMPLES, run=lf.fold_chunks(n))
    assert float((out - exact).abs().max()) <= 4 * err32


@pytest.mark.parametrize("chunk", [17, 40, 64])
def test_matmul_tf32x3_chunked_one_chunk_is_the_unchunked_form(chunk):
    """A chunk as deep as the contraction takes the unchunked form's three
    passes in its order, into one accumulator: bit-equal; a batch is taken
    like matmul."""
    rng = np.random.default_rng(chunk)
    A = torch.from_numpy(rng.normal(size=(30, 17)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(5, 17, 9)).astype(np.float32))
    out = split.matmul_tf32x3_emulated(A, B, chunk=chunk)
    assert torch.equal(out, split.matmul_tf32x3_emulated(A, B, chunk=17))
    assert tuple(out.shape) == (5, 30, 9) and out.dtype == torch.float32


@pytest.mark.parametrize("n", [52, 2000])
def test_matmul_tf32x3_chunked_folded_is_float32_grade(n):
    """The kernels' form with their running totals (a sum every
    FOLD_CHUNKS chunks): within 4 x the exact float32 product's error of
    the float64 product."""
    rng = np.random.default_rng(n + 2)
    A = torch.from_numpy(rng.normal(size=(96, n)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32))
    exact = A.double() @ B.double()
    err32 = float((A @ B - exact).abs().max())
    out = split.matmul_tf32x3_emulated(A, B, chunk=lf.CHUNK_SAMPLES, run=lf.FOLD_CHUNKS)
    assert float((out - exact).abs().max()) <= 4 * err32


@pytest.mark.parametrize("fold", [1, 2, 3, 7])
def test_matmul_tf32x3_chunked_fold_adds_runs_into_a_total(fold):
    """A fold of `fold` chunks: each run of `fold` chunks summed as the
    unfolded form sums it, the runs' sums added in order; a fold as deep as
    the contraction is the unfolded form, bit-equal."""
    rng = np.random.default_rng(fold)
    A = torch.from_numpy(rng.normal(size=(30, 130)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(3, 130, 9)).astype(np.float32))
    chunk = 20
    run = chunk * fold
    want = None
    for r0 in range(0, 130, run):
        part = split.matmul_tf32x3_emulated(A[:, r0 : r0 + run], B[:, r0 : r0 + run], chunk=chunk)
        want = part if want is None else want + part
    assert torch.equal(split.matmul_tf32x3_emulated(A, B, chunk=chunk, run=fold), want)
    assert torch.equal(split.matmul_tf32x3_emulated(A, B, chunk=chunk, run=7),
                       split.matmul_tf32x3_emulated(A, B, chunk=chunk))


# --- the chunked bf16x3 twin (the general and wide LOD kernels under "high") ----------


def test_matmul_bf16x3_emulated_one_chunk_is_matmul_bf16x3():
    """One chunk as deep as the contraction: the three bf16 passes into one
    accumulator give ``matmul_bf16x3``'s products where every sum is exact
    (integers of up to 10 bits, a hi and a lo half each, 20 deep: every sum
    below 2^24; the lo x lo term dropped by both), bit for bit; batched as
    matmul."""
    rng = np.random.default_rng(5)
    A = torch.from_numpy(rng.integers(-600, 601, (3, 20, 20)).astype(np.float32))
    B = torch.from_numpy(rng.integers(-600, 601, (20, 11)).astype(np.float32))
    assert bool((split.bf16_split(A)[1] != 0).any())  # the lo halves are used
    out = split.matmul_bf16x3_emulated(A, B, chunk=20)
    assert tuple(out.shape) == (3, 20, 11) and out.dtype == torch.float32
    assert torch.equal(out, split.matmul_bf16x3(A, B))
    assert not torch.equal(out, A @ B)  # the dropped lo x lo term


@pytest.mark.parametrize("run", [None, 2], ids=["one accumulator", "folded"])
@pytest.mark.parametrize("n", [52, 2000])
def test_matmul_bf16x3_emulated_is_bf16x3_grade(n, run):
    """The chunked form (chunks of BF16_CHUNK_SAMPLES, the kernels' one
    accumulator over the walk) and a folded one (runs of 2 chunks into a
    total) against float64: within 2^-16 sum |a b| plus 4 x the exact
    float32 product's error, as ``matmul_bf16x3``; and apart from the exact
    float32 product by more than its error (the dropped lo x lo terms)."""
    rng = np.random.default_rng(n + 3)
    A = torch.from_numpy(rng.normal(size=(96, n)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(n, 40)).astype(np.float32))
    exact = A.double() @ B.double()
    err32 = float((A @ B - exact).abs().max())
    scale = A.double().abs() @ B.double().abs()
    out = split.matmul_bf16x3_emulated(A, B, chunk=lf.BF16_CHUNK_SAMPLES, run=run)
    assert bool(((out.double() - exact).abs() <= 2.0**-16 * scale + 4 * err32).all())
    assert float((out.double() - exact).abs().max()) > err32


@pytest.mark.parametrize("fold", [1, 2, 3])
def test_matmul_bf16x3_emulated_adds_runs_into_a_total(fold):
    """A run of ``fold`` chunks summed as the unfolded form sums it, the
    runs' sums added in order, rounded to nearest; a run as deep as the
    contraction is the unfolded form, bit-equal."""
    rng = np.random.default_rng(fold + 10)
    A = torch.from_numpy(rng.normal(size=(30, 130)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(3, 130, 9)).astype(np.float32))
    chunk = 32
    want = None
    for r0 in range(0, 130, chunk * fold):
        cut = slice(r0, r0 + chunk * fold)
        part = split.matmul_bf16x3_emulated(A[:, cut], B[:, cut], chunk=chunk)
        want = part if want is None else want + part
    assert torch.equal(split.matmul_bf16x3_emulated(A, B, chunk=chunk, run=fold), want)
    assert torch.equal(split.matmul_bf16x3_emulated(A, B, chunk=chunk, run=5),
                       split.matmul_bf16x3_emulated(A, B, chunk=chunk))


def test_matmul_bf16x3_emulated_sums_as_the_tensor_cores():
    """Each depth step of 16 is one tensor-core sum of the bf16 model: on
    one step the twin is ``tensor_core_sum`` of the three passes' exact
    products, pass after pass."""
    rng = np.random.default_rng(6)
    A = torch.from_numpy(rng.normal(size=(8, 16)).astype(np.float32))
    B = torch.from_numpy(rng.normal(size=(16, 5)).astype(np.float32))
    (Ah, Al), (Bh, Bl) = split.bf16_split(A), split.bf16_split(B)
    acc = torch.zeros((8, 5), dtype=torch.float32)
    for a, b in ((Al, Bh), (Ah, Bl), (Ah, Bh)):
        prods = a.double()[:, None, :] * b.double().T[None, :, :]
        acc = split.tensor_core_sum(acc, prods, **split.BF16_TENSOR_CORE_SUM)
    assert torch.equal(split.matmul_bf16x3_emulated(A, B, chunk=32), acc)


# --- the tensor cores' sums -----------------------------------------------------------

#: The probe's documented cases as the card gave them (chip_smoke.py phase
#: 2b, NVIDIA H100 80GB HBM3, mma.sync m16n8k8 and wgmma m64n64k8 alike):
#: pattern -> the result minus the accumulator, in units of 2^-23, for the
#: accumulators 1.0, -1.0, 1.5 and -1.5 (accumulate_probe.ACCUMULATORS)
PROBE_CASES = {
    "one product +0.25 ulp": (0.0, 0.5, 0.0, 1.0),
    "one product -0.25 ulp": (-0.5, 0.0, -1.0, 0.0),
    "one product +0.5 ulp": (0.0, 0.5, 0.0, 1.0),
    "one product -0.5 ulp": (-0.5, 0.0, -1.0, 0.0),
    "one product +0.75 ulp": (0.0, 1.0, 0.0, 1.0),
    "one product -0.75 ulp": (-1.0, 0.0, -1.0, 0.0),
    "one product +1.25 ulp": (1.0, 1.5, 1.0, 2.0),
    "one product -1.25 ulp": (-1.5, -1.0, -2.0, -1.0),
    "one product +1.5 ulp": (1.0, 1.5, 1.0, 2.0),
    "one product -1.5 ulp": (-1.5, -1.0, -2.0, -1.0),
    "eight products 2^-1 ulp": (4.0, 4.0, 4.0, 4.0),
    "eight products 2^-2 ulp": (2.0, 2.0, 2.0, 2.0),
    "eight products 2^-3 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-4 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-5 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-6 ulp": (0.0, 0.0, 0.0, 0.0),
    "four products 1/4 ulp, first half": (1.0, 1.0, 1.0, 1.0),
    "two 1/4 ulp in each half": (1.0, 1.0, 1.0, 1.0),
}


def test_probe_cases_are_the_documented_ones():
    names, acc, prods = ap.documented_cases()
    assert names == list(PROBE_CASES)
    assert acc.shape == (len(names), len(ap.ACCUMULATORS)) and prods.shape == (len(names), ap.DEPTH)


@pytest.mark.parametrize("name", list(PROBE_CASES))
def test_tensor_core_sum_reproduces_the_probe(name):
    """The twin's model of the tensor cores' sum (split.TENSOR_CORE_SUM)
    gives the card's result of every documented case bit for bit; rounding
    to nearest or keeping every bit does not (the cases have force)."""
    names, acc, prods = ap.documented_cases()
    r = names.index(name)
    a = torch.tensor(acc[r], dtype=torch.float32)
    pr = torch.from_numpy(np.broadcast_to(prods[r], (len(ap.ACCUMULATORS), ap.DEPTH)).copy())
    want = a.double() + torch.tensor(PROBE_CASES[name], dtype=torch.float64) * ap.ULP
    got = split.tensor_core_sum(a, pr, **split.TENSOR_CORE_SUM)
    assert torch.equal(got, want.float()) and torch.equal(want.float().double(), want)


def test_probe_fit_names_the_twins_model_alone():
    """Of every candidate model, the documented cases' card results are
    given by the twin's and by no model that rounds to nearest or keeps more
    than 2 bits beyond float32's last place."""
    names, acc, prods = ap.documented_cases()
    A, C = ap._tiles_of(acc, prods, "mma")
    D = C.reshape(-1, C.shape[-1]).copy()  # rows past the cases: no products
    table = np.array([PROBE_CASES[n] for n in names])
    for j in range(D.shape[1]):  # columns repeat the accumulators
        D[: len(names), j] = acc[:, j % acc.shape[1]] + table[:, j % acc.shape[1]] * ap.ULP
    D = D.reshape(C.shape)
    models = ap.fit(A, C, D)
    assert split.TENSOR_CORE_SUM in models
    assert all(m["finish"] == "rz" and m["extra"] == 2 for m in models)


#: The bf16 forms' documented cases as the card gave them (chip_smoke.py
#: phase 2b, NVIDIA H100 80GB HBM3, mma.sync m16n8k16 and wgmma m64n64k16
#: alike): as PROBE_CASES, at depth 16
BF16_PROBE_CASES = {
    "one product +0.25 ulp": (0.0, 0.5, 0.0, 1.0),
    "one product -0.25 ulp": (-0.5, 0.0, -1.0, 0.0),
    "one product +0.5 ulp": (0.0, 0.5, 0.0, 1.0),
    "one product -0.5 ulp": (-0.5, 0.0, -1.0, 0.0),
    "one product +0.75 ulp": (0.0, 1.0, 0.0, 1.0),
    "one product -0.75 ulp": (-1.0, 0.0, -1.0, 0.0),
    "one product +1.25 ulp": (1.0, 1.5, 1.0, 2.0),
    "one product -1.25 ulp": (-1.5, -1.0, -2.0, -1.0),
    "one product +1.5 ulp": (1.0, 1.5, 1.0, 2.0),
    "one product -1.5 ulp": (-1.5, -1.0, -2.0, -1.0),
    "eight products 2^-1 ulp": (4.0, 4.0, 4.0, 4.0),
    "eight products 2^-2 ulp": (2.0, 2.0, 2.0, 2.0),
    "eight products 2^-3 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-4 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-5 ulp": (0.0, 0.0, 0.0, 0.0),
    "eight products 2^-6 ulp": (0.0, 0.0, 0.0, 0.0),
    "four products 1/4 ulp, first half": (1.0, 1.0, 1.0, 1.0),
    "two 1/4 ulp in each half": (1.0, 1.0, 1.0, 1.0),
    "sixteen products 2^-1 ulp": (8.0, 8.0, 8.0, 8.0),
    "sixteen products 2^-2 ulp": (4.0, 4.0, 4.0, 4.0),
    "sixteen products 2^-3 ulp": (0.0, 0.0, 0.0, 0.0),
    "sixteen products 2^-4 ulp": (0.0, 0.0, 0.0, 0.0),
    "sixteen products 2^-5 ulp": (0.0, 0.0, 0.0, 0.0),
    "sixteen products 2^-6 ulp": (0.0, 0.0, 0.0, 0.0),
    "four products 1/4 ulp, second eight": (1.0, 1.0, 1.0, 1.0),
    "one 1/4 ulp in each quarter": (1.0, 1.0, 1.0, 1.0),
    "one product -1/4 ulp, then 3/4 ulp in the second eight": (0.0, 0.5, 0.0, 1.0),
}


def test_bf16_probe_cases_are_the_documented_ones():
    names, acc, prods = ap.documented_cases(ap.BF16_DEPTH)
    assert names == list(BF16_PROBE_CASES)
    assert acc.shape == (len(names), len(ap.ACCUMULATORS)) and prods.shape == (len(names), 16)
    assert names[: len(PROBE_CASES)] == list(PROBE_CASES)  # the depth-8 cases, padded
    assert not prods[: len(PROBE_CASES), 8:].any()


@pytest.mark.parametrize("name", list(BF16_PROBE_CASES))
def test_bf16_tensor_core_sum_reproduces_the_probe(name):
    """The twin's model of the tensor cores' sum of bf16 products
    (split.BF16_TENSOR_CORE_SUM: one group of 16, cut toward zero, 2 bits
    past float32's last place) gives the card's result of every documented
    bf16 case bit for bit."""
    names, acc, prods = ap.documented_cases(ap.BF16_DEPTH)
    r = names.index(name)
    a = torch.tensor(acc[r], dtype=torch.float32)
    pr = torch.from_numpy(np.broadcast_to(prods[r], (len(ap.ACCUMULATORS), 16)).copy())
    want = a.double() + torch.tensor(BF16_PROBE_CASES[name], dtype=torch.float64) * ap.ULP
    got = split.tensor_core_sum(a, pr, **split.BF16_TENSOR_CORE_SUM)
    assert torch.equal(got, want.float()) and torch.equal(want.float().double(), want)


def test_bf16_probe_fit_names_one_group_of_sixteen():
    """Of every candidate at depth 16, the documented bf16 cases' card
    results are given by the twin's model, and only by models that sum the
    16 products as one group, cut toward zero, 2 bits past float32's last
    place: the TF32 model's groups of 8 do not fit (the case of -1/4 ulp
    and then 3/4 ulp in the second eight tells them apart)."""
    names, acc, prods = ap.documented_cases(ap.BF16_DEPTH)
    A, C = ap._tiles_of(acc, prods, "mma_bf16")
    D = C.reshape(-1, C.shape[-1]).copy()
    table = np.array([BF16_PROBE_CASES[n] for n in names])
    for j in range(D.shape[1]):
        D[: len(names), j] = acc[:, j % acc.shape[1]] + table[:, j % acc.shape[1]] * ap.ULP
    models = ap.fit(A, C, D.reshape(C.shape))
    assert split.BF16_TENSOR_CORE_SUM in models
    assert all((m["finish"], m["extra"], m["group"]) == ("rz", 2, 16) for m in models)
    assert split.TENSOR_CORE_SUM not in models


def _bxd_like_products(seed):
    """D1 = (X * X)^T W and B = X^T WY of a BXD-shaped rotated fixture (79
    samples), float32 operands."""
    import chip_smoke

    n, p, m = 79, 128, 256
    G, K, Y = chip_smoke.synth_bxd(n, p, m, seed=seed)
    lam, U = np.linalg.eigh(K)
    X = torch.from_numpy((U.T @ G.astype(np.float64)).astype(np.float32))
    w = 1.0 / (0.5 * lam + 0.5)
    W = torch.from_numpy(np.broadcast_to(w[:, None], (n, m)).astype(np.float32).copy())
    WY = torch.from_numpy((w[:, None] * (U.T @ Y.astype(np.float64))).astype(np.float32))
    return {"D1": ((X * X).T.contiguous(), W), "B": (X.T.contiguous(), WY)}


@pytest.mark.parametrize("product", ["D1", "B"])
@pytest.mark.parametrize("order", ["resident", "mma"])
def test_cut_sums_stray_and_runs_do_not(product, order):
    """On a BXD-like fixture, against the float64 product of the same
    float32 operands (RMS error relative to the largest output): under the
    tensor cores' sums, the kernels' old order (one accumulator carried
    across the depth) strays farther than the round-to-nearest twin
    (``matmul_tf32x3``), and the new order (each depth step's run from zero,
    added into the total rounded to nearest) stays within it."""
    A, B = _bxd_like_products(3)[product]
    exact = A.double() @ B.double()

    def rms(out):
        return float(((out.double() - exact) / exact.abs().max()).square().mean().sqrt())

    first = order == "resident"
    old = split.matmul_tf32x3_emulated(A, B, smalls_first=first)
    new = split.matmul_tf32x3_emulated(A, B, smalls_first=first, run=1)
    rn = rms(split.matmul_tf32x3(A, B))
    assert rms(old) > 1.2 * rn
    assert rms(new) <= rn


def test_emulated_step_is_exact_for_exact_sums():
    """Products whose sum with the accumulator is a float32 number lose
    nothing: small integers, any order, batched as matmul."""
    rng = np.random.default_rng(4)
    A = torch.from_numpy(rng.integers(-8, 9, (3, 20, 37)).astype(np.float32))
    B = torch.from_numpy(rng.integers(-8, 9, (37, 11)).astype(np.float32))
    want = A @ B
    for kw in ({}, {"run": 1}, {"smalls_first": True, "run": 1}, {"chunk": 16, "run": 2}):
        assert torch.equal(split.matmul_tf32x3_emulated(A, B, **kw), want)


# --- the permutation kernel's split reference ----------------------------------------


@pytest.fixture(scope="module")
def perm_rotated():
    """Rotated operands at n = 52, p = 96, m = 4, c up to 3 (the shape of
    tests/test_torch_bulkperm.py), made with numpy from a seed."""
    rng = np.random.default_rng(11)
    n, p, m = 52, 96, 4
    G = rng.choice([0.0, 0.5, 1.0], size=(n, p))
    X = G - G.mean(0)
    K = X @ X.T / p + 0.5 * np.eye(n)
    lam, U = np.linalg.eigh(K)
    Y = rng.normal(size=(n, m)) + G[:, [7]] * np.array([0.0, 2.0, 0.0, 1.0])
    C = np.column_stack([np.ones(n), rng.normal(size=(n, 2))])
    return dict(Y0=U.T @ Y, X0m=U.T @ G, C0=U.T @ C, lam=lam, h2=np.array([0.1, 0.8, 0.0, 0.55]))


def _perm_operands(rot, c, nperms=24, seed=7):
    """(X, S2, inv_xn) float32 on the CPU, through the package's preparation,
    with the JAX package's shuffle indices."""
    n = rot["Y0"].shape[0]
    args = [torch.from_numpy(rot[k]).float() for k in ("Y0", "C0", "lam", "h2")]
    args[1] = args[1][:, :c].contiguous()
    S, Q, wrn = tops.perm_trait_parts(*args, precision=bt.FAST32)
    sw, Qs = S.T.contiguous(), torch.stack(Q, 0).permute(2, 0, 1).contiguous()
    idx = torch.from_numpy(np.array(jops.permutation_indices(n, nperms, seed)))
    X = torch.from_numpy(rot["X0m"]).float()
    S2 = bf.prepare_chunk_inputs(sw, Qs, wrn, idx)
    return X, S2, bf.prepare_trait_block(X, sw, Qs, precision=bt.FAST32)


@pytest.mark.parametrize("c", [1, 3])
def test_bulkperm_split_reference_matches_plain(perm_rotated, c):
    """The 3 x TF32 arithmetic against exact float32 on the kernel's own
    operands: 1e-6 in max r^2, with a masked trait exactly 0 and a masked
    marker out of the running."""
    X, S2, inv = _perm_operands(perm_rotated, c)
    S2[2] = 0.0
    best = (torch.einsum("np,tnk->tpk", X, S2) ** 2 * inv[:, :, None]).argmax(1)[0, 0]
    inv[0, best] = 0.0
    plain = bf.bulkperm_maxr2_plain(X, S2, inv)
    out = bf.bulkperm_maxr2_split_reference(X, S2, inv)
    assert tuple(out.shape) == (4, 25) and out.dtype == torch.float32
    assert float((out - plain).abs().max()) <= 1e-6
    assert bool((out[2] == 0).all())
    inv_full = inv.clone()
    inv_full[0, best] = 1.0
    assert out[0, 0] < bf.bulkperm_maxr2_split_reference(X, S2, inv_full)[0, 0]
    assert not launch_counts


@pytest.mark.parametrize("c, mb, K", [(1, 4, 25), (3, 3, 17)], ids=["c1", "c3-ragged"])
def test_bulkperm_split_reference_matches_pallas_interpret(perm_rotated, c, mb, K):
    """Against the Pallas kernel in interpret mode at HIGHEST (the default
    of its wrapper), as tests/test_torch_bulkperm.py runs it: 1e-5 in LOD.
    The Pallas wrapper needs 8-trait blocks, so its operands are zero-padded."""
    X, S2, inv = _perm_operands(perm_rotated, c)
    S2, inv = S2[:mb, :, :K].contiguous(), inv[:mb].contiguous()
    pad = 8 - mb
    ref = jfused.fused_perm_maxlods(
        jnp.asarray(X.numpy()), jnp.pad(jnp.asarray(S2.numpy()), ((0, pad), (0, 0), (0, 0))),
        jnp.pad(jnp.asarray(inv.numpy()), ((0, pad), (0, 0))), n=52, tile_p=32, interpret=True,
    )[:mb]
    lod = tops.maxr2_to_lod(bf.bulkperm_maxr2_split_reference(X, S2, inv), 52)
    assert float(np.abs(lod.double().numpy() - np.asarray(ref, dtype=np.float64)).max()) < 1e-5


def test_split_reference_sub_blocks_do_not_show(perm_rotated, monkeypatch):
    X, S2, inv = _perm_operands(perm_rotated, 3)
    whole = bf.bulkperm_maxr2_split_reference(X, S2, inv)
    monkeypatch.setattr(bf, "PLAIN_BUDGET_BYTES", 4 * 96 * 25)  # one trait per sub-block
    assert torch.equal(bf.bulkperm_maxr2_split_reference(X, S2, inv), whole)


def _unit_operands(n, p=40, mb=3, K=11, seed=5):
    """(X, S2, inv_xn) float32 with unit-norm marker and permutation columns,
    so that every r^2 is a squared correlation in [0, 1]."""
    rng = np.random.default_rng(seed + n)
    X = rng.normal(size=(n, p))
    S2 = rng.normal(size=(mb, n, K))
    X /= np.linalg.norm(X, axis=0)
    S2 /= np.linalg.norm(S2, axis=1, keepdims=True)
    inv = np.ones((mb, p))
    return [torch.from_numpy(a).float() for a in (X, S2, inv)]


def _maxr2_of(num, inv):
    return (num * num * inv[:, :, None]).max(1).values


RUN = bf.CHUNK_SAMPLES * bf.FOLD_CHUNKS  # samples of one fold run of the chunked kernel


@pytest.mark.parametrize("n", [RUN - 7, RUN, RUN + 9], ids=["below-a-run", "one-run", "above-a-run"])
def test_bulkperm_chunked_split_reference_folds_runs(n, monkeypatch):
    """The chunked branch's sum, forced at any n: up to one fold run the
    product is one accumulator over the whole depth in chunks of
    CHUNK_SAMPLES, bit for bit; past it the first run's sum and the next
    run's are added with round to nearest, bit for bit; within 1e-6 of the
    plain version in max r^2 either way."""
    X, S2, inv = _unit_operands(n)
    monkeypatch.setattr(bf, "kernel_path", lambda n: "chunked")
    out = bf.bulkperm_maxr2_split_reference(X, S2, inv)
    A = X.T.contiguous()
    first = split.matmul_tf32x3_emulated(A[:, :RUN], S2[:, :RUN], chunk=bf.CHUNK_SAMPLES)
    if n <= RUN:
        assert torch.equal(out, _maxr2_of(first, inv))
    else:
        rest = split.matmul_tf32x3_emulated(A[:, RUN:], S2[:, RUN:], chunk=bf.CHUNK_SAMPLES)
        assert torch.equal(out, _maxr2_of(first + rest, inv))
    assert float((out - bf.bulkperm_maxr2_plain(X, S2, inv)).abs().max()) <= 1e-6


@pytest.mark.parametrize("n", [89, 300])
def test_bulkperm_chunked_split_reference_beats_one_accumulator(n):
    """At n > 88 (the chunked path) the split reference's folded runs are
    within 1e-6 of the plain version in max r^2 and no farther from the
    float64 product than one accumulator carried over the whole depth."""
    X, S2, inv = _unit_operands(n, p=64, mb=2, K=9)
    assert bf.kernel_path(n) == "chunked"
    out = bf.bulkperm_maxr2_split_reference(X, S2, inv)
    carried = _maxr2_of(split.matmul_tf32x3_emulated(X.T.contiguous(), S2, chunk=bf.CHUNK_SAMPLES),
                        inv)
    exact = _maxr2_of(torch.matmul(X.double().T, S2.double()), inv.double())
    assert float((out - bf.bulkperm_maxr2_plain(X, S2, inv)).abs().max()) <= 1e-6
    assert float((out.double() - exact).abs().max()) <= float((carried.double() - exact).abs().max())


# --- the alt-grid kernel's split reference ----------------------------------------------


@pytest.fixture(scope="module")
def alt_rotated():
    """tests/test_pallas_altgrid.py's fixture: n = 40, p = 96, m = 48, c = 2."""
    rng = np.random.default_rng(3)
    n, p, m = 40, 96, 48
    return dict(
        Y0=rng.normal(size=(n, m)),
        X0m=rng.normal(size=(n, p)),
        C0=np.column_stack([np.ones(n), rng.normal(size=n)]),
        lam=np.sort(rng.uniform(0.05, 3.0, n)),
    )


def _two_smallest_gap(Xn, Yn, cmat):
    """Relative gap between the two smallest u_k of every pair, in float64."""
    R = torch.einsum("gnp,gnm->gpm", Xn.double(), Yn.double())
    u = torch.clamp(1.0 - R * R, min=1e-300) * cmat.double()[:, None, :]
    two = torch.topk(u, 2, dim=0, largest=False).values
    return (two[1] - two[0]) / two[1]


@pytest.mark.parametrize("reml", [False, True])
def test_altgrid_split_reference_matches_plain_and_pallas(alt_rotated, reml):
    """5e-5 in L against the plain version and against the JAX package's
    interpret run; the grid index may differ only where the two smallest u
    lie within 1e-5 of each other (relative)."""
    names = ("Y0", "X0m", "C0", "lam")
    targs = [torch.from_numpy(alt_rotated[k]) for k in names] + [torch.from_numpy(GRID)]
    ops = af.prepare_inputs(*targs, prior=PRIOR, reml=reml)
    L_plain, k_plain = af.altgrid_plain(*ops)
    L, k = af.altgrid_split_reference(*ops)
    assert tuple(L.shape) == (96, 48) and L.dtype == torch.float32 and k.dtype == torch.int32
    assert float((L - L_plain).abs().max()) < 5e-5
    flips = k != k_plain
    assert bool((_two_smallest_gap(*ops)[flips] < 1e-5).all())
    L_none, none = af.altgrid_split_reference(*ops, panel=False)
    assert none is None and torch.equal(L_none, L)

    jargs = [jnp.asarray(alt_rotated[k]) for k in names] + [jnp.asarray(GRID)]
    L_pl, h2_pl = jax_fused_alt_grid(*jargs, prior=PRIOR, reml=reml, interpret=True,
                                     tile_p=32, tile_m=128)
    assert float(np.abs(L.double().numpy() - np.asarray(L_pl, dtype=np.float64)).max()) < 5e-5
    flips = torch.from_numpy(GRID)[k.long()].numpy() != np.asarray(h2_pl)
    assert bool((_two_smallest_gap(*ops).numpy()[flips] < 1e-5).all())
    assert not launch_counts


def test_altgrid_split_reference_single_grid_point(alt_rotated):
    names = ("Y0", "X0m", "C0", "lam")
    targs = [torch.from_numpy(alt_rotated[k]) for k in names] + [torch.tensor([0.3], dtype=torch.float64)]
    ops = af.prepare_inputs(*targs, prior=PRIOR)
    L, k = af.altgrid_split_reference(*ops)
    assert bool((k == 0).all())
    assert float((L - af.altgrid_plain(*ops)[0]).abs().max()) < 5e-5


# --- the LOD kernel's split reference -----------------------------------------------------


def _lod_operands(n, p, m, c, seed=5):
    """The LOD kernel's operands from genotype-like markers (uniform on
    [0, 1], so that with the intercept D = D1 - sum Z^2 cancels to about a
    quarter of D1, the case that enlarges the products' error)."""
    rng = np.random.default_rng(seed + n + c)
    Y0 = rng.normal(size=(n, m))
    X0m = rng.uniform(0.0, 1.0, size=(n, p))
    C0 = np.column_stack([np.ones(n)] + [rng.normal(size=n) for _ in range(c - 1)])
    lam = rng.uniform(0.1, 2.0, n)
    h2 = rng.uniform(0.0, 0.9, m)
    return lf.prepare_inputs(*[torch.from_numpy(a.astype(np.float32)) for a in (Y0, X0m, C0, lam, h2)])


@pytest.mark.parametrize("n", [79, 80])
@pytest.mark.parametrize("c", [1, 2, 3])
def test_liteqtl_split_reference_under_cancellation(n, c):
    """Three TF32 passes stay within 5e-5 in LOD of exact float32 where D
    cancels; the leading pass alone misses that bar by more than 10 x, so
    the bar has force."""
    ops = _lod_operands(n, 70, 45, c)
    plain = lf.liteqtl_lod_plain(*ops)
    D1 = (ops[0] * ops[0]).T @ ops[2]
    assert float(D1.min()) > 0
    assert float((lf.liteqtl_split_reference(*ops) - plain).abs().max()) < 5e-5
    one_pass = lf._lod_with_product(*ops, split.matmul_tf32x1)
    assert float((one_pass - plain).abs().max()) > 10 * 5e-5
    assert not launch_counts


def test_liteqtl_split_reference_rounds_the_forms_first():
    """X * X and X * C_k are rounded to float32 before they are split: the
    reference's D1 is the split product of the rounded squares."""
    X, C, W, WY, scal = _lod_operands(48, 16, 8, 2)
    seen = []

    def product(A, B):
        seen.append(A)
        return split.matmul_tf32x3(A, B)

    lf._lod_with_product(X, C, W, WY, scal, product)
    assert len(seen) == 4
    assert torch.equal(seen[0], X.T) and torch.equal(seen[1], (X * X).T)
    assert torch.equal(seen[3], (X * C[:, 1:2]).T)


# --- the path rule and the padding helper ----------------------------------------------


@pytest.mark.parametrize("n, depth", [(1, 8), (8, 8), (9, 16), (79, 80), (80, 80), (81, 88), (2000, 2000)])
def test_padded_depth(n, depth):
    assert bf.padded_depth(n) == depth


@pytest.mark.parametrize("n, path", [(1, "resident"), (48, "resident"), (79, "resident"), (80, "resident"),
                                     (81, "resident"), (88, "resident"), (89, "chunked"), (96, "chunked"),
                                     (2000, "chunked"), (20000, "chunked")])
def test_kernel_path_by_depth(n, path):
    """The trait's operand stays in shared memory while both halves of its
    (padded n, 256) tile fit beside two marker stages; above, n is walked in
    chunks."""
    assert bf.kernel_path(n) == path
    assert (bf.resident_shared_bytes(n) <= bf.SHARED_LIMIT_BYTES) or path == "chunked"


@pytest.mark.parametrize("n, depth", [(1, 16), (16, 16), (17, 32), (79, 80), (81, 96), (88, 96), (2000, 2000)])
def test_padded_depth_bf16x3(n, depth):
    """Under "high" a depth step is 16 samples: n = 88 pads to 96."""
    assert bf.padded_depth(n, "high") == depth


@pytest.mark.parametrize("n", [1, 48, 79, 88, 89, 2000])
def test_kernel_route_names_the_products(n):
    """Both paths have bf16x3 products; the path is the same under both."""
    assert bf.kernel_route(n, "high") == (bf.kernel_path(n), "bf16x3")
    assert bf.kernel_route(n) == (bf.kernel_path(n), "tf32x3")
    if bf.kernel_path(n) == "resident":
        assert bf.resident_shared_bytes(n, "high") <= bf.SHARED_LIMIT_BYTES


def test_resident_shared_bytes_at_the_main_path_shape():
    # n = 79: two halves of 80 x 256 floats and two stages of 81 x 72
    assert bf.resident_shared_bytes(79) == 4 * (2 * 80 * 256 + 2 * 81 * 72) == 210_496
    assert bf.resident_shared_bytes(88) <= bf.SHARED_LIMIT_BYTES < bf.resident_shared_bytes(96)
    # bf16x3: two halves of 80 x 256 bf16 values beside the same stages
    assert bf.resident_shared_bytes(79, "high") == 2 * 80 * 256 * 2 + 4 * 2 * 81 * 72 == 128_576


@pytest.mark.parametrize("cols, padded", [(1, 4), (4, 4), (5, 8), (7321, 7324), (35554, 35556), (1001, 1004)])
def test_rows_at_16_bytes_pads_the_rows(cols, padded):
    rng = np.random.default_rng(cols)
    X = torch.from_numpy(rng.normal(size=(2, 3, cols)).astype(np.float32))
    out = split.rows_at_16_bytes(X)
    assert tuple(out.shape) == (2, 3, padded) and out.is_contiguous() and out.dtype == torch.float32
    assert out.data_ptr() % 16 == 0
    assert torch.equal(out[..., :cols], X) and bool((out[..., cols:] == 0).all())
    if cols == padded:
        assert out.data_ptr() == X.data_ptr()  # aligned rows are handed over as they are


def test_rows_at_16_bytes_copies_a_misaligned_view():
    base = torch.arange(64, dtype=torch.float32)
    view = base[1:33].reshape(4, 8)  # contiguous, rows of 8, but 4 bytes off
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    out = split.rows_at_16_bytes(view)
    assert out.data_ptr() % 16 == 0 and torch.equal(out, view)
