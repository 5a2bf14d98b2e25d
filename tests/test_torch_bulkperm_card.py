"""The permutation kernel's chunked path (n > 88) on a CUDA card: against its
split reference, its maxima bit-equal however its marker walk is split
across blocks, and the launches it counts. Every test skips without a card.
The file imports no JAX, so it runs where the port runs (the repository's
conftest imports JAX, hence ``--noconftest``):

    python3 -m pytest --noconftest tests/test_torch_bulkperm_card.py
"""

import numpy as np
import pytest
import torch

import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
from bulklmm_tpu_torch.ops import bulkperm as ob
from bulklmm_tpu_torch.utils.profiling import launch_counts

R2_BAR = 1e-5  # max |d max r^2| of the kernel from its references (chip_smoke.py's R2_BAR)
KERNEL_BAR = 5e-5  # max |dLOD| at up to 48 samples, scaled by n / 48 above (chip_smoke.py's)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _operands(n, p, mb, K, dev, seed):
    """The kernel's operands (X, S2, inv_xn) from random rotated data through
    the package's own preparation, with an intercept and one covariate."""
    rng = np.random.default_rng(seed)

    def on_card(a):
        return torch.from_numpy(np.asarray(a, dtype=np.float32)).to(dev)

    Y0, X0m = on_card(rng.normal(size=(n, mb))), on_card(rng.normal(size=(n, p)))
    C0 = on_card(np.column_stack([np.ones(n), rng.normal(size=n)]))
    lam, h2 = on_card(rng.uniform(0.1, 2.0, n)), on_card(rng.uniform(0.0, 0.9, mb))
    S, Q, wrn = ob.perm_trait_parts(Y0, C0, lam, h2, precision=bt.FAST32)
    sw, Qs = S.T.contiguous(), torch.stack(Q, 0).permute(2, 0, 1).contiguous()
    S2 = bf.prepare_chunk_inputs(sw, Qs, wrn, ob.permutation_indices(n, K - 1, seed).to(dev))
    return X0m, S2, bf.prepare_trait_block(X0m, sw, Qs, precision=bt.FAST32)


def _sms(dev):
    return torch.cuda.get_device_properties(dev).multi_processor_count


@pytest.mark.card
@pytest.mark.parametrize("n", [89, 2000, 5000])
def test_chunked_kernel_matches_its_split_reference(dev, n):
    """At K = 1,001 (a ragged last tile of permutations) and a ragged last
    tile of markers: the kernel within the chunked bars of its split
    reference, which sums as its warpgroup products do, and of its plain
    version."""
    ops = _operands(n, 300, 2, 1001, dev, seed=n)
    assert bf.kernel_path(n) == "chunked"
    out = bf.bulkperm_maxr2_cuda(*ops)
    twin = bf.bulkperm_maxr2_split_reference(*ops)
    plain = bf.bulkperm_maxr2_plain(*ops)
    bar = KERNEL_BAR * max(1.0, n / 48)
    for ref in (twin, plain):
        assert float((out - ref).abs().max()) <= R2_BAR
        lod = (ob.maxr2_to_lod(out, n) - ob.maxr2_to_lod(ref, n)).abs().max()
        assert float(lod) <= bar


@pytest.mark.card
@pytest.mark.parametrize("dot_precision", ["highest", "high"])
def test_marker_groups_give_the_same_maxima_and_are_counted(dev, dot_precision):
    """A trait's maxima launched alone, its marker walk split across blocks,
    are bit-equal to the same trait's inside a block of traits wide enough
    for one marker group; the launch record counts the first launch under
    the path "chunked_split" and the second under "chunked", and the
    library's rule is the Python twin's."""
    n, p, K, wide = 300, 4000, 1001, 160
    sms = _sms(dev)
    X, S2, inv = _operands(n, p, wide, K, dev, seed=3)
    lib = bf._library()
    assert bf.marker_groups(n, p, 1, K, sms) > 1
    assert bf.marker_groups(n, p, wide, K, sms) == 1
    for mb in (1, wide):
        assert lib.bulklmm_bulkperm_marker_groups(n, p, mb, K) == bf.marker_groups(n, p, mb, K, sms)
    products = bf.kernel_route(n, dot_precision)[1]
    split, chunked = (f"bulkperm_maxr2.{path}.{products}" for path in ("chunked_split", "chunked"))
    before = launch_counts[split], launch_counts[chunked]
    alone = bf.bulkperm_maxr2_cuda(X, S2[7:8].contiguous(), inv[7:8].contiguous(),
                                   dot_precision=dot_precision)
    assert (launch_counts[split], launch_counts[chunked]) == (before[0] + 1, before[1])
    whole = bf.bulkperm_maxr2_cuda(X, S2, inv, dot_precision=dot_precision)
    assert (launch_counts[split], launch_counts[chunked]) == (before[0] + 1, before[1] + 1)
    assert torch.equal(alone[0], whole[7])


@pytest.mark.card
def test_marker_group_rule_matches_the_library(dev):
    """``bulklmm_bulkperm_marker_groups`` against :func:`marker_groups` with
    the card's SM count, over both paths and the benchmark's launch shapes."""
    lib, sms = bf._library(), _sms(dev)
    for shape in [(79, 7321, 1024, 1001), (5000, 100_000, 32, 1001), (2000, 20_000, 64, 1001),
                  (89, 96, 8, 257), (20_000, 50_000, 128, 257), (300, 130, 1, 1)]:
        assert lib.bulklmm_bulkperm_marker_groups(*shape) == bf.marker_groups(*shape, sms)
