"""The biobank driver (``bulklmm_tpu_torch/biobank.py``) against
``benchmarks/biobank.py`` on the CPU: the cohort bit for bit, the flags
and the printed lines, the eigendecomposition cache, and its scan and
permutation calls at a small size against the JAX package's ``bulkscan``
and ``bulkscan_perms`` on the same arrays and the same float32 factors.
The card runs it at BASELINE.md's 5,000 x 100,000 x 20,000
(``chip_smoke.py`` phase 18).
"""

import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bulklmm_tpu as bl
from bulklmm_tpu.ops import bulkperm as jops
from bulklmm_tpu.ops.rotation import KinshipDecomposition as JaxDecomposition
from bulklmm_tpu.utils import config as jcfg
import bulklmm_tpu_torch as bt
from bulklmm_tpu_torch import biobank as bb

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
SCRIPT = REPO / "benchmarks" / "biobank.py"
N, P, M = 120, 400, 24
#: max |dLOD| against the JAX package under BALANCED on the same factors:
#: tests/test_torch_bulkscan.py's bar for the preset
BAR = 1e-4


def _script():
    """benchmarks/biobank.py, whose top level needs only numpy."""
    spec = importlib.util.spec_from_file_location("biobank_jax", SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    G, Y = bb.synth_cohort(N, P, M)
    Gd = torch.from_numpy(G)
    K, setup_s = bb.kinship_for_run(Gd, cache_dir=tmp_path_factory.mktemp("cache"))
    return G, Y, K, setup_s


def _jax_decomposition(K):
    return JaxDecomposition(Ut=jnp.asarray(K.Ut.numpy()), lam=jnp.asarray(K.lam.numpy()))


@pytest.mark.parametrize("shape", [(N, P, M), (1000, 64, 3), (40, 100, 1)])
def test_synth_cohort_is_the_jax_scripts_bit_for_bit(shape):
    for ours, theirs in zip(bb.synth_cohort(*shape), _script().synth_cohort(*shape)):
        assert ours.dtype == theirs.dtype == np.float32 and np.array_equal(ours, theirs)


def test_flags_and_sizes_are_the_jax_scripts():
    src = SCRIPT.read_text()
    theirs = re.findall(r'add_argument\(\s*"(--[\w-]+)"', src)
    ours = [a.option_strings[0] for a in bb.parser()._actions if a.option_strings[0] != "-h"]
    assert ours == theirs + ["--cache-dir"]
    assert "(5000, 100_000, 20_000) if args.full else (2000, 30_000, 8_000)" in src
    assert (bb.FULL, bb.DEFAULT) == ((5000, 100_000, 20_000), (2000, 30_000, 8_000))
    assert set(re.findall(r'"(\w+)": (?:FAST32|BALANCED|MIXED|EXACT64|THROUGHPUT)', src)) == set(
        bb.PRECISIONS)
    assert all(bb.preset(name) is getattr(bt, name.upper()) for name in bb.PRECISIONS)
    assert bb.preset(None) is bt.DEFAULT_PRECISION
    args = bb.parser().parse_args([])
    assert (args.trait_chunk, args.host_blocks, args.perm_traits) == (4096, 1, 128)


def test_printed_lines_are_the_jax_scripts():
    line = bb.bulkscan_line(5000, 100_000, 20_000, 2.0, 31.4, 0)
    assert line["metric"] == "biobank_bulkscan_5000x100000x20000" and line["unit"] == "s"
    assert line["vs_baseline"] == round(100_000 * 20_000 / 2.0 / 1.23e8, 1)
    assert line["note"].endswith("kinship+eigh setup 31.4s (cached)")
    perm = bb.bulkperms_line(5000, 100_000, 128, 256, 1.5, 0.0, 0)
    assert perm["metric"] == "biobank_bulkperms_5000x100000x128x256"
    assert perm["vs_baseline"] == round(128 * 0.079 * 0.256 / 1.5, 1)
    assert "lowrank k=64" in bb.bulkperms_line(1, 1, 1, 1, 1.0, 2.0, 64)["note"]
    src = SCRIPT.read_text()
    assert "lod_per_s / 1.23e8" in src and "mp_ * 0.079 * (args.perms / 1000.0)" in src


def test_the_cache_is_written_then_read(tmp_path):
    G, _ = bb.synth_cohort(50, 80, 2)
    Gd = torch.from_numpy(G)
    Ut, lam, s = bb.host_decomposition(Gd, tmp_path)
    assert s > 0 and (tmp_path / "eigh_n50.npz").is_file()
    Ut2, lam2, s2 = bb.host_decomposition(Gd, tmp_path)
    assert s2 == 0.0 and np.array_equal(Ut, Ut2) and np.array_equal(lam, lam2)
    K = np.asarray(bl.calc_kinship(G.astype(np.float64)))
    lam_ref = np.linalg.eigvalsh(K)
    assert np.max(np.abs(lam - lam_ref)) <= 1e-10
    dec, _ = bb.kinship_for_run(Gd, cache_dir=tmp_path)
    assert dec.Ut.dtype == dec.lam.dtype == torch.float32  # the JAX script's cast
    assert np.array_equal(dec.Ut.numpy(), Ut.astype(np.float32))


@pytest.mark.parametrize("host_blocks,trait_chunk", [(1, 4096), (3, 8)])
def test_scan_matches_the_jax_package(cohort, host_blocks, trait_chunk):
    G, Y, K, setup_s = cohort
    assert setup_s > 0
    Yd, Gd = torch.from_numpy(Y), torch.from_numpy(G)
    blocks = list(bb.scan_blocks(Yd, Gd, K, precision=bt.BALANCED, trait_chunk=trait_chunk,
                                 host_blocks=host_blocks))
    assert len(blocks) == host_blocks
    L = torch.cat([r.L for r in blocks], 1).double().numpy()
    ref = bl.bulkscan(Y, G, _jax_decomposition(K), trait_chunk=trait_chunk,
                      precision=jcfg.BALANCED)
    assert L.shape == (P, M)
    assert np.max(np.abs(L - np.asarray(ref.L))) <= BAR
    total = bb.scan_checksum(Yd, Gd, K, precision=bt.BALANCED, trait_chunk=trait_chunk,
                             host_blocks=host_blocks)
    assert total == pytest.approx(float(np.asarray(ref.L).sum()), abs=BAR * P * M)


def test_perms_match_the_jax_package(cohort):
    G, Y, K, _ = cohort
    nperms, mp = 40, 5
    idx = np.asarray(jops.permutation_indices(N, nperms, 0))  # the script's default seed
    got = bt.bulkscan_perms(torch.from_numpy(Y[:, :mp]), torch.from_numpy(G), K, nperms=nperms,
                            precision=bt.BALANCED, perm_idx=idx)
    ref = bl.bulkscan_perms(Y[:, :mp], G, _jax_decomposition(K), nperms=nperms,
                            precision=jcfg.BALANCED)
    assert tuple(got.maxlods.shape) == (mp, nperms + 1)
    assert np.max(np.abs(got.maxlods.double().numpy() - np.asarray(ref.maxlods))) <= BAR


def test_lowrank_kinship_for_run():
    G, _ = bb.synth_cohort(60, 90, 2)
    lr, s = bb.kinship_for_run(torch.from_numpy(G), lowrank=8)
    assert isinstance(lr, bt.LowRankKinship) and tuple(lr.U.shape) == (60, 8) and s > 0


def test_main_needs_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="CUDA device"):
        bb.main(["--perms", "4"])
