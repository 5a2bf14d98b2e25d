"""The port's file readers and writers (``bulklmm_tpu_torch/io.py``) and its
native CSV parser (``bulklmm_tpu_torch/_native``) against the JAX package's
``bulklmm_tpu.io`` on the same temporary files: equal arrays (NaN where it
has NaN), equal bytes from the writers, and the native parser equal to the
pure-Python one. The reference-data checks are gated as tests/test_io.py
gates its own: the data stays out of the repo.
"""

import struct
import threading

import numpy as np
import pytest

from bulklmm_tpu import io as jio
from bulklmm_tpu_torch import _native
from bulklmm_tpu_torch import io as tio
from test_io import GEMMA_LODS, GMAP, KINSHIP_HE, PHENOCOVAR

GENO = (
    "id,m1_a,m1_b,m2_a,m2_b,m3_a,m3_b\n"
    "BXD1,0.9,0.1,0.2,0.8,1,0\n"
    "BXD2,0.5,0.5,0.7,0.3,NA,\n"
    "BXD3, 0.25 ,\"0.75\",1e-3,9.99e-1,0.0,1.0\r\n"
    "BXD4,0.125,0.875,x,0.5,0.5\n"
    "\n\n"
)
PHENO = "id,t1,t2,t3,sex\nBXD1,1.5,2.5,-3,1\nBXD2,3.5,NA,4.5e2,0\nBXD3,,7,8,1\n"


def _write(tmp_path, name, text):
    p = tmp_path / name
    p.write_bytes(text.encode())
    return p


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    assert np.array_equal(a, b, equal_nan=a.dtype.kind == "f")


@pytest.fixture
def pure_python(monkeypatch):
    """The port's pure-Python parser, as where the native library does not build."""
    monkeypatch.setattr(_native, "fastcsv_available", lambda: False)


READERS = [
    ("read_geno_prob", GENO, {}),
    ("read_geno_prob", GENO, {"get_marker_names": False, "get_ids": False}),
    ("read_geno_prob_exclude_complements", GENO, {}),
    ("read_bxd_geno", GENO, {}),
    ("read_bxd_pheno", PHENO, {}),
]


@pytest.mark.parametrize("name,text,kw", READERS, ids=[f"{r[0]}-{i}" for i, r in enumerate(READERS)])
def test_readers_match_jax_and_both_parsers(tmp_path, monkeypatch, name, text, kw):
    f = _write(tmp_path, "in.csv", text)
    assert _native.fastcsv_available()
    native = getattr(tio, name)(f, **kw)
    _same(native, getattr(jio, name)(f, **kw))
    monkeypatch.setattr(_native, "fastcsv_available", lambda: False)
    _same(getattr(tio, name)(f, **kw), native)


def test_native_parser_contract(tmp_path):
    f = _write(tmp_path, "pheno.csv", PHENO)
    assert _native.dims(f, skip_rows=1) == (3, 5)
    out = _native.read_numeric_csv(f, skip_rows=1, skip_cols_left=1, skip_cols_right=1)
    _same(out, tio.read_bxd_pheno(f))
    lib = _native.library_path()
    assert lib.parent == _native.BUILD_DIR and lib.is_file()
    assert lib.parent.parent.name == "build"
    with pytest.raises(OSError):
        _native.read_numeric_csv(tmp_path / "missing.csv")


def test_native_build_is_atomic_under_concurrent_builders(tmp_path, monkeypatch):
    """Processes that build at once (xdist workers) each compile to their
    own temporary name and rename into place: every builder succeeds and the
    library loads."""
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "native")
    lib = _native.library_path()
    assert lib.parent == tmp_path / "native"
    results = []
    threads = [threading.Thread(target=lambda: results.append(_native._compile(lib)))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert results == [True, True]
    assert sorted(p.name for p in lib.parent.iterdir()) == [lib.name]
    monkeypatch.setattr(_native, "_lib", None)
    monkeypatch.setattr(_native, "_tried", False)
    assert _native.fastcsv_available()
    assert _native.dims(_write(tmp_path, "p.csv", PHENO), skip_rows=1) == (3, 5)


@pytest.mark.parametrize("data", [
    np.asarray([[1.0, 2.0], [3.0, 4.5e-7]]),
    np.asarray([0.1, 2.0 / 3.0, -5.0]),
    np.asarray([[1.5, np.nan]], dtype=np.float32),
    np.asarray([["m1", "A", 1.8], ["m2", "B", 0.4]], dtype=object),
    np.arange(6).reshape(2, 3),
], ids=["f64", "vector", "f32-nan", "object", "int"])
def test_write_to_file_same_bytes(tmp_path, data):
    tio.write_to_file(data, tmp_path / "port.csv")
    jio.write_to_file(data, tmp_path / "jax.csv")
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()


def test_gemma_converters_same_bytes(tmp_path):
    geno = _write(tmp_path, "geno.csv",
                  "id,m1_pA,m1_pB,m2_pA,m2_pB\nBXD1,0.9,0.1,0.2,0.8\nBXD2,0.5,0.5,0.7,0.3\n")
    a = tio.transform_bxd_geno_to_gemma(geno, tmp_path / "g_port.txt")
    b = jio.transform_bxd_geno_to_gemma(geno, tmp_path / "g_jax.txt")
    _same(a, b)
    assert (tmp_path / "g_port.txt").read_bytes() == (tmp_path / "g_jax.txt").read_bytes()
    pheno = _write(tmp_path, "pheno.csv", PHENO)
    _same(tio.transform_bxd_pheno_to_gemma(pheno, tmp_path / "p_port.txt", 2),
          jio.transform_bxd_pheno_to_gemma(pheno, tmp_path / "p_jax.txt", 2))
    assert (tmp_path / "p_port.txt").read_bytes() == (tmp_path / "p_jax.txt").read_bytes()
    lods = _write(tmp_path, "lods.txt", "0.5\n\n1.25\n4.75e0\n")
    _same(tio.read_gemma_lods(lods), jio.read_gemma_lods(lods))


def test_gmap_and_phenocovar_match_jax(tmp_path):
    gmap = _write(tmp_path, "gmap.csv",
                  "Locus,Chr,cM,Mb\nrs1,1,0.5,3.01\nrs2,1,NA,4.5\nrs3,X,12,\n")
    a, b = tio.read_gmap(gmap), jio.read_gmap(gmap)
    assert a._fields == b._fields
    for fa, fb in zip(a, b):
        _same(fa, fb)
    assert list(a.chromosome) == ["1", "1", "X"]
    pc = _write(tmp_path, "pc.csv", "id,name,unit\nt1,spleen a,mg\nt2,\"b, c\",g\n")
    a, b = tio.read_phenocovar(pc), jio.read_phenocovar(pc)
    assert list(a) == list(b) == ["id", "name", "unit"]
    for k in a:
        _same(a[k], b[k])


def _helium(path, K, *, magic=b"\x01\x02\x03\x04", cut=0):
    head = struct.pack("<QQQ", K.shape[0], K.shape[1], 3940) + magic + bytes(28)
    path.write_bytes((head + K.astype("<f8").tobytes())[: len(head) + K.nbytes - cut])
    return path


def test_helium_reader_matches_jax(tmp_path):
    K = np.random.default_rng(1).uniform(size=(5, 4))
    f = _helium(tmp_path / "k.he", K)
    _same(tio.read_helium_matrix(f), jio.read_helium_matrix(f))
    _same(tio.read_helium_matrix(f), K)
    for bad, match in ((_helium(tmp_path / "m.he", K, magic=b"\x00\x00\x00\x00"), "magic"),
                       (_helium(tmp_path / "s.he", K, cut=8), "too short")):
        for mod in (tio, jio):
            with pytest.raises(ValueError, match=match):
                mod.read_helium_matrix(bad)


def test_rotated_checkpoints_cross_load(tmp_path):
    rng = np.random.default_rng(0)
    y0, X0, lam = rng.normal(size=(10, 1)), rng.normal(size=(10, 5)), rng.uniform(0, 2, 10)
    tio.save_rotated(tmp_path / "port.npz", y0, X0, lam, n_covars=2)
    jio.save_rotated(tmp_path / "jax.npz", y0, X0, lam, n_covars=2)
    for f in ("port.npz", "jax.npz"):
        a, b = tio.load_rotated(tmp_path / f), jio.load_rotated(tmp_path / f)
        assert a[3] == b[3] == 2
        for x, y, ref in zip(a[:3], b[:3], (y0, X0, lam)):
            _same(x, y)
            _same(x, ref)


def test_find_bxd_data_with_root(tmp_path):
    big = "x" * 2048
    for key in ("genoprob", "gmap"):
        (tmp_path / tio.BXD_FILES[key]).write_text(big)
    (tmp_path / tio.BXD_FILES["pheno"]).write_text("stub")  # an LFS stub: too small
    assert tio.BXD_FILES == jio.BXD_FILES
    a = tio.find_bxd_data(tmp_path)
    assert a == jio.find_bxd_data(tmp_path)
    assert a["genoprob"] == tmp_path / tio.BXD_FILES["genoprob"] and a["pheno"] is None


@pytest.mark.skipif(not KINSHIP_HE.is_file(), reason="reference golden not mounted")
def test_helium_reference_golden_matches_jax():
    K = tio.read_helium_matrix(KINSHIP_HE)
    _same(K, jio.read_helium_matrix(KINSHIP_HE))
    assert K.shape == (79, 79) and abs(K[0, 1] - 0.4687748986091472) < 1e-15


@pytest.mark.skipif(not GMAP.is_file(), reason="reference gmap not mounted")
def test_gmap_reference_matches_jax():
    for fa, fb in zip(tio.read_gmap(GMAP), jio.read_gmap(GMAP)):
        _same(fa, fb)


@pytest.mark.skipif(not PHENOCOVAR.is_file(), reason="reference phenocovar not mounted")
def test_phenocovar_reference_matches_jax():
    a, b = tio.read_phenocovar(PHENOCOVAR), jio.read_phenocovar(PHENOCOVAR)
    assert list(a) == list(b)
    for k in a:
        _same(a[k], b[k])


@pytest.mark.skipif(not GEMMA_LODS.is_file(), reason="reference GEMMA file not mounted")
def test_gemma_lods_reference_matches_jax():
    _same(tio.read_gemma_lods(GEMMA_LODS), jio.read_gemma_lods(GEMMA_LODS))
