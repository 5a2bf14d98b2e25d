"""Data I/O: GeneNetwork-format genotype/phenotype readers and helpers.

Counterpart of ``bulklmm_tpu/io.py``, with the same functions and file
formats (the port keeps its own copy: it imports nothing of the JAX
package). Feature parity with the reference's readers (reference
src/readData.jl): ``readGenoProb`` (:41), ``readGenoProb_ExcludeComplements``
(:85), ``readBXDpheno`` (:159), ``readBXDgeno`` (:163), ``writeToFile``
(:167), and the GEMMA-format converters (:173, :181). The reference's
dead/broken legacy readers (``readPheno``, ``readGeno``, ``str2num``) are
deliberately not reproduced.

Extras with no reference counterpart: a reader for the Helium ``.he`` binary
matrix format (used by the reference's kinship golden file,
reference test/kinship_test.jl:5-7), marker-map/trait-annotation loaders for
the bundled ``gmap.csv``/``phenocovar.csv``, and npz checkpointing of rotated
datasets so very large cohorts can skip the eigendecomposition on re-runs.

Everything here is host-side numpy: readers return float64 numpy arrays
and touch no device; arrays go to the device only when a scan engine is
called. Numeric blocks are parsed by the native multithreaded parser
(``bulklmm_tpu_torch/_native``) where it builds, else by the pure-Python
parser, with the same result.
"""

from __future__ import annotations

import csv
import struct
from pathlib import Path
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# Genotype-probability / phenotype readers (GeneNetwork "Pjotr Prins" format)
# ---------------------------------------------------------------------------

def _read_csv(file, delim: str = ","):
    with open(file, newline="") as fh:
        return list(csv.reader(fh, delimiter=delim))


def _read_numeric(file, *, delim=",", skip_rows=0, skip_left=0, skip_right=0):
    """Numeric CSV block as float64, preferring the native multithreaded
    parser (bulklmm_tpu_torch/_native) with a pure-Python fallback that
    gives the same block, ragged rows and trailing blank lines included."""
    from . import _native

    if _native.fastcsv_available():
        return _native.read_numeric_csv(
            file, delim=delim, skip_rows=skip_rows,
            skip_cols_left=skip_left, skip_cols_right=skip_right,
        )
    rows = _read_csv(file, delim)[skip_rows:]
    while rows and not "".join(rows[-1]).strip():
        rows.pop()  # trailing blank lines
    # the native parser's shape: the first row's field count, short rows
    # padded with NaN and extra fields dropped
    ncols = max(len(rows[0]) - skip_left - skip_right, 0) if rows else 0
    data = [(r[skip_left:] + [""] * ncols)[:ncols] for r in rows]

    def conv(v):
        try:
            return float(v)
        except ValueError:
            return float("nan")

    return np.asarray([[conv(v) for v in r] for r in data], dtype=np.float64).reshape(
        len(data), ncols
    )


def read_geno_prob(
    file,
    *,
    delim: str = ",",
    get_marker_names: bool = True,
    get_ids: bool = True,
) -> np.ndarray:
    """Genotype-probability matrix from a CSV with a marker-name header row
    and a strain-id first column (reference readGenoProb, src/readData.jl:41).

    Returns the (n_individuals, n_prob_columns) float64 matrix; header and
    ids are discarded, like the reference.
    """
    return _read_numeric(
        file, delim=delim,
        skip_rows=1 if get_marker_names else 0,
        skip_left=1 if get_ids else 0,
    )


def read_geno_prob_exclude_complements(
    file,
    *,
    delim: str = ",",
    get_marker_names: bool = True,
    get_ids: bool = True,
) -> np.ndarray:
    """Keep only the first of each complementary allele-probability column
    pair (reference readGenoProb_ExcludeComplements, src/readData.jl:85:
    1-based odd columns == 0-based even columns)."""
    gp = read_geno_prob(
        file, delim=delim, get_marker_names=get_marker_names, get_ids=get_ids
    )
    return gp[:, 0::2]


def read_bxd_pheno(file) -> np.ndarray:
    """BXD phenotype matrix: drop the header row, the id column, and the
    trailing sex column (reference readBXDpheno, src/readData.jl:159-161)."""
    return _read_numeric(file, skip_rows=1, skip_left=1, skip_right=1)


def read_bxd_geno(file, *, skipstart: int = 1) -> np.ndarray:
    """BXD genotype probabilities: skip header, take 1-based even columns —
    the first allele of each complement pair after the id column
    (reference readBXDgeno, src/readData.jl:163-165)."""
    gp = _read_numeric(file, skip_rows=skipstart, skip_left=1)
    return gp[:, 0::2]


def write_to_file(data, filename) -> None:
    """Comma-delimited writer (reference writeToFile, src/readData.jl:167-171)."""
    arr = np.asarray(data)
    with open(filename, "w", newline="") as fh:
        w = csv.writer(fh)
        if arr.ndim == 1:
            for v in arr:
                w.writerow([v])
        else:
            for row in arr:
                w.writerow(list(row))


# ---------------------------------------------------------------------------
# GEMMA-format converters
# ---------------------------------------------------------------------------

def transform_bxd_pheno_to_gemma(inputfile, outputfile, trait_index: int) -> np.ndarray:
    """Write one trait column in GEMMA phenotype format (one value per line).

    ``trait_index`` is 0-based (the reference's ``iter`` is 1-based Julia,
    src/readData.jl:173-179).
    """
    pheno = read_bxd_pheno(inputfile)
    col = pheno[:, trait_index]
    with open(outputfile, "w") as fh:
        for v in col:
            fh.write(f"{v}\n")
    return pheno


def transform_bxd_geno_to_gemma(inputfile, outputfile) -> np.ndarray:
    """BXD genotype CSV -> GEMMA mean-genotype format: marker name (pair
    suffix stripped), dummy minor/major alleles, then 2x the first-allele
    probabilities per individual (reference src/readData.jl:181-191)."""
    rows = _read_csv(inputfile)
    header = rows[0]
    marker_names = [name[:-3] for name in header[1::2]]
    data = 2.0 * np.asarray([r[1::2] for r in rows[1:]], dtype=np.float64)
    out = np.empty((len(marker_names), 3 + data.shape[0]), dtype=object)
    out[:, 0] = marker_names
    out[:, 1] = "A"
    out[:, 2] = "B"
    out[:, 3:] = data.T
    write_to_file(out, outputfile)
    return out


def read_gemma_lods(file) -> np.ndarray:
    """Per-marker LOD vector from a GEMMA output export (one value per line;
    the reference bundles data/bxdData/GEMMA_BXDTrait1112/gemma_lod_1112.txt
    for its README comparison plot, reference README.md:257-279)."""
    with open(file) as fh:
        return np.asarray([float(line) for line in fh if line.strip()])


# ---------------------------------------------------------------------------
# Marker map / trait annotations (bundled gmap.csv, phenocovar.csv)
# ---------------------------------------------------------------------------

class MarkerMap(NamedTuple):
    locus: np.ndarray  # marker names
    chromosome: np.ndarray
    cm: np.ndarray  # genetic position (centimorgan)
    mb: np.ndarray  # physical position (megabase)


def read_gmap(file) -> MarkerMap:
    """Marker map loader (reference data/bxdData/gmap.csv: Locus,Chr,cM,Mb)."""
    rows = _read_csv(file)[1:]
    locus = np.asarray([r[0] for r in rows])
    chrom = np.asarray([r[1] for r in rows])
    cm = np.asarray([float(r[2]) if r[2] not in ("", "NA") else np.nan for r in rows])
    mb = np.asarray([float(r[3]) if r[3] not in ("", "NA") else np.nan for r in rows])
    return MarkerMap(locus=locus, chromosome=chrom, cm=cm, mb=mb)


def read_phenocovar(file) -> Dict[str, np.ndarray]:
    """Trait annotation loader (reference data/bxdData/phenocovar.csv);
    returns a dict of column-name -> values."""
    rows = _read_csv(file)
    header, body = rows[0], rows[1:]
    cols = list(zip(*body)) if body else [[] for _ in header]
    return {h: np.asarray(c) for h, c in zip(header, cols)}


# ---------------------------------------------------------------------------
# Helium binary matrix format (.he)
# ---------------------------------------------------------------------------

def read_helium_matrix(file) -> np.ndarray:
    """Read a Helium ``.he`` binary matrix.

    Layout (determined from the reference's kinship golden file,
    reference test/ref_data_for_tests/kinship_ref.he): a 56-byte header —
    u64 nrow, u64 ncol, an unidentified u64 field, 4-byte magic
    ``01 02 03 04``, padding — followed by nrow*ncol little-endian float64
    values (payload length is validated against the header dims).
    """
    raw = Path(file).read_bytes()
    nrow, ncol = struct.unpack_from("<QQ", raw, 0)
    magic = raw[24:28]
    if magic != b"\x01\x02\x03\x04":
        raise ValueError(f"not a Helium matrix file (magic={magic!r})")
    # the u64 at offset 16 is NOT an element size (the reference golden
    # carries 3940 there); element width is validated from the payload
    # length instead
    expected = 56 + 8 * nrow * ncol
    if len(raw) < expected:
        raise ValueError(
            f"Helium payload too short for {nrow} x {ncol} float64 values "
            f"({len(raw)} < {expected} bytes)"
        )
    data = np.frombuffer(raw, dtype="<f8", count=nrow * ncol, offset=56)
    return data.reshape(nrow, ncol)


# ---------------------------------------------------------------------------
# Rotated-dataset checkpointing (no reference counterpart)
# ---------------------------------------------------------------------------

def save_rotated(file, y0, X0, lam, *, n_covars: int) -> None:
    """Persist an eigen-rotated dataset so large cohorts skip the O(n^3)
    decomposition on resume."""
    np.savez_compressed(
        file,
        y0=np.asarray(y0),
        X0=np.asarray(X0),
        lam=np.asarray(lam),
        n_covars=np.asarray(n_covars),
    )


def load_rotated(file) -> Tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    z = np.load(file)
    return z["y0"], z["X0"], z["lam"], int(z["n_covars"])


# ---------------------------------------------------------------------------
# Bundled-data discovery
# ---------------------------------------------------------------------------

BXD_FILES = {
    "genoprob": "spleen-bxd-genoprob.csv",
    "pheno": "spleen-pheno-nomissing.csv",
    "gmap": "gmap.csv",
    "phenocovar": "phenocovar.csv",
}


def find_bxd_data(root: Optional[str] = None) -> Dict[str, Optional[Path]]:
    """Locate the BXD demo files under ``root`` (or common defaults).

    The reference keeps them in data/bxdData/ of its checkout (pass that
    directory as ``root``), but the two large matrices are git-LFS stubs in
    some checkouts — callers should treat ``None`` entries as "gate the
    parity test". Without ``root`` only this checkout's data/bxdData/ is
    searched.
    """
    candidates = []
    if root is not None:
        candidates.append(Path(root))
    candidates.append(Path(__file__).resolve().parent.parent / "data" / "bxdData")
    out: Dict[str, Optional[Path]] = {}
    for key, fname in BXD_FILES.items():
        out[key] = None
        for c in candidates:
            p = c / fname
            if p.is_file() and p.stat().st_size > 1024:
                out[key] = p
                break
    return out
