"""Synthetic biobank-scale run on the card: n = 5,000 individuals x 100,000
markers x 20,000 traits (BASELINE.md's fifth configuration) with
``--full``, 2,000 x 30,000 x 8,000 without.

    python -m bulklmm_tpu_torch.biobank [--full] [--perms N --perm-traits M]
        [--precision NAME] [--trait-chunk N] [--host-blocks N] [--lowrank K]
        [--sharded] [--cache-dir DIR]

The counterpart of ``benchmarks/biobank.py``, under its flags and metric
names. The cohort (:func:`synth_cohort`) is the JAX script's, bit for bit.
The (n, n) eigendecomposition is cached in
``build/bulklmm_tpu_torch_cache/eigh_n{n}.npz`` (``--cache-dir`` names
another directory) and carried to the card in float32, as the JAX script
casts ``Ut``. One warm-up call, then the timed call, closed by a checksum
fetch and a synchronisation, on the host clock. Prints one JSON line:
``biobank_bulkscan_{n}x{p}x{m}`` or, with ``--perms``,
``biobank_bulkperms_{n}x{p}x{mp}x{perms}``, each with the JAX script's
``vs_baseline`` (1.23e8 LODs/s; 0.079 s a trait for 1,000 permutations).
``--sharded`` runs ``bulkscan_sharded`` on ``make_mesh()`` when there is
more than one CUDA device. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

FULL = (5000, 100_000, 20_000)
DEFAULT = (2000, 30_000, 8_000)
#: the reference's LOD evaluations a second (the JAX script's vs_baseline)
REFERENCE_LODS_PER_S = 1.23e8
#: the reference's seconds a trait for 1,000 permutations (README.md:229-233)
REFERENCE_PERM_S = 0.079
CACHE_DIR = Path(__file__).resolve().parent.parent / "build" / "bulklmm_tpu_torch_cache"
PRECISIONS = ("fast32", "balanced", "mixed", "exact64", "throughput")


def synth_cohort(n, p, m, seed=7):
    """Low-rank genotype structure so the kinship has a realistic spectrum:
    the JAX script's cohort, drawn in its order. (G, Y), float32."""
    rng = np.random.default_rng(seed)
    nfound = max(8, n // 50)  # founder haplotypes
    founders = rng.uniform(0, 1, (nfound, p)).astype(np.float32)
    mix = rng.dirichlet(np.ones(nfound) * 0.2, size=n).astype(np.float32)
    G = np.clip(mix @ founders + 0.05 * rng.normal(size=(n, p)).astype(np.float32), 0, 1)
    Y = rng.normal(size=(n, m)).astype(np.float32)
    return G, Y


def preset(name):
    """The ``--precision`` name's preset; None: the library default."""
    import bulklmm_tpu_torch as bt

    return bt.DEFAULT_PRECISION if name is None else getattr(bt, name.upper())


def host_decomposition(Gd, cache_dir=CACHE_DIR):
    """(Ut, lam, seconds): the host float64 eigendecomposition of the
    kinship of ``Gd`` (formed in float64 on Gd's device), loaded from
    ``cache_dir/eigh_n{n}.npz`` when it is there (0 seconds), else computed
    and saved there."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops.rotation import kinship_eigen

    cache = Path(cache_dir) / f"eigh_n{Gd.shape[0]}.npz"
    if cache.is_file():
        z = np.load(cache)
        return z["Ut"], z["lam"], 0.0
    t0 = time.perf_counter()
    Ut, lam = kinship_eigen(bt.calc_kinship(Gd, bt.EXACT64))
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, Ut=Ut, lam=lam)
    return Ut, lam, time.perf_counter() - t0


def kinship_for_run(Gd, *, lowrank=0, cache_dir=CACHE_DIR):
    """(K, setup seconds): the rank-k factors from the genotypes on the
    device (``lowrank`` > 0), else the cached decomposition on Gd's device
    in float32, as the JAX script casts ``Ut``."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops.rotation import decomposition_from_numpy

    if lowrank:
        t0 = time.perf_counter()
        K = bt.kinship_lowrank_from_geno(Gd, lowrank)
        float(K.lam.sum())  # the constructor's checksum: forces completion
        return K, time.perf_counter() - t0
    Ut, lam, eigh_s = host_decomposition(Gd, cache_dir)
    return decomposition_from_numpy(Ut, lam, device=Gd.device, dtype=torch.float32), eigh_s


def scan_blocks(Yd, Gd, K, *, precision, trait_chunk=4096, host_blocks=1, mesh=None):
    """Each host block's ``bulkscan`` result in turn (``host_blocks``
    sequential calls over the traits), or one ``bulkscan_sharded`` result on
    ``mesh``."""
    import bulklmm_tpu_torch as bt

    if mesh is not None:
        yield bt.bulkscan_sharded(Yd, Gd, K, mesh=mesh, precision=precision)
        return
    mb = -(-Yd.shape[1] // host_blocks)
    for b in range(host_blocks):
        Yb = Yd[:, b * mb : (b + 1) * mb]
        yield bt.bulkscan(Yb, Gd, K, trait_chunk=trait_chunk, precision=precision)


def scan_checksum(Yd, Gd, K, **kw) -> float:
    """The sum of every LOD, each block's fetched before the next runs."""
    return sum(float(r.L.sum()) for r in scan_blocks(Yd, Gd, K, **kw))


def timed(run) -> float:
    """Seconds of ``run()`` after one warm-up call, on the host clock; ``run``
    ends in a checksum fetch, and the device is synchronized on both sides."""
    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def bulkscan_line(n, p, m, dt, setup_s, lowrank) -> dict:
    lod_per_s = p * m / dt
    return {
        "metric": f"biobank_bulkscan_{n}x{p}x{m}",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(lod_per_s / REFERENCE_LODS_PER_S, 1),
        "note": f"{lod_per_s:.2e} LOD evals/s; "
        + (f"lowrank k={lowrank} device constructor {setup_s:.1f}s" if lowrank
           else f"kinship+eigh setup {setup_s:.1f}s (cached)"),
    }


def bulkperms_line(n, p, mp, perms, dt, setup_s, lowrank) -> dict:
    # the reference's sequential single-trait permutation scans, scaled to
    # the permutation count run; it also pays a ~n^3 host eigh
    return {
        "metric": f"biobank_bulkperms_{n}x{p}x{mp}x{perms}",
        "value": round(dt, 3),
        "unit": "s",
        "vs_baseline": round(mp * REFERENCE_PERM_S * (perms / 1000.0) / dt, 1),
        "note": (f"lowrank k={lowrank} constructor {setup_s:.1f}s" if lowrank
                 else f"eigh setup {setup_s:.1f}s (cached)"),
    }


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full", action="store_true", help="5,000 x 100,000 x 20,000")
    ap.add_argument("--sharded", action="store_true",
                    help="bulkscan_sharded on make_mesh() when there is more than one CUDA device")
    ap.add_argument("--trait-chunk", type=int, default=4096)
    ap.add_argument("--host-blocks", type=int, default=1,
                    help="split traits into N sequential bulkscan calls (each block's LOD matrix "
                         "is consumed before the next; for a (p, m) result past one card's memory)")
    ap.add_argument("--lowrank", type=int, default=0,
                    help="the rank-k kinship engine at this rank instead of the rotated full-rank "
                         "path; 0 = full-rank")
    ap.add_argument("--perms", type=int, default=0,
                    help="bulkscan_perms with N permutations instead of the scan")
    ap.add_argument("--perm-traits", type=int, default=128, help="trait count for --perms")
    ap.add_argument("--precision", default=None, choices=PRECISIONS,
                    help="numerics preset (default: the library default)")
    ap.add_argument("--cache-dir", type=Path, default=CACHE_DIR,
                    help="where the eigendecomposition is cached")
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the biobank run needs a CUDA device")
    import bulklmm_tpu_torch as bt

    dev = torch.device("cuda", torch.cuda.current_device())
    n, p, m = FULL if args.full else DEFAULT
    prec = preset(args.precision)

    t0 = time.perf_counter()
    G, Y = synth_cohort(n, p, m)
    print(f"# cohort {n} x {p} x {m} drawn on the host in {time.perf_counter() - t0:.1f} s",
          flush=True)
    Gd, Yd = torch.from_numpy(G).to(dev), torch.from_numpy(Y).to(dev)
    del G, Y
    K, setup_s = kinship_for_run(Gd, lowrank=args.lowrank, cache_dir=args.cache_dir)

    if args.perms:
        mp = min(args.perm_traits, m)
        Yp = Yd[:, :mp]
        dt = timed(lambda: float(bt.bulkscan_perms(Yp, Gd, K, nperms=args.perms,
                                                   precision=prec).maxlods.sum()))
        print(json.dumps(bulkperms_line(n, p, mp, args.perms, dt, setup_s, args.lowrank)))
        return 0

    mesh = bt.make_mesh() if args.sharded and torch.cuda.device_count() > 1 else None
    dt = timed(lambda: scan_checksum(Yd, Gd, K, precision=prec, trait_chunk=args.trait_chunk,
                                     host_blocks=args.host_blocks, mesh=mesh))
    print(json.dumps(bulkscan_line(n, p, m, dt, setup_s, args.lowrank)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
