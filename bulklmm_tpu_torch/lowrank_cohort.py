"""Large-n cohort run on the card: the rank-k kinship engine against the
full-rank path.

    python -m bulklmm_tpu_torch.lowrank_cohort [--n 20000 --p 50000 --m 2000
        --k 2048] [--compare-full] [--all-methods]

The counterpart of ``benchmarks/lowrank_cohort.py``, under its flags and
metric names. The full-rank engines pay an O(n^3) host eigendecomposition
and an (n, n) upload a cohort; the rank-k engine (``ops/lowrank.py``)
replaces both with randomized subspace iteration on the device and scans
by rank-k Woodbury corrections. The cohort (:func:`cohort`) follows the
JAX script's recipe, drawn on the device from a seeded ``torch.Generator``
(not ``jax.random``: other draws of the same distribution). Prints one
JSON line a phase (:func:`drive`): ``lowrank_construct_from_geno``,
``lowrank_bulkscan_null_grid``; with ``--all-methods`` the null-exact and
alt-grid scans and the 1,024-permutation ``scan``; with ``--compare-full``
``full_host_eigh_plus_upload``, ``full_bulkscan_null_grid`` and
``lowrank_vs_full_fidelity`` (:func:`fidelity`). Times on the host clock,
each call closed by a checksum fetch. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

ANCESTRY = 8  # ancestry directions of the cohort's genotype frequencies
DRAW_BLOCK = 8192  # markers drawn at a time
SCAN_REPS, METHOD_REPS = 3, 2  # timed calls after the first, as the JAX script takes
SCAN_NPERMS = 1024


def cohort(n, p, m, *, seed=0, device=None):
    """0/1 genotypes whose frequencies follow :data:`ANCESTRY` directions
    through a sigmoid load, and normal traits, drawn on ``device`` (default:
    the current CUDA device). Returns (G, Y), float32."""
    from bulklmm_tpu_torch.utils.device import resolve_device

    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    F = torch.randn((n, ANCESTRY), generator=gen, device=dev)
    W = torch.randn((ANCESTRY, p), generator=gen, device=dev)
    G = torch.empty((n, p), device=dev)
    for s in range(0, p, DRAW_BLOCK):
        load = torch.sigmoid(0.5 * (F @ W[:, s : s + DRAW_BLOCK]))
        draw = torch.rand(load.shape, generator=gen, device=dev)
        G[:, s : s + DRAW_BLOCK] = (draw < load).float()
    Y = torch.randn((n, m), generator=gen, device=dev)
    return G, Y


def _seconds(fn) -> float:
    """One call by the host clock; ``fn`` ends in a checksum fetch."""
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def _first_and_best(fn, reps) -> tuple:
    """(the first call's seconds, the least of ``reps`` calls after it)."""
    first = _seconds(fn)
    return first, min(_seconds(fn) for _ in range(reps))


def fidelity(L_lr, h2_lr, L_full, h2_full, *, k, n) -> dict:
    """The truncation's fidelity line: the share of traits whose grid h2
    agrees, the max |dLOD| on them (the weights' tail alone), and the 99th
    percentile and max of |dLOD| over every pair (a flip moves a trait's
    LODs by about the grid step)."""
    same = np.asarray(h2_lr) == np.asarray(h2_full)
    dL = np.abs(np.asarray(L_lr, dtype=np.float64) - np.asarray(L_full, dtype=np.float64))
    same_max = float(dL[:, same].max()) if same.any() else float("nan")
    return {
        "metric": "lowrank_vs_full_fidelity",
        "h2_grid_agreement": round(float(same.mean()), 4),
        "same_h2_max_absL": round(same_max, 6),
        "overall_p99_absL": round(float(np.quantile(dL, 0.99)), 6),
        "overall_max_absL": round(float(dL.max()), 6),
        "note": f"k={k} of n={n}",
    }


def _host(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def drive(G, Y, k, *, compare_full=False, all_methods=False, precision=None, log=print) -> dict:
    """The JAX script's phases on G's device, under ``precision`` (default:
    the library default). ``log`` takes each JSON line. Returns
    {"lowrank": the rank-k null-grid result, "lr": its factors} and, with
    ``compare_full``, "decomp" (the full decomposition in the preset's
    solve dtype), "full" (its null-grid result) and "fidelity"."""
    import bulklmm_tpu_torch as bt

    prec = bt.DEFAULT_PRECISION if precision is None else precision
    n, p = G.shape
    m = Y.shape[1]

    def emit(metric, s, **extra):
        log(json.dumps({"metric": metric, "value": round(s, 4), "unit": "s", **extra}))

    # 1. the rank-k constructor straight from the genotypes (K never formed)
    last = {}

    def construct():
        last["lr"] = bt.kinship_lowrank_from_geno(G, k, precision=prec)
        float(last["lr"].lam.sum())  # checksum fetch: forces completion

    first, best = _seconds(construct), _seconds(construct)
    emit("lowrank_construct_first_incl_compile", first, note=f"n={n} p={p} k={k}")
    emit("lowrank_construct_from_geno", best,
         note=f"n={n} p={p} k={k}, randomized subspace iteration, device-side")
    lr = last["lr"]

    # 2. the rank-k null-grid scan
    def scan(K, method="null-grid"):
        last["scan"] = bt.bulkscan(Y, G, K, method=method, precision=prec)
        float(last["scan"].L.sum())

    first, best = _first_and_best(lambda: scan(lr), SCAN_REPS)
    emit("lowrank_bulkscan_compile_first", first)
    emit("lowrank_bulkscan_null_grid", best, note=f"n={n} p={p} m={m} k={k}")
    out = {"lowrank": last["scan"], "lr": lr}

    if all_methods:  # the other methods and the permutation scan on the same factors
        for meth in ("null-exact", "alt-grid"):
            first, best = _first_and_best(lambda meth=meth: scan(lr, meth), METHOD_REPS)
            emit(f"lowrank_{meth}_compile_first", first)
            emit(f"lowrank_bulkscan_{meth.replace('-', '_')}", best,
                 note=f"n={n} p={p} m={m} k={k}")
        y1 = Y[:, 0].double()

        def perms():
            float(bt.scan(y1, G, lr, permutation_test=True, nperms=SCAN_NPERMS, rndseed=0,
                          precision=prec).L_perms.sum())

        first, best = _first_and_best(perms, METHOD_REPS)
        emit("lowrank_perms_compile_first", first)
        emit(f"lowrank_scan_perms_{SCAN_NPERMS}", best,
             note=f"n={n} p={p} k={k}, rank-k whitening + correlate")

    if compare_full:
        # 3. the wall the rank-k engine removes: host float64 eigh + (n, n) upload
        Kh = bt.calc_kinship(G, prec).cpu().double().numpy()

        def decompose():
            last["decomp"] = bt.decompose_kinship(Kh, dtype=prec.resolve_solve(), device=G.device)
            float(last["decomp"].lam.sum())

        emit("full_host_eigh_plus_upload", _seconds(decompose),
             note=f"n={n}, float64 LAPACK eigh + (n,n) upload")
        decomp = last["decomp"]
        first, best = _first_and_best(lambda: scan(decomp), SCAN_REPS)
        emit("full_bulkscan_compile_first", first)
        emit("full_bulkscan_null_grid", best, note="cached decomposition")
        r_lr, r_fu = out["lowrank"], last["scan"]
        out.update(decomp=decomp, full=r_fu,
                   fidelity=fidelity(_host(r_lr.L), _host(r_lr.h2_null_list), _host(r_fu.L),
                                     _host(r_fu.h2_null_list), k=k, n=n))
        log(json.dumps(out["fidelity"]))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=20000)
    ap.add_argument("--p", type=int, default=50000)
    ap.add_argument("--m", type=int, default=2000)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--compare-full", action="store_true")
    ap.add_argument("--all-methods", action="store_true",
                    help="also time null-exact, alt-grid, and the rank-k permutation scan")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the cohort run needs a CUDA device")
    dev = torch.device("cuda", torch.cuda.current_device())
    G, Y = cohort(args.n, args.p, args.m, device=dev)
    float(Y.sum())
    drive(G, Y, args.k, compare_full=args.compare_full, all_methods=args.all_methods,
          log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
