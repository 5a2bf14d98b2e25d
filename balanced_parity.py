#!/usr/bin/env python3
"""BALANCED against EXACT64 at BXD scale, in the JAX package and in the
port's plain path, on the CPU.

    JAX_PLATFORMS=cpu python3 balanced_parity.py [--block 4096] [--traits N] [--rank-k]

The input is ``chip_smoke.py``'s BXD problem (79 samples x 7,321 markers x
35,554 traits, seed 2026, the intercept alone). For null-grid and alt-grid,
each package scans every trait block under BALANCED and under EXACT64 and
reports max |dLOD| between the two: null-grid on the traits whose grid h2
is the same under both presets, alt-grid on all pairs, as ``chip_smoke.py``
gates them on the card. The port runs with ``device="cpu"`` (its plain
path). Blocks are ``--block`` traits wide; the last one is padded with
copies of its own traits, which are dropped (each trait's arithmetic is
independent of the others'). The two EXACT64 runs are also held against
each other. Prints one line per (package, method) and, last, one JSON
object with every figure. ``--rank-k`` instead runs null-exact on the
rank-k engine at k = n (``kinship_lowrank_exact(K, 79)``) in both packages
under BALANCED, against the rotated EXACT64 null-exact scan (max |dLOD| and
max |dh2| over all traits): the JAX package fits each trait's h2 in the
kernel dtype there, the port in the solve dtype. Imports both packages: it
is a tool beside the tests, not part of the port.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import torch  # noqa: E402

import bulklmm_tpu as bl  # noqa: E402
import bulklmm_tpu_torch as bt  # noqa: E402
from bulklmm_tpu.utils import config as jcfg  # noqa: E402
from chip_smoke import synth_bxd  # noqa: E402

METHODS = ("null-grid", "alt-grid")


def _jax(Y, G, K, method, preset):
    res = bl.bulkscan(Y, G, K, method=method, precision=getattr(jcfg, preset))
    return np.asarray(res.L, np.float64), (
        None if method == "alt-grid" else np.asarray(res.h2_null_list, np.float64))


def _port(Y, G, K, method, preset):
    res = bt.bulkscan(Y, G, K, method=method, precision=bt.precision_by_name(preset),
                      device="cpu")
    return res.L.double().numpy(), (
        None if method == "alt-grid" else res.h2_null_list.double().numpy())


def _max_err(L, L64, h2, h2_64):
    """max |dLOD| on the equal-h2 traits (all pairs without h2), and the
    number of traits whose grid h2 differs."""
    if h2 is None:
        return float(np.max(np.abs(L - L64))), 0
    same = h2 == h2_64
    err = float(np.max(np.abs(L[:, same] - L64[:, same]))) if same.any() else 0.0
    return err, int((~same).sum())


def _rank_k_null_exact(Y, G, K, block) -> dict:
    """max |dLOD| and max |dh2| of rank-n null-exact under BALANCED in each
    package against the rotated EXACT64 null-exact scan, block by block."""
    from bulklmm_tpu.ops.lowrank import kinship_lowrank_exact

    lr = kinship_lowrank_exact(K, K.shape[0])
    worst = {pkg: {"max_abs_dlod": 0.0, "max_abs_dh2": 0.0} for pkg in ("jax", "port")}
    for s in range(0, Y.shape[1], block):
        Yb = np.ascontiguousarray(Y[:, s : s + block])
        ref, ref_h2 = _jax(Yb, G, K, "null-exact", "EXACT64")
        for pkg, run in (("jax", _jax), ("port", _port)):
            L, h2 = run(Yb, G, lr, "null-exact", "BALANCED")
            w = worst[pkg]
            w["max_abs_dlod"] = max(w["max_abs_dlod"], float(np.max(np.abs(L - ref))))
            w["max_abs_dh2"] = max(w["max_abs_dh2"], float(np.max(np.abs(h2 - ref_h2))))
    return worst


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--traits", type=int, default=None, help="the first N traits only")
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--rank-k", action="store_true",
                    help="rank-n null-exact against the rotated EXACT64 scan")
    args = ap.parse_args()
    torch.set_num_threads(args.threads)

    G, K, Y = synth_bxd()
    m = Y.shape[1] if args.traits is None else args.traits
    if args.rank_k:
        worst = _rank_k_null_exact(Y[:, :m], G, K, args.block)
        for pkg, w in worst.items():
            print(f"{pkg} rank-{K.shape[0]} null-exact BALANCED vs rotated EXACT64 over {m} "
                  f"traits: max|dLOD| = {w['max_abs_dlod']:.3e}, max|dh2| = {w['max_abs_dh2']:.3e}")
        print(json.dumps({"traits": m, "rank_k_null_exact": worst}))
        return
    stats = {(pkg, meth): {"err": 0.0, "flips": 0} for pkg in ("jax", "port") for meth in METHODS}
    cross = {meth: 0.0 for meth in METHODS}
    t0 = time.perf_counter()
    for s in range(0, m, args.block):
        e = min(s + args.block, m)
        cols = np.arange(s, s + args.block)
        cols[cols >= e] = s + (cols[cols >= e] - s) % (e - s)  # pad with the block's own traits
        Yb = np.ascontiguousarray(Y[:, cols])
        keep = slice(0, e - s)
        for meth in METHODS:
            L64 = {}
            for pkg, run in (("jax", _jax), ("port", _port)):
                L, h2 = run(Yb, G, K, meth, "BALANCED")
                L64[pkg], h2_64 = run(Yb, G, K, meth, "EXACT64")
                err, flips = _max_err(L[:, keep], L64[pkg][:, keep],
                                      None if h2 is None else h2[keep],
                                      None if h2_64 is None else h2_64[keep])
                st = stats[(pkg, meth)]
                st["err"], st["flips"] = max(st["err"], err), st["flips"] + flips
            cross[meth] = max(cross[meth], float(np.max(np.abs(L64["jax"][:, keep]
                                                             - L64["port"][:, keep]))))
        print(f"traits {s}-{e}: {time.perf_counter() - t0:.0f} s", flush=True)

    report = {"traits": m, "n": int(Y.shape[0]), "p": int(G.shape[1]), "figures": []}
    for (pkg, meth), st in stats.items():
        what = "equal-h2 traits" if meth == "null-grid" else "all pairs"
        print(f"{pkg} {meth}: BALANCED vs EXACT64 max|dLOD| = {st['err']:.3e} on {what} "
              f"({st['flips']} traits with another grid h2; 1e-5 "
              f"{'met' if st['err'] <= 1e-5 else 'NOT met'})")
        report["figures"].append({"package": pkg, "method": meth, "max_abs_dlod": st["err"],
                                  "h2_flips": st["flips"]})
    for meth, err in cross.items():
        print(f"{meth}: EXACT64 JAX package vs port max|dLOD| = {err:.3e}")
    report["exact64_cross"] = cross
    print(json.dumps(report))


if __name__ == "__main__":
    main()
