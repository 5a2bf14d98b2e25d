"""THROUGHPUT's FWER claim measured on the card: how far the screening
tier's permutation thresholds move from BALANCED's, against the
seed-to-seed spread a user already accepts by picking one seed.

    python -m bulklmm_tpu_torch.throughput_fwer [--out PATH]

The counterpart of ``benchmarks/throughput_fwer.py``, under its names: for
:data:`NSEEDS` seeds, BALANCED and then THROUGHPUT ``bulkscan_perms``
(:data:`NPERMS` permutations, ``rndseed=seed``) on a BXD-scale trait
panel (:func:`synth`, 79 x 7,321 x 256), then ``get_thresholds_bulk`` at
:data:`ALPHAS`; one row an alpha (:func:`fwer_rows`) sets the paired
same-seed |threshold difference| between the tiers against the across-seed
spread of BALANCED's. Then THROUGHPUT's accuracy engine by engine
(:func:`engine_accuracy_table`): max |dLOD| against the port's own
``device="cpu"`` EXACT64 runs on the same inputs, under the keys of the
JAX script's ``ENGINE_CHILD``.

The two tiers of one seed take the same shuffle indices (the port's seeded
CPU generator, not the JAX package's threefry, so the card's thresholds
are other draws than the TPU's; the claim needs the pairing only).
Prints one JSON line a row and a line an engine, and writes both to
``build/throughput_fwer.json`` (``--out`` names another path). Imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

ALPHAS = [0.25, 0.10, 0.05, 0.01, 0.002]
NSEEDS = 10
NPERMS = 1000

#: the engines of the JAX script's ENGINE_CHILD, in its order
ENGINES = ("scan_null", "scan_alt", "bulk_null_grid", "bulk_null_exact", "bulk_alt_grid",
           "bulk_perms", "streamed", "lowrank_trunc")

#: the engine table's fixture: the JAX script's ``synth`` arguments
ENGINE_DATA = dict(n=79, p=512, m=64, seed=5)

OUT = Path(__file__).resolve().parent.parent / "build" / "throughput_fwer.json"


def synth(n=79, p=7321, m=256, seed=2026):
    """The JAX script's data, drawn in its order: (G, K, Y)."""
    rng = np.random.default_rng(seed)
    G = rng.uniform(0, 1, (n, p)).astype(np.float32)
    X = G.astype(np.float64) - 0.5
    K = 2 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Lc = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    h2s = rng.uniform(0.1, 0.9, m)
    Y = (
        np.sqrt(h2s) * (Lc @ rng.normal(size=(n, m)))
        + np.sqrt(1 - h2s) * rng.normal(size=(n, m))
    ).astype(np.float32)
    return G, K, Y


def tier_thresholds(G, K, Y, *, nseeds=NSEEDS, nperms=NPERMS, device=None, perm_idx=None,
                    log=None) -> dict:
    """{"balanced": (seeds, alphas, m), "throughput": ...}: for each seed,
    BALANCED and then THROUGHPUT ``bulkscan_perms(nperms=nperms,
    rndseed=seed)`` and their ``get_thresholds_bulk`` at :data:`ALPHAS`.
    ``perm_idx``, when given, maps a seed to the (nperms + 1, n) shuffle
    indices both tiers take for it. ``log`` takes a line after each seed."""
    import bulklmm_tpu_torch as bt

    thrs = {"balanced": [], "throughput": []}
    for seed in range(nseeds):
        idx = None if perm_idx is None else perm_idx(seed)
        for tier, prec in (("balanced", bt.BALANCED), ("throughput", bt.THROUGHPUT)):
            bp = bt.bulkscan_perms(Y, G, K, nperms=nperms, rndseed=seed, precision=prec,
                                   perm_idx=idx, device=device)
            thrs[tier].append(bt.get_thresholds_bulk(bp.perm_maxima, ALPHAS).thrs)
        if log is not None:
            log(f"seed {seed} done")
    return {tier: np.stack(t) for tier, t in thrs.items()}


def fwer_rows(bal, thr, alphas) -> list:
    """One row an alpha from (seeds, alphas, m) thresholds of the two tiers:
    the paired same-seed |difference| (mean, 99th percentile, max), the
    across-seed spread of BALANCED's (standard deviation, mean and min over
    traits) and their ratio trait by trait (mean and max)."""
    rows = []
    for ai, alpha in enumerate(alphas):
        delta = np.abs(bal[:, ai] - thr[:, ai])       # paired same-seed
        mc = bal[:, ai].std(axis=0, ddof=1)           # across-seed spread
        rows.append({
            "alpha": alpha,
            "tier_delta_mean": float(delta.mean()),
            "tier_delta_p99": float(np.quantile(delta, 0.99)),
            "tier_delta_max": float(delta.max()),
            "mc_spread_mean": float(mc.mean()),
            "mc_spread_min": float(mc.min()),
            "delta_over_spread_mean": float((delta.mean(axis=0) / mc).mean()),
            "delta_over_spread_max": float((delta.mean(axis=0) / mc).max()),
        })
    return rows


def fwer_measurement(G, K, Y, *, nseeds=NSEEDS, nperms=NPERMS, device=None, perm_idx=None,
                     log=None) -> list:
    """The JAX script's ``fwer_measurement``: :func:`fwer_rows` of
    :func:`tier_thresholds`."""
    t = tier_thresholds(G, K, Y, nseeds=nseeds, nperms=nperms, device=device, perm_idx=perm_idx,
                        log=log)
    return fwer_rows(t["balanced"], t["throughput"], ALPHAS)


def engine_outputs(data, device, precision) -> dict:
    """{engine: float64 array}: each of :data:`ENGINES` on ``device`` under
    ``precision``, the calls of the JAX script's ``ENGINE_CHILD``."""
    import bulklmm_tpu_torch as bt

    G, K, Y = data
    y = Y[:, 0]
    kw = dict(precision=precision, device=device)
    lr = bt.kinship_lowrank_exact(K, 32, dtype=torch.float64, device=device)
    runs = {
        "scan_null": lambda: bt.scan(y, G, K, **kw).lod,
        "scan_alt": lambda: bt.scan(y, G, K, assumption="alt", **kw).lod,
        "bulk_null_grid": lambda: bt.bulkscan(Y, G, K, **kw).L,
        "bulk_null_exact": lambda: bt.bulkscan(Y, G, K, method="null-exact", **kw).L,
        "bulk_alt_grid": lambda: bt.bulkscan(Y, G, K, method="alt-grid", **kw).L,
        "bulk_perms": lambda: bt.bulkscan_perms(Y, G, K, nperms=200, rndseed=3, **kw).maxlods,
        "streamed": lambda: bt.bulkscan_streamed(Y, G, K, marker_block=100, **kw).L,
        "lowrank_trunc": lambda: bt.bulkscan(Y, G, lr, **kw).L,
    }
    out = {}
    for name in ENGINES:
        res = runs[name]()
        out[name] = (res.detach().cpu().double().numpy() if torch.is_tensor(res)
                     else np.asarray(res, dtype=np.float64))
    return out


def engine_accuracy_table(device, log=None) -> dict:
    """{engine: max |dLOD|}: THROUGHPUT on ``device`` against the port's
    EXACT64 on the CPU, at :data:`ENGINE_DATA`. ``log`` takes one JSON line
    an engine."""
    import bulklmm_tpu_torch as bt

    data = synth(**ENGINE_DATA)
    gold = engine_outputs(data, "cpu", bt.EXACT64)
    got = engine_outputs(data, device, bt.THROUGHPUT)
    table = {}
    for name in ENGINES:
        table[name] = float(np.max(np.abs(got[name] - gold[name])))
        if log is not None:
            log(json.dumps({"engine": name, "throughput_max_abs_err": table[name]}))
    return table


def main(argv=None) -> int:
    """The study and the table on the current CUDA device; writes the JSON
    record."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT, help="the JSON record's path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("the FWER study needs a CUDA device")
    device = torch.device("cuda", torch.cuda.current_device())
    log = lambda line: print(line, flush=True)  # noqa: E731

    G, K, Y = synth()
    log(f"FWER measurement: m={Y.shape[1]} traits x {G.shape[1]} markers, nperms={NPERMS}, "
        f"{NSEEDS} seeds, alphas={ALPHAS}, on {torch.cuda.get_device_name(device)}")
    rows = fwer_measurement(G, K, Y, device=device, log=log)
    for r in rows:
        log(json.dumps(r))
    table = engine_accuracy_table(device, log=log)
    out = {"fwer": rows, "engine_throughput_err": table,
           "config": {"n": G.shape[0], "p": G.shape[1], "m": Y.shape[1], "nperms": NPERMS,
                      "nseeds": NSEEDS, "alphas": ALPHAS},
           "device": torch.cuda.get_device_name(device)}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(out, indent=2) + "\n")
    log(f"# wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
