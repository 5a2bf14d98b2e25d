"""The validation sweep: every public scan path on the card against the
port's own CPU float64 goldens.

    python -m bulklmm_tpu_torch.validation

The counterpart of ``benchmarks/tpu_validation.py``: its fixture
(``default_rng(17)``, 79 samples x 512 markers x 64 traits, the same
kinship, traits, weights, covariates, chromosomes, matched-k eigenpairs at
k = 32 and missing pattern), its paths under the same keys and its bars
(:data:`TOL`), plus ``bulk_null_grid_c12`` and ``effects_c12``: 11 random
covariates beside the intercept, the LOD kernel's wide path. The device
side runs in BALANCED on the current CUDA device; the goldens are the port itself on ``device="cpu"`` at EXACT64, which the
tests hold against the JAX package. Imports nothing of JAX.

Prints one JSON line a path, ``{"path", "max_abs_err", "tol", "pass"}``,
then ``ALL PASS`` or ``FAILURES PRESENT``; exits 1 if any path fails.
:func:`run` with ``in_process=True`` leaves out the paths that start
subprocesses (the kill-and-resume of a checkpointed sweep and the command
line), as the CPU tests run it.
"""

from __future__ import annotations

import contextlib
import json
import os
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

#: the bar of every path, max |device - golden|; the first 41 are
#: benchmarks/tpu_validation.py's TOL, key by key
TOL = {
    "scan_null": 2e-5,
    "scan_reml": 2e-5,
    "scan_covar": 2e-5,
    "scan_weights": 2e-5,
    "scan_alt": 2e-5,
    "perms": 2e-5,
    "bulk_null_grid": 2e-5,
    "bulk_null_exact": 2e-5,
    "bulk_alt_grid": 2e-5,
    "bulk_perms": 2e-5,
    "lowrank_k_eq_n": 2e-5,
    "lowrank_trunc": 2e-5,
    "lowrank_scan": 2e-5,
    "lowrank_scan_perms": 2e-5,
    "lowrank_bulk_perms": 2e-5,
    "streamed": 2e-5,
    "streamed_perms": 2e-5,
    "loco_scan": 2e-5,
    "loco_bulk": 2e-5,
    "effects_beta": 2e-5,
    "effects_beta_se": 2e-5,
    "scan_effects_beta": 2e-5,
    "thresholds_bulk": 2e-5,
    "adj_pvals": 2e-5,
    "scan_svd": 2e-5,
    # the svd scheme's descending singular-value basis sums the float32
    # products in another order (the JAX package measured 2.1e-5 on its TPU)
    "bulk_svd": 3e-5,
    "compat_sqrt_weights": 2e-5,
    # log-likelihoods, O(n)-scale sums: 2e-5 LOD x ln 10 x |ll|
    "profile_ll_null": 1e-3,
    "profile_ll_alt": 1e-3,
    "getll": 1e-3,
    "bulk_perms_loco": 2e-5,
    "missing_mask": 2e-5,
    "missing_drop": 2e-5,
    # q-values near 1e-2..1 move ~25 times a LOD error through the chi2 cdf
    "lod_fdr_q": 5e-4,
    "bh_adjust": 5e-4,
    "streamed_memmap": 2e-5,
    "resume_on_chip": 1e-9,  # the device against itself: resumed == uninterrupted
    "cli_kinship": 2e-5,
    "cli_scan": 2e-5,
    "cli_bulkscan": 2e-5,
    "cli_bulkscan_perms": 2e-5,
    # the LOD kernel's wide path: c = 12 (11 covariates and the intercept)
    "bulk_null_grid_c12": 2e-5,
    "effects_c12": 2e-5,
}

#: paths that start subprocesses; ``run(in_process=True)`` leaves them out
SUBPROCESS_PATHS = ("resume_on_chip", "cli_kinship", "cli_scan", "cli_bulkscan",
                    "cli_bulkscan_perms")

NPERMS, SEED = 100, 7


def fixture(n: int = 79, p: int = 512, m: int = 64, seed: int = 17) -> dict:
    """benchmarks/tpu_validation.py's data, drawn in its order, then the 11
    covariates of the c = 12 paths."""
    rng = np.random.default_rng(seed)
    G = rng.uniform(0, 1, (n, p)).astype(np.float32)
    X = G.astype(np.float64) - 0.5
    K = 2 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    Lc = np.linalg.cholesky(K + 1e-9 * np.eye(n))
    h2s = rng.uniform(0.1, 0.9, m)
    Y = (np.sqrt(h2s) * (Lc @ rng.normal(size=(n, m)))
         + np.sqrt(1 - h2s) * rng.normal(size=(n, m))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n)
    covar = rng.normal(size=(n, 2))
    chrom = np.repeat(np.arange(1, 9), p // 8)
    evals, evecs = np.linalg.eigh(K)
    order = np.argsort(evals)[::-1][:32]
    Ym = Y.astype(np.float64).copy()
    Ym[2:7, 0] = np.nan
    Ym[2:7, 1] = np.nan
    Ym[11:14, 3] = np.nan
    covar12 = rng.normal(size=(n, 11))
    return dict(Y=Y, G=G, K=K, w=w, covar=covar, chrom=chrom, lrU=evecs[:, order],
                lrlam=np.maximum(evals[order], 0.0), Ym=Ym, covar12=covar12)


@contextlib.contextmanager
def _float64_default():
    """torch's default float raised to float64 for the block, as the JAX
    sweep runs with ``jax_enable_x64``: the calls without a ``precision``
    (``profile_LL``) then rotate in float64 on both sides."""
    saved = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        yield
    finally:
        torch.set_default_dtype(saved)


def _np(x):
    return x.detach().cpu().double().numpy() if torch.is_tensor(x) else np.asarray(x, np.float64)


def paths(data: dict, device, precision, *, golden: bool = False) -> dict:
    """Every in-process path on ``device`` under ``precision``: {key: array},
    or {key: (array, golden key)} where a path is held against another's
    golden (rank k = n, the streamed engines), which ``golden=True`` leaves
    out."""
    import bulklmm_tpu_torch as bt
    from bulklmm_tpu_torch.ops.rotation import kinship_eigen

    Y, G, K, w, covar, chrom = (data[k] for k in ("Y", "G", "K", "w", "covar", "chrom"))
    n = G.shape[0]
    y = Y[:, 0]
    kw = dict(precision=precision, device=device)
    out = {}
    with _float64_default():
        out["scan_null"] = bt.scan(y, G, K, **kw).lod
        out["scan_reml"] = bt.scan(y, G, K, reml=True, **kw).lod
        out["scan_covar"] = bt.scan(y, G, K, covar=covar, **kw).lod
        out["scan_weights"] = bt.scan(y, G, K, weights=w, **kw).lod
        out["scan_alt"] = bt.scan(y, G, K, assumption="alt", **kw).lod
        out["perms"] = bt.scan(y, G, K, permutation_test=True, nperms=NPERMS, rndseed=SEED,
                               **kw).L_perms
        out["bulk_null_grid"] = bt.bulkscan(Y, G, K, **kw).L
        out["bulk_null_exact"] = bt.bulkscan(Y, G, K, method="null-exact", **kw).L
        out["bulk_alt_grid"] = bt.bulkscan(Y, G, K, method="alt-grid", **kw).L
        bp = bt.bulkscan_perms(Y, G, K, nperms=NPERMS, rndseed=SEED, **kw)
        out["bulk_perms"] = bp.maxlods

        dtype = precision.resolve_solve()
        if not golden:
            full = bt.kinship_lowrank_exact(K, n, dtype=dtype, device=device)
            out["lowrank_k_eq_n"] = (bt.bulkscan(Y, G, full, **kw).L, "bulk_null_grid")
        lr = bt.LowRankKinship(U=torch.as_tensor(data["lrU"], dtype=dtype, device=device),
                               lam=torch.as_tensor(data["lrlam"], dtype=dtype, device=device))
        out["lowrank_trunc"] = bt.bulkscan(Y, G, lr, **kw).L
        out["lowrank_scan"] = bt.scan(y, G, lr, **kw).lod
        out["lowrank_scan_perms"] = bt.scan(y, G, lr, permutation_test=True, nperms=NPERMS,
                                            rndseed=SEED, **kw).L_perms
        out["lowrank_bulk_perms"] = bt.bulkscan_perms(Y, G, lr, nperms=NPERMS, rndseed=SEED,
                                                      **kw).maxlods

        if not golden:  # marker_block < p: several blocks stream
            out["streamed"] = (bt.bulkscan_streamed(Y, G, K, marker_block=100, **kw).L,
                               "bulk_null_grid")
            out["streamed_perms"] = (bt.bulkscan_perms_streamed(
                Y, G, K, nperms=NPERMS, rndseed=SEED, marker_block=100, **kw).maxlods,
                "bulk_perms")

        out["loco_scan"] = bt.scan_loco(y, G, chrom, **kw).lod
        out["loco_bulk"] = bt.bulkscan_loco(Y, G, chrom, **kw).L

        eb = bt.bulkscan(Y, G, K, output_effects=True, **kw)
        out["effects_beta"] = eb.beta_mat
        out["effects_beta_se"] = eb.beta_se_mat
        out["scan_effects_beta"] = bt.scan(y, G, K, output_effects=True, **kw).beta

        thr = bt.get_thresholds_bulk(bp.perm_maxima, [0.10, 0.05, 0.01])
        out["thresholds_bulk"] = thr.thrs
        out["adj_pvals"] = bp.log10_adj_pvals

        out["scan_svd"] = bt.scan(y, G, K, decomp_scheme="svd", **kw).lod
        out["bulk_svd"] = bt.bulkscan(Y, G, K, decomp_scheme="svd", **kw).L
        out["compat_sqrt_weights"] = bt.scan(y, G, K, weights=w, assumption="alt",
                                             compat_sqrt_weights=True, **kw).lod
        ones = np.ones((n, 1))
        prof = bt.profile_LL(y, G, ones, K, np.arange(0.05, 0.95, 0.05), 10, device=device)
        out["profile_ll_null"] = prof.ll_list_null
        out["profile_ll_alt"] = prof.ll_list_alt
        Ut, lam = kinship_eigen(K)
        on = lambda a: torch.as_tensor(a, dtype=torch.float64, device=device)  # noqa: E731
        out["getll"] = torch.stack(bt.getLL(on(Ut @ y), on(Ut @ np.column_stack([ones, G])),
                                            on(lam), 1, 10, 0.5))
        out["bulk_perms_loco"] = bt.bulkscan_perms_loco(Y, G, chrom, nperms=50, rndseed=SEED,
                                                        **kw).maxlods
        out["missing_mask"] = bt.bulkscan(data["Ym"], G, K, missing="mask", **kw).L
        out["missing_drop"] = bt.bulkscan(data["Ym"], G, K, missing="drop", **kw).L
        # FDR on the device's own LODs
        L = _np(out["bulk_null_grid"])
        out["lod_fdr_q"] = bt.lod_fdr(L)[0]
        out["bh_adjust"] = bt.bh_adjust(bt.lod2p(L, 1))

        if not golden:  # memmap in, memmap out: the large-p flow
            out["streamed_memmap"] = (_streamed_memmap(Y, G, K, **kw), "bulk_null_grid")

        # the LOD kernel's wide path: 11 covariates and the intercept
        c12 = data["covar12"]
        out["bulk_null_grid_c12"] = bt.bulkscan(Y, G, K, c12, **kw).L
        e12 = bt.bulkscan(Y, G, K, c12, output_effects=True, **kw)
        out["effects_c12"] = torch.stack([e12.beta_mat, e12.beta_se_mat])
    return out


def _streamed_memmap(Y, G, K, **kw) -> np.ndarray:
    """``bulkscan_streamed`` from a read-only memmap of G into a memmap L."""
    import bulklmm_tpu_torch as bt

    with tempfile.TemporaryDirectory() as tmp:
        Gmm = np.memmap(Path(tmp) / "G.dat", dtype=np.float32, mode="w+", shape=G.shape)
        Gmm[:] = G
        Gmm.flush()
        Gro = np.memmap(Path(tmp) / "G.dat", dtype=np.float32, mode="r", shape=G.shape)
        Lmm = np.memmap(Path(tmp) / "L.dat", dtype=np.float64, mode="w+",
                        shape=(G.shape[1], Y.shape[1]))
        st = bt.bulkscan_streamed(Y, Gro, K, marker_block=100, out=Lmm, **kw)
        if st.L is not Lmm:
            raise AssertionError("bulkscan_streamed(out=...) did not return its memmap")
        return np.array(Lmm)


def goldens(data: dict) -> dict:
    """The port on the CPU at EXACT64: {key: float64 array}."""
    import bulklmm_tpu_torch as bt

    return {k: _np(v) for k, v in paths(data, "cpu", bt.EXACT64, golden=True).items()}


def _resume(tmp: Path, data: dict, device) -> float:
    """A subprocess runs a checkpointed permutation sweep on ``device`` and
    is killed once its first trait chunk is written; this process resumes
    from the torn checkpoint and must equal its own uninterrupted run.
    Returns max |resumed - uninterrupted|."""
    import bulklmm_tpu_torch as bt

    np.savez(tmp / "data.npz", Y=data["Y"], G=data["G"], K=data["K"])
    kw = dict(nperms=1000, rndseed=SEED, trait_chunk=2, precision=bt.BALANCED, device=device)
    ref = bt.bulkscan_perms(data["Y"], data["G"], data["K"], **kw)
    ck = tmp / "ck"
    script = (
        "import sys, numpy as np, bulklmm_tpu_torch as bt\n"
        f"z = np.load(r'{tmp / 'data.npz'}')\n"
        "bt.bulkscan_perms(z['Y'], z['G'], z['K'], nperms=1000, rndseed=7, trait_chunk=2,\n"
        f"                 precision=bt.BALANCED, device='{device}', checkpoint=r'{ck}')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))
    total = -(-data["Y"].shape[1] // 2)
    killed = False
    for _ in range(3):
        for f in ck.glob("*") if ck.exists() else ():
            f.unlink()
        proc = subprocess.Popen([sys.executable, "-c", script], env=env,
                                stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        deadline = time.time() + 300
        try:
            while time.time() < deadline and proc.poll() is None:
                if list(ck.glob("maxlods_*.npy")):
                    break
                time.sleep(0.005)
            if proc.poll() is None:
                os.kill(proc.pid, signal.SIGKILL)
        finally:
            proc.wait(timeout=120)
        if 1 <= len(list(ck.glob("maxlods_*.npy"))) < total:
            killed = True
            break
    res = bt.bulkscan_perms(data["Y"], data["G"], data["K"], checkpoint=str(ck), **kw)
    print(json.dumps({"path": "resume_on_chip.kill_landed_mid_sweep", "value": killed}))
    return float((res.maxlods.double() - ref.maxlods.double()).abs().max())


def _cli(tmp: Path, data: dict, device):
    """``python -m bulklmm_tpu_torch`` subprocesses on ``device`` (BALANCED,
    the default preset): (key, array, golden key); "ZERO" marks an array of
    absolute differences already taken."""
    np.savez(tmp / "g.npz", geno=data["G"])
    np.savez(tmp / "y.npz", pheno=data["Y"])
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent.parent))

    def run(*args):
        r = subprocess.run([sys.executable, "-m", "bulklmm_tpu_torch", *args, "--device",
                            str(device)], env=env, capture_output=True, text=True, timeout=1200,
                           cwd=tmp)
        if r.returncode != 0:
            raise RuntimeError(f"the command line failed: {args}\n{r.stderr[-1500:]}")

    run("kinship", "--geno", "g.npz", "-o", "Kcli.npz")
    yield "cli_kinship", np.abs(np.load(tmp / "Kcli.npz")["kinship"] - data["K"]), "ZERO"
    run("scan", "--geno", "g.npz", "--pheno", "y.npz", "--trait", "0", "-o", "scan_cli.npz")
    yield "cli_scan", np.load(tmp / "scan_cli.npz")["lod"], "scan_null"
    run("bulkscan", "--geno", "g.npz", "--pheno", "y.npz", "--nperms", str(NPERMS), "--seed",
        str(SEED), "-o", "bulk_cli.npz")
    z = np.load(tmp / "bulk_cli.npz")
    yield "cli_bulkscan", z["L"], "bulk_null_grid"
    yield "cli_bulkscan_perms", z["perm_maxlods"], "bulk_perms"


def compare(results: dict, gold: dict) -> list:
    """One line a path: {"path", "max_abs_err", "tol", "pass"}. A value is
    an array held against its own key's golden, or (array, golden key),
    where the key "SELF" marks an error already taken and "ZERO" an array
    of absolute differences."""
    lines = []
    for name, value in results.items():
        arr, key = value if isinstance(value, tuple) else (value, name)
        if key == "SELF":
            err = float(arr)
        elif key == "ZERO":
            err = float(np.max(arr))
        else:
            a, g = _np(arr), gold[key]
            if a.shape != g.shape:
                raise AssertionError(f"{name}: shape {a.shape}, golden {g.shape}")
            err = float(np.max(np.abs(a - g)))
        lines.append({"path": name, "max_abs_err": err, "tol": TOL[name],
                      "pass": bool(err <= TOL[name])})
    return lines


def run(device, *, in_process: bool = False) -> list:
    """The sweep's lines: the device side in BALANCED on ``device`` against
    the CPU EXACT64 goldens."""
    import bulklmm_tpu_torch as bt

    data = fixture()
    gold = goldens(data)
    results = paths(data, device, bt.BALANCED)
    if not in_process:
        with tempfile.TemporaryDirectory() as tmp:
            results["resume_on_chip"] = (_resume(Path(tmp), data, device), "SELF")
            for name, arr, key in _cli(Path(tmp), data, device):
                results[name] = (arr, key)
    return compare(results, gold)


def main() -> int:
    """The whole sweep on the current CUDA device; 0 if every path holds."""
    if not torch.cuda.is_available():
        raise SystemExit("the validation sweep needs a CUDA device")
    lines = run(torch.device("cuda", torch.cuda.current_device()))
    for line in lines:
        print(json.dumps(line))
    ok = all(line["pass"] for line in lines)
    print("ALL PASS" if ok else "FAILURES PRESENT")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
