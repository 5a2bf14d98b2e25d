#!/usr/bin/env python3
"""Times of the LOD, bulk-permutation and alt-grid CUDA kernels of several
checkouts of this repository, in turns on one card.

    python3 kernel_times.py --trees build/parent . . build/parent

Each tree is a checkout that holds ``bulklmm_tpu_torch/`` and
``chip_smoke.py`` (for a parent commit: ``git archive <commit> | tar -x -C
build/parent``). For every tree in the order given, a fresh process imports
the port from that tree, builds its kernels, prepares the operands of the
main path at BXD scale with the tree's own preparation (79 samples x 7,321
markers x 35,554 traits, seed 2026: the BALANCED null-grid scan's own h2
for the LOD kernel, the first 1,024-trait block x 1,001 columns for the
permutation kernel, the default 10-point grid for the alt-grid kernel), and
times each kernel's wrapper alone: the median of 5
launches by CUDA events after one warm-up; a tree whose wrappers take
``dot_precision`` also has each kernel's bf16x3 products (THROUGHPUT's
"high") timed there, beside the 3 x TF32 ones. The LOD kernel is also timed at
the shapes of ``LOD_SHAPES``: S1-S6 (the general path forced at BXD scale,
BXD with 4, 8 and 12 covariate columns, 2,000 x 100,000 x 2,048 with one and
2,000 x 20,000 x 2,048 with 12), S7 (2,000 x 20,000 x 2,048 with 4) and the
effects variant at S1, S2, S4 and S5 (S1e, S2e, S4e, S5e), on random operands drawn
from one seed (``chip_smoke._kernel_inputs``) and prepared by the tree's own
``prepare_inputs``, so that each tree takes its own kernel for the shape.
The same tree named twice shows the spread. In a tree whose wrappers take
``dot_precision`` each shape is timed with bf16x3 products too, in turns
with the 3 x TF32 launch (the bf16x3 general and wide kernels where the
tree has them), and held against the float32 plain version. Each tree's LOD
kernel is also held against its plain version at every shape and on
``chip_smoke.py`` phase 11's block (the first 8,192 markers of its 2,000 x
100,000 panel, on the scan's own operands): max |dLOD| of each. The
permutation kernel is also timed on its chunked path at ``PERM_2000``
(random operands) and held against its plain version there, and at
``PERM_BIOBANK`` (random operands drawn on the card, timed only), and the
BALANCED null-grid scan at ``GENERAL_N`` samples (the general LOD kernel)
against EXACT64 at each of ``GENERAL_C``: max |dLOD| on the traits of equal
grid h2 and the h2 flips (and the THROUGHPUT scan's). Prints the
card's name and power limit, one line per run and each shape's bound (3 x
TF32 passes at 495 TFLOP/s, or the bytes at 3.35 TB/s; beside it the
bf16x3 bound, three bf16 passes at 989 TFLOP/s). Needs a CUDA device.

    python3 kernel_times.py --plain

times, in this checkout, the kernels' plain versions instead (median of 3
after a warm-up, CUDA events): the LOD step's float32 and bf16x3
(``liteqtl_bf16x3_reference``) plain versions on the main path's BXD
operands and at S4, S5 and S6, the alt-grid and permutation kernels'
bf16x3 plain versions (``dot_precision="high"``) on theirs, and the
permutation kernel's float32 and bf16x3 plain versions at ``PERM_2000``.

    python3 kernel_times.py --sass build/parent .

builds the kernel library of each tree instead and compares, with
``cuobjdump -sass``, the machine code of every kernel of the first tree
with the same kernel of the others (a kernel that gained the products'
policy as a template argument is matched as ``tf32x3::Policy``'s
instantiation), and prints how many are identical, differ or are missing.
"""

from __future__ import annotations

import argparse
import inspect
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path
from typing import NamedTuple


class Shape(NamedTuple):
    """A shape of the LOD kernel: samples, markers, traits, covariate
    columns, the general kernel forced, the effects variant."""

    n: int
    p: int
    m: int
    c: int
    general: bool = False
    effects: bool = False


#: the LOD kernel's shapes; chip_smoke.py times S1-S6 on its main path
LOD_SHAPES = {
    "S1": Shape(79, 7321, 35554, 1, general=True), "S2": Shape(79, 7321, 35554, 4),
    "S3": Shape(79, 7321, 35554, 8), "S4": Shape(2000, 100_000, 2048, 1),
    "S5": Shape(79, 7321, 35554, 12), "S6": Shape(2000, 20_000, 2048, 12),
    "S7": Shape(2000, 20_000, 2048, 4),
    "S1e": Shape(79, 7321, 35554, 1, general=True, effects=True),
    "S2e": Shape(79, 7321, 35554, 4, effects=True),
    "S4e": Shape(2000, 100_000, 2048, 1, effects=True),
    "S5e": Shape(79, 7321, 35554, 12, effects=True),
}
SHAPE_SEED = 12
#: the permutation kernel's chunked path (n > 88): samples, markers, traits
#: and columns (1,000 permutations and the observed one) of its timed launch
PERM_2000 = (2000, 20_000, 64, 1001)
#: the permutation kernel's launch in the benchmark's biobank.perms cell
#: (chunked, 32 traits: the marker walk split across blocks where the tree
#: does so), timed on random operands drawn on the card
PERM_BIOBANK = (5000, 100_000, 32, 1001)
#: samples of the BALANCED null-grid scans that take the general LOD kernel
#: (88 < n <= 200: four chunks of 40) against EXACT64, on chip_smoke.py's
#: synthetic BXD-shaped data with its markers and traits, at these
#: covariate counts (the intercept, and two random columns beside it)
GENERAL_N, GENERAL_C = 150, (1, 3)


def bound_ms(shape: Shape, products: str = "tf32x3") -> tuple[float, str]:
    """The least time of the LOD kernel at a shape on an H100 SXM, ms, and
    what sets it ("operations" or "bytes"): the larger of three passes of
    its 2 (c + 2) n p m flops on the tensor cores, TF32 at 495 TFLOP/s or
    with ``products="bf16x3"`` bf16 at 989 TFLOP/s, and its bytes (X, the
    (n, m) operands, V past 3 columns, one (p, m) output, three for the
    effects variant) at 3.35 TB/s."""
    n, p, m, c = shape[:4]
    flops = 2.0 * (c + 2) * n * p * m
    outs = 3 if shape.effects else 1
    nbytes = 4 * (n * p + 2 * n * m + (c * n * m if c > 3 else n * c) + outs * p * m)
    peak = {"tf32x3": 495e12, "bf16x3": 989e12}[products]
    by_ops, by_bytes = 3 * flops / peak * 1e3, nbytes / 3.35e12 * 1e3
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes, "bytes")


def perm_bound_ms(n: int, p: int, mb: int, K: int) -> float:
    """The least time of the permutation kernel's launch, ms: the larger of
    three TF32 passes of its 2 n p mb K flops at 495 TFLOP/s and its bytes
    (X, S2, inv_xn, the (mb, K) maxima) at 3.35 TB/s."""
    nbytes = 4 * (n * p + mb * n * K + mb * p + mb * K)
    return max(3 * 2.0 * n * p * mb * K / 495e12, nbytes / 3.35e12) * 1e3


def time_tree(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch

    import chip_smoke as cs
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.models import bulkperm as mp
    from bulklmm_tpu_torch.ops.bulkperm import permutation_indices
    from bulklmm_tpu_torch.utils.config import with_highest_matmul
    import bulklmm_tpu_torch as bt

    if not Path(bt.__file__).resolve().is_relative_to(tree.resolve()):
        raise RuntimeError(f"bulklmm_tpu_torch imported from {bt.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    G, K, Y = cs.synth_bxd()
    Gd, Yd = torch.from_numpy(G).to(dev), torch.from_numpy(Y).to(dev)
    grid = torch.as_tensor(cs.GRID, dtype=torch.float64, device=dev)
    rotated = cs._rotated_bxd(K, Yd, Gd, dev)
    alt_ops = af.prepare_inputs(*rotated, grid, prior=cs.PRIOR)
    h2 = bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED).h2_null_list
    lod_ops = lf.prepare_inputs(*rotated, h2)
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    ones = torch.ones((cs.N, 1), dtype=torch.float64, device=dev)
    with with_highest_matmul():
        prep = mp._bulkperm_prep(
            Yd.double(), Gd.double(), ones, dec.Ut, dec.lam, grid, prior=cs.PRIOR, reml=False,
            method="null-grid", optim_interval=1, precision=bt.BALANCED,
        )
    idx = permutation_indices(cs.N, cs.NPERMS, 0).to(dev)
    perm_ops = cs._perm_block_operands(prep, idx, 0, cs.PERM_BLOCK)

    def median_ms(fn):
        cs._event_ms(fn)
        return statistics.median(cs._event_ms(fn) for _ in range(5))

    out = {
        "tree": str(tree),
        "lod_ms": median_ms(lambda: lf.liteqtl_lod_cuda(*lod_ops)),
        "bulkperm_ms": median_ms(lambda: bf.bulkperm_maxr2_cuda(*perm_ops)),
        "altgrid_ms": median_ms(lambda: af.altgrid_cuda(*alt_ops)),
    }
    if "dot_precision" in inspect.signature(lf.liteqtl_lod_cuda).parameters:
        out["bf16x3"] = {
            "lod_ms": median_ms(lambda: lf.liteqtl_lod_cuda(*lod_ops, dot_precision="high")),
            "bulkperm_ms": median_ms(lambda: bf.bulkperm_maxr2_cuda(*perm_ops, dot_precision="high")),
            "altgrid_ms": median_ms(lambda: af.altgrid_cuda(*alt_ops, dot_precision="high")),
        }
    del G, Gd, Yd, rotated, alt_ops, lod_ops, prep, perm_ops
    torch.cuda.empty_cache()
    out["err"] = {}
    if "bf16x3" in out:
        out["bf16x3"]["shapes"], out["bf16x3"]["err"] = {}, {}
    for name, shape in LOD_SHAPES.items():
        rng = np.random.default_rng(SHAPE_SEED)
        ops = lf.prepare_inputs(*cs._kernel_inputs(*shape[:4], rng, dev), effects=shape.effects)

        def launch(**kw):
            return lf.liteqtl_lod_cuda(*ops, general=shape.general, effects=shape.effects, **kw)

        plain = lf.liteqtl_lod_plain(*ops, effects=shape.effects)
        if shape.effects:
            plain = plain[0]
        if "bf16x3" in out:
            # each products' launch in turns with the other's
            ms = {"highest": [], "high": []}
            for dp in ms:
                cs._event_ms(lambda: launch(dot_precision=dp))
            for _ in range(5):
                for dp in ms:
                    ms[dp].append(cs._event_ms(lambda: launch(dot_precision=dp)))
            out[name] = statistics.median(ms["highest"])
            out["bf16x3"]["shapes"][name] = statistics.median(ms["high"])
            got = launch(dot_precision="high")
            got = got[0] if shape.effects else got
            out["bf16x3"]["err"][name] = float((got - plain).abs().max())
        else:
            out[name] = median_ms(launch)
        got = launch()
        got = got[0] if shape.effects else got
        out["err"][name] = float((got - plain).abs().max())
        del ops, got, plain
        torch.cuda.empty_cache()
    out["err"]["block"], block_bf16 = _biobank_block_err(cs, bt, lf, dev, "bf16x3" in out)
    if block_bf16 is not None:
        out["bf16x3"]["err"]["block"] = block_bf16
    n, p, mb, K = PERM_2000
    if bf.kernel_path(n) != "chunked":
        raise RuntimeError(f"the permutation kernel at n = {n} does not take its chunked path")
    perm_ops = cs._perm_operands(n, p, mb, 1, K, np.random.default_rng(SHAPE_SEED), dev)
    out["perm2000_ms"] = median_ms(lambda: bf.bulkperm_maxr2_cuda(*perm_ops))
    out["err"]["perm2000_r2"] = float(
        (bf.bulkperm_maxr2_cuda(*perm_ops) - bf.bulkperm_maxr2_plain(*perm_ops)).abs().max())
    del perm_ops
    n, p, mb, K = PERM_BIOBANK
    gen = torch.Generator(device=dev).manual_seed(SHAPE_SEED)
    X = torch.randn((n, p), generator=gen, device=dev)
    S2 = torch.randn((mb, n, K), generator=gen, device=dev) / n**0.5
    inv = (1.0 / X.square().sum(0)).expand(mb, p).contiguous()
    out["perm_biobank_ms"] = median_ms(lambda: bf.bulkperm_maxr2_cuda(X, S2, inv))
    del X, S2, inv
    torch.cuda.empty_cache()
    out["general_vs_exact64"] = _general_vs_exact64(cs, bt, lf, dev)
    return out


def _general_vs_exact64(cs, bt, lf, dev) -> dict:
    """{c: (max |dLOD| on traits of equal grid h2, h2 flips, the plain
    version's max |dLOD| on the same traits, and the THROUGHPUT scan's max
    |dLOD| and h2 flips)} of the BALANCED null-grid scan at GENERAL_N
    samples against EXACT64, for each of GENERAL_C; the scans take the
    general LOD kernel, the plain version (``fused_lods_per_trait_reference``)
    the tree's own preparation of the same rotated inputs and h2."""
    import numpy as np
    import torch

    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    n = GENERAL_N
    G, K, Y = cs.synth_bxd(n, cs.P, cs.M)
    Gd, Yd = torch.from_numpy(G).to(dev), torch.from_numpy(Y).to(dev)
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    out = {}
    for c in GENERAL_C:
        if lf.kernel_path(n, c) != "general":
            raise RuntimeError(f"n = {n}, c = {c} does not take the general LOD kernel")
        covar = torch.from_numpy(np.random.default_rng(c).normal(size=(n, c - 1))).to(dev)
        res = bt.bulkscan(Yd, Gd, K, covar if c > 1 else None, precision=bt.BALANCED)
        ex = bt.bulkscan(Yd, Gd, K, covar if c > 1 else None, precision=bt.EXACT64)
        same = ex.h2_null_list == res.h2_null_list.double()
        C = torch.cat([torch.ones((n, 1), dtype=torch.float64, device=dev), covar], 1)
        with with_highest_matmul():
            Lp = lf.fused_lods_per_trait_reference(dec.Ut @ Yd.double(), dec.Ut @ Gd.double(),
                                                   dec.Ut @ C, dec.lam, res.h2_null_list)
        tp = bt.bulkscan(Yd, Gd, K, covar if c > 1 else None, precision=bt.THROUGHPUT)
        tsame = ex.h2_null_list == tp.h2_null_list.double()
        out[c] = (cs._max_abs_diff_cols(res.L, ex.L, same), int((~same).sum()),
                  cs._max_abs_diff_cols(Lp, ex.L, same), cs._max_abs_diff_cols(tp.L, ex.L, tsame),
                  int((~tsame).sum()))
        del res, ex, Lp, tp
        torch.cuda.empty_cache()
    return out


def _biobank_block_err(cs, bt, lf, dev, bf16=False) -> tuple:
    """max |dLOD| of the LOD kernel against its plain version on
    chip_smoke.py phase 11's block: the first 8,192 markers of its 2,000 x
    100,000 panel (seed 2026) with its 2,048 traits, on the rotated
    operands and the BALANCED null-grid h2 of that panel; with ``bf16``
    also the kernel's bf16x3 launch's (else None)."""
    import numpy as np
    import torch

    from bulklmm_tpu_torch.utils.config import with_highest_matmul

    n, p, m, block = 2000, 100_000, 2048, 8192
    rng = np.random.default_rng(cs.SEED)
    panel = rng.random((n, p), dtype=np.float32)
    Y = torch.from_numpy(rng.standard_normal((n, m), dtype=np.float32)).to(dev)
    K = bt.calc_kinship(torch.from_numpy(panel).to(dev), precision=bt.EXACT64).cpu().numpy()
    G = torch.from_numpy(np.ascontiguousarray(panel[:, :block])).to(dev)
    del panel
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    h2 = bt.bulkscan(Y, G, dec, precision=bt.BALANCED).h2_null_list
    with with_highest_matmul():
        ones = torch.ones((n, 1), dtype=torch.float64, device=dev)
        ops = lf.prepare_inputs(dec.Ut @ Y.double(), dec.Ut @ G.double(), dec.Ut @ ones, dec.lam, h2)
    plain = lf.liteqtl_lod_plain(*ops)
    high = (float((lf.liteqtl_lod_cuda(*ops, dot_precision="high") - plain).abs().max())
            if bf16 else None)
    return float((lf.liteqtl_lod_cuda(*ops) - plain).abs().max()), high


def plain_times() -> dict:
    """{what: ms} of the kernels' plain versions in this checkout (see the
    module's note on ``--plain``)."""
    import numpy as np
    import torch

    import chip_smoke as cs
    from bulklmm_tpu_torch.kernels import altgrid_fused as af
    from bulklmm_tpu_torch.kernels import bulkperm_fused as bf
    from bulklmm_tpu_torch.kernels import liteqtl_fused as lf
    from bulklmm_tpu_torch.models import bulkperm as mp
    from bulklmm_tpu_torch.ops.bulkperm import permutation_indices
    from bulklmm_tpu_torch.utils.config import with_highest_matmul
    import bulklmm_tpu_torch as bt

    dev = torch.device("cuda", 0)

    def median_ms(fn):
        cs._event_ms(fn)
        return statistics.median(cs._event_ms(fn) for _ in range(3))

    G, K, Y = cs.synth_bxd()
    Gd, Yd = torch.from_numpy(G).to(dev), torch.from_numpy(Y).to(dev)
    grid = torch.as_tensor(cs.GRID, dtype=torch.float64, device=dev)
    rotated = cs._rotated_bxd(K, Yd, Gd, dev)
    lod_ops = lf.prepare_inputs(*rotated, bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED).h2_null_list)
    out = {"lod float32": median_ms(lambda: lf.liteqtl_lod_plain(*lod_ops)),
           "lod bf16x3": median_ms(lambda: lf.liteqtl_bf16x3_reference(*lod_ops))}
    del lod_ops
    alt_ops = af.prepare_inputs(*rotated, grid, prior=cs.PRIOR)
    out["altgrid bf16x3"] = median_ms(lambda: af.altgrid_plain(*alt_ops, dot_precision="high")[0])
    del alt_ops
    dec = bt.decompose_kinship(K, dtype=torch.float64, device=dev)
    ones = torch.ones((cs.N, 1), dtype=torch.float64, device=dev)
    with with_highest_matmul():
        prep = mp._bulkperm_prep(
            Yd.double(), Gd.double(), ones, dec.Ut, dec.lam, grid, prior=cs.PRIOR, reml=False,
            method="null-grid", optim_interval=1, precision=bt.BALANCED,
        )
    perm_ops = cs._perm_block_operands(prep, permutation_indices(cs.N, cs.NPERMS, 0).to(dev), 0,
                                       cs.PERM_BLOCK)
    out["bulkperm bf16x3"] = median_ms(lambda: bf.bulkperm_maxr2_plain(*perm_ops, dot_precision="high"))
    del G, Gd, Yd, rotated, prep, perm_ops
    torch.cuda.empty_cache()
    for name in ("S4", "S5", "S6"):
        ops = lf.prepare_inputs(*cs._kernel_inputs(*LOD_SHAPES[name][:4],
                                                   np.random.default_rng(SHAPE_SEED), dev))
        out[f"{name} float32"] = median_ms(lambda: lf.liteqtl_lod_plain(*ops))
        out[f"{name} bf16x3"] = median_ms(lambda: lf.liteqtl_bf16x3_reference(*ops))
        del ops
        torch.cuda.empty_cache()
    n, p, mb, K = PERM_2000
    perm_ops = cs._perm_operands(n, p, mb, 1, K, np.random.default_rng(SHAPE_SEED), dev)
    for dp, what in (("highest", "float32"), ("high", "bf16x3")):
        out[f"perm2000 {what}"] = median_ms(lambda: bf.bulkperm_maxr2_plain(*perm_ops, dot_precision=dp))
    return out


def _library(tree: Path) -> Path:
    """The kernel library of a tree, built in a process of its own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); from bulklmm_tpu_torch.kernels.build "
            "import load_library, library_path; load_library(); print(library_path())")
    run = subprocess.run([sys.executable, "-c", code, str(tree)], capture_output=True, text=True,
                         check=True, timeout=900)
    return Path(run.stdout.strip().splitlines()[-1])


def _sass(lib: Path) -> dict:
    """{kernel: its instructions} from ``cuobjdump -sass``; names without the
    hash of an anonymous namespace's file, instructions without their
    addresses and encodings."""
    out = subprocess.run(["/usr/local/cuda/bin/cuobjdump", "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=600).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if found := re.search(r"Function : (\S+)", line):
            name = re.sub(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}", "ANON", found.group(1))
            funcs[name] = []
        elif name and "/*" in line:
            ins = re.sub(r"/\* 0x[0-9a-f]+ \*/|/\*[0-9a-f]{4,}\*/", "", line).strip()
            if ins:
                funcs[name].append(ins)
    return funcs


def _policy_name(name: str) -> str:
    """A kernel's name and template arguments, with ``tf32x3::Policy`` as
    the first argument where the name has none (a kernel from before the
    products' policy came), so that a kernel and its earlier form match."""
    head = name.partition("EEv")[0] if "EEv" in name else name.partition("EPKf")[0] + "I"
    if "Policy" not in head:
        at = head.find("_kernelI") + len("_kernelI")
        head = head[:at] + "N6tf32x36PolicyE" + head[at:]
    return head.rstrip("E")


def sass_diff(trees) -> None:
    libs = [_library(t) for t in trees]
    first, *others = [_sass(lib) for lib in libs]
    for tree, funcs in zip(trees[1:], others):
        by_head = {_policy_name(k): v for k, v in funcs.items()}
        same = [k for k, v in first.items() if by_head.get(_policy_name(k)) == v]
        missing = [k for k in first if _policy_name(k) not in by_head]
        differ = [k for k in first if k not in same and k not in missing]
        print(f"{trees[0]} against {tree}: {len(first)} kernels, {len(same)} with identical SASS, "
              f"{len(differ)} differ, {len(missing)} missing; {len(funcs)} kernels in {tree}")
        for k in differ + missing:
            print(f"  {'differs' if k in differ else 'missing'}: {k}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", type=Path, default=[Path(".")])
    parser.add_argument("--one", type=Path, help="time this tree in this process (internal)")
    parser.add_argument("--sass", type=Path, nargs="+",
                        help="compare the kernels' machine code of these trees instead")
    parser.add_argument("--plain", action="store_true",
                        help="time the kernels' plain versions in this checkout instead")
    args = parser.parse_args()
    if args.sass:
        sass_diff(args.sass)
        return
    if args.plain:
        import chip_smoke

        chip_smoke.device_check()
        print("plain versions (ms, median of 3): " + ", ".join(
            f"{k} {v:.3f}" for k, v in plain_times().items()))
        return
    if args.one is not None:
        print(json.dumps(time_tree(args.one)))
        return
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    for tree in args.trees:
        run = subprocess.run([sys.executable, __file__, "--one", str(tree)],
                             capture_output=True, text=True, timeout=900)
        if run.returncode:
            raise SystemExit(f"{tree}: exit {run.returncode}\n{run.stderr[-3000:]}")
        res = json.loads(run.stdout.strip().splitlines()[-1])
        print(f"{res['tree']:>16s}: LOD kernel {res['lod_ms']:.3f} ms a launch, permutation kernel "
              f"{res['bulkperm_ms']:.3f} ms, alt-grid kernel {res['altgrid_ms']:.3f} ms; LOD kernel "
              + ", ".join(f"{name} {res[name]:.3f}" for name in LOD_SHAPES) + " ms; max|dLOD| "
              "vs its plain version " + ", ".join(f"{k} {v:.4e}" for k, v in res["err"].items()))
        print(f"{'':>16s}  permutation kernel at n, p, mb, K = {PERM_2000} (chunked): "
              f"{res['perm2000_ms']:.3f} ms, at {PERM_BIOBANK}: {res['perm_biobank_ms']:.3f} ms; BALANCED null-grid at n = {GENERAL_N} (general kernel) "
              "vs EXACT64, (max|dLOD|, h2 flips; plain version's max|dLOD|; THROUGHPUT's max|dLOD|, "
              "h2 flips) by covariate count: "
              + ", ".join(f"c = {c} ({v[0]:.4e}, {v[1]}; {v[2]:.4e}; {v[3]:.4e}, {v[4]})"
                          for c, v in res["general_vs_exact64"].items()))
        if "bf16x3" in res:
            b = res["bf16x3"]
            print(f"{'':>16s}  bf16x3 products: " + ", ".join(
                f"{k.removesuffix('_ms')} {v:.3f} ms" for k, v in b.items() if k.endswith("_ms")))
            print(f"{'':>16s}  bf16x3 LOD kernel, in turns with the 3 x TF32 one: " + ", ".join(
                f"{name} {b['shapes'][name]:.3f}" for name in LOD_SHAPES) + " ms; max|dLOD| vs the "
                "float32 plain version " + ", ".join(f"{k} {v:.4e}" for k, v in b["err"].items()))
    print("bounds (ms): " + ", ".join(f"{name} {bound_ms(shape)[0]:.3f}"
                                      for name, shape in LOD_SHAPES.items()))
    print(f"permutation kernel at {PERM_2000}: bound {perm_bound_ms(*PERM_2000):.3f} ms; at "
          f"{PERM_BIOBANK}: bound {perm_bound_ms(*PERM_BIOBANK):.3f} ms")
    print("bf16x3 bounds (ms): " + ", ".join(f"{name} {bound_ms(shape, 'bf16x3')[0]:.3f}"
                                             for name, shape in LOD_SHAPES.items()))


if __name__ == "__main__":
    main()
