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
launches by CUDA events after one warm-up. The same tree named twice shows
the spread. Prints the card's name and power limit and one line per run.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path


def time_tree(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
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

    return {
        "tree": str(tree),
        "lod_ms": median_ms(lambda: lf.liteqtl_lod_cuda(*lod_ops)),
        "bulkperm_ms": median_ms(lambda: bf.bulkperm_maxr2_cuda(*perm_ops)),
        "altgrid_ms": median_ms(lambda: af.altgrid_cuda(*alt_ops)),
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", type=Path, default=[Path(".")])
    parser.add_argument("--one", type=Path, help="time this tree in this process (internal)")
    args = parser.parse_args()
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
              f"{res['bulkperm_ms']:.3f} ms, alt-grid kernel {res['altgrid_ms']:.3f} ms")


if __name__ == "__main__":
    main()
