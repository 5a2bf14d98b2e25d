"""Readings that a cell's limits are set from: the control's and the
program's numbers, seed by seed, at the cell's own sizes.

    python3 portbench/control.py --workload <cell> --seeds <n> [<n> ...] [--program]

For each seed the cell's data is drawn as a run draws it, and three calls
are compared as a run compares its first, a middle and its last call: the
same trait columns, shuffle columns and calls. The control is the plain
reference one precision lower than the configuration states (float32
throughout, products on TF32, ``reference/lmm.py``), put in the program's
place; with ``--program`` the program's own calls are read too, without a
timed window. Prints one JSON line a seed and side, and needs a CUDA card.
The benchmark's runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def readings(cell, seed: int, device, *, program: bool) -> dict:
    """``{side: {number: value}}`` for one seed: "control", and "program"
    where asked."""
    import torch

    from portbench.core import cell as cm, judge, spec

    d = cm.Data(cell, seed, device)
    first, last, columns = cm.compared_calls(cell, seed)
    warm = cm.WARMUP_CALLS
    calls = [(warm, first, False), (warm + 1, first, False), (warm + 2, last, True)]
    kind = spec.kind(cell.traffic["kind"])
    out = {}
    if program:
        prog = cm.Program(cell, d)
        kept = []
        for i, cols, is_last in calls:
            res, _ = prog(i)
            kept.append(judge.keep(kind, res, i, cols, columns(i, is_last)))
            del res
        prog.free()
        torch.cuda.empty_cache()
        out["program"] = judge.judge(kind, cm.reference(cell, d), kept, d.panels, d.shuffles)
        del kept
    ctrl = cm.reference(cell, d, control=True)
    kept = [judge.Kept(call=i, cols=cols, columns=columns(i, is_last),
                       out=judge.control_outputs(kind, ctrl, d.panel(i), cols, columns(i, is_last),
                                                 d.shuffles(i) if kind.SHUFFLES else None))
            for i, cols, is_last in calls]
    del ctrl
    torch.cuda.empty_cache()
    out["control"] = judge.judge(kind, cm.reference(cell, d), kept, d.panels, d.shuffles)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--program", action="store_true")
    args = ap.parse_args(argv)
    import torch

    from portbench.core import spec

    if not torch.cuda.is_available():
        print("control.py needs a CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        for side, values in readings(cell, seed, torch.device("cuda", 0),
                                     program=args.program).items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "values": values, "limits": cell.checks["limits"],
                              "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
