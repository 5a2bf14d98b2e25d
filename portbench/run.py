"""Run one cell of the port's benchmark once and print its result's line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Needs a CUDA card (exits with code 2 and no
result without one, or with fewer than the cell asks for). Prints the
comparison's numbers with their limits as the last lines on standard
error, and as the last line of standard output one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), device, with ``--trace 1`` breakdown,
and checks. Exits with code 3, and no result, where a module of JAX or of
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return time.time() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


PROCESS_START = _process_start()
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
# every cache a run may fill lives at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / "build" / "portbench_cache" / sub))

FORBIDDEN = ("jax", "jaxlib", "flax", "bulklmm_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    from portbench.core import cell as cell_mod, spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import bulklmm_tpu_torch  # noqa: F401  (a checkout without the program stops here)

    line = cell_mod.run(cell, args.seed, args.seconds, bool(args.trace),
                        torch.device("cuda", 0), PROCESS_START)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"check correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
