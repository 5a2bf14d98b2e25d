"""Where a call's time goes on the card.

    python3 -m bulklmm_tpu_torch.profile_paths [--calls 3] [--paths null-grid perms]

Runs each BALANCED entry point at the BXD shape (79 samples x 7,321 markers x
35,554 traits, synthetic, seed 2026; ``bulkscan_perms`` with 1,000
permutations; the single-trait ``scan``, null and alt, on trait 0) once to
warm up, then ``--calls`` times under
``torch.profiler``, each call followed by a checksum fetch as a user's
would be, first with the profiler off for the wall time on the host clock.
Per call it prints that wall time, the time the device was busy (the sum
of the device kernels' and copies' own times), the idle share, the kernel
launches and the synchronizing runtime calls, the device kernels that took
most of the busy time, and the host operators that took most of the host's
own time. Needs a CUDA device; it never runs on the CPU.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

N, P, M, NPERMS, SEED = 79, 7321, 35554, 1000, 2026
PATHS = ("null-grid", "alt-grid", "null-exact", "perms", "scan-null", "scan-alt")


def synth_bxd(n=N, p=P, m=M, seed=SEED):
    """BXD-shaped synthetic data: uniform genotype probabilities, their
    kinship, standard normal traits."""
    rng = np.random.default_rng(seed)
    G = rng.uniform(0.0, 1.0, (n, p)).astype(np.float32)
    X = G.astype(np.float64) - 0.5
    K = 2.0 * X @ X.T / p + 0.5
    np.fill_diagonal(K, 1.0)
    return G, K, rng.normal(size=(n, m)).astype(np.float32)


def _device_us(event) -> float:
    # the attribute's name changed between PyTorch versions
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(event, name):
            return float(getattr(event, name))
    raise AttributeError("the profiler's events carry no device time")


def profile_path(name, fn, calls: int, top: int = 8) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    float(fn().sum())  # warm-up: builds the kernels, fills the caches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        float(fn().sum())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / calls  # the profiler is off
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            float(fn().sum())
        torch.cuda.synchronize()
    events = prof.key_averages()
    # kernels and copies only: an operator's row repeats its kernels' time
    on_device = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(_device_us(e) for e in on_device) / 1e3 / calls
    if busy_ms == 0.0:
        raise RuntimeError("the profiler recorded no device time; time with CUDA events instead")
    launches = sum(e.count for e in events if e.key.startswith("cudaLaunchKernel")) / calls
    syncs = sum(e.count for e in events if "Synchronize" in e.key) / calls
    print(f"{name}: wall {wall_ms:.2f} ms per call (profiler off), device busy {busy_ms:.2f} ms "
          f"(profiler on), idle {100 * (1 - busy_ms / wall_ms):.0f} %, {launches:.0f} kernel "
          f"launches and {syncs:.0f} synchronizing calls per call")
    for e in sorted(on_device, key=_device_us, reverse=True)[:top]:
        ms = _device_us(e) / 1e3 / calls
        print(f"    {ms:9.3f} ms  {100 * ms / busy_ms:5.1f} %  x{e.count / calls:<7.0f} {e.key[:90]}")
    on_host = [e for e in events if e.device_type == DeviceType.CPU]
    print("  host operators by their own time (profiler on):")
    for e in sorted(on_host, key=lambda e: e.self_cpu_time_total, reverse=True)[:top // 2]:
        ms = e.self_cpu_time_total / 1e3 / calls
        print(f"    {ms:9.3f} ms  x{e.count / calls:<7.0f} {e.key[:90]}")


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--calls", type=int, default=3)
    parser.add_argument("--paths", nargs="+", choices=PATHS, default=list(PATHS))
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_paths needs a CUDA device")
    import bulklmm_tpu_torch as bt

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip())
    G, K, Y = synth_bxd()
    Gd, Yd = torch.from_numpy(G).cuda(), torch.from_numpy(Y).cuda()
    y = Y[:, 0].astype(np.float64)
    runs = {
        "null-grid": lambda: bt.bulkscan(Yd, Gd, K, precision=bt.BALANCED).L,
        "alt-grid": lambda: bt.bulkscan(Yd, Gd, K, method="alt-grid", precision=bt.BALANCED).L,
        "null-exact": lambda: bt.bulkscan(Yd, Gd, K, method="null-exact", precision=bt.BALANCED).L,
        "perms": lambda: bt.bulkscan_perms(
            Yd, Gd, K, nperms=NPERMS, rndseed=0, precision=bt.BALANCED).maxlods,
        "scan-null": lambda: bt.scan(y, Gd, K, precision=bt.BALANCED).lod,
        "scan-alt": lambda: bt.scan(y, Gd, K, assumption="alt", precision=bt.BALANCED).lod,
    }
    for name in args.paths:
        profile_path(f"BALANCED {name}", runs[name], args.calls)


if __name__ == "__main__":
    main()
