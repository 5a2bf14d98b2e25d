"""Build the package's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together, and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <obj> csrc/<name>.cu    (each)
    nvcc -shared -o <lib> <obj>...

The library lands in ``build/bulklmm_tpu_torch_kernels/`` beside the
package, named by a hash of the sources and flags, so an edited source is
rebuilt and an unchanged one is loaded as it is. ``build.log`` there keeps
the command and the compiler's report (registers, spills). No
``--use_fast_math``: it would swap ``log10f`` for a low-accuracy intrinsic
and flush subnormals. Nothing here is imported or built until a kernel is
launched on a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bulklmm_tpu_torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: one build at a time in a process: the tiles of a mesh launch their first
#: kernels from one host thread a device, all at once
_BUILD_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = Path(home) / "bin" / "nvcc"
    if nvcc.is_file():
        return str(nvcc)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit (set CUDA_HOME)"
        )
    return found


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    """Hash of the kernel sources, headers and compiler flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libbulklmm_tpu_torch_{source_hash()}.so"


def _build(lib: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    stem = f"{lib.stem}.{os.getpid()}.{threading.get_ident()}"
    tmp = lib.with_name(f"{stem}.tmp.so")
    objs = {src: lib.with_name(f"{stem}.{src.stem}.o") for src in _sources()[0]}
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in objs.items()]
    procs = [
        subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cmd in cmds
    ]
    outputs = [proc.communicate()[0] for proc in procs]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())]
    failed = [(cmd, out) for cmd, proc, out in zip(cmds, procs, outputs) if proc.returncode]
    try:
        if not failed:
            r = subprocess.run(link, capture_output=True, text=True)
            cmds.append(link)
            outputs.append(r.stdout + r.stderr)
            if r.returncode:
                failed.append((link, outputs[-1]))
        (BUILD_DIR / "build.log").write_text(
            "".join(" ".join(cmd) + "\n" + out for cmd, out in zip(cmds, outputs))
        )
        if failed:
            cmd, out = failed[0]
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{out[-4000:]}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees the whole library or none
    finally:
        for leftover in (tmp, *objs.values()):
            leftover.unlink(missing_ok=True)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if its sources changed.
    Threads that ask at once wait for one build (``_BUILD_LOCK``); other
    processes build to names of their own and rename atomically."""
    with _BUILD_LOCK:
        lib = library_path()
        if not lib.exists():
            _build(lib)
    return ctypes.CDLL(str(lib))
