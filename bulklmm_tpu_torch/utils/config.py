"""Precision / numerics configuration for the PyTorch port.

Counterpart of ``bulklmm_tpu/utils/config.py``: the same two knobs and the
same five presets, with torch dtypes in place of jnp dtypes.

- ``solve_dtype``: weights, likelihoods, the h2 grid and the rotation.
- ``gemm_dtype`` + ``gemm_precision``: the big trait x marker correlation
  products. ``gemm_precision`` is a name, "highest" or "high" (any other
  raises). The CUDA kernels take float32 products as three TF32 passes under
  "highest"; under "high" (THROUGHPUT, the JAX package's HIGH) the alt-grid
  kernel, both paths of the permutation kernel and the resident LOD kernel
  take them as three bf16 passes (bf16x3: ``kernels/split.py``), the LOD
  step's general and wide kernels keep three TF32 passes, and the plain
  torch products stay full float32. On the CPU the alt-grid and permutation
  kernels' plain versions follow "high" with bf16x3 products, as the JAX
  package's Pallas kernels do in interpret mode; the LOD step keeps float32
  products there, as XLA's HIGH does on a CPU.
- ``kernel_dtype``: the (p x m)-scale combines of the correlation step.

``None`` dtypes resolve through :func:`default_float`, which follows
``torch.get_default_dtype()``; :func:`enable_x64` raises it to float64 (the
counterpart of ``jax_enable_x64``).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import torch


@contextlib.contextmanager
def with_highest_matmul():
    """Full-float32 matrix products for the duration of the block.

    Turns TF32 off for cuBLAS and cuDNN and sets the float32 matmul
    precision to "highest", then restores all three on exit. cuDNN's TF32
    is on by default in PyTorch; the statistics here lose ~3 decimal digits
    under it. Usable as a decorator too. Never changes the process-wide
    settings outside the block.
    """
    saved = (
        torch.backends.cuda.matmul.allow_tf32,
        torch.backends.cudnn.allow_tf32,
        torch.get_float32_matmul_precision(),
    )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def default_float() -> torch.dtype:
    """``torch.get_default_dtype()``: float32 unless the caller raised it."""
    return torch.get_default_dtype()


def enable_x64() -> None:
    """Make float64 torch's default float dtype, so that presets without an
    explicit dtype (``DEFAULT_PRECISION``) resolve to it; call before
    creating tensors."""
    torch.set_default_dtype(torch.float64)


#: the names ``gemm_precision`` takes: three TF32 passes and three bf16 passes
#: in the CUDA kernels' products
GEMM_PRECISIONS = ("highest", "high")


def check_gemm_precision(name: str) -> str:
    """``name`` if it is one of :data:`GEMM_PRECISIONS`, else a ValueError."""
    if name not in GEMM_PRECISIONS:
        raise ValueError(f"unknown GEMM precision {name!r}; choose one of {GEMM_PRECISIONS}")
    return name


@dataclasses.dataclass(frozen=True)
class PrecisionConfig:
    """Numerics knobs for the scan engines (see the module docstring)."""

    solve_dtype: Optional[torch.dtype] = None
    gemm_dtype: Optional[torch.dtype] = None
    gemm_precision: str = "highest"
    kernel_dtype: Optional[torch.dtype] = None

    def __post_init__(self):
        check_gemm_precision(self.gemm_precision)

    def resolve_solve(self) -> torch.dtype:
        return self.solve_dtype if self.solve_dtype is not None else default_float()

    def resolve_gemm(self) -> torch.dtype:
        return self.gemm_dtype if self.gemm_dtype is not None else self.resolve_solve()

    def resolve_kernel(self) -> torch.dtype:
        return self.kernel_dtype if self.kernel_dtype is not None else self.resolve_solve()


DEFAULT_PRECISION = PrecisionConfig()

# FAST32: everything float32.
FAST32 = PrecisionConfig(solve_dtype=torch.float32, gemm_dtype=torch.float32)
# MIXED: float64 likelihood and combines, float32 correlation products.
MIXED = PrecisionConfig(solve_dtype=torch.float64, gemm_dtype=torch.float32)
# EXACT64: float64 end to end; the oracle the others are held against.
EXACT64 = PrecisionConfig(solve_dtype=torch.float64, gemm_dtype=torch.float64)
# BALANCED: float64 rotation, float32 grid likelihoods (the kernel dtype),
# float32 correlation products and combines.
BALANCED = PrecisionConfig(
    solve_dtype=torch.float64, gemm_dtype=torch.float32, kernel_dtype=torch.float32
)
# THROUGHPUT: FAST32 with "high" products: the kernels' bf16x3 on the card.
THROUGHPUT = PrecisionConfig(
    solve_dtype=torch.float32, gemm_dtype=torch.float32, gemm_precision="high"
)

_PRESETS = {
    "FAST32": FAST32,
    "MIXED": MIXED,
    "EXACT64": EXACT64,
    "BALANCED": BALANCED,
    "THROUGHPUT": THROUGHPUT,
}


def precision_by_name(name: str) -> PrecisionConfig:
    """The preset called ``name`` (case-insensitive), e.g. ``"BALANCED"``."""
    try:
        return _PRESETS[name.upper()]
    except KeyError:
        raise ValueError(
            f"unknown precision preset {name!r}; choose one of {sorted(_PRESETS)}"
        ) from None
