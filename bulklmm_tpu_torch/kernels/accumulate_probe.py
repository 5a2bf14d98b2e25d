"""The accumulate probe: how the card's tensor cores finish a float32 sum.

Not a port of a TPU kernel and on no scan's path. ``csrc/accumulate_probe.cu``
takes one ``mma.sync`` m16n8k8 and one ``wgmma`` m64n64k8 TF32 product
(float32 accumulators, the two forms the kernels use) on operands crafted
here; :func:`fit` then names every parameter set of
``split.py::tensor_core_sum`` that gives the card's results bit for bit.
``chip_smoke.py`` runs it before the scans and prints what it found.

The operands: B is all ones, so that output (i, j) is ``C[i, j] +
sum_k A[i, k]``: a row of A is one pattern of 8 products, a column of C one
accumulator. The documented cases (:func:`documented_cases`) are
accumulators 1.0, 1.5 and their negatives with products at known fractions
of 1.0's last place (2^-23) and below it; :func:`random_cases` adds seeded
tiles of random TF32 products of many sizes and signs against random
accumulators, which tell the candidate models apart.
"""

from __future__ import annotations

import ctypes
import functools
import itertools

import numpy as np
import torch

from .split import tensor_core_sum

#: the forms: rows and columns of one tile
SHAPES = {"mma": (16, 8), "wgmma": (64, 64)}
DEPTH = 8
ULP = 2.0**-23  # float32's last place at 1.0
#: accumulators of the documented cases
ACCUMULATORS = (1.0, -1.0, 1.5, -1.5)
#: random tiles a form: about 32,000 outputs each
RANDOM_TILES = {"mma": 256, "wgmma": 8}


def _product_patterns():
    """(name, 8 products) of the documented cases, in units of ULP."""
    pats = []
    for f in (0.25, 0.5, 0.75, 1.25, 1.5):
        for sign in (1, -1):
            pats.append((f"one product {sign * f:+g} ulp", [sign * f] + [0.0] * 7))
    for j in range(1, 7):
        pats.append((f"eight products 2^-{j} ulp", [2.0**-j] * 8))
    pats.append(("four products 1/4 ulp, first half", [0.25] * 4 + [0.0] * 4))
    pats.append(("two 1/4 ulp in each half", [0.25, 0.25, 0, 0, 0.25, 0.25, 0, 0]))
    return pats


def documented_cases():
    """(names, acc (rows, columns), products (rows, 8)) in float64: row r
    pairs pattern r with every accumulator."""
    pats = _product_patterns()
    names = [name for name, _ in pats]
    prods = np.array([p for _, p in pats], dtype=np.float64) * ULP
    acc = np.broadcast_to(np.array(ACCUMULATORS), (len(pats), len(ACCUMULATORS)))
    return names, np.ascontiguousarray(acc), prods


def _tf32(x):
    """float32 values cut to TF32's 10 mantissa bits (exact operands)."""
    bits = np.asarray(x, dtype=np.float32).view(np.int32) & np.int32(-(1 << 13))
    return bits.view(np.float32)


def random_cases(tiles: int, form: str, seed: int = 0):
    """(A, C) of ``tiles`` random tiles: products of many sizes and both
    signs, accumulators from 0 to a few times their sum, some near
    cancellation. B is all ones."""
    rows, cols = SHAPES[form]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(tiles, rows, DEPTH)) * np.exp2(rng.integers(-30, 1, (tiles, rows, DEPTH)))
    A = _tf32(A)
    sums = A.astype(np.float64).sum(-1, keepdims=True)
    scale = np.exp2(rng.integers(-4, 12, (tiles, rows, cols)))
    C = rng.normal(size=(tiles, rows, cols)) * np.abs(sums) * scale
    C[:, :, 0] = -sums[..., 0] * (1 + rng.normal(size=(tiles, rows)) * 2.0**-20)  # cancellation
    C[:, :, 1] = 0.0
    return A, C.astype(np.float32)


def _tiles_of(acc, prods, form):
    """A, C tiles (float32) holding the documented cases, padded with zeros."""
    rows, cols = SHAPES[form]
    n_r, n_c = acc.shape
    tiles = -(-n_r // rows)
    A = np.zeros((tiles * rows, DEPTH), np.float32)
    C = np.zeros((tiles * rows, cols), np.float32)
    A[:n_r] = prods
    for j in range(cols):
        C[:n_r, j] = acc[:, j % n_c]
    return A.reshape(tiles, rows, DEPTH), C.reshape(tiles, rows, cols)


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    for name in ("bulklmm_probe_mma", "bulklmm_probe_wgmma"):
        fn = getattr(lib, name)
        fn.argtypes = [*[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def probe_cuda(A, C, form: str, device="cuda"):
    """D = C + A B (B all ones) on the card by ``form``'s product: A (tiles,
    rows, 8) and C (tiles, rows, columns) float32 numpy arrays, A's values
    TF32. Returns D as a float32 numpy array."""
    rows, cols = SHAPES[form]
    At = torch.as_tensor(np.ascontiguousarray(A, np.float32), device=device)
    Ct = torch.as_tensor(np.ascontiguousarray(C, np.float32), device=device)
    tiles = At.shape[0]
    if At.shape != (tiles, rows, DEPTH) or Ct.shape != (tiles, rows, cols):
        raise ValueError(f"probe_cuda: A {tuple(At.shape)}, C {tuple(Ct.shape)} for {form}")
    Bt = torch.ones((tiles, DEPTH, cols), dtype=torch.float32, device=device)
    D = torch.empty_like(Ct)
    lib = _library()
    fn = lib.bulklmm_probe_mma if form == "mma" else lib.bulklmm_probe_wgmma
    with torch.cuda.device(At.device):
        rc = fn(At.data_ptr(), Bt.data_ptr(), Ct.data_ptr(), D.data_ptr(), tiles,
                torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError("probe launch failed: " + lib.bulklmm_cuda_error_string(rc).decode())
    return D.cpu().numpy()


def model_sum(A, C, **model):
    """What ``tensor_core_sum`` with ``model`` gives for the tiles (B all
    ones): float32, C's shape."""
    acc = torch.as_tensor(np.asarray(C, np.float32))
    prods = torch.as_tensor(np.asarray(A, np.float64))[..., None, :].expand(*acc.shape, DEPTH)
    return tensor_core_sum(acc, prods, **model).numpy()


#: the candidate models :func:`fit` tries
CANDIDATES = [dict(extra=e, addend=a, finish=f, group=g) for e, a, f, g in
              itertools.product(range(25), ("rz", "rd"), ("rz", "rn"), (8, 4, 2, 1))]


def fit(A, C, D):
    """The candidates of :data:`CANDIDATES` that give D bit for bit."""
    want = np.asarray(D, np.float32).view(np.int32)
    return [m for m in CANDIDATES if np.array_equal(model_sum(A, C, **m).view(np.int32), want)]


def run(form: str, device="cuda", seed: int = 0):
    """The probe of one form on the card: the documented cases' results and
    the models that give every result of them and of the random tiles.
    Returns ``{"documented": [(pattern, accumulator, exact sum in ulps of
    the accumulator, card's result)], "models": [...]}``."""
    names, acc, prods = documented_cases()
    A1, C1 = _tiles_of(acc, prods, form)
    A2, C2 = random_cases(RANDOM_TILES[form], form, seed)
    A = np.concatenate([A1, A2])
    C = np.concatenate([C1, C2])
    D = probe_cuda(A, C, form, device)
    n_r, n_c = acc.shape
    D1 = D[: len(A1)].reshape(-1, D.shape[-1])[:n_r, :n_c]
    documented = []
    for r, name in enumerate(names):
        for j in range(n_c):
            a = float(acc[r, j])
            documented.append((name, a, float(prods[r].sum()) / ULP, float(D1[r, j])))
    return {"documented": documented, "models": fit(A, C, D)}
