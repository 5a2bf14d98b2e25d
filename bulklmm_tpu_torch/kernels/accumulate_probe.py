"""The accumulate probe: how the card's tensor cores finish a float32 sum.

Not a port of a TPU kernel and on no scan's path. ``csrc/accumulate_probe.cu``
takes one ``mma.sync`` m16n8k8 and one ``wgmma`` m64n64k8 TF32 product
(float32 accumulators, the two forms the 3 x TF32 kernels use), and their
bf16 forms ``mma.sync`` m16n8k16 and ``wgmma`` m64n64k16 (depth 16, the
bf16x3 kernels' under THROUGHPUT), on operands crafted here; :func:`fit`
then names every parameter set of ``split.py::tensor_core_sum`` that gives
the card's results bit for bit. ``chip_smoke.py`` runs it before the scans
and prints what it found.

The operands: B is all ones, so that output (i, j) is ``C[i, j] +
sum_k A[i, k]``: a row of A is one pattern of 8 (16) products, a column of
C one accumulator. The documented cases (:func:`documented_cases`) are
accumulators 1.0, 1.5 and their negatives with products at known fractions
of 1.0's last place (2^-23) and below it; :func:`random_cases` adds seeded
tiles of random TF32 (bf16) products of many sizes and signs against random
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
SHAPES = {"mma": (16, 8), "wgmma": (64, 64), "mma_bf16": (16, 8), "wgmma_bf16": (64, 64)}
DEPTH = 8  # depth of the TF32 forms
BF16_DEPTH = 16  # depth of the bf16 forms
#: the forms' depth, and the C entry that runs each
DEPTHS = {"mma": DEPTH, "wgmma": DEPTH, "mma_bf16": BF16_DEPTH, "wgmma_bf16": BF16_DEPTH}
ENTRIES = {"mma": "bulklmm_probe_mma", "wgmma": "bulklmm_probe_wgmma",
           "mma_bf16": "bulklmm_probe_mma_bf16", "wgmma_bf16": "bulklmm_probe_wgmma_bf16"}
ULP = 2.0**-23  # float32's last place at 1.0
#: accumulators of the documented cases
ACCUMULATORS = (1.0, -1.0, 1.5, -1.5)
#: random tiles a form: about 32,000 outputs each
RANDOM_TILES = {"mma": 256, "wgmma": 8, "mma_bf16": 256, "wgmma_bf16": 8}


def _product_patterns(depth: int = DEPTH):
    """(name, ``depth`` products) of the documented cases, in units of ULP:
    the depth-8 patterns (padded with zeros at depth 16), and at depth 16
    patterns over its two halves of 8."""
    pats = []
    for f in (0.25, 0.5, 0.75, 1.25, 1.5):
        for sign in (1, -1):
            pats.append((f"one product {sign * f:+g} ulp", [sign * f] + [0.0] * 7))
    for j in range(1, 7):
        pats.append((f"eight products 2^-{j} ulp", [2.0**-j] * 8))
    pats.append(("four products 1/4 ulp, first half", [0.25] * 4 + [0.0] * 4))
    pats.append(("two 1/4 ulp in each half", [0.25, 0.25, 0, 0, 0.25, 0.25, 0, 0]))
    if depth == DEPTH:
        return pats
    pats = [(name, p + [0.0] * 8) for name, p in pats]
    for j in range(1, 7):
        pats.append((f"sixteen products 2^-{j} ulp", [2.0**-j] * 16))
    pats.append(("four products 1/4 ulp, second eight", [0.0] * 8 + [0.25] * 4 + [0.0] * 4))
    pats.append(("one 1/4 ulp in each quarter", ([0.25] + [0.0] * 3) * 4))
    pats.append(("one product -1/4 ulp, then 3/4 ulp in the second eight",
                 [-0.25] + [0.0] * 7 + [0.75] + [0.0] * 7))
    return pats


def documented_cases(depth: int = DEPTH):
    """(names, acc (rows, columns), products (rows, depth)) in float64: row r
    pairs pattern r with every accumulator."""
    pats = _product_patterns(depth)
    names = [name for name, _ in pats]
    prods = np.array([p for _, p in pats], dtype=np.float64) * ULP
    acc = np.broadcast_to(np.array(ACCUMULATORS), (len(pats), len(ACCUMULATORS)))
    return names, np.ascontiguousarray(acc), prods


def _cut(x, low_bits: int):
    """float32 values with their ``low_bits`` low bits zero: cut to TF32's
    10 mantissa bits (13) or bf16's 7 (16), exact operands of either form."""
    bits = np.asarray(x, dtype=np.float32).view(np.int32) & np.int32(-(1 << low_bits))
    return bits.view(np.float32)


def random_cases(tiles: int, form: str, seed: int = 0):
    """(A, C) of ``tiles`` random tiles: products of many sizes and both
    signs, accumulators from 0 to a few times their sum, some near
    cancellation. B is all ones."""
    rows, cols = SHAPES[form]
    depth = DEPTHS[form]
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(tiles, rows, depth)) * np.exp2(rng.integers(-30, 1, (tiles, rows, depth)))
    A = _cut(A, 13 if depth == DEPTH else 16)
    sums = A.astype(np.float64).sum(-1, keepdims=True)
    scale = np.exp2(rng.integers(-4, 12, (tiles, rows, cols)))
    C = rng.normal(size=(tiles, rows, cols)) * np.abs(sums) * scale
    C[:, :, 0] = -sums[..., 0] * (1 + rng.normal(size=(tiles, rows)) * 2.0**-20)  # cancellation
    C[:, :, 1] = 0.0
    return A, C.astype(np.float32)


def _tiles_of(acc, prods, form):
    """A, C tiles (float32) holding the documented cases, padded with zeros."""
    rows, cols = SHAPES[form]
    depth = DEPTHS[form]
    n_r, n_c = acc.shape
    tiles = -(-n_r // rows)
    A = np.zeros((tiles * rows, depth), np.float32)
    C = np.zeros((tiles * rows, cols), np.float32)
    A[:n_r] = prods
    for j in range(cols):
        C[:n_r, j] = acc[:, j % n_c]
    return A.reshape(tiles, rows, depth), C.reshape(tiles, rows, cols)


@functools.lru_cache(maxsize=None)
def _library():
    from .build import load_library

    lib = load_library()
    for name in ENTRIES.values():
        fn = getattr(lib, name)
        fn.argtypes = [*[ctypes.c_void_p] * 4, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.bulklmm_cuda_error_string.argtypes = [ctypes.c_int]
    lib.bulklmm_cuda_error_string.restype = ctypes.c_char_p
    return lib


def probe_cuda(A, C, form: str, device="cuda"):
    """D = C + A B (B all ones) on the card by ``form``'s product: A (tiles,
    rows, depth) and C (tiles, rows, columns) float32 numpy arrays, A's
    values TF32 (bf16 for the bf16 forms). Returns D as a float32 numpy
    array."""
    rows, cols = SHAPES[form]
    depth = DEPTHS[form]
    At = torch.as_tensor(np.ascontiguousarray(A, np.float32), device=device)
    Ct = torch.as_tensor(np.ascontiguousarray(C, np.float32), device=device)
    tiles = At.shape[0]
    if At.shape != (tiles, rows, depth) or Ct.shape != (tiles, rows, cols):
        raise ValueError(f"probe_cuda: A {tuple(At.shape)}, C {tuple(Ct.shape)} for {form}")
    Bt = torch.ones((tiles, depth, cols), dtype=torch.float32, device=device)
    D = torch.empty_like(Ct)
    lib = _library()
    fn = getattr(lib, ENTRIES[form])
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
    A = np.asarray(A, np.float64)
    prods = torch.as_tensor(A)[..., None, :].expand(*acc.shape, A.shape[-1])
    return tensor_core_sum(acc, prods, **model).numpy()


#: the candidate models :func:`fit` tries at depth 8; at depth 16 also
#: groups of 16 (:func:`candidates`)
CANDIDATES = [dict(extra=e, addend=a, finish=f, group=g) for e, a, f, g in
              itertools.product(range(25), ("rz", "rd"), ("rz", "rn"), (8, 4, 2, 1))]


def candidates(depth: int = DEPTH):
    """The candidate models for products of ``depth``: groups of up to the
    depth."""
    if depth == DEPTH:
        return CANDIDATES
    return [dict(extra=e, addend=a, finish=f, group=g) for e, a, f, g in
            itertools.product(range(25), ("rz", "rd"), ("rz", "rn"), (16, 8, 4, 2, 1))]


def fit(A, C, D):
    """The candidates (:func:`candidates` of A's depth) that give D bit for
    bit."""
    want = np.asarray(D, np.float32).view(np.int32)
    return [m for m in candidates(np.shape(A)[-1])
            if np.array_equal(model_sum(A, C, **m).view(np.int32), want)]


def run(form: str, device="cuda", seed: int = 0):
    """The probe of one form on the card: the documented cases' results and
    the models that give every result of them and of the random tiles.
    Returns ``{"documented": [(pattern, accumulator, exact sum in ulps of
    the accumulator, card's result)], "models": [...]}``."""
    names, acc, prods = documented_cases(DEPTHS[form])
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
