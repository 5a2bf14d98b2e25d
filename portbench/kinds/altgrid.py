"""The alt-grid scan (``bulkscan(method="alt-grid")``): each (marker,
trait) pair's h2 from the grid. Compared: ``lod_gap``, the largest
|L - L_ref| over the compared pairs. L does not depend on the grid point
reported; where the program's grid point lies farther below the largest
alternative log-likelihood than a tie (:data:`judge.H2_TIE`), the pair
reads that shortfall in LOD units if it is the larger."""

import math

import torch

from portbench.core import judge

NUMBERS = ("lod_gap",)
SHUFFLES = False
_BLOCK = 4096  # traits compared at a time


def lods(shape: dict) -> float:
    """LODs a call: traits x markers."""
    return shape["m"] * shape["p"]


def call_kwargs(data, call: int) -> dict:
    return {}


def outputs(res) -> list:
    """Every output tensor of a call, for its checksum."""
    return [t for t in (res.L, res.h2_null_list, res.h2_panel) if torch.is_tensor(t)]


def keep(res, cols, columns) -> dict:
    return {"L": judge.trait_columns(res.L, cols), "panel": judge.trait_columns(res.h2_panel, cols)}


def compare(ref, Y0, k, shuffles, worst) -> None:
    cols = k.cols.to(Y0.device)
    for b in range(0, cols.numel(), _BLOCK):
        k_out = judge.grid_index(ref, k.out["panel"][:, b : b + _BLOCK].to(Y0.device))
        L_ref, _, best, short = ref.alt_grid(Y0[:, cols[b : b + _BLOCK]], k_out)
        gap = (k.out["L"][:, b : b + _BLOCK].to(L_ref.device, L_ref.dtype) - L_ref).abs()
        gap = torch.where(judge.ties(best, best - short, ref.n), gap,
                          torch.maximum(gap, short / math.log(10.0)))
        worst("lod_gap", judge.widest(gap))
        del L_ref, best, short, gap, k_out


def control(ctrl, Y0, cols, columns, idx) -> dict:
    L, kbest, _, _ = ctrl.alt_grid(Y0[:, cols.to(Y0.device)])
    return {"L": L, "panel": ctrl.grid[kbest]}
