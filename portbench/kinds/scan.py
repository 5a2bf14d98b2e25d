"""The null-grid scan (``bulkscan``): every trait's h2 from the null grid,
every marker scored at it. Compared: ``lod_gap``, the largest |L - L_ref|
over the compared (marker, trait) pairs, each trait scored by the
reference at the h2 that :func:`portbench.core.judge.scored_h2` allows."""

import torch

from portbench.core import judge

NUMBERS = ("lod_gap",)
SHUFFLES = False


def lods(shape: dict) -> float:
    """LODs a call: traits x markers."""
    return shape["m"] * shape["p"]


def call_kwargs(data, call: int) -> dict:
    return {}


def outputs(res) -> list:
    """Every output tensor of a call, for its checksum."""
    return [t for t in (res.L, res.h2_null_list, res.h2_panel) if torch.is_tensor(t)]


def keep(res, cols, columns) -> dict:
    return {"h2": res.h2_null_list.clone(), "L": judge.trait_columns(res.L, cols)}


def compare(ref, Y0, k, shuffles, worst) -> None:
    cols = k.cols.to(Y0.device)
    h2 = judge.scored_h2(ref, Y0, k.out["h2"])[cols]
    for local, L_ref in ref.lods(Y0[:, cols], h2):
        L_out = k.out["L"][:, local.to(k.out["L"].device)].to(L_ref.device, L_ref.dtype)
        worst("lod_gap", judge.widest((L_out - L_ref).abs()))


def control(ctrl, Y0, cols, columns, idx) -> dict:
    dev_cols = cols.to(Y0.device)
    _, h2, _ = ctrl.grid_fit(Y0)
    L = torch.empty((ctrl.X0.shape[1], cols.numel()), dtype=ctrl.dtype, device=Y0.device)
    for local, block in ctrl.lods(Y0[:, dev_cols], h2[dev_cols]):
        L[:, local] = block
    return {"h2": h2, "L": L}
