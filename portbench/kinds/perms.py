"""The permutation sweep (``bulkscan_perms``): each trait's largest LOD
over markers under the identity and every shuffle, the shuffle indices
drawn for each call and passed as ``perm_idx``. Compared: ``maxlod_gap``,
the largest |max LOD - reference| over the compared traits and shuffle
columns, each trait at the h2 that :func:`judge.scored_h2` allows."""

import torch

from portbench.core import judge

NUMBERS = ("maxlod_gap",)
SHUFFLES = True


def lods(shape: dict) -> float:
    """LODs a call: traits x markers x (shuffles + the identity)."""
    return shape["m"] * shape["p"] * shape["columns"]


def call_kwargs(data, call: int) -> dict:
    return {"perm_idx": data.shuffles(call)}


def outputs(res) -> list:
    """Every output tensor of a call, for its checksum."""
    return [res.maxlods, res.h2_null_list]


def keep(res, cols, columns) -> dict:
    rows = res.maxlods.index_select(0, cols.to(res.maxlods.device))
    return {"h2": res.h2_null_list.clone(),
            "maxlods": rows.index_select(1, columns.to(rows.device))}


def compare(ref, Y0, k, shuffles, worst) -> None:
    cols = k.cols.to(Y0.device)
    idx = shuffles(k.call).index_select(0, k.columns.to(Y0.device))
    h2 = judge.scored_h2(ref, Y0, k.out["h2"])[cols]
    ref_max = ref.perm_maxlods(Y0[:, cols], h2, idx)
    out = k.out["maxlods"].to(ref_max.device, ref_max.dtype)
    worst("maxlod_gap", judge.widest((out - ref_max).abs()))


def control(ctrl, Y0, cols, columns, idx) -> dict:
    _, h2, _ = ctrl.grid_fit(Y0)
    dev_cols = cols.to(Y0.device)
    return {"h2": h2, "maxlods": ctrl.perm_maxlods(
        Y0[:, dev_cols], h2[dev_cols], idx.index_select(0, columns.to(idx.device)))}
