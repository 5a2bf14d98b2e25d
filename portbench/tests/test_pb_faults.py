"""A whole run of each cell at a tiny size on the CPU, the look for a card
skipped: ``correct`` holds for the program as it is, and comes out false
with the timed path broken underneath, once for each fault a cell can
have: an answer altered where it is produced, a call that hands back an
earlier call's outputs (its state unchanged), and half of the traits left
out (the rest's answers in their place); and for the null methods every
trait's h2 taken from the wrong end of the grid."""

from __future__ import annotations

import importlib
import time

import pytest
import torch

import bulklmm_tpu_torch as bt
from portbench.core import cell
from portbench.tests.conftest import WORKLOADS, tiny

# the package's names ``bulkscan`` shadow the module of the same name
bulkscan_mod = importlib.import_module("bulklmm_tpu_torch.models.bulkscan")
bulkperm_mod = importlib.import_module("bulklmm_tpu_torch.models.bulkperm")


def _run(name):
    line = cell.run(tiny(name), 2**31 + 99, 0.6, False, "cpu", time.time())
    assert line["attempted"] >= 3 and line["failed"] == 0
    return line


@pytest.mark.parametrize("workload", WORKLOADS)
def test_sound_program_is_correct(workload):
    line = _run(workload)
    assert line["correct"], line["checks"]


def _alter_where_produced(monkeypatch, kind):
    """Every output of the kernel's step moved by 0.01 LOD."""
    def moved(real):
        def step(*a, **k):
            out = real(*a, **k)
            return (out[0] + 0.01,) + tuple(out[1:])
        return step

    if kind == "scan":
        monkeypatch.setattr(bulkscan_mod, "_lod_outputs", moved(bulkscan_mod._lod_outputs))
    elif kind == "altgrid":  # the kernel on a card, the plain formulation here
        monkeypatch.setattr(bulkscan_mod, "fused_alt_grid", moved(bulkscan_mod.fused_alt_grid))
        monkeypatch.setattr(bulkscan_mod, "_alt_grid_impl", moved(bulkscan_mod._alt_grid_impl))
    else:
        real = bulkperm_mod._trait_block_lods
        monkeypatch.setattr(bulkperm_mod, "_trait_block_lods", lambda *a, **k: real(*a, **k) + 0.01)


def _stale(monkeypatch, entry):
    """Every call hands back the first call's outputs."""
    real, first = getattr(bt, entry), []

    def stale(*a, **k):
        if not first:
            first.append(real(*a, **k))
        return first[0]

    monkeypatch.setattr(bt, entry, stale)


def _half(monkeypatch, entry):
    """Only the first half of the traits computed; their answers fill the
    other half."""
    real = getattr(bt, entry)

    def half(Y, *a, **k):
        m = Y.shape[1]
        h = (m + 1) // 2
        res = real(Y[:, :h], *a, **k)
        fill = torch.arange(m) % h
        for f in ("L", "h2_panel"):
            t = getattr(res, f, None)
            if torch.is_tensor(t):
                setattr(res, f, t[:, fill.to(t.device)])
        for f in ("maxlods", "h2_null_list"):
            t = getattr(res, f, None)
            if torch.is_tensor(t):
                setattr(res, f, t[fill.to(t.device)])
        return res

    monkeypatch.setattr(bt, entry, half)


def _wrong_h2(monkeypatch):
    """The null grid's likelihoods replaced by ones that rise along the
    grid, so every trait takes its largest h2."""
    def rising(Y0, C0, lam, h2_grid, prior, *, reml=False):
        g, m = h2_grid.shape[0], Y0.shape[1]
        return torch.arange(g, dtype=Y0.dtype, device=Y0.device)[:, None].expand(g, m)

    monkeypatch.setattr(bulkscan_mod, "grid_null_ell", rising)
    monkeypatch.setattr(bulkperm_mod, "grid_null_ell", rising)


@pytest.mark.parametrize("workload", [w for w in WORKLOADS if tiny(w).traffic["kind"] != "altgrid"])
def test_wrong_h2_is_not_correct(monkeypatch, workload):
    _wrong_h2(monkeypatch)
    line = _run(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("fault", ["altered", "stale", "half"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_broken_program_is_not_correct(monkeypatch, workload, fault):
    c = tiny(workload)
    if fault == "altered":
        _alter_where_produced(monkeypatch, c.traffic["kind"])
    elif fault == "stale":
        _stale(monkeypatch, c.traffic["entry"])
    else:
        _half(monkeypatch, c.traffic["entry"])
    line = _run(workload)
    assert not line["correct"], line["checks"]
    assert any(v["value"] > v["limit"] for v in line["checks"].values())
