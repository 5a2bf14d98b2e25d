"""Whether the timed path's outputs are right: each compared call's outputs
against the float64 reference (``reference/lmm.py``), run once the window
has closed.

What a call's outputs are, which of them a run keeps, and how they are
compared belongs to the cell's kind of call, ``kinds/<kind>.py`` (the
traffic mix names it): a module with ``NUMBERS`` (the numbers it compares,
each the widest over the compared calls), ``SHUFFLES`` (whether its calls
take shuffle indices), ``lods(shape)`` (LODs a call, for the rates),
``call_kwargs(data, call)``, ``outputs(res)``,
``keep(res, cols, columns)``, ``compare(ref, Y0, kept, shuffles, worst)``
and ``control(ctrl, Y0, cols, columns, idx)``. A compared call is kept as
a :class:`Kept`: its index, the trait columns compared, and the outputs
restricted to them.

The h2 that the program fitted are judged inside those numbers. The
reference scores a trait at the program's h2 where that grid point's null
log-likelihood ties the largest, within :data:`H2_TIE` times the number of
samples, and at its own best grid point otherwise, where the program's
LODs, computed at another h2, then miss. A value that is not finite reads as infinite, and
fails.
"""

from __future__ import annotations

import dataclasses
import math

import torch

#: the size of a tie of two null log-likelihoods, per sample: BALANCED
#: computes the grid likelihoods in float32, so grid points whose likelihoods
#: lie this close may come out in either order. The rounding grows with the
#: number of samples n (n log(rss / n) and a sum of n log-weights), not with
#: the likelihood's value, which lies near 0 for some traits: at 5,000
#: samples the program's choices fell short by up to 2.4e-7 n (1.2e-3), which
#: is 1.08e-6 of a likelihood of -1,112
H2_TIE = 1e-6


@dataclasses.dataclass
class Kept:
    call: int
    cols: torch.Tensor  # trait columns of the call's panel that are compared
    out: dict  # the kind's ``keep``: "h2" (m,), "L", "panel" (p, cols), "maxlods" (cols, columns)
    columns: torch.Tensor | None = None  # shuffle columns compared (a kind with SHUFFLES)


def keep(kind, res, call: int, cols: torch.Tensor, columns=None) -> Kept:
    """The outputs of one call that the comparison reads, copied out of the
    result by the kind's ``keep``."""
    return Kept(call=call, cols=cols, out=kind.keep(res, cols, columns), columns=columns)


def trait_columns(t: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The columns ``cols`` of a (p, m) output: a small copy on its device,
    or the output itself where ``cols`` is every trait."""
    return t if cols.numel() == t.shape[1] else t.index_select(1, cols.to(t.device))


def widest(t: torch.Tensor) -> float:
    if t.numel() == 0:
        return 0.0
    v = float(t.max())
    return v if math.isfinite(v) and bool(torch.isfinite(t).all()) else math.inf


def grid_index(ref, h2: torch.Tensor) -> torch.Tensor:
    """The grid index of each h2 value (the nearest grid point)."""
    grid = ref.grid.to(h2.device, torch.float64)
    return torch.argmin((h2.to(torch.float64)[..., None] - grid).abs(), dim=-1)


def ties(best: torch.Tensor, at: torch.Tensor, n: int) -> torch.Tensor:
    """Where a log-likelihood ``at`` of ``n`` samples ties the largest,
    ``best``."""
    return best - at <= H2_TIE * n


def scored_h2(ref, Y0, h2_out) -> torch.Tensor:
    """Each trait's h2 at which the reference scores it: the program's where
    it ties the best grid point, else the reference's own."""
    _, h2_ref, ells = ref.grid_fit(Y0)
    k = grid_index(ref, h2_out.to(ells.device))
    ok = ties(ells.max(0).values, ells.gather(0, k[None])[0], ref.n)
    return torch.where(ok, ref.grid[k], h2_ref)


def judge(kind, ref, kept: list, panels: list, shuffles=None) -> dict:
    """``{number: value}`` for the calls ``kept``; ``panels[i % len]`` is
    call i's (n, traits) trait panel, ``shuffles(i)`` its (K, n) shuffle
    indices."""
    values = {name: 0.0 for name in kind.NUMBERS}

    def worst(name, v):
        values[name] = max(values[name], v)

    for k in kept:
        kind.compare(ref, ref.rotate(panels[k.call % len(panels)]), k, shuffles, worst)
    return values


def control_outputs(kind, ctrl, panel, cols, columns=None, idx=None) -> dict:
    """What the control (the reference one precision lower, in the
    program's place) gives for one call: the outputs the kind's ``keep``
    takes."""
    return kind.control(ctrl, ctrl.rotate(panel), cols, columns, idx)


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, checks)``: every number at or under its limit, and the
    numbers with their limits for the result's line."""
    checks = {name: {"value": values[name], "limit": limits[name]} for name in values}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
