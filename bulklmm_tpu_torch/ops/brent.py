"""Branch-free Brent minimization, batched over lanes.

Counterpart of ``bulklmm_tpu/ops/brent.py`` (Optim.jl's Brent and the
reference's ``gridbrent``, src/gridbrent.jl:9-24). Every lane of a batch
tensor is one bounded 1-D minimization; each Brent iteration is one set of
masked tensor updates over the whole batch, so thousands of traits step
together. Lanes that have converged freeze; the Python loop stops when
every lane has converged or after ``maxiter`` iterations, which gives what
the JAX package's per-lane ``while_loop`` gives.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch

from ..utils.config import default_float

_CGOLD = 0.3819660112501051  # 2 - golden ratio

#: iterations run by the last :func:`brent_min` call (every lane frozen by
#: then, or ``maxiter``); chip_smoke.py reports it
iterations = 0


def _as_lanes(v, dtype, device):
    if torch.is_tensor(v):
        return v.to(dtype=dtype if dtype is not None else v.dtype, device=device or v.device)
    return torch.as_tensor(v, dtype=dtype if dtype is not None else default_float(), device=device)


def brent_min(
    f: Callable,
    lo,
    hi,
    *,
    rel_tol: float = None,
    abs_tol: float = None,
    maxiter: int = 96,
    dtype=None,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Minimize ``f`` on ``[lo, hi]`` lane by lane; returns ``(fmin, xmin)``.

    ``lo`` and ``hi`` are numbers or tensors of one batch shape; ``f`` maps a
    tensor of that shape to the objective's values, lane by lane. The
    endpoints are never evaluated (the first probe is the interior golden
    point), matching Brent's bracketing. Tolerances default to Optim.jl's
    dtype-adaptive values, ``sqrt(eps)`` and ``eps`` of the domain dtype
    (``dtype``, else ``lo``'s).
    """
    global iterations
    a = _as_lanes(lo, dtype, device)
    b = _as_lanes(hi, a.dtype, a.device)
    a, b = torch.broadcast_tensors(a, b)
    eps = torch.finfo(a.dtype).eps
    rel_tol = eps**0.5 if rel_tol is None else rel_tol
    abs_tol = eps if abs_tol is None else abs_tol

    x = a + _CGOLD * (b - a)
    fx = f(x)
    w = v = x
    fw = fv = fx
    d = torch.zeros_like(x)
    e = torch.zeros_like(x)
    where = torch.where

    it = 0
    while it < maxiter:
        xm = 0.5 * (a + b)
        tol1 = rel_tol * x.abs() + abs_tol
        tol2 = 2.0 * tol1
        done = (x - xm).abs() <= tol2 - 0.5 * (b - a)
        if bool(done.all()):
            break

        # trial parabolic fit through (x, w, v)
        r = (x - w) * (fx - fv)
        q = (x - v) * (fx - fw)
        p = (x - v) * q - (x - w) * r
        q = 2.0 * (q - r)
        p = where(q > 0.0, -p, p)
        q = q.abs()
        d_para = p / where(q == 0.0, 1.0, q)
        u_para = x + d_para
        use_para = (
            (e.abs() > tol1)
            & (p.abs() < (0.5 * q * e).abs())
            & (p > q * (a - x))
            & (p < q * (b - x))
        )
        # a parabolic step landing within tol2 of a bound: nudge toward xm
        d_para = where(
            (u_para - a < tol2) | (b - u_para < tol2),
            where(xm - x >= 0.0, tol1, -tol1),
            d_para,
        )
        # golden-section fallback
        e_gold = where(x >= xm, a - x, b - x)
        e_new = where(use_para, d, e_gold)
        d_new = where(use_para, d_para, _CGOLD * e_gold)

        # never step less than tol1
        u = where(d_new.abs() >= tol1, x + d_new, x + where(d_new >= 0.0, tol1, -tol1))
        fu = f(u)

        better = fu <= fx
        a_n = where(better, where(u >= x, x, a), where(u < x, u, a))
        b_n = where(better, where(u >= x, b, x), where(u < x, b, u))
        # rotate the (x, w, v) history
        promote_w = ~better & ((fu <= fw) | (w == x))
        promote_v = ~better & ~promote_w & ((fu <= fv) | (v == x) | (v == w))
        v_n = where(better | promote_w, w, where(promote_v, u, v))
        fv_n = where(better | promote_w, fw, where(promote_v, fu, fv))
        w_n = where(better, x, where(promote_w, u, w))
        fw_n = where(better, fx, where(promote_w, fu, fw))
        x_n = where(better, u, x)
        fx_n = where(better, fu, fx)

        new = (a_n, b_n, x_n, w_n, v_n, fx_n, fw_n, fv_n, d_new, e_new)
        old = (a, b, x, w, v, fx, fw, fv, d, e)
        a, b, x, w, v, fx, fw, fv, d, e = (where(done, o, nv) for o, nv in zip(old, new))
        it += 1
    iterations = it
    return fx, x


def gridbrent(
    f: Callable,
    a: float,
    b: float,
    ninterval: int = 1,
    *,
    batch_shape=(),
    **brent_kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Brent on ``ninterval`` equal subdivisions of ``[a, b]``; global minimum.

    ``f`` maps a tensor of shape ``batch_shape + (L,)``, one objective per
    batch entry and ``L = ninterval + 1`` candidate lanes each, to its values.
    Returns ``(fmin, xmin)`` of shape ``batch_shape``.

    The lower endpoint rides the same batch as a degenerate ``[a, a]`` lane,
    which converges at once to ``(f(a), a)`` (COMPAT.md #19); the upper
    endpoint is not a candidate (h2 = 1 is an open boundary of the model).
    A NaN objective loses; the first minimum wins.
    """
    pts = np.linspace(a, b, ninterval + 1)
    av = np.concatenate([pts[:-1], pts[:1]])
    bv = np.concatenate([pts[1:], pts[:1]])
    shape = tuple(batch_shape) + (len(av),)
    kw = {k: brent_kwargs.pop(k, None) for k in ("dtype", "device")}
    lo = _as_lanes(av, kw["dtype"], kw["device"]).expand(shape)
    hi = _as_lanes(bv, kw["dtype"], kw["device"]).expand(shape)
    fmins, xmins = brent_min(f, lo, hi, **brent_kwargs)
    fmins = torch.where(torch.isnan(fmins), torch.inf, fmins)
    i = torch.argmin(fmins, dim=-1, keepdim=True)  # first minimum wins
    return fmins.gather(-1, i)[..., 0], xmins.gather(-1, i)[..., 0]
