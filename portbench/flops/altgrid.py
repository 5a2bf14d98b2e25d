"""The alt-grid kernel (``csrc/altgrid_fused.cu``): for each of g grid
points one correlation product of the weighted, residualized markers and
traits, a running minimum over the grid, then the LOD and its grid index.

A launch at g grid points, n samples, p markers and m traits does
``2 g n p m`` flops. It reads the grid's markers (g, n, p), traits
(g, n, m) and null terms (g, m), and writes L and the index (p, m each):
4 bytes each.
"""

NAME_PREFIXES = ("altgrid_",)


def launch_shape(call: dict, launches: float) -> dict:
    """One of ``launches`` launches of a call: the traits split evenly."""
    return dict(call, m=call["m"] / launches)


def flops(s: dict) -> float:
    return 2.0 * s["g"] * s["n"] * s["p"] * s["m"]


def bytes(s: dict) -> float:
    g, n, p, m = s["g"], s["n"], s["p"], s["m"]
    return 4.0 * (g * n * p + g * n * m + g * m + 2 * p * m)
