"""The permutation kernel (``csrc/bulkperm_fused.cu``): for every trait of a
block and every shuffle, the correlation product with every marker and its
maximum over the markers.

A launch at n samples, p markers, m traits and K shuffle columns does
``2 n p K m`` flops. It reads the markers (n, p), the trait operands
(m, n, K) and the marker norms (m, p), and writes the maxima (m, K):
4 bytes each.
"""

NAME_PREFIXES = ("bulkperm_",)


def launch_shape(call: dict, launches: float) -> dict:
    """One of ``launches`` launches of a call: trait blocks of equal width,
    each with all of the call's shuffle columns."""
    return dict(call, m=call["m"] / launches)


def flops(s: dict) -> float:
    return 2.0 * s["n"] * s["p"] * s["columns"] * s["m"]


def bytes(s: dict) -> float:
    n, p, m, K = s["n"], s["p"], s["m"], s["columns"]
    return 4.0 * (n * p + m * n * K + m * p + m * K)
