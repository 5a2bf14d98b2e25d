"""The LOD kernel (``csrc/liteqtl_*``): per trait, c + 2 products over the
samples (the covariates', the trait's and the squared marker's) for every
marker, then the correlation and its LOD.

A launch at n samples, p markers, m traits and c covariate columns does
``2 n (c + 2) p m`` flops. It reads the markers X (n, p), the covariates
(n, c), the weights and weighted traits (2 n m) and the trait scalars
(c (c + 1) / 2 + c + 1 rows of m), and writes L (p, m): 4 bytes each.
"""

NAME_PREFIXES = ("liteqtl_",)


def launch_shape(call: dict, launches: float) -> dict:
    """One of ``launches`` launches of a call: the traits split evenly."""
    return dict(call, m=call["m"] / launches)


def flops(s: dict) -> float:
    return 2.0 * s["n"] * (s["c"] + 2) * s["p"] * s["m"]


def bytes(s: dict) -> float:
    n, p, m, c = s["n"], s["p"], s["m"], s["c"]
    scalars = c * (c + 1) / 2 + c + 1
    return 4.0 * (n * p + n * c + 2 * n * m + scalars * m + p * m)
