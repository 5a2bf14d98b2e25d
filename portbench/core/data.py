"""The general generator: a cell's data from ``--seed``, on the device.

Every draw takes a generator of its own, seeded from the run's seed and the
draw's name (and the call's index), so a draw never depends on how many
came before it: the same seed gives the same genotypes, kinship, trait
panels and shuffle indices on every run, and two seeds give the same sizes.

- genotypes: ``uniform`` (probabilities uniform on [0, 1]) or
  ``founder_mix`` (each individual a Dirichlet mix of founder haplotypes,
  plus Gaussian noise, clipped to [0, 1]: a kinship with a realistic
  spectrum);
- kinship: ``2 (G - 0.5)(G - 0.5)^T / p + 0.5`` with a unit diagonal, in
  float64 on the device;
- traits: each trait has its own heritability h2, uniform on the
  configuration's range, and is ``sqrt(h2) L z1 + sqrt(1 - h2) z2`` with
  ``K = L L^T`` and standard normal z1, z2, so that the null fit takes h2
  across the whole grid;
- covariates: the intercept, and any further columns standard normal;
- shuffles: the identity row, then ``nperms`` uniform permutations.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


def mix(seed: int, *keys) -> int:
    """A 63-bit seed for the draw named by ``keys`` under the run's seed."""
    h = hashlib.blake2b(repr((int(seed),) + keys).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") >> 1


def generator(device, seed: int, *keys) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(mix(seed, *keys))
    return g


def genotypes(cfg: dict, seed: int, device) -> torch.Tensor:
    """(n, p) float32 genotype probabilities."""
    n, p = cfg["n"], cfg["p"]
    spec = cfg["genotypes"]
    g = generator(device, seed, "genotypes")
    if spec["kind"] == "uniform":
        return torch.rand((n, p), generator=g, device=device, dtype=torch.float32)
    if spec["kind"] == "founder_mix":
        nfound = max(spec["min_founders"], n // spec["individuals_per_founder"])
        founders = torch.rand((nfound, p), generator=g, device=device, dtype=torch.float32)
        # the (n, founders) weights are small: drawn on the host, Dirichlet
        rng = np.random.default_rng(mix(seed, "founder_weights"))
        weights = rng.dirichlet(np.full(nfound, spec["dirichlet_alpha"]), size=n)
        weights = torch.as_tensor(weights, dtype=torch.float32, device=device)
        G = weights @ founders
        G += spec["noise_sd"] * torch.randn((n, p), generator=g, device=device,
                                            dtype=torch.float32)
        return G.clamp_(0.0, 1.0)
    raise ValueError(f"unknown genotype kind {spec['kind']!r}")


def kinship(G: torch.Tensor, block: int = 16384) -> torch.Tensor:
    """(n, n) float64 kinship of ``G``, over blocks of markers."""
    n, p = G.shape
    XXt = torch.zeros((n, n), dtype=torch.float64, device=G.device)
    for s in range(0, p, block):
        X = G[:, s : s + block].to(torch.float64) - 0.5
        XXt.addmm_(X, X.T)
    K = 2.0 * XXt / p + 0.5
    K.fill_diagonal_(1.0)
    return K


def covariates(cfg: dict, seed: int, device) -> torch.Tensor | None:
    """The covariates beyond the intercept, (n, c - 1) float32, or None."""
    extra = cfg["covariates"] - 1
    if extra <= 0:
        return None
    g = generator(device, seed, "covariates")
    return torch.randn((cfg["n"], extra), generator=g, device=device, dtype=torch.float32)


def trait_panels(cfg: dict, K: torch.Tensor, traits: int, panels: int, seed: int):
    """``panels`` (n, traits) float32 trait panels drawn through K's factor."""
    L = torch.linalg.cholesky(K)
    lo, hi = cfg["traits"]["h2_range"]
    out = []
    for i in range(panels):
        g = generator(K.device, seed, "traits", i)
        h2 = lo + (hi - lo) * torch.rand(traits, generator=g, device=K.device, dtype=torch.float64)
        z = torch.randn((2, K.shape[0], traits), generator=g, device=K.device, dtype=torch.float64)
        Y = torch.sqrt(h2) * (L @ z[0]) + torch.sqrt(1.0 - h2) * z[1]
        out.append(Y.to(torch.float32))
        del z, Y
    return out


def shuffles(n: int, nperms: int, seed: int, call: int, device) -> torch.Tensor:
    """(nperms + 1, n) int64 shuffle indices of call ``call``: the identity,
    then uniform permutations (argsort of float64 uniforms)."""
    g = generator(device, seed, "shuffles", call)
    keys = torch.rand((nperms, n), generator=g, device=device, dtype=torch.float64)
    idx = torch.argsort(keys, dim=1)
    ident = torch.arange(n, device=device, dtype=idx.dtype)[None]
    return torch.cat([ident, idx])


def sample_traits(traits: int, count: int, seed: int) -> torch.Tensor:
    """``count`` distinct trait columns (all of them where ``count`` is
    None or at least ``traits``), sorted, drawn from the seed on the host."""
    if count is None or count >= traits:
        return torch.arange(traits)
    g = torch.Generator().manual_seed(mix(seed, "sample_traits"))
    return torch.randperm(traits, generator=g)[:count].sort().values


def sample_columns(columns: int, count: int | None, seed: int, call: int) -> torch.Tensor:
    """Permutation columns to compare: column 0 (the observed scan) and
    ``count - 1`` others drawn from the seed, or all of them."""
    if count is None or count >= columns:
        return torch.arange(columns)
    g = torch.Generator().manual_seed(mix(seed, "sample_columns", call))
    rest = torch.randperm(columns - 1, generator=g)[: count - 1] + 1
    return torch.cat([torch.zeros(1, dtype=torch.int64), rest.sort().values])
