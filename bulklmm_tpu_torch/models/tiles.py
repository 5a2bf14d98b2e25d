"""The (traits x markers) grid of devices that the bulk engines run on.

Counterpart of the mesh half of ``bulklmm_tpu/parallel/sharding.py``. The
JAX package puts its arrays on a ``jax.sharding.Mesh`` and lets XLA
partition the jitted cores; here the partition is explicit:

- **traits** axis, the data-parallel axis: each row of the mesh owns one
  shard of the trait columns (the traits padded with zero columns to a
  multiple of the axis, the padding sliced off the results);
- **markers** axis: each column of the mesh owns one shard of the marker
  columns (padded likewise), for panels larger than one device;
- **permutations** ride the markers axis in the permutation engine: device
  (i, j) computes trait shard i x permutation shard j against the
  replicated marker panel, so the max over markers stays on the device.

Device (i, j) runs the single-device core of ``bulkscan.py`` or
``bulkperm.py`` on its tile, so under the float32 presets every CUDA tile
launches the hand-written kernels on its own device. A call without a mesh
is the same computation on a mesh of one position. The hot path has no
collective; results are assembled into one tensor on the mesh's first
device, the counterpart of JAX's globally sharded array.

Shards on distinct devices run side by side, one host thread a device under
``torch.cuda.device`` (:func:`_run_tiles`): the null-exact fit reads its
convergence once an iteration, so one host loop would serialize the cards.
The tiles of a device named more than once (a virtual mesh) run one after
another.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.config import with_highest_matmul
from ..utils.host import to_device

TRAITS_AXIS = "traits"
MARKERS_AXIS = "markers"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 2-D grid of devices with the axes ("traits", "markers").

    ``devices[i][j]`` owns trait shard i x marker shard j. A mesh may name
    one device more than once: ``["cpu"] * 8`` runs eight positions on the
    CPU (the tests), ``[cuda:0] * 4`` four on one card, the counterpart of
    the JAX package's virtual host devices. ``ranks`` is set on a pod's
    global mesh (``parallel/distributed.py::make_global_mesh``): the process
    that owns each position; None means this process owns them all.
    """

    devices: tuple
    ranks: Optional[tuple] = None

    def __post_init__(self):
        rows = tuple(tuple(torch.device(d) for d in row) for row in self.devices)
        if not rows or not rows[0] or len({len(r) for r in rows}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        object.__setattr__(self, "devices", rows)

    @classmethod
    def single(cls, device) -> "Mesh":
        """The mesh of one position that a call without a mesh runs on."""
        return cls(((device,),))

    @property
    def shape(self) -> dict:
        return {TRAITS_AXIS: len(self.devices), MARKERS_AXIS: len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device that holds the assembled results."""
        return self.devices[0][0]

    @property
    def flat(self) -> list:
        return [d for row in self.devices for d in row]

    def tiles(self) -> list:
        """``(i, j, device)`` of every position, in row-major order."""
        return [(i, j, d) for i, row in enumerate(self.devices) for j, d in enumerate(row)]


def make_mesh(
    n_devices: Optional[int] = None,
    *,
    marker_shards: Optional[int] = None,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """Build a ("traits", "markers") mesh.

    By default over every CUDA device (``torch.cuda.device_count()``), all
    on the traits axis; ``marker_shards`` splits off a markers axis, which
    must divide the device count. ``devices`` names the positions instead,
    and may repeat a device (``devices=["cpu"] * 8``, ``[cuda:0] * 4``).
    Without a CUDA device and without ``devices`` this raises: the mesh
    never picks the CPU by itself.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device was found, so make_mesh() has no devices to use: pass "
                'devices=["cpu"] * k for a mesh of k positions on the CPU'
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [torch.device(d) for d in devices]
    if n_devices is not None:
        devs = devs[:n_devices]
    nd = len(devs)
    ms = 1 if marker_shards is None else int(marker_shards)
    if ms < 1 or nd % ms != 0:
        raise ValueError(f"marker_shards={ms} must divide device count {nd}")
    return Mesh(tuple(tuple(devs[i * ms:(i + 1) * ms]) for i in range(nd // ms)))


def _pad_cols(A, multiple: int):
    """Zero-pad the columns of (n, k) A to a multiple of ``multiple``;
    returns (padded, k)."""
    k = A.shape[1]
    rem = (-k) % multiple
    if rem:
        A = torch.cat([A, torch.zeros((A.shape[0], rem), dtype=A.dtype, device=A.device)], 1)
    return A, k


def _device_scope(dev: torch.device):
    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def _run_tiles(tiles, work) -> dict:
    """``{(i, j, dev): work(i, j, dev)}``. The tiles of each distinct device
    run in order on a host thread of their own under that device's scope;
    several devices run side by side (TF32 stays off for the whole run, so
    no thread restores the flags under another)."""
    by_dev = {}
    for t in tiles:
        by_dev.setdefault(t[2], []).append(t)

    def run(dev, ts):
        with _device_scope(dev):
            return {t: work(*t) for t in ts}

    if len(by_dev) == 1:
        ((dev, ts),) = by_dev.items()
        return run(dev, ts)
    out = {}
    with with_highest_matmul(), concurrent.futures.ThreadPoolExecutor(len(by_dev)) as ex:
        futures = [ex.submit(run, dev, ts) for dev, ts in by_dev.items()]
        for f in futures:
            out.update(f.result())
    return out


def _per_device(mesh: Mesh, fn) -> dict:
    """``{dev: fn(dev)}`` over the mesh's distinct devices: the replicated
    operands, placed once a device."""
    return {d: fn(d) for d in dict.fromkeys(mesh.flat)}


def _assemble(res: dict, mesh: Mesh, width: int, m: int):
    """The tiles' outputs as tensors on the mesh's first device: a (rows, w)
    output of tile (i, j) at marker block j x trait block i, a (w,) output
    (per trait) from the tiles of marker shard 0; the trait axis cut to m.
    A mesh of one position returns its tile's outputs as they are."""
    if len(res) == 1:
        ((outs),) = res.values()
        return tuple(None if o is None else o[..., :m] for o in outs)
    first = res[mesh.tiles()[0]]
    outs = []
    for k, proto in enumerate(first):
        if proto is None:
            outs.append(None)
            continue
        if proto.ndim == 1:
            buf = torch.empty(mesh.shape[TRAITS_AXIS] * width, dtype=proto.dtype, device=mesh.first)
            for (i, j, _), r in res.items():
                if j == 0:
                    buf[i * width:(i + 1) * width] = r[k].to(mesh.first)
        else:
            rows = proto.shape[0]
            buf = torch.empty((mesh.shape[MARKERS_AXIS] * rows, mesh.shape[TRAITS_AXIS] * width),
                              dtype=proto.dtype, device=mesh.first)
            for (i, j, _), r in res.items():
                buf[j * rows:(j + 1) * rows, i * width:(i + 1) * width] = r[k].to(mesh.first)
        outs.append(buf[..., :m])
    return tuple(outs)


def _core_trait_chunks(core, Y, mesh: Mesh, trait_chunk: Optional[int], fit=None):
    """Run ``core(Y_i, j, dev, chunk)`` on every tile and assemble.

    Y pads to the traits axis; tile (i, j) takes trait shard i of it on its
    device, with marker shard j, and runs it in blocks of ``chunk`` =
    ceil(``trait_chunk`` / trait shards) columns (None: one block), so that
    ``trait_chunk`` is the global block width as in the JAX package and the
    (p, m)-scale temporaries exist at (p / marker shards, chunk) size per
    device step. With ``fit``, ``fit(Y_i, dev, chunk)`` (each trait's null
    h2, which no marker moves) runs first, once a trait shard on the first
    device of its row, and ``core`` takes its (w,) result on the tile's
    device as a fifth argument. Returns the outputs (:func:`_assemble`; the
    marker axis padded, the caller's to cut).
    """
    tshards = mesh.shape[TRAITS_AXIS]
    Yp, m = _pad_cols(Y, tshards)
    w = Yp.shape[1] // tshards
    chunk = None if trait_chunk is None else -(-max(int(trait_chunk), 1) // tshards)
    fitted = {}
    if fit is not None:
        rows = [(i, 0, row[0]) for i, row in enumerate(mesh.devices)]
        fitted = _run_tiles(rows, with_highest_matmul()(
            lambda i, j, dev: fit(Yp[:, i * w:(i + 1) * w].to(dev), dev, chunk)))
        fitted = {i: h for (i, _, _), h in fitted.items()}

    @with_highest_matmul()
    def tile(i, j, dev):
        extra = () if fit is None else (fitted[i].to(dev),)
        return core(Yp[:, i * w:(i + 1) * w].to(dev), j, dev, chunk, *extra)

    return _assemble(_run_tiles(mesh.tiles(), tile), mesh, w, m)


def _marker_shards(G, mesh: Mesh, dtype) -> tuple:
    """``({(j, dev): marker shard j of G on dev}, p)``: G (a host array or
    a tensor anywhere) padded to the markers axis, each shard uploaded to
    the devices of its column of the mesh only."""
    G = G if torch.is_tensor(G) else torch.from_numpy(np.asarray(G))
    mshards = mesh.shape[MARKERS_AXIS]
    Gp, p = _pad_cols(G, mshards)
    pp = Gp.shape[1] // mshards
    out = {}
    for _, j, d in mesh.tiles():
        if (j, d) not in out:
            out[(j, d)] = Gp[:, j * pp:(j + 1) * pp].to(device=d, dtype=dtype)
    return out, p


class _PermTiles:
    """The (trait shard x permutation shard) tiles of one permutation sweep.

    The shuffle indices pad with identity rows to the permutation-row
    quantum (their columns are cut off) and split into one contiguous shard
    a column of the mesh, placed once a device. The trait-side operands
    ``(lead, Qstack, wrn)`` (sqrt-weights or the rank-k ``sqrt(w) - 1``
    (m, .), the covariate bases (m, c, n), the whitened residuals (n, m))
    lie on the mesh's first device; :meth:`row` cuts a global trait block
    into one sub-block a trait shard, zero-padded to the trait quantum.
    """

    def __init__(self, mesh: Mesh, idx: torch.Tensor, trait_ops, *, row_quant: int):
        self.mesh, self.trait_ops = mesh, trait_ops
        self.K_total = int(idx.shape[0])
        pad = (-self.K_total) % row_quant
        if pad:
            idx = torch.cat([idx, idx[:1].expand(pad, -1)], 0)
        self.ks = idx.shape[0] // mesh.shape[MARKERS_AXIS]
        self.idx = {}
        for _, j, d in mesh.tiles():
            if (j, d) not in self.idx:
                self.idx[(j, d)] = to_device(idx[j * self.ks:(j + 1) * self.ks], d)

    def row(self, ms: int, me: int, block_lods) -> torch.Tensor:
        """(me - ms, K) genome-wide maxima of traits ms..me on the mesh's
        first device: ``block_lods(dev, lead_b, Q_b, wrn_b, idx_b)`` of each
        tile, the tiles side by side."""
        tshards = self.mesh.shape[TRAITS_AXIS]
        lead, Q, wrn = self.trait_ops
        mb = me - ms
        pad = (-mb) % tshards
        lead_b, Q_b, wrn_b = lead[ms:me], Q[ms:me], wrn[:, ms:me]
        if pad:
            lead_b = torch.cat([lead_b, lead_b.new_zeros((pad,) + lead_b.shape[1:])], 0)
            Q_b = torch.cat([Q_b, Q_b.new_zeros((pad,) + Q_b.shape[1:])], 0)
            wrn_b = torch.cat([wrn_b, wrn_b.new_zeros((wrn_b.shape[0], pad))], 1)
        w = (mb + pad) // tshards

        @with_highest_matmul()
        def tile(i, j, dev):
            s = slice(i * w, (i + 1) * w)
            return (block_lods(dev, lead_b[s].to(dev), Q_b[s].to(dev), wrn_b[:, s].to(dev),
                               self.idx[(j, dev)]),)

        res = _run_tiles(self.mesh.tiles(), tile)
        if len(res) == 1:
            ((r,),) = res.values()
            return r[:mb, :self.K_total]
        out = None
        for (i, j, _), (r,) in res.items():
            if out is None:
                out = torch.empty((tshards * w, self.mesh.shape[MARKERS_AXIS] * self.ks),
                                  dtype=r.dtype, device=self.mesh.first)
            out[i * w:(i + 1) * w, j * self.ks:(j + 1) * self.ks] = r.to(self.mesh.first)
        return out[:mb, :self.K_total]
