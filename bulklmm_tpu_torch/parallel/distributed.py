"""Multi-process (pod) execution: per-process trait feeding and sharded output.

Counterpart of ``bulklmm_tpu/parallel/distributed.py``. A pod run is:

  1. ``init_distributed()`` in every process: ``torch.distributed`` with
     the gloo backend over a ``tcp://`` rendezvous;
  2. one global ("traits",) mesh over the devices of every process
     (:func:`make_global_mesh`, one ``all_gather_object`` of each process's
     device names);
  3. each process feeds ONLY its own trait block (:func:`local_trait_slice`
     -> :func:`bulkscan_distributed`), which runs on this process's devices
     of the mesh; no process ever holds the whole trait matrix;
  4. the results stay where they were computed: each process writes its own
     LOD columns (``save_dir=...``: one ``lod_shard_<pid>.npz`` a process),
     and :func:`merge_shards` assembles them offline.

Gloo is the backend on purpose: no tensor of the scan crosses the process
group (trait sharding needs no collective; the kinship factors are computed
by every process from the same inputs), so the group carries only the
device census, and NCCL would refuse two processes on one GPU, the only pod
a one-card machine can run.
"""

from __future__ import annotations

import atexit
import datetime
from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.config import DEFAULT_PRECISION, PrecisionConfig
from ..utils.host import to_numpy
from .sharding import TRAITS_AXIS, Mesh, bulkscan_perms_sharded, bulkscan_sharded


#: how long the teardown waits at its barrier for the other processes
_TEARDOWN_TIMEOUT = datetime.timedelta(seconds=60)


def _process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def _process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Join the process group of a pod; returns this process's index.

    ``coordinator_address`` is ``host:port`` of process 0's rendezvous
    (``tcp://``; any free port on ``localhost`` for a pod on one machine).
    A no-op that returns 0 for a single-process run (no coordinator, one
    process), and one that returns the rank when the group exists already,
    so the same launcher works on one host and on a pod.
    """
    if dist.is_initialized():
        return dist.get_rank()
    if coordinator_address is None and num_processes in (None, 1):
        return 0
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "coordinator_address, num_processes and process_id must be given together"
        )
    dist.init_process_group(
        "gloo", init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes), rank=int(process_id),
    )
    atexit.register(_end_process_group)
    return int(process_id)


def _end_process_group() -> None:
    """End the process group that :func:`init_distributed` joined, if any:
    a barrier bounded by :data:`_TEARDOWN_TIMEOUT`, then
    ``destroy_process_group``. Registered with ``atexit``. A process that
    exits with its group alive leaves the rendezvous store's and gloo's
    threads running into the interpreter's teardown, and a peer that closes
    its sockets at that moment aborts it (``terminate called without an
    active exception``). The barrier lets every process reach the teardown
    before any store goes away; a peer that never comes (it died) costs the
    timeout, and the group is destroyed all the same."""
    if not dist.is_initialized():
        return
    try:
        dist.monitored_barrier(timeout=_TEARDOWN_TIMEOUT)
    except RuntimeError:
        pass  # a peer is gone: nothing left to wait for
    dist.destroy_process_group()


def make_global_mesh(devices=None) -> Mesh:
    """A ("traits",) mesh (markers axis of 1) over every process's devices,
    ordered by (process, device index), so that each process owns one
    contiguous block of the traits axis.

    ``devices``: this process's devices (default: every CUDA device it
    sees; ``devices=["cpu"]`` on the CPU). Every process must contribute
    the same number. The mesh records each position's process
    (``Mesh.ranks``); a process computes only on its own positions.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device was found, so make_global_mesh() has no devices to use: "
                'pass devices=["cpu"] to run this process\'s share on the CPU'
            )
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    local = [str(torch.device(d)) for d in devices]
    census = [None] * _process_count()
    if dist.is_initialized():
        dist.all_gather_object(census, local)
    else:
        census = [local]
    entries = sorted(
        (rank, torch.device(d).index or 0, k, torch.device(d))
        for rank, devs in enumerate(census) for k, d in enumerate(devs)
    )
    return Mesh(tuple((e[3],) for e in entries), ranks=tuple((e[0],) for e in entries))


def _local_mesh(mesh: Mesh) -> Mesh:
    """This process's positions of ``mesh`` as a mesh of their own."""
    if mesh.ranks is None:
        return mesh
    pid = _process_index()
    rows = [row for row, ranks in zip(mesh.devices, mesh.ranks) if ranks[0] == pid]
    if not rows:
        raise ValueError(f"process {pid} owns no position of the mesh")
    return Mesh(tuple(rows))


def _shard_geometry(m_total: int, mesh: Mesh):
    """(per_shard, M_padded, local_ndev, col_lo, col_hi) for this process."""
    tshards = mesh.shape[TRAITS_AXIS]
    nproc = _process_count()
    if tshards % nproc != 0:
        raise ValueError(
            f"traits-axis size {tshards} must be a multiple of the process "
            f"count {nproc} (every process contributes the same device count)"
        )
    per_shard = -(-m_total // tshards)
    M = per_shard * tshards
    ld = tshards // nproc
    pid = _process_index()
    # a tail process can own nothing but padding (m_total < lo): clamp both
    # ends so its slice is empty rather than negative
    lo = min(pid * ld * per_shard, m_total)
    hi = min(lo + ld * per_shard, m_total)
    return per_shard, M, ld, lo, hi


def local_trait_slice(m_total: int, mesh: Optional[Mesh] = None) -> slice:
    """The trait columns this process owns under even trait sharding.

    With a ``mesh``, blocks align to the padded per-device shard width, so a
    slice of the global trait matrix fed to :func:`bulkscan_distributed`
    lands exactly on this process's devices. Without one, plain ceiling
    division by the process count.
    """
    if mesh is None:
        nproc, pid = _process_count(), _process_index()
        per = -(-m_total // nproc)
        return slice(min(pid * per, m_total), min((pid + 1) * per, m_total))
    _, _, _, lo, hi = _shard_geometry(m_total, mesh)
    return slice(lo, hi)


class DistributedScanResult(NamedTuple):
    """Output of :func:`bulkscan_distributed`.

    L: (p, local_ndev x per_shard) LOD columns of this process's padded
       trait block, on this process's first device of the mesh.
    h2: the block's per-trait h2 (null methods) or (p, .) panel (alt-grid),
       likewise.
    trait_lo / trait_hi: the [lo, hi) global trait columns this process owns.
    L_local: (p, hi - lo) numpy copy of this process's unpadded LOD columns.
    h2_local: the matching h2 columns.
    """

    L: torch.Tensor
    h2: torch.Tensor
    trait_lo: int
    trait_hi: int
    L_local: np.ndarray
    h2_local: np.ndarray


def _check_local(Y_local, m_total, mesh):
    """``(Y_local, lo, hi)``: the local trait block as a host float64
    (n, hi - lo) array, refused unless it is exactly
    ``local_trait_slice(m_total, mesh)``'s."""
    _, _, _, lo, hi = _shard_geometry(m_total, mesh)
    Y_local = to_numpy(Y_local, np.float64)
    Y_local = Y_local[:, None] if Y_local.ndim == 1 else Y_local
    if Y_local.shape[1] != hi - lo:
        raise ValueError(
            f"process {_process_index()} expected {hi - lo} local trait columns "
            f"(= local_trait_slice({m_total}, mesh)), got {Y_local.shape[1]}"
        )
    return Y_local, lo, hi


def _m_total(m_total, Y_local):
    if m_total is not None:
        return int(m_total)
    if _process_count() > 1:
        raise ValueError("m_total (global trait count) is required multi-process")
    return 1 if np.ndim(Y_local) == 1 else np.shape(Y_local)[1]


def bulkscan_distributed(
    Y_local,
    G,
    K,
    covar=None,
    *,
    m_total: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    method: str = "null-grid",
    h2_grid=None,
    add_intercept: bool = True,
    weights=None,
    prior_variance: float = 1.0,
    prior_sample_size: float = 0.0,
    reml: bool = False,
    optim_interval: int = 1,
    decomp_scheme: str = "eigen",
    solve_method: str = "qr",
    precision: PrecisionConfig = DEFAULT_PRECISION,
    save_dir: Optional[str] = None,
) -> DistributedScanResult:
    """Multi-trait scan where each process supplies ONLY its trait block.

    ``Y_local`` must be exactly ``Y_global[:, local_trait_slice(m_total,
    mesh)]``; genotypes, covariates and kinship (dense, a decomposition or a
    ``LowRankKinship``) are the same in every process. The block, zero-
    padded to this process's share of the traits axis, runs
    :func:`bulkscan_sharded` on this process's positions of ``mesh``
    (default :func:`make_global_mesh`): the numerics of ``bulkscan``.
    Single-process calls work too (``m_total`` defaults to the block's
    width).

    With ``save_dir``, this process writes its LOD columns to
    ``<save_dir>/lod_shard_<pid>.npz`` (fields trait_lo, trait_hi, lod, h2),
    the pod's output path, where no process gathers the whole matrix.
    """
    if method not in ("null-grid", "null-exact", "alt-grid"):
        # before the O(n^3) eigendecomposition
        raise ValueError("method must be one of 'null-grid', 'null-exact', 'alt-grid'")
    if mesh is None:
        mesh = make_global_mesh()
    m_total = _m_total(m_total, Y_local)
    Y_local, lo, hi = _check_local(Y_local, m_total, mesh)
    per_shard, _, ld, _, _ = _shard_geometry(m_total, mesh)
    pad = np.zeros((Y_local.shape[0], ld * per_shard - (hi - lo)))
    Yb = np.concatenate([Y_local, pad], axis=1)
    res = bulkscan_sharded(
        Yb, G, K, covar, mesh=_local_mesh(mesh), method=method, h2_grid=h2_grid,
        add_intercept=add_intercept, weights=weights, prior_variance=prior_variance,
        prior_sample_size=prior_sample_size, reml=reml, optim_interval=optim_interval,
        decomp_scheme=decomp_scheme, solve_method=solve_method,
        precision=precision,
    )
    alt = method == "alt-grid"
    h2 = res.h2_panel if alt else res.h2_null_list
    keep = hi - lo
    L_local = to_numpy(res.L[:, :keep])
    h2_local = to_numpy(h2[..., :keep])
    if save_dir is not None:
        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(out / f"lod_shard_{_process_index():05d}.npz",
                 trait_lo=lo, trait_hi=hi, lod=L_local, h2=h2_local)
    return DistributedScanResult(L=res.L, h2=h2, trait_lo=lo, trait_hi=hi,
                                 L_local=L_local, h2_local=h2_local)


def _check_shards_tile(loaded, m: int, save_dir) -> None:
    """Shard ranges must tile [0, m) exactly: a dead process or a partial
    copy would otherwise merge into fabricated all-zero trait columns that
    thresholds and FDR consume without error."""
    spans = sorted((int(d["trait_lo"]), int(d["trait_hi"])) for d in loaded)
    cursor = 0
    for lo, hi in spans:
        if lo != cursor:
            raise ValueError(
                f"shard files under {save_dir} do not cover traits "
                f"[{cursor}, {lo}) — a process's shard is missing or the "
                "directory is partially copied"
            )
        cursor = hi
    if cursor != m:
        raise ValueError(f"shard files under {save_dir} stop at trait {cursor} of {m}")


def _load_shards(save_dir, pattern: str):
    shards = sorted(Path(save_dir).glob(pattern))
    if not shards:
        raise FileNotFoundError(f"no {pattern} under {save_dir}")
    loaded = [np.load(s) for s in shards]
    m = max(int(d["trait_hi"]) for d in loaded)
    _check_shards_tile(loaded, m, save_dir)
    return loaded, m


def merge_shards(save_dir) -> np.ndarray:
    """Assemble the global (p, m) LOD matrix from per-process shard files
    (an offline utility: pod runs themselves never gather)."""
    loaded, m = _load_shards(save_dir, "lod_shard_*.npz")
    L = np.zeros((loaded[0]["lod"].shape[0], m))
    for d in loaded:
        L[:, int(d["trait_lo"]):int(d["trait_hi"])] = d["lod"]
    return L


def bulkscan_perms_distributed(
    Y_local,
    G,
    K,
    covar=None,
    *,
    m_total: Optional[int] = None,
    mesh: Optional[Mesh] = None,
    save_dir: Optional[str] = None,
    **kwargs,
):
    """Pod-scale permutation maxima: each process tests ONLY its local
    trait block, on its own positions of ``mesh``
    (:func:`bulkscan_perms_sharded`; remaining keywords go there: nperms,
    rndseed, method, engine, checkpoint, a ``LowRankKinship`` K, ...).

    Traits are independent in the permutation engine, and the shuffle
    indices depend only on ``(n, nperms, rndseed)``: they come from a
    seeded CPU ``torch.Generator`` (``ops/bulkperm.py::
    permutation_indices``), the same draw in every process and on every
    device. So the merged per-process rows equal the single-process
    ``bulkscan_perms`` exactly, with no communication. ``Y_local`` must be
    exactly ``Y_global[:, local_trait_slice(m_total, mesh)]``.

    With ``save_dir``, this process writes ``<save_dir>/perm_shard_<pid>.npz``
    (fields trait_lo, trait_hi, maxlods, h2, sigma2, log10_adj_pvals); merge
    with :func:`merge_perm_shards`. Returns ``(result, trait_lo, trait_hi)``,
    ``result`` this process's :class:`BulkPermResult`.
    """
    if mesh is None:
        mesh = make_global_mesh()
    m_total = _m_total(m_total, Y_local)
    Y_local, lo, hi = _check_local(Y_local, m_total, mesh)
    res = bulkscan_perms_sharded(Y_local, G, K, covar, mesh=_local_mesh(mesh), **kwargs)
    if save_dir is not None:
        out = Path(save_dir)
        out.mkdir(parents=True, exist_ok=True)
        np.savez(
            out / f"perm_shard_{_process_index():05d}.npz",
            trait_lo=lo, trait_hi=hi, maxlods=to_numpy(res.maxlods),
            h2=to_numpy(res.h2_null_list), sigma2=to_numpy(res.sigma2_e_list),
            log10_adj_pvals=(to_numpy(res.log10_adj_pvals)
                             if res.log10_adj_pvals is not None else np.zeros(0)),
        )
    return res, lo, hi


def merge_perm_shards(save_dir) -> np.ndarray:
    """Assemble the global (m, 1 + nperms) permutation maxima from
    per-process ``perm_shard_*.npz`` files (an offline utility)."""
    loaded, m = _load_shards(save_dir, "perm_shard_*.npz")
    out = np.zeros((m, loaded[0]["maxlods"].shape[1]))
    for d in loaded:
        out[int(d["trait_lo"]):int(d["trait_hi"])] = d["maxlods"]
    return out
