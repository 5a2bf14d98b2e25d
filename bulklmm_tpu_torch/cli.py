"""Command-line interface: kinship / scan / bulkscan from CSV files.

Counterpart of ``bulklmm_tpu/cli.py``, with the same subcommands, options,
output files and argument errors. The reference has no CLI (driven from
the Julia REPL, reference README.md:99-361). ``kinship`` and ``scan`` write
CSV or ``.npz``; ``bulkscan`` writes ``.npz`` (multiple arrays).
``--kinship`` feeds a precomputed kinship (dense or rank-k factors) back
into scan/bulkscan; ``--loco`` with ``--gmap`` scans each chromosome against
the kinship of the others.

  python -m bulklmm_tpu_torch kinship --geno geno.csv -o kinship.csv
  python -m bulklmm_tpu_torch scan --geno geno.csv --pheno pheno.csv \\
      --trait 1112 --nperms 1000 -o scan1112.csv
  python -m bulklmm_tpu_torch bulkscan --geno geno.csv --pheno pheno.csv \\
      --loco --gmap gmap.csv --nperms 1000 -o lods.npz

``--device`` (the one option the JAX CLI lacks, in the place of its
``JAX_PLATFORMS``) names the device the scans run on; by default the
current CUDA device. Without one the CLI exits with a message naming
``--device cpu``, which runs the plain PyTorch versions of the kernels on
the CPU; it never switches to the CPU by itself.

``bulkscan --sharded`` runs on a device mesh (``parallel/sharding.py``)
over every visible CUDA device, or, with ``--device``, over that device
named once for each marker shard; ``--marker-shards`` splits off a markers
axis; both compose with ``--stream-markers``, ``--loco`` and ``--nperms``.
``podscan`` is one process of a pod (``parallel/distributed.py``): every
process runs it with the same ``--coordinator host:port`` and ``--nproc``
and its own ``--pid``, and writes its own shard file; ``merge-shards``
assembles them.

  python -m bulklmm_tpu_torch podscan --geno geno.csv --pheno pheno.csv \\
      --coordinator localhost:29500 --nproc 2 --pid 0 --save-shards shards -o pod.npz
  python -m bulklmm_tpu_torch merge-shards --shards-dir shards -o lods.npz
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .utils.config import precision_by_name
from .utils.host import to_numpy


def _device(args) -> torch.device:
    """The device of ``--device``, else the current CUDA device; without
    one, exit naming ``--device cpu`` rather than run on the CPU unasked."""
    if args.device is not None:
        return torch.device(args.device)
    if torch.cuda.is_available():
        return torch.device("cuda", torch.cuda.current_device())
    raise SystemExit(
        "no CUDA device was found: pass --device cpu to run the plain PyTorch "
        "versions on the CPU"
    )


def _cli_mesh(args, device):
    """The mesh of ``--sharded``: every visible CUDA device, or with
    ``--device`` that device alone, named once for each of
    ``--marker-shards``' positions (a virtual mesh); ``--marker-shards``
    splits off the markers axis."""
    from .parallel import make_mesh

    shards = args.marker_shards or None
    if args.device is not None:
        return make_mesh(devices=[device] * (shards or 1), marker_shards=shards)
    return make_mesh(marker_shards=shards)


def _load_geno(args):
    from . import io as bio

    if args.geno.endswith(".npz"):
        return np.load(args.geno)["geno"]
    if args.exclude_complements:
        return bio.read_geno_prob_exclude_complements(args.geno)
    return bio.read_geno_prob(args.geno)


def _load_pheno(args):
    from . import io as bio

    if args.pheno.endswith(".npz"):
        return np.load(args.pheno)["pheno"]
    return bio.read_bxd_pheno(args.pheno)


def _kinship(args):
    from . import calc_kinship, kinship_lowrank_from_geno
    from . import io as bio

    precision = precision_by_name(args.precision)
    if args.lowrank_k and not args.output.endswith(".npz"):
        raise SystemExit("--lowrank-k output must be .npz (U, lam fields)")
    device = _device(args)
    G = _load_geno(args)
    if args.lowrank_k:
        # rank-k factors: the n x n kinship is never materialized
        lr = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision, device=device)
        np.savez_compressed(args.output, U=to_numpy(lr.U), lam=to_numpy(lr.lam))
        print(f"kinship rank-{lr.rank} factors ({lr.n} x {lr.rank}) -> {args.output}")
        return
    K = to_numpy(calc_kinship(G, precision, device=device))
    if args.output.endswith(".npz"):
        np.savez_compressed(args.output, kinship=K)
    else:
        bio.write_to_file(K, args.output)
    print(f"kinship {K.shape} -> {args.output}")


def _load_kinship(args, G, precision, device):
    """Kinship from --kinship (a file previously written by the kinship
    subcommand: dense CSV/.npz, or rank-k U/lam factors from
    ``kinship --lowrank-k``), or computed from the genotypes. A dense file
    combined with --lowrank-k is factored to rank k (randomized eigen on the
    device) rather than silently running full-rank."""
    from . import calc_kinship, kinship_lowrank
    from .ops.lowrank import LowRankKinship

    f = args.kinship
    if f:
        if f.endswith(".npz"):
            z = np.load(f)
            if "U" in z:  # rank-k factors
                return LowRankKinship(U=torch.as_tensor(z["U"], device=device),
                                      lam=torch.as_tensor(z["lam"], device=device))
            K = z["kinship"]
        else:
            K = np.loadtxt(f, delimiter=",")
        if args.lowrank_k:
            return kinship_lowrank(K, args.lowrank_k, precision=precision, device=device)
        return K
    return to_numpy(calc_kinship(G, precision, device=device))


def _loco_chrom(args, p):
    """Chromosome labels for --loco from the marker map (--gmap)."""
    from .io import read_gmap

    if not args.gmap:
        raise SystemExit("--loco requires --gmap (marker map with Chr column)")
    chrom = read_gmap(args.gmap).chromosome
    if chrom.shape[0] != p:
        raise SystemExit(
            f"--gmap has {chrom.shape[0]} markers but the genotype file has {p}"
        )
    return chrom


def _refuse_loco_with_kinship(args):
    if args.loco and args.kinship:
        raise SystemExit(
            "--loco builds per-chromosome leave-out kinships from the "
            "genotypes; --kinship cannot be combined with it"
        )


def _scan(args):
    from . import get_thresholds, kinship_lowrank_from_geno, scan, scan_loco
    from . import io as bio

    precision = precision_by_name(args.precision)
    _refuse_loco_with_kinship(args)
    device = _device(args)
    G = _load_geno(args)
    Y = _load_pheno(args)
    y = Y[:, args.trait]
    kwargs = dict(
        reml=args.reml,
        assumption=args.assumption,
        permutation_test=args.nperms > 0,
        nperms=max(args.nperms, 1),
        rndseed=args.seed,
        output_pvals=args.pvals,
        output_effects=args.effects,
        precision=precision,
        missing=args.missing,
        device=device,
    )
    if args.loco:
        res = scan_loco(y, G, _loco_chrom(args, G.shape[1]), lowrank_k=args.lowrank_k, **kwargs)
    elif args.lowrank_k and not args.kinship:
        # rank-k engine: no n x n kinship, no host eigh (ops/lowrank.py)
        K = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision, device=device)
        res = scan(y, G, K, **kwargs)
    else:
        res = scan(y, G, _load_kinship(args, G, precision, device), **kwargs)
    out = {"lod": to_numpy(res.lod)}
    if args.effects:
        out["beta"] = to_numpy(res.beta)
        out["beta_se"] = to_numpy(res.beta_se)
    meta = {
        "trait": args.trait,
        "h2_null": float(res.h2_null),
        "sigma2_e": float(res.sigma2_e),
    }
    if res.h2_null_by_chrom:
        # LOCO: h2_null above is the across-chromosome mean
        meta["h2_null_by_chrom"] = {str(c): float(v) for c, v in res.h2_null_by_chrom.items()}
    if args.nperms > 0:
        thr = get_thresholds(res.L_perms, [0.10, 0.05, 0.01])
        meta["thresholds"] = dict(zip(["0.10", "0.05", "0.01"], map(float, thr.thrs)))
    if args.pvals:
        out["log10pvals"] = to_numpy(res.log10pvals)
    if args.output.endswith(".npz"):
        np.savez_compressed(args.output, **out)
    else:
        bio.write_to_file(np.column_stack(list(out.values())), args.output)
    print(json.dumps(meta))


def _bulkscan(args):
    from . import (
        bulkscan, bulkscan_loco, bulkscan_perms, bulkscan_perms_loco, bulkscan_perms_streamed,
        bulkscan_streamed, decompose_kinship, get_thresholds_bulk, kinship_lowrank_from_geno,
    )
    from .ops.lowrank import is_lowrank
    from .parallel import bulkscan_perms_sharded, bulkscan_sharded

    precision = precision_by_name(args.precision)
    if not args.output.endswith(".npz"):
        raise SystemExit(
            "bulkscan writes multiple arrays; -o/--output must end in .npz"
        )
    stream = args.stream_markers
    if args.loco and stream:
        raise SystemExit(
            "--loco does not compose with --stream-markers; use --sharded "
            "or stream via the Python API"
        )
    if args.checkpoint_every != 1:
        # fail BEFORE compute: outside the marker-streamed checkpointed
        # permutation sweep the flag would be silently ignored
        if not stream:
            raise SystemExit(
                "--checkpoint-every applies only to the marker-streamed "
                "permutation sweep; add --stream-markers BLOCK or drop "
                "the flag"
            )
        if args.nperms <= 0:
            raise SystemExit(
                "--checkpoint-every applies only to the permutation "
                "sweep; add --nperms N or drop the flag"
            )
        if not args.resume:
            raise SystemExit(
                "--checkpoint-every needs a checkpoint directory; add "
                "--resume DIR or drop the flag"
            )
    _refuse_loco_with_kinship(args)
    device = _device(args)
    mesh = _cli_mesh(args, device) if args.sharded else None
    # where the calls run: the mesh's entry points take no device
    where = dict(device=device) if mesh is None else dict(mesh=mesh)
    G = _load_geno(args)
    Y = _load_pheno(args)
    kwargs = dict(
        method=args.method,
        reml=args.reml,
        precision=precision,
        trait_chunk=args.trait_chunk,
        output_pvals=args.pvals,
        output_effects=args.effects,
        missing=args.missing,
    )
    K = None
    chrom = _loco_chrom(args, G.shape[1]) if args.loco else None
    if args.loco:
        res = bulkscan_loco(Y, G, chrom, lowrank_k=args.lowrank_k, **where, **kwargs)
    else:
        if args.lowrank_k and not args.kinship:
            # rank-k engine (ops/lowrank.py): no n x n kinship, no host eigh
            K = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision, device=device)
        else:
            K = _load_kinship(args, G, precision, device)
            if not is_lowrank(K):
                # one decomposition serves the scan AND the permutation
                # engine below: a raw K would pay the O(n^3) eigh twice
                K = decompose_kinship(K, dtype=precision.resolve_solve(), device=device)
        if stream:
            # host-resident genotype panel streamed in marker blocks; on a
            # mesh each block's tiles run on the mesh
            skw = dict(kwargs)
            skw.pop("trait_chunk")  # size marker blocks instead
            res = bulkscan_streamed(Y, G, K, marker_block=stream, **where, **skw)
        elif mesh is not None:
            res = bulkscan_sharded(Y, G, K, mesh=mesh, **kwargs)
        else:
            res = bulkscan(Y, G, K, device=device, **kwargs)
    out = {"L": to_numpy(res.L)}
    if args.effects:
        out["beta"] = to_numpy(res.beta_mat)
        out["beta_se"] = to_numpy(res.beta_se_mat)
    if res.h2_null_list is not None:
        out["h2_null_list"] = to_numpy(res.h2_null_list)
    if res.h2_panel is not None:
        out["h2_panel"] = to_numpy(res.h2_panel)
    if res.h2_null_by_chrom:
        # LOCO: the null h2 is chromosome-specific: one (m,) array (or
        # (p_c, m) panel for alt-grid) per chromosome
        for c, v in res.h2_null_by_chrom.items():
            out[f"h2_null_chr{c}"] = to_numpy(v)
    if args.pvals:
        out["log10Pvals"] = to_numpy(res.log10Pvals_mat)
    if args.nperms > 0:
        # all-trait permutation FWER thresholds (models/bulkperm.py); with
        # --loco, per-chromosome maxima stitched by an elementwise max
        # (models/loco.py::bulkscan_perms_loco)
        perm_kwargs = dict(
            nperms=args.nperms, rndseed=args.seed,
            method=args.method if args.method != "alt-grid" else "null-grid",
            # the permutation sweep must run under the SAME likelihood
            # criterion as the scan: REML thresholds for an ML scan (or
            # vice versa) would be silently inconsistent
            reml=args.reml,
            precision=precision,
            missing=args.missing,
            **where,
        )
        if args.resume:
            perm_kwargs["checkpoint"] = args.resume
            if args.trait_chunk is not None:
                perm_kwargs["trait_chunk"] = args.trait_chunk
        if stream and args.checkpoint_every != 1:
            perm_kwargs["checkpoint_every"] = args.checkpoint_every
        if args.loco:
            # the checkpoint (if any) fans out to per-chromosome subdirectories
            pr = bulkscan_perms_loco(Y, G, chrom, lowrank_k=args.lowrank_k, **perm_kwargs)
        elif stream:
            pr = bulkscan_perms_streamed(Y, G, K, marker_block=stream, **perm_kwargs)
        elif mesh is not None:
            pr = bulkscan_perms_sharded(Y, G, K, **perm_kwargs)
        else:
            # K from the scan branch above: a decomposition, or rank-k
            # factors with --lowrank-k (the Woodbury whitening path)
            pr = bulkscan_perms(Y, G, K, **perm_kwargs)
        thr = get_thresholds_bulk(pr.perm_maxima, [0.10, 0.05, 0.01])
        out["perm_maxlods"] = to_numpy(pr.maxlods)
        out["thresholds"] = thr.thrs  # (3, m): rows = 0.10 / 0.05 / 0.01
        out["log10_adj_pvals"] = to_numpy(pr.log10_adj_pvals)
    np.savez_compressed(args.output, **out)
    print(f"bulkscan {out['L'].shape} ({args.method}) -> {args.output}")


def _podscan(args):
    """One process of a pod: the process group's handshake, this process's
    trait block in, its shard file out (no process gathers the whole
    matrix). Every process runs the same command with its own --pid."""
    from pathlib import Path

    from . import kinship_lowrank_from_geno
    from .models.missing import subset_kinship
    from .parallel import (
        bulkscan_distributed, bulkscan_perms_distributed, init_distributed, local_trait_slice,
        make_global_mesh,
    )
    from .parallel.distributed import _end_process_group

    precision = precision_by_name(args.precision)
    given = {args.coordinator is not None, args.nproc is not None, args.pid is not None}
    if len(given) != 1:
        raise SystemExit(
            "--coordinator/--nproc/--pid must be given together (or all "
            "omitted for a single-process run)"
        )
    if args.loco or args.gmap:
        raise SystemExit(
            "podscan does not support --loco/--gmap yet; run per-chromosome "
            "pods or use bulkscan --loco --sharded on one host"
        )
    device = _device(args)
    pid = init_distributed(args.coordinator, args.nproc, args.pid)
    save_dir = args.save_shards or str(Path(args.output).parent)
    G = _load_geno(args)
    Y = _load_pheno(args)
    drop_rows = None
    finite = np.isfinite(np.asarray(Y, dtype=np.float64))
    if args.missing != "error" and not finite.all():
        if args.missing == "mask":
            raise SystemExit(
                "podscan supports --missing drop only: per-trait pattern masking "
                "changes the row geometry per trait, which does not compose with "
                "the pod's fixed trait sharding. Run bulkscan --missing mask on one "
                "host, or --missing drop here."
            )
        # listwise drop from the FULL trait matrix: every process reads the
        # same phenotype file, so the row set is the same across the pod
        drop_rows = np.flatnonzero(finite.all(axis=1))
        Y, G = np.asarray(Y)[drop_rows], np.asarray(G)[drop_rows]
    mesh = make_global_mesh(None if args.device is None else [device])
    sl = local_trait_slice(Y.shape[1], mesh)
    if args.lowrank_k and not args.kinship:
        # rank-k factors straight from the genotypes (of the kept rows): the
        # cohorts a pod is for are where a dense kinship stops being an option
        K = kinship_lowrank_from_geno(G, args.lowrank_k, precision=precision, device=device)
    else:
        K = _load_kinship(args, G, precision, device)
        kn = K.U.shape[0] if hasattr(K, "U") else np.shape(K)[0]
        if drop_rows is not None and kn != G.shape[0]:
            # a --kinship file covers the whole cohort: its kept rows
            K = subset_kinship(K, drop_rows)
    if args.nperms > 0:
        _, lo, hi = bulkscan_perms_distributed(
            Y[:, sl], G, K, m_total=Y.shape[1], mesh=mesh, save_dir=save_dir,
            nperms=args.nperms, rndseed=args.seed, method=args.method, reml=args.reml,
            precision=precision,
        )
        shard = f"perm_shard_{pid:05d}.npz"
    else:
        res = bulkscan_distributed(
            Y[:, sl], G, K, m_total=Y.shape[1], mesh=mesh, method=args.method,
            reml=args.reml, precision=precision, save_dir=save_dir,
        )
        lo, hi = res.trait_lo, res.trait_hi
        shard = f"lod_shard_{pid:05d}.npz"
    print(json.dumps({
        "pid": pid, "traits": [int(lo), int(hi)], "shard": str(Path(save_dir) / shard),
    }))
    _end_process_group()


def _merge_shards(args):
    from . import get_thresholds_bulk
    from .parallel import merge_perm_shards, merge_shards

    if args.perms:
        maxlods = merge_perm_shards(args.shards_dir)
        # (m, 1 + nperms), the unpermuted column first: replicates are 1:
        thr = get_thresholds_bulk(maxlods[:, 1:], [0.10, 0.05, 0.01])
        np.savez_compressed(args.output, perm_maxlods=maxlods, thresholds=to_numpy(thr.thrs))
        print(f"merged perm maxima {maxlods.shape} -> {args.output}")
    else:
        L = merge_shards(args.shards_dir)
        np.savez_compressed(args.output, L=L)
        print(f"merged LODs {L.shape} -> {args.output}")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bulklmm_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def common(p, pheno=True):
        p.add_argument("--geno", required=True, help="genotype-prob CSV or .npz")
        p.add_argument(
            "--exclude-complements", action="store_true",
            help="keep only odd genotype-prob columns (complement pairs)",
        )
        if pheno:
            p.add_argument("--pheno", required=True, help="phenotype CSV or .npz")
        p.add_argument("-o", "--output", required=True)
        p.add_argument(
            "--precision",
            choices=["fast32", "balanced", "mixed", "exact64", "throughput"],
            default="balanced",
            help="numerics preset (utils/config.py); throughput runs as fast32 "
            "(the port has no cheaper product tier yet)",
        )
        p.add_argument(
            "--lowrank-k", type=int, default=0,
            help="use the rank-k kinship engine (no n x n kinship / host "
            "eigh); 0 = full-rank (default)",
        )
        p.add_argument(
            "--device", default=None,
            help="torch device to run on (default: the current CUDA device; "
            "'cpu' runs the kernels' plain PyTorch versions on the CPU)",
        )
        if pheno:
            p.add_argument(
                "--missing", choices=["error", "mask", "drop"],
                default="error",
                help="NaN-phenotype policy: error (default), mask "
                "(per-trait complete-case, pattern-grouped), or drop "
                "(listwise deletion). See COMPAT.md #18",
            )
            p.add_argument(
                "--loco", action="store_true",
                help="leave-one-chromosome-out kinship (needs --gmap)",
            )
            p.add_argument("--gmap", help="marker map CSV (Locus,Chr,cM,Mb)")
            p.add_argument(
                "--kinship",
                help="precomputed kinship from the kinship subcommand "
                "(CSV/.npz dense, or rank-k U/lam .npz factors) instead of "
                "recomputing from the genotypes",
            )

    k = sub.add_parser("kinship", help="kinship matrix from genotype probs")
    common(k, pheno=False)
    k.set_defaults(fn=_kinship)

    s = sub.add_parser("scan", help="single-trait genome scan")
    common(s)
    s.add_argument("--trait", type=int, default=0, help="0-based trait column")
    s.add_argument("--assumption", choices=["null", "alt"], default="null")
    s.add_argument("--reml", action="store_true")
    s.add_argument("--nperms", type=int, default=0, help=">0 enables permutation test")
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--pvals", action="store_true")
    s.add_argument(
        "--effects", action="store_true",
        help="also output per-marker GLS effect sizes + Wald SEs",
    )
    s.set_defaults(fn=_scan)

    b = sub.add_parser("bulkscan", help="all-trait genome scan")
    common(b)
    b.add_argument(
        "--method", choices=["null-grid", "null-exact", "alt-grid"],
        default="null-grid",
    )
    b.add_argument("--reml", action="store_true")
    b.add_argument("--trait-chunk", type=int, default=None)
    b.add_argument("--pvals", action="store_true")
    b.add_argument(
        "--nperms", type=int, default=0,
        help=">0 adds per-trait permutation FWER thresholds "
        "(perm_maxlods/thresholds/log10_adj_pvals in the .npz); "
        "composes with --loco",
    )
    b.add_argument("--seed", type=int, default=0)
    b.add_argument(
        "--effects", action="store_true",
        help="also output (p, m) GLS effect sizes + Wald SEs (null methods)",
    )
    b.add_argument(
        "--resume", metavar="DIR", default=None,
        help="with --nperms: write per-trait-chunk checkpoints to DIR and "
        "resume any found there (a preempted sweep continues where it "
        "stopped; config or input-data mismatches are refused)",
    )
    b.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="N",
        help="with --nperms --stream-markers --resume: persist the "
        "running-max accumulator every N marker blocks instead of every "
        "block (each save syncs the device and rewrites the full state; "
        "raise for biobank-scale sweeps)",
    )
    b.add_argument(
        "--sharded", action="store_true",
        help="run on a device mesh over all visible CUDA devices (with "
        "--device: that device, once a marker shard); traits data-parallel, "
        "see --marker-shards",
    )
    b.add_argument(
        "--marker-shards", type=int, default=0,
        help="with --sharded: split off a model-parallel markers axis "
        "(must divide the device count; 0 = traits-only mesh)",
    )
    b.add_argument(
        "--stream-markers", type=int, default=0, metavar="BLOCK",
        help="stream the genotype panel through the device in marker "
        "blocks of this width (for p beyond one device's memory); composes "
        "with --sharded",
    )
    b.set_defaults(fn=_bulkscan)

    pd = sub.add_parser(
        "podscan",
        help="one process of a multi-host (pod) bulkscan: every process runs "
        "this with the same --coordinator/--nproc and its own --pid, each "
        "writes its own LOD shard; assemble with merge-shards",
    )
    common(pd)
    pd.add_argument(
        "--method", choices=["null-grid", "null-exact", "alt-grid"],
        default="null-grid",
    )
    pd.add_argument("--reml", action="store_true")
    pd.add_argument(
        "--coordinator", default=None,
        help="host:port of process 0's rendezvous (torch.distributed, gloo); "
        "omit for a single-process run",
    )
    pd.add_argument("--nproc", type=int, default=None)
    pd.add_argument("--pid", type=int, default=None)
    pd.add_argument(
        "--save-shards", default=None,
        help="directory for per-process lod_shard_<pid>.npz files "
        "(default: the -o directory)",
    )
    pd.add_argument(
        "--nperms", type=int, default=0,
        help=">0 runs the distributed permutation engine instead, writing "
        "perm_shard_<pid>.npz per process",
    )
    pd.add_argument("--seed", type=int, default=0)
    pd.set_defaults(fn=_podscan)

    mg = sub.add_parser(
        "merge-shards",
        help="assemble podscan shard files into one .npz",
    )
    mg.add_argument("--shards-dir", required=True)
    mg.add_argument("-o", "--output", required=True)
    mg.add_argument("--perms", action="store_true")
    mg.set_defaults(fn=_merge_shards)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
