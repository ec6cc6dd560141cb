"""Sequence-parallel sumcheck: hypercube rows sharded across the ranks of a
``torch.distributed`` process group.

Counterpart of ``ceno_tpu/parallel/sharded.py`` (a JAX ``shard_map`` over a
device mesh there; one process per rank here, the reference's row
parallelism, SURVEY.md §2.8b P2).

Layout contract (the reference's): row i of an N-row MLE lives on rank
i mod D at local index i // D, so a rank's slab is ``x[..., rank::D]``.
Folding the TOP variable pairs global i with i + N/2, which is local j with
j + nloc/2 on the same rank, so every fold stays on its rank. D is a power
of two and N a multiple of 2D.

Each round a rank evaluates its slab's (deg+1, 4) message with the port's
K6a (``sumcheck/terms.round_evals``, ``round_evals_ext``), the messages are
summed across ranks by one ``all_reduce`` (int64 SUM, then mod p), every
rank absorbs the sum into its own copy of the host transcript (the
transcript is deterministic, so all ranks sample the same challenge: no
broadcast) and folds its slab with K6b (``fold_banks``,
``fold_ext_bank``). The message crosses ranks before it is absorbed, so the
rounds take the per-round path, never the fused device duplex; its bytes are
the fused path's. Once a slab is down to one row (D global rows), the slabs
are gathered in global order and every rank finishes the last log2(D)
rounds on its own device (the reference gathers at ``HOST_N`` rows). The
all-reduce and gather buffers sit on the host for ``gloo`` and on the
rank's card for ``nccl``.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import queue
import tempfile
import time
import traceback
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from .. import DEFAULT_DEVICE
from ..fields import babybear as bb
from ..fields import ext4
from ..fields import ext4_host as exth
from ..mle import ops
from ..sumcheck import prover as sc_prover
from ..sumcheck import terms as T
from ..sumcheck.prover import SumcheckOutput, SumcheckProof


@dataclass(frozen=True)
class Mesh:
    """One rank's view of the row mesh: its process group, rank, the rank
    count D and the device its slabs live on."""

    group: object
    rank: int
    size: int
    device: torch.device
    reduce_device: torch.device  # where all_reduce / all_gather buffers sit


def make_mesh(group=None, device=None) -> Mesh:
    """The calling rank's mesh over ``group`` (the default group if None),
    its slabs on ``device`` (the card unless named)."""
    d = dist.get_world_size(group)
    if d & (d - 1):
        raise ValueError(f"make_mesh: {d} ranks, not a power of two")
    dev = torch.device(device or DEFAULT_DEVICE)
    red = dev if dist.get_backend(group) == "nccl" else torch.device("cpu")
    return Mesh(group, dist.get_rank(group), d, dev, red)


def _check_rows(mesh: Mesh, n: int) -> None:
    if n % (2 * mesh.size):
        raise ValueError(f"{n} rows over {mesh.size} ranks: need a multiple of {2 * mesh.size}")


def slab(mesh: Mesh, x):
    """The rank's rows ``x[..., rank::D]`` of a canonical numpy array (as
    Montgomery int32) or a Montgomery tensor, on the mesh's device."""
    if isinstance(x, np.ndarray):
        return bb.to_device(np.ascontiguousarray(x[..., mesh.rank :: mesh.size]), mesh.device)
    return x[..., mesh.rank :: mesh.size].contiguous().to(mesh.device)


def shard_base_cols(mesh: Mesh, cols, n: int | None = None):
    """A rank's slab of base columns with the sentinel-ones column last:
    (C+1, N/D) Montgomery int32 on the mesh's device. ``cols`` is a (C, N)
    canonical numpy matrix or a list of (N,) columns (Montgomery tensors or
    canonical arrays); with no columns, ``n`` gives N."""
    if isinstance(cols, np.ndarray):
        n = cols.shape[-1]
        bank = slab(mesh, cols)
    elif cols:
        n = cols[0].shape[-1]
        bank = torch.stack([slab(mesh, c) for c in cols])
    else:
        bank = bb.zeros((0, n // mesh.size), mesh.device)
    _check_rows(mesh, n)
    return torch.cat([bank, bb.ones((1, n // mesh.size), mesh.device)])


def shard_ext_cols(mesh: Mesh, cols, n: int | None = None):
    """A rank's slab of ext columns (a list of (4, N)) with the sentinel-ones
    column last: (4, C+1, N/D) Montgomery int32; with no columns, ``n``
    gives N."""
    n = cols[0].shape[-1] if cols else n
    _check_rows(mesh, n)
    parts = [slab(mesh, c)[:, None, :] for c in cols]
    return torch.cat(parts + [ext4.ones((1, n // mesh.size), mesh.device)], dim=1)


def all_reduce_mod(mesh: Mesh, x):
    """The sum mod p over ranks of a Montgomery int32 tensor (int64 SUM on
    the mesh's reduce device), as Montgomery int32 there."""
    t = x.to(mesh.reduce_device, torch.int64)
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return (t % bb.P).to(bb.DTYPE)


def gather_rows(mesh: Mesh, x):
    """Every rank's slab (..., nloc) put back in global row order: (...,
    nloc * D) on the mesh's device (global row j*D + d is local j of rank d)."""
    t = x.to(mesh.reduce_device, torch.int64).contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.size)]
    dist.all_gather(parts, t, group=mesh.group)
    full = torch.stack(parts, dim=-1).reshape(*x.shape[:-1], -1)
    return full.to(mesh.device, bb.DTYPE)


def eq_slab(mesh: Mesh, point: np.ndarray):
    """The rank's slab of eq(point, .): (4, 2^n / D) Montgomery, ``point``
    (n, 4) canonical LSB-first. The low log2(D) index bits are the rank's, so
    the slab is eq over the high variables scaled by eq(point_low, rank)."""
    k = mesh.size.bit_length() - 1
    bits = np.zeros((k, 4), np.uint64)
    bits[:, 0] = [(mesh.rank >> j) & 1 for j in range(k)]
    scale = exth.eq_eval(point[:k], bits)
    return ops.build_eq(bb.to_device(np.asarray(point[k:], np.uint64), mesh.device),
                        scale=bb.to_device(scale, mesh.device))


def prove_sharded(mesh: Mesh, base_cols, ext_cols, term_list, n_vars: int, transcript):
    """Row-sharded sumcheck over full columns (each rank passes the same
    ones and keeps its slab): base (N,) and ext (4, N), Montgomery tensors
    or canonical numpy. Byte-identical to ``sumcheck.prover.prove`` (the
    partial sums are added in another order, and modular addition is
    associative)."""
    n = 1 << n_vars
    return prove_banks(mesh, shard_base_cols(mesh, list(base_cols), n),
                       shard_ext_cols(mesh, list(ext_cols), n), term_list, n_vars, transcript)


def prove_banks(mesh: Mesh, base_bank, ext_bank, term_list, n_vars: int, transcript):
    """:func:`prove_sharded` over banks that already are the rank's slabs,
    each with its ones sentinel last: base (Cb+1, 2^n_vars / D), ext
    (4, Ce+1, 2^n_vars / D)."""
    n_base, n_ext = base_bank.shape[0] - 1, ext_bank.shape[1] - 1
    _check_rows(mesh, base_bank.shape[1] * mesh.size)
    if base_bank.shape[1] * mesh.size != 1 << n_vars:
        raise ValueError(f"prove_banks: slabs of {base_bank.shape[1]} rows over {mesh.size} "
                         f"ranks for {n_vars} variables")
    bidx_np, eidx_np, scal_np, deg = sc_prover.compile_terms(term_list, n_base, n_ext)
    midx_np = T.merge_indices(bidx_np, eidx_np, n_base, n_ext)
    live = np.nonzero(scal_np.any(axis=1))[0]  # padding terms weigh zero
    dev = mesh.device
    idx = lambda a: torch.from_numpy(a[live].astype(np.int32)).to(dev)  # noqa: E731
    bidx, eidx, midx = idx(bidx_np), idx(eidx_np), idx(midx_np)
    scalars = bb.to_device(scal_np[live].T, dev)

    msgs = np.zeros((n_vars, deg + 1, 4), np.uint64)
    chals = np.zeros((n_vars, 4), np.uint64)
    merged = None
    on_slabs = True
    for rnd in range(n_vars):
        if merged is None:
            ev = T.round_evals(base_bank, ext_bank, bidx, eidx, scalars, deg=deg)
        else:
            ev = T.round_evals_ext(merged, midx, scalars, deg=deg)
        if on_slabs:
            ev = all_reduce_mod(mesh, ev)
        msgs[rnd] = bb.to_host(ev)
        transcript.append(msgs[rnd].ravel())
        chals[rnd] = transcript.sample_ext()
        r = bb.to_device(chals[rnd], dev)
        if merged is None:
            merged = T.fold_banks(base_bank, ext_bank, r)
            base_bank = ext_bank = None
        else:
            merged = T.fold_ext_bank(merged, r)
        if on_slabs and merged.shape[2] == 1:
            # D global rows left: the last log2(D) rounds run on every rank
            merged = gather_rows(mesh, merged)
            on_slabs = False

    fin = bb.to_host(T.final_evals(merged)).T  # (C, 4)
    return SumcheckOutput(SumcheckProof(msgs), chals[::-1].copy(), fin[:n_base],
                          fin[n_base : n_base + n_ext])


# ---------------------------------------------------------------------------
# Starting ranks
# ---------------------------------------------------------------------------

def run_ranks(fn, args=(), world_size: int = 2, backend: str = "gloo",
              timeout: float = 60.0, deadline: float = 300.0) -> list:
    """``fn(rank, *args)`` on ``world_size`` spawned processes joined in one
    process group (``backend``, a ``file://`` rendezvous in a temporary
    directory, ``timeout`` seconds for every collective). ``fn`` is a
    module-level function; it may call :func:`make_mesh`. Returns the ranks'
    results in rank order. Raises RuntimeError with the traceback of a rank
    that failed, or when a rank died without an answer, and TimeoutError
    when the ranks have not all answered within ``deadline`` seconds; no
    rank is left running."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, args, r, world_size, backend, init, timeout, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        out = {}
        end = time.monotonic() + deadline
        try:
            while len(out) < world_size:
                try:
                    rank, ok, value = results.get(timeout=1.0)
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"run_ranks: ranks {dead} died without an answer "
                                           f"(exit codes {[procs[r].exitcode for r in dead]})"
                                           ) from None
                    if time.monotonic() > end:
                        missing = sorted(set(range(world_size)) - set(out))
                        raise TimeoutError(f"run_ranks: ranks {missing} gave no result within "
                                           f"{deadline} s") from None
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world_size} failed:\n{value}")
                out[rank] = value
        finally:
            # after every answer the ranks are leaving: give them 10 s; a
            # failed run's ranks are stopped at once
            stop = time.monotonic() + (10 if len(out) == world_size else 0)
            for p in procs:
                p.join(max(0.0, stop - time.monotonic()))
                if p.is_alive():
                    p.terminate()
                    p.join()
        return [out[r] for r in range(world_size)]


def _rank_main(fn, args, rank: int, world_size: int, backend: str, init: str,
               timeout: float, results) -> None:
    try:
        dist.init_process_group(backend, init_method=init, world_size=world_size, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        try:
            value = fn(rank, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, value))
    except Exception:  # the boundary: the parent reads the traceback
        results.put((rank, False, traceback.format_exc()))
