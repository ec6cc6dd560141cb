"""GL shard driver: continuations over the quintic multiset hash.

Counterpart of ``ceno_tpu/gl/shard.py``, the GL configuration of
zkvm/shard.py: it reuses the field-independent planning stages (boundary
planning, RAM event chaining, token derivation: zkvm/shard.plan_shards;
addresses, values and clocks are u32-range integers, the same in any field),
then rewrites each shard's public rw sums with the GL quintic-curve EC sums
(fields/gl5_host.py) in the 5-limb pv layout (x at base..base+5, y at
base+7..base+12, the other slots reserved-zero), and proves each shard with
gl/scheme.prove_gl under the GL field context (the planner's BabyBear
stage-1 witness is not reused: is-zero inverse columns are
field-dependent). The shards prove one after another, as in the reference,
on ``device`` (the card when None); unlike the reference, which derives the
GL key once a shard, :func:`prove_shards_gl` derives it once (the same
bytes).

:func:`verify_shards_gl` mirrors zkvm/shard.verify_shards: public-value
chaining, per-shard verify_gl with first/last gating, and the global EC-sum
identity over the quintic curve. Host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from ..fields import gl5_host as G5
from ..zkvm import shard as bshard
from ..zkvm.layout import (
    PV_INIT_PC, PV_END_PC, PV_INIT_CYCLE, PV_END_CYCLE, PV_SHARD_ID,
    PV_RW_SUM_IN, PV_RW_SUM_OUT, PV_HEAP_WORDS, PV_STACK_WORDS,
    PV_INFO_WORDS, PV_PUBIO_DIGEST,
)
from . import scheme as gscheme
from .shard_chips import tokens_to_points_gl


@dataclass
class GlShardedProof:
    proofs: list        # GlZKVMProof per shard
    n_shards: int = 0

    def __post_init__(self):
        self.n_shards = len(self.proofs)


class GlShardChainError(gscheme.GlSchemeError):
    pass


def _gl_sum(tok, negate: bool):
    """Quintic EC sum of one direction's token points ((2, 5) canonical)."""
    if tok.n == 0:
        return np.zeros((2, 5), np.uint64)
    _, xs, ys = tokens_to_points_gl(tok)
    if negate:
        ys = G5.neg(ys)
    acc = (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    for i in range(tok.n):
        acc = G5.point_add(acc, (xs[i], ys[i]))
    return np.stack(acc)


def plan_shards_gl(view, vm, pk, cfg, max_steps_per_shard=None,
                   max_cells_per_shard=None):
    """zkvm/shard.plan_shards + quintic pv rewrite."""
    ctxs = bshard.plan_shards(view, vm, pk, cfg, max_steps_per_shard,
                              max_cells_per_shard)
    out = []
    for ctx in ctxs:
        pv = np.asarray(ctx.pv, np.uint64).copy()
        for base, tok, neg in (
            (PV_RW_SUM_IN, ctx.in_tokens, False),
            (PV_RW_SUM_OUT, ctx.out_tokens, True),
        ):
            pv[base : base + 14] = 0
            s = _gl_sum(tok, neg)
            pv[base : base + 5] = s[0]
            pv[base + 7 : base + 12] = s[1]
        out.append(replace(ctx, pv=pv))
    return out


def prove_shards_gl(pk, vm, records, max_steps_per_shard=None,
                    max_cells_per_shard=None, params=None,
                    device=None) -> GlShardedProof:
    """Prove every shard over GL on ``device`` (the card when None), one
    after another (the per-chip schedule; the BabyBear path's witgen/device
    overlap is not used here)."""
    from ..zkvm.chips.opcodes import TraceView

    view = (records if isinstance(records, TraceView)
            else TraceView.from_records(records))
    ctxs = plan_shards_gl(view, vm, pk, pk.cfg, max_steps_per_shard,
                          max_cells_per_shard)
    vk = gscheme.keygen_gl(pk)
    proofs = []
    for ctx in ctxs:
        sub = view.select(np.arange(ctx.step_lo, ctx.step_hi))
        proofs.append(
            gscheme.prove_gl(pk, vm, sub, ctx.pv, params=params,
                             shard_ctx=ctx, device=device, vk=vk)
        )
    return GlShardedProof(proofs)


def verify_shards_gl(vk, sproof: GlShardedProof, params=None,
                     expect_halt: bool = True) -> bool:
    """Stitching verifier: per-shard proofs, public-value chaining, and the
    global quintic EC-sum infinity check."""
    n_shards = len(sproof.proofs)
    if n_shards == 0:
        raise GlShardChainError("no shards")
    acc = (np.zeros(5, np.uint64), np.zeros(5, np.uint64))
    prev_pv = None
    for s, proof in enumerate(sproof.proofs):
        pv = np.asarray(proof.public_values, np.uint64)
        if int(pv[PV_SHARD_ID]) != s:
            raise GlShardChainError(f"shard {s}: wrong shard id")
        if prev_pv is not None:
            if pv[PV_INIT_PC] != prev_pv[PV_END_PC]:
                raise GlShardChainError(f"shard {s}: pc chain broken")
            if pv[PV_INIT_CYCLE] != prev_pv[PV_END_CYCLE]:
                raise GlShardChainError(f"shard {s}: cycle chain broken")
            if (
                pv[PV_HEAP_WORDS] != prev_pv[PV_HEAP_WORDS]
                or pv[PV_STACK_WORDS] != prev_pv[PV_STACK_WORDS]
                or pv[PV_INFO_WORDS] != prev_pv[PV_INFO_WORDS]
            ):
                raise GlShardChainError(f"shard {s}: RAM length mismatch")
            if not np.array_equal(
                pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
                prev_pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
            ):
                raise GlShardChainError(f"shard {s}: pubio digest mismatch")
        gscheme.verify_gl(
            vk, proof, params=params, expect_halt=expect_halt,
            is_first=(s == 0), is_last=(s == n_shards - 1),
            standalone=(n_shards == 1),
        )
        for base in (PV_RW_SUM_IN, PV_RW_SUM_OUT):
            pt = (pv[base : base + 5], pv[base + 7 : base + 12])
            acc = G5.point_add(acc, pt)
        prev_pv = pv
    if not G5.is_infinity(*acc):
        raise GlShardChainError("cross-shard RAM EC sum is not the identity")
    return True
