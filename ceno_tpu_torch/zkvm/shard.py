"""Sharding / continuations: plan, per-shard prove, stitching verify.

Role mirror of the reference's segmented-zkVM machinery (SURVEY.md §2.3/§3.3):
``ShardContextBuilder`` (e2e.rs:684-828), per-shard proving with public-value
chaining, and the stitching verifier (verifier.rs:398-475). The long trace is
split at step boundaries; each shard proves independently (own transcript,
own ∏R=∏W / Σlogup=0 bus) and continuity is restored by

  1. public-value chaining: shard s+1's (init_pc, init_cycle) must equal
     shard s's (end_pc, end_cycle); only the last shard halts;
  2. the septic-curve multiset hash: every RAM cell whose state crosses a
     shard boundary becomes a TOKEN (addr, type, value, holder_shard, clk);
     the exporting shard's EC point (write-half y) and the importing shard's
     point (read-half y) are exact negatives, so the sum of all shards'
     (in + out) tree sums must be the point at infinity.

Timestamps are GLOBAL cycles (the 4-subcycle model): an importing shard's
inserted local write reuses the exporter's clk, so opcode records keep their
traced prev_ts unchanged — only the init (first shard) and final (last
shard) RAM tables are shard-gated.

Token planning ground truth: the opcode chips' write-record FIELD expressions
evaluated over their assigned witness (circuit_builder.w_fields), so the
planner's view of the bus matches the circuits by construction.

Counterpart of ``ceno_tpu/zkvm/shard.py``, with the same relative imports.
Planning and witgen are host numpy; each shard's ``scheme.prove`` runs on
``device`` (the card unless the caller names another). ``prove_shards``
keeps the reference's pipeline: the next shard's witgen runs on a host
thread, which launches nothing on the card, while the main thread proves the
current shard. Unlike the reference, it times the planning and each shard's
prove in spans (``plan-shards``, ``shard/<s>``; the thread's ``witgen``
spans start at the span tree's root).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import septic as S
from ..gkr.mock import eval_expr_host
from ..gkr.chip import structural_table
from .chips.opcodes import TraceView
from .chips.shard_ram import Tokens, tokens_to_points
from .layout import (
    N_PUBLIC_VALUES, PV_INIT_PC, PV_END_PC, PV_INIT_CYCLE, PV_END_CYCLE,
    PV_EXIT_CODE_LO, PV_EXIT_CODE_HI, PV_SHARD_ID, PV_RW_SUM_IN, PV_RW_SUM_OUT,
    PV_HEAP_WORDS, PV_STACK_WORDS, PV_INFO_WORDS, PV_PUBIO_DIGEST,
)
from ..utils import spans
from .tables import ZKVMConfig, memory_windows
from .witgen import assign_opcode_chips, _MOCK_CHAL
from . import scheme

RAM_REGISTER = 1
RAM_MEMORY = 2


@dataclass
class ShardContext:
    shard_id: int
    n_shards: int
    step_lo: int
    step_hi: int
    in_tokens: Tokens
    out_tokens: Tokens
    pv: np.ndarray
    opcode_assigned: list  # stage-1 witness, reused by generate_witness


@dataclass
class ShardedProof:
    proofs: list        # scheme.ZKVMProof per shard
    n_shards: int = 0

    def __post_init__(self):
        self.n_shards = len(self.proofs)


def _ram_events(assigned, instances):
    """(is_reg, addr, value, ts) arrays from every produced local RAM record."""
    cols = {"is_reg": [], "addr": [], "value": [], "ts": [], "step": []}
    for a in assigned:
        k = a.num_instances
        if k == 0:
            continue
        n = a.wit.shape[1]
        structural = (
            np.stack([structural_table(s, n, instances)
                      for s in a.compiled.structural])
            if a.compiled.structural
            else np.zeros((0, n), np.uint64)
        )
        fixed = np.zeros((0, n), np.uint64)
        memo = {}
        for fields in a.cb.w_fields:
            if len(fields) != 5:
                continue  # GlobalState (3 fields) / custom buses
            vals = []
            for f in fields:
                kind, v = eval_expr_host(
                    f, a.wit, fixed, structural, instances, _MOCK_CHAL, memo
                )
                assert kind == "b"
                vals.append(
                    np.broadcast_to(np.atleast_1d(np.asarray(v, np.uint64)), (n,))[:k]
                )
            rtype = vals[0]
            keep = (rtype == RAM_REGISTER) | (rtype == RAM_MEMORY)
            if not keep.any():
                continue
            cols["is_reg"].append((rtype[keep] == RAM_REGISTER).astype(np.uint64))
            cols["addr"].append(vals[1][keep])
            cols["value"].append(vals[2][keep] + (vals[3][keep] << np.uint64(16)))
            cols["ts"].append(vals[4][keep])
            cols["step"].append(np.zeros(int(keep.sum()), np.uint64))
    if not cols["addr"]:
        return {k: np.zeros(0, np.uint64) for k in cols}
    return {k: np.concatenate(v) for k, v in cols.items()}


def plan_boundaries(
    view: TraceView,
    opcode_chips: list,
    max_cells_per_shard: int | None = None,
    max_steps_per_shard: int | None = None,
) -> list[int]:
    """Preflight shard planner: step boundaries from a per-step witness-cell
    cost model (ShardPlanBuilder mirror, tracer.rs:490-700 — each step costs
    its chip's witness-cell count, so e.g. a keccak ecall weighs ~85x an
    add). Splits when the running cell total would exceed
    ``max_cells_per_shard`` or the step count ``max_steps_per_shard``."""
    n = view.n
    cost_by_kind = {}
    for chip in opcode_chips:
        for k in chip.kinds:
            cost_by_kind[k] = cost_by_kind.get(k, 0) + (
                len(chip.cb.wit_names) * chip.rows_per_step
            )
    costs = np.array(
        [cost_by_kind.get(int(k), 32) for k in view.kind], np.int64
    )
    bounds = [0]
    cur_cells = 0
    cur_steps = 0
    for i in range(n):
        over_cells = (
            max_cells_per_shard is not None
            and cur_cells + costs[i] > max_cells_per_shard
            and cur_steps > 0
        )
        over_steps = (
            max_steps_per_shard is not None and cur_steps >= max_steps_per_shard
        )
        if over_cells or over_steps:
            bounds.append(i)
            cur_cells = 0
            cur_steps = 0
        cur_cells += costs[i]
        cur_steps += 1
    bounds.append(n)
    return bounds


def _cost_by_kind(opcode_chips: list) -> dict:
    cost = {}
    for chip in opcode_chips:
        for k in chip.kinds:
            cost[k] = cost.get(k, 0) + len(chip.cb.wit_names) * chip.rows_per_step
    return cost


def plan_boundaries_preflight(
    vm,
    opcode_chips: list,
    max_cells_per_shard: int | None = None,
    max_steps_per_shard: int | None = None,
    max_steps: int = 1 << 24,
) -> list[int]:
    """Shard plan WITHOUT a trace: run the guest through the AOT preflight
    backend (emulator/aotgen.py — basic blocks compiled to native code,
    ceno_emul/src/aot.rs role) with plan_boundaries' exact cost/boundary
    logic fused in. Identical boundaries to tracing + plan_boundaries at
    2-3 orders of magnitude more steps/s; matters once shard streams
    approach the reference's 2^29 default (e2e.rs:58-60). ``vm`` must be
    fresh (it is not mutated — the preflight runs its own native state).
    Falls back to trace + plan_boundaries without a C++ toolchain."""
    from ..emulator import native

    try:
        bounds, _counts, _steps, state = native.run_preflight(
            vm, _cost_by_kind(opcode_chips), max_cells_per_shard,
            max_steps_per_shard, max_steps,
        )
        if not state["halted"]:
            raise RuntimeError("guest did not halt within max_steps")
        return bounds
    except native.UnsupportedSyscall:
        pass
    except (RuntimeError, OSError):
        # no toolchain, unwritable cache dir, jump-table guests (-5), ...
        pass
    view = native.run_trace(vm, max_steps)
    return plan_boundaries(view, opcode_chips, max_cells_per_shard,
                           max_steps_per_shard)


def plan_shards(
    view: TraceView,
    vm,
    pk,
    cfg: ZKVMConfig,
    max_steps_per_shard: int | None = None,
    max_cells_per_shard: int | None = None,
) -> list[ShardContext]:
    """Split the trace and compute each shard's token lists + public values."""
    from ..emulator.state import CYCLE_START

    n = view.n
    bounds = plan_boundaries(
        view, pk.opcode_chips, max_cells_per_shard, max_steps_per_shard
    )
    n_shards = max(1, len(bounds) - 1)
    last = n_shards - 1

    # stage-1 witness per shard (reused later by generate_witness)
    shards = []
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        sub = view.select(np.arange(lo, hi))
        assigned = assign_opcode_chips(sub, pk.opcode_chips)
        shards.append((lo, hi, assigned))

    # all produced local RAM records, tagged by shard
    ev = {k: [] for k in ("is_reg", "addr", "value", "ts", "shard")}
    dummy_pv = np.zeros(N_PUBLIC_VALUES, np.uint64)
    for s, (lo, hi, assigned) in enumerate(shards):
        e = _ram_events(assigned, dummy_pv)
        for k in ("is_reg", "addr", "value", "ts"):
            ev[k].append(e[k])
        ev["shard"].append(np.full(e["addr"].shape[0], s, np.uint64))
    # init-table writes (shard 0, ts 0): registers + all window addrs
    reg_init_v = np.zeros(32, np.uint64)
    reg_init_v[2] = cfg.platform.stack_top - 0x100  # sp (reg_init table mirror)
    ev["is_reg"].append(np.ones(32, np.uint64))
    ev["addr"].append(np.arange(32, dtype=np.uint64))
    ev["value"].append(reg_init_v)
    ev["ts"].append(np.zeros(32, np.uint64))
    ev["shard"].append(np.zeros(32, np.uint64))
    for base, sz in memory_windows(cfg):
        vals = np.zeros(sz, np.uint64)
        for waddr, v0 in vm.mem_init.items():
            if base <= waddr < base + sz:
                vals[waddr - base] = v0
        ev["is_reg"].append(np.zeros(sz, np.uint64))
        ev["addr"].append(np.arange(base, base + sz, dtype=np.uint64))
        ev["value"].append(vals)
        ev["ts"].append(np.zeros(sz, np.uint64))
        ev["shard"].append(np.zeros(sz, np.uint64))
    # dynamic heap/stack init writes (zero value, ts 0, first shard)
    from .chips.dyn_ram import dyn_region_words

    dyn_lens = dyn_region_words(vm, cfg)
    heap_base = cfg.platform.heap_start >> 2
    info_base = cfg.platform.info_start >> 2
    stack_top = cfg.platform.stack_top >> 2
    for region, k in dyn_lens.items():
        if not k:
            continue
        if region == "heap":
            addrs = np.arange(heap_base, heap_base + k, dtype=np.uint64)
        elif region == "info":
            addrs = np.arange(info_base, info_base + k, dtype=np.uint64)
        else:
            addrs = np.arange(stack_top - k, stack_top, dtype=np.uint64)
        ev["is_reg"].append(np.zeros(k, np.uint64))
        ev["addr"].append(addrs)
        ev["value"].append(np.zeros(k, np.uint64))
        ev["ts"].append(np.zeros(k, np.uint64))
        ev["shard"].append(np.zeros(k, np.uint64))
    image = pk.data_image or {}
    if image:
        # program-image init writes incl. the table's contiguous pad rows
        # (tables._prog_data_tables geometry)
        addrs = np.array(sorted(image), np.uint64)
        count = addrs.shape[0]
        n_pad = (1 << max(1, int(count - 1).bit_length())) - count
        all_addrs = np.concatenate(
            [addrs, addrs[-1] + np.arange(1, n_pad + 1, dtype=np.uint64)]
        )
        vals = np.array([image[int(a)] for a in addrs], np.uint64)
        ev["is_reg"].append(np.zeros(all_addrs.shape[0], np.uint64))
        ev["addr"].append(all_addrs)
        ev["value"].append(np.concatenate([vals, np.zeros(n_pad, np.uint64)]))
        ev["ts"].append(np.zeros(all_addrs.shape[0], np.uint64))
        ev["shard"].append(np.zeros(all_addrs.shape[0], np.uint64))
    ev = {k: np.concatenate(v) for k, v in ev.items()}

    # per-cell chain -> tokens between consecutive holder shards
    key = ev["is_reg"] * (np.uint64(1) << np.uint64(40)) + ev["addr"]
    order = np.lexsort((ev["ts"], key))
    key_s = key[order]
    cell_starts = np.concatenate([[0], np.nonzero(key_s[1:] != key_s[:-1])[0] + 1])
    cell_ends = np.concatenate([cell_starts[1:], [key_s.shape[0]]])
    tok_in = [dict((k, []) for k in ("is_reg", "addr", "value", "shard", "clk"))
              for _ in range(n_shards)]
    tok_out = [dict((k, []) for k in ("is_reg", "addr", "value", "shard", "clk"))
               for _ in range(n_shards)]
    for st, en in zip(cell_starts, cell_ends):
        idx = order[st:en]
        shards_of = ev["shard"][idx]
        holders = sorted(set(int(x) for x in shards_of))
        if holders[-1] != last:
            holders.append(last)
        if len(holders) == 1:
            continue
        is_reg = int(ev["is_reg"][idx[0]])
        addr = int(ev["addr"][idx[0]])
        for a, b in zip(holders[:-1], holders[1:]):
            in_a = np.nonzero(shards_of == a)[0]
            j = idx[in_a[-1]]
            token = (is_reg, addr, int(ev["value"][j]), a, int(ev["ts"][j]))
            for side, shard_idx in ((tok_out, a), (tok_in, b)):
                d = side[shard_idx]
                d["is_reg"].append(token[0])
                d["addr"].append(token[1])
                d["value"].append(token[2])
                d["shard"].append(token[3])
                d["clk"].append(token[4])

    def mk_tokens(d):
        return Tokens(*(np.array(d[k], np.uint64) for k in
                        ("is_reg", "addr", "value", "shard", "clk")))

    out = []
    for s, (lo, hi, assigned) in enumerate(shards):
        t_in = mk_tokens(tok_in[s])
        t_out = mk_tokens(tok_out[s])
        pv = np.zeros(N_PUBLIC_VALUES, np.uint64)
        pv[PV_INIT_PC] = view.pc[lo] if n else vm.entry
        pv[PV_INIT_CYCLE] = view.ts[lo] if n else CYCLE_START
        if s == last:
            pv[PV_END_PC] = vm.pc
            pv[PV_END_CYCLE] = vm.cycle
            pv[PV_EXIT_CODE_LO] = vm.exit_code & 0xFFFF
            pv[PV_EXIT_CODE_HI] = (vm.exit_code >> 16) & 0xFFFF
        else:
            pv[PV_END_PC] = view.pc[hi]
            pv[PV_END_CYCLE] = view.ts[hi]
        pv[PV_SHARD_ID] = s
        pv[PV_HEAP_WORDS] = dyn_lens["heap"]
        pv[PV_STACK_WORDS] = dyn_lens["stack"]
        pv[PV_INFO_WORDS] = dyn_lens["info"]
        digest = vm.pubio_digest
        if digest is None:
            from ..emulator.keccak import KECCAK_EMPTY_WORDS

            digest = KECCAK_EMPTY_WORDS
        for i, wd in enumerate(digest):
            pv[PV_PUBIO_DIGEST + 2 * i] = wd & 0xFFFF
            pv[PV_PUBIO_DIGEST + 2 * i + 1] = (wd >> 16) & 0xFFFF
        for base_pv, tok in ((PV_RW_SUM_IN, t_in), (PV_RW_SUM_OUT, t_out)):
            if tok.n:
                _, xs, ys = tokens_to_points(tok)
                if base_pv == PV_RW_SUM_OUT:
                    ys = S.neg(ys)
                acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
                for i in range(tok.n):
                    acc = S.point_add(acc, (xs[i], ys[i]))
                pv[base_pv : base_pv + 7] = acc[0]
                pv[base_pv + 7 : base_pv + 14] = acc[1]
        out.append(ShardContext(s, n_shards, lo, hi, t_in, t_out, pv, assigned))
    return out


def prove_shards(pk, vm, records, max_steps_per_shard: int | None = None,
                 max_cells_per_shard: int | None = None,
                 pipeline: bool = True, device=None) -> ShardedProof:
    """Prove every shard on ``device`` (the card by default). With
    ``pipeline`` (default), shard N+1's witness generation runs on a host
    thread while shard N proves on the device — the P4 host<->device
    pipeline (e2e.rs:2266-2406 rendezvous-channel mirror; bounded queue
    keeps at most 2 witnesses in flight). Proofs are byte-identical to the
    sequential path: witgen has no transcript interaction, so overlap cannot
    reorder any absorb/sample. The thread runs host numpy only; every device
    launch stays on the calling thread."""
    view = records if isinstance(records, TraceView) else TraceView.from_records(records)
    with spans.span("plan-shards"):
        ctxs = plan_shards(view, vm, pk, pk.cfg, max_steps_per_shard,
                           max_cells_per_shard)
    from .witgen import generate_witness

    def witgen(ctx):
        with spans.span("witgen"):
            return generate_witness(
                None, pk.opcode_chips, pk.tables, vm, ctx.pv, pk.cfg,
                shard_ctx=ctx, shard_chips=pk.shard_chips,
                dyn_chips=pk.dyn_chips, opcode_assigned=ctx.opcode_assigned,
                data_image=pk.data_image,
            )

    proofs = []
    if pipeline and len(ctxs) > 1:
        import queue
        import threading

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def producer():
            try:
                for ctx in ctxs:
                    if stop.is_set():
                        return
                    q.put((ctx, witgen(ctx), None))
            except BaseException as e:  # surface witgen errors in the consumer
                q.put((None, None, e))

        th = threading.Thread(target=producer, daemon=True)
        th.start()
        try:
            for _ in ctxs:
                ctx, assigned, err = q.get()
                if err is not None:
                    raise err
                with spans.span(f"shard/{ctx.shard_id}"):
                    proofs.append(
                        scheme.prove(pk, vm, None, ctx.pv, shard_ctx=ctx,
                                     assigned=assigned, device=device)
                    )
        finally:
            # a failed prove leaves the producer blocked on the full queue
            stop.set()
            while th.is_alive():
                try:
                    q.get(timeout=0.1)
                except queue.Empty:
                    pass
            th.join()
    else:
        for ctx in ctxs:
            with spans.span(f"shard/{ctx.shard_id}"):
                proofs.append(
                    scheme.prove(pk, vm, None, ctx.pv, shard_ctx=ctx,
                                 opcode_assigned=ctx.opcode_assigned,
                                 device=device)
                )
    return ShardedProof(proofs)


class ShardChainError(scheme.ZKVMError):
    pass


def verify_shards(vk, sproof: ShardedProof, expect_halt: bool = True) -> bool:
    """Stitching verifier (verifier.rs:398-475 mirror): per-shard proofs,
    public-value chaining, and the global EC-sum infinity check."""
    n_shards = len(sproof.proofs)
    if n_shards == 0:
        raise ShardChainError("no shards")
    acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    prev_pv = None
    for s, proof in enumerate(sproof.proofs):
        pv = np.asarray(proof.public_values, np.uint64)
        if int(pv[PV_SHARD_ID]) != s:
            raise ShardChainError(f"shard {s}: wrong shard id {pv[PV_SHARD_ID]}")
        if prev_pv is not None:
            if pv[PV_INIT_PC] != prev_pv[PV_END_PC]:
                raise ShardChainError(f"shard {s}: pc chain broken")
            if pv[PV_INIT_CYCLE] != prev_pv[PV_END_CYCLE]:
                raise ShardChainError(f"shard {s}: cycle chain broken")
            if (
                pv[PV_HEAP_WORDS] != prev_pv[PV_HEAP_WORDS]
                or pv[PV_STACK_WORDS] != prev_pv[PV_STACK_WORDS]
                or pv[PV_INFO_WORDS] != prev_pv[PV_INFO_WORDS]
            ):
                raise ShardChainError(f"shard {s}: dynamic RAM length mismatch")
            if not np.array_equal(
                pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
                prev_pv[PV_PUBIO_DIGEST:PV_PUBIO_DIGEST + 16],
            ):
                raise ShardChainError(f"shard {s}: pubio digest mismatch")
        scheme.verify(
            vk, proof, is_first=(s == 0), is_last=(s == n_shards - 1),
            standalone=False, expect_halt=expect_halt,
        )
        for base_pv in (PV_RW_SUM_IN, PV_RW_SUM_OUT):
            pt = (pv[base_pv : base_pv + 7], pv[base_pv + 7 : base_pv + 14])
            acc = S.point_add(acc, pt)
        prev_pv = pv
    if not S.is_infinity(*acc):
        raise ShardChainError("cross-shard RAM EC sum is not the identity")
    return True
