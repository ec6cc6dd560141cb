"""Witness generation: trace records -> per-chip trace matrices + multiplicities.

Role mirror of the reference's witgen stage (generate_witness, e2e.rs:1392 and
Instruction::assign_instances, SURVEY.md §3.1): dispatch traced steps to opcode
chips by instruction kind, fill each chip's witness matrix, count lookup
multiplicities (LkMultiplicity mirror) by evaluating every chip's lookup field
expressions over its assigned rows, then assign the table chips from the
counts + final VM state.

Sharded mode (shard_ctx set): opcode chips see only the shard's step slice,
the shard-RAM / EC-tree chips are assigned from the shard's token lists, and
the RAM init/final tables are gated to the first/last shard (inactive tables
prove with num_instances = 0 — all rows padding).

Port of ``ceno_tpu/zkvm/witgen.py``, with the same relative imports. It is
host numpy and launches nothing on the card, so ``zkvm/shard.prove_shards``
runs it on a host thread. The reference's hooks for the Goldilocks package's
shard assigners (``assign_shard_fn`` / ``assign_tree_fn``) come with that
package (M13). Unlike the reference, ``generate_witness`` times three of its
steps in spans (``opcode-chips``, ``lookup-counts``, ``tables``).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass

import numpy as np

from ..gkr.mock import eval_expr_host
from ..gkr.chip import structural_table
from ..utils import spans
from .chips.opcodes import ChipDef
from .tables import TableDef, WitgenCtx, ZKVMConfig


@dataclass
class AssignedChip:
    name: str
    compiled: object
    cb: object
    wit: np.ndarray          # (n_wit, N) canonical, padded to pow2
    num_instances: int
    n_rows: int              # padded height
    is_table: bool
    kind: str = "opcode"     # 'opcode' | 'table' | shard-chip kinds
    ec_final_sum: object = None  # (2, 7) for ec_tree chips


def _pad_pow2(m: np.ndarray, k: int) -> np.ndarray:
    n = max(2, 1 << max(0, (k - 1).bit_length()))
    if m.shape[1] < n:
        m = np.pad(m, ((0, 0), (0, n - m.shape[1])))
    return m


def _lk_counts(cb, compiled, wit, instances, k, counts: dict):
    """Evaluate chip-side lookup fields over active rows; bump counters."""
    n = wit.shape[1] if wit.size else 2
    structural = (
        np.stack([structural_table(s, n, instances)
                  for s in compiled.structural])
        if compiled.structural
        else np.zeros((0, n), np.uint64)
    )
    fixed = np.zeros((0, n), np.uint64)  # lookups never reference fixed cols here
    memo = {}
    for tag, fields in cb.lk_fields:
        vals = []
        for f in fields:
            kind, v = eval_expr_host(f, wit, fixed, structural, instances, _MOCK_CHAL, memo)
            assert kind == "b", "lookup fields must be base-valued"
            vals.append(np.broadcast_to(np.atleast_1d(np.asarray(v, np.uint64)), (n,)))
        tagc = counts.setdefault(tag, Counter())
        stacked = np.stack(vals, axis=1)[:k]  # (k, n_fields)
        # pack rows into one uint64 key when the widths fit: 1D unique is
        # ~5x faster than the structured axis=0 sort on the hot tables
        widths = [
            max(1, int(stacked[:, j].max()).bit_length())
            for j in range(stacked.shape[1])
        ]
        if sum(widths) <= 63:
            keys = np.zeros(k, np.uint64)
            for j, w_ in enumerate(widths):
                keys = (keys << np.uint64(w_)) | stacked[:, j]
            if sum(widths) <= 20:
                # narrow key space: O(n) bincount beats the unique sort
                counts_arr = np.bincount(
                    keys.astype(np.int64), minlength=1 << sum(widths)
                )
                uk = np.nonzero(counts_arr)[0].astype(np.uint64)
                cnt = counts_arr[uk.astype(np.int64)]
            else:
                uk, cnt = np.unique(keys, return_counts=True)
            for key, c in zip(uk, cnt):
                key = int(key)
                row = []
                for w_ in reversed(widths):
                    row.append(key & ((1 << w_) - 1))
                    key >>= w_
                tagc[tuple(reversed(row))] += int(c)
        else:
            uniq, cnt = np.unique(stacked, axis=0, return_counts=True)
            for row, c in zip(uniq, cnt):
                tagc[tuple(int(x) for x in row)] += int(c)


_MOCK_CHAL = np.array([[5, 7, 11, 13], [17, 19, 23, 29]], np.uint64)


def assign_opcode_chips(view, opcode_chips: list[ChipDef]):
    """Stage 1: fill opcode-chip matrices from a (possibly sliced) trace view.

    Lookup counting is deferred (stage 2) so the shard planner can run on the
    assigned matrices in between."""
    covered = np.zeros(view.n, bool)
    assigned = []
    for chip in opcode_chips:
        mask = np.isin(view.kind, np.array(chip.kinds, np.int64))
        covered |= mask
        idx = np.nonzero(mask)[0]
        k = len(idx) * chip.rows_per_step
        n_pad = max(2, 1 << max(0, (k - 1).bit_length()))
        wit = chip.assign(view.select(idx), pad_to=n_pad) if k else np.zeros(
            (len(chip.cb.wit_names), 0), np.uint64
        )
        wit = _pad_pow2(wit, k)
        assigned.append(
            AssignedChip(chip.name, chip.compiled, chip.cb, wit, k, wit.shape[1], False)
        )
    assert covered.all(), (
        f"steps with no chip: kinds {set(view.kind[~covered].tolist())}"
    )
    return assigned


def _table_active(gate: str, shard_ctx) -> bool:
    if gate == "always" or shard_ctx is None:
        return True
    if gate == "first":
        return shard_ctx.shard_id == 0
    return shard_ctx.shard_id == shard_ctx.n_shards - 1


def generate_witness(
    records,
    opcode_chips: list[ChipDef],
    tables: list[TableDef],
    vm,
    instances: np.ndarray,
    cfg: ZKVMConfig,
    shard_ctx=None,
    shard_chips: list | None = None,
    dyn_chips: list | None = None,
    opcode_assigned: list | None = None,
    data_image: dict | None = None,
):
    """Returns the assigned list in registry order: opcode chips, shard
    chips (if any), dynamic-RAM chips (if any), then tables.
    ``opcode_assigned`` lets the sharded driver reuse matrices it already
    built for planning."""
    from .chips.opcodes import TraceView

    if opcode_assigned is None:
        view = records if isinstance(records, TraceView) else TraceView.from_records(records)
        with spans.span("opcode-chips"):
            opcode_assigned = assign_opcode_chips(view, opcode_chips)
    assigned = list(opcode_assigned)
    counts: dict = {}
    with spans.span("lookup-counts"):
        for a in assigned:
            if a.num_instances:
                _lk_counts(a.cb, a.compiled, a.wit, instances, a.num_instances, counts)

    if shard_chips:
        from .chips.shard_ram import assign_shard_ram, assign_ec_tree, Tokens

        tok_in = shard_ctx.in_tokens if shard_ctx else Tokens.empty()
        tok_out = shard_ctx.out_tokens if shard_ctx else Tokens.empty()
        for chip in shard_chips:
            tok = tok_in if chip.kind.endswith("_in") else tok_out
            fsum = None
            if chip.kind.startswith("shard_ram"):
                wit = assign_shard_ram(chip, tok)
            else:
                wit, fsum = assign_ec_tree(chip, tok)
            k = tok.n
            a = AssignedChip(
                chip.name, chip.compiled, chip.cb, wit, k, wit.shape[1],
                False, kind=chip.kind, ec_final_sum=fsum,
            )
            if k:
                _lk_counts(chip.cb, chip.compiled, wit, instances, k, counts)
            assigned.append(a)

    if dyn_chips:
        from .chips.dyn_ram import assign_dyn_ram, dyn_region_words

        lens = dyn_region_words(vm, cfg)
        pv = np.asarray(instances, np.uint64)
        for chip in dyn_chips:
            active = _table_active(chip.gate, shard_ctx)
            k = int(pv[chip.pv_slot]) if active else 0
            if active and k < lens[chip.region]:
                raise AssertionError(
                    f"{chip.name}: public {chip.region} length {k} does not "
                    f"cover the {lens[chip.region]} accessed words"
                )
            wit = assign_dyn_ram(chip, vm, k)
            assigned.append(
                AssignedChip(chip.name, chip.compiled, chip.cb, wit, k,
                             wit.shape[1], False, kind=chip.kind)
            )

    # every touched/initialized address must be covered by a RAM window,
    # a dynamic region, or the program image
    from .chips.dyn_ram import dyn_regions
    from .tables import memory_windows

    windows = memory_windows(cfg)
    regions = dyn_regions(cfg)
    image = data_image or {}
    for waddr in set(vm.touched) | set(vm.mem_init):
        if waddr in image:
            continue
        if any(b <= waddr < b + sz for b, sz in windows):
            continue
        if any(lo <= waddr < hi for lo, hi, _ in regions):
            continue
        raise AssertionError(
            f"memory access at word {waddr:#x} outside all RAM regions"
        )

    ctx = WitgenCtx(counts, vm, None, cfg)
    with spans.span("tables"):
        for t in tables:
            if _table_active(t.gate, shard_ctx):
                wit = t.assign(ctx)
                k = t.n_rows
            else:
                # inactive shard-gated table: all rows padding, but keep the full
                # height so its fixed columns open against the keygen commitment
                wit = np.zeros((len(t.cb.wit_names), t.n_rows), np.uint64)
                k = 0
            wit = _pad_pow2(wit, t.n_rows)
            assigned.append(
                AssignedChip(
                    t.name, t.compiled, t.cb, wit, k, wit.shape[1], True, kind="table"
                )
            )
    return assigned
