"""Dynamic RAM chips: heap and stack init/final halves with DYNAMIC length.

Role mirror of the reference's ``DynVolatileRamTable`` family
(ceno_zkvm/src/tables/ram/ram_circuit.rs:61-344): a volatile RAM region is a
contiguous word-address run whose LENGTH is chosen per execution — the heap
grows up from ``heap_start``, the stack grows down from ``stack_top``. Rows
are zero-initialised (write value 0 at ts 0) and read back at their final
value/timestamp; the address column is structural (start + step*i, verifier
evaluated), so only the row count is dynamic.

Unlike the static window tables these are NON-table chips: ``num_instances``
varies per proof and records are prefix-selector gated like opcode chips.
The verifier pins each chip's instance count to the shared public value
(PV_HEAP_WORDS / PV_STACK_WORDS) so the init half (first shard) and final
half (last shard) cover the same cells even when they live in different
shard proofs.

Copy of ``ceno_tpu/zkvm/chips/dyn_ram.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...fields import babybear as bb
from ...gkr.chip import compile_chip
from ...gkr.circuit_builder import (
    CircuitBuilder,
    StructuralSpec,
    RAM_MEMORY,
)
from ...mle import expression as E
from ..layout import PV_HEAP_WORDS, PV_STACK_WORDS


@dataclass
class DynRamDef:
    name: str
    kind: str        # 'dyn_ram_init' | 'dyn_ram_final'
    gate: str        # 'first' | 'last'
    region: str      # 'heap' | 'stack'
    pv_slot: int
    cb: CircuitBuilder
    compiled: object
    base: int        # first word address (heap: low end; stack: top-1)
    step: int        # +1 (heap) or -1 (stack)


def _region_geometry(cfg, region: str):
    if region == "heap":
        return cfg.platform.heap_start >> 2, 1, PV_HEAP_WORDS
    if region == "info":
        from ..layout import PV_INFO_WORDS

        return cfg.platform.info_start >> 2, 1, PV_INFO_WORDS
    return (cfg.platform.stack_top >> 2) - 1, -1, PV_STACK_WORDS


def _build(cfg, region: str, half: str) -> DynRamDef:
    base, step, slot = _region_geometry(cfg, region)
    name = f"dyn_{region}_{half}"
    cb = CircuitBuilder(name)
    addr = cb.create_structural(
        StructuralSpec("incremental", start=base, step=step % bb.P)
    )
    if half == "init":
        unused = cb.create_witin("unused")
        cb.require_zero("unused_zero", unused)
        cb.write_record([E.Const(RAM_MEMORY), addr, E.Const(0), E.Const(0),
                         E.Const(0)])
        gate, kind = "first", "dyn_ram_init"
    else:
        f_lo = cb.create_witin("final_lo")
        f_hi = cb.create_witin("final_hi")
        f_ts = cb.create_witin("final_ts")
        cb.read_record([E.Const(RAM_MEMORY), addr, f_lo, f_hi, f_ts])
        gate, kind = "last", "dyn_ram_final"
    return DynRamDef(name, kind, gate, region, slot, cb, compile_chip(cb),
                     base, step)


def build_dyn_ram_chips(cfg) -> list:
    return [
        _build(cfg, "heap", "init"),
        _build(cfg, "heap", "final"),
        _build(cfg, "stack", "init"),
        _build(cfg, "stack", "final"),
        _build(cfg, "info", "init"),
        _build(cfg, "info", "final"),
    ]


def dyn_regions(cfg) -> list:
    """[(low_word, high_word_exclusive, region)] covered dynamically."""
    return [
        (cfg.platform.heap_start >> 2, cfg.platform.info_start >> 2, "heap"),
        (cfg.platform.stack_start >> 2, cfg.platform.stack_top >> 2, "stack"),
        (cfg.platform.info_start >> 2, cfg.platform.info_end >> 2, "info"),
    ]


def dyn_region_words(vm, cfg) -> dict:
    """region -> word count covering every access, from the final VM state."""
    words = set(vm.touched) | set(vm.mem_init)
    out = {}
    for low, high, region in dyn_regions(cfg):
        used = [w for w in words if low <= w < high]
        if not used:
            out[region] = 0
        elif region == "stack":
            out[region] = high - min(used)
        else:  # heap/info grow upward
            out[region] = max(used) - low + 1
    return out


def assign_dyn_ram(chip: DynRamDef, vm, k: int) -> np.ndarray:
    """Witness matrix (n_wit, pad) for a dyn RAM chip with k instances."""
    n_pad = max(2, 1 << max(0, int(k - 1).bit_length()))
    wit = np.zeros((len(chip.cb.wit_names), n_pad), np.uint64)
    if chip.kind == "dyn_ram_final" and k:
        addrs = chip.base + chip.step * np.arange(k)
        lo = np.zeros(k, np.uint64)
        hi = np.zeros(k, np.uint64)
        ts = np.zeros(k, np.uint64)
        for i, a in enumerate(addrs.tolist()):
            v = vm.mem.get(a, 0)
            lo[i], hi[i] = v & 0xFFFF, v >> 16
            ts[i] = vm.mem_ts.get(a, 0)
        names = chip.cb.wit_names
        wit[names.index("final_lo"), :k] = lo
        wit[names.index("final_hi"), :k] = hi
        wit[names.index("final_ts"), :k] = ts
    return wit
