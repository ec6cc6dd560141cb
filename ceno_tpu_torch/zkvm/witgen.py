"""Witness generation for the opcode chips: trace rows -> per-chip matrices.

Counterpart of ``ceno_tpu/zkvm/witgen.py``, its first stage only
(``AssignedChip``, ``_pad_pow2`` and ``assign_opcode_chips``): dispatch traced
steps to opcode chips by instruction kind and fill each chip's witness
matrix, canonical numpy ``uint64`` on the host as in the reference. The
lookup multiplicities and the table chips (``generate_witness``) need
``zkvm/tables.py`` and are not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .chips.opcodes import ChipDef


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
