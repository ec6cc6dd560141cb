"""End-to-end pipeline: emulate -> witgen -> prove -> verify.

Role mirror of the reference's run_e2e_with_checkpoint (e2e.rs:2035,
SURVEY.md §3.1), single-shard: run the guest on the host emulator, derive
public values, generate witness, prove on the card, verify on host.

Counterpart of ``ceno_tpu/zkvm/e2e.py``. ``run_e2e`` and the checkpointed
pipeline take ``device`` (the card unless the caller names another) for
keygen and prove. Like the reference they emulate through
``native.run_trace``, which falls back to the Python interpreter where the
native core does not build; a caller that must not fall back composes the
stages itself from ``native.run_trace_native``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..emulator.state import VMState, CYCLE_START
from .layout import (
    PV_INIT_PC, PV_END_PC, PV_INIT_CYCLE, PV_END_CYCLE,
    PV_EXIT_CODE_LO, PV_EXIT_CODE_HI, PV_HEAP_WORDS, PV_STACK_WORDS,
    PV_INFO_WORDS,
    PV_PUBIO_DIGEST,
    N_PUBLIC_VALUES,
)
from .tables import ZKVMConfig
from .scheme import keygen, prove, verify, ProvingKey, ZKVMProof
from ..pcs.basefold import BasefoldParams


def public_values_from_vm(vm: VMState, cfg: ZKVMConfig | None = None) -> np.ndarray:
    from .chips.dyn_ram import dyn_region_words

    cfg = cfg or ZKVMConfig(platform=vm.platform)
    pv = np.zeros(N_PUBLIC_VALUES, np.uint64)
    pv[PV_INIT_PC] = vm.entry
    pv[PV_INIT_CYCLE] = CYCLE_START
    pv[PV_END_PC] = vm.pc
    pv[PV_END_CYCLE] = vm.cycle
    pv[PV_EXIT_CODE_LO] = vm.exit_code & 0xFFFF
    pv[PV_EXIT_CODE_HI] = (vm.exit_code >> 16) & 0xFFFF
    lens = dyn_region_words(vm, cfg)
    pv[PV_HEAP_WORDS] = lens["heap"]
    pv[PV_STACK_WORDS] = lens["stack"]
    pv[PV_INFO_WORDS] = lens["info"]
    digest = vm.pubio_digest
    if digest is None:
        from ..emulator.keccak import KECCAK_EMPTY_WORDS

        digest = KECCAK_EMPTY_WORDS
    for i, w in enumerate(digest):
        pv[PV_PUBIO_DIGEST + 2 * i] = w & 0xFFFF
        pv[PV_PUBIO_DIGEST + 2 * i + 1] = (w >> 16) & 0xFFFF
    return pv


@dataclass
class E2EResult:
    pk: ProvingKey
    proof: ZKVMProof
    public_values: np.ndarray
    n_steps: int


def run_e2e(
    vm: VMState,
    cfg: ZKVMConfig | None = None,
    params: BasefoldParams | None = None,
    max_steps: int = 1 << 24,
    pk: ProvingKey | None = None,
    data_image: dict | None = None,
    device=None,
) -> E2EResult:
    from ..emulator import native

    trace = native.run_trace(vm, max_steps)  # native core when available
    assert vm.halted, "guest did not halt"
    pv = public_values_from_vm(vm, cfg)
    if pk is None:
        pk = keygen(vm.program, cfg, params, data_image=data_image, device=device)
    proof = prove(pk, vm, trace, pv, device=device)
    return E2EResult(pk, proof, pv, trace.n)


# ---------------------------------------------------------------------------
# Checkpointed pipeline (run_e2e_with_checkpoint mirror, e2e.rs:1869-1875,
# 2035: Checkpoint::{PrepE2EProving, PrepWitnessGen, PrepVerify, Complete})
# ---------------------------------------------------------------------------

import enum


class Checkpoint(enum.Enum):
    """Stop points for the staged pipeline: each stage returns a resumable
    state so setup, emulation, witgen+prove, and verify can be timed or
    distributed independently (the reference uses this to split keygen-time
    work from proving services)."""

    PREP_E2E_PROVING = "prep_e2e_proving"   # stop after keygen
    PREP_WITNESS_GEN = "prep_witness_gen"   # stop after emulation
    PREP_VERIFY = "prep_verify"             # stop after proving
    COMPLETE = "complete"                   # prove AND verify


@dataclass
class CheckpointState:
    checkpoint: Checkpoint
    cfg: ZKVMConfig
    params: BasefoldParams
    vm: VMState = None
    pk: ProvingKey = None
    trace: object = None
    public_values: np.ndarray = None
    proof: ZKVMProof = None
    verified: bool = False
    device: str | None = None
    max_steps: int = 1 << 24

    def resume(self, to: "Checkpoint" = Checkpoint.COMPLETE) -> "CheckpointState":
        return _advance(self, to)


def run_e2e_with_checkpoint(
    vm: VMState,
    cfg: ZKVMConfig | None = None,
    params: BasefoldParams | None = None,
    checkpoint: Checkpoint = Checkpoint.COMPLETE,
    max_steps: int = 1 << 24,
    device=None,
) -> CheckpointState:
    st = CheckpointState(
        Checkpoint.PREP_E2E_PROVING, cfg or ZKVMConfig(),
        params or BasefoldParams(), vm=vm, device=device, max_steps=max_steps,
    )
    st.pk = keygen(vm.program, st.cfg, st.params, device=device)
    if checkpoint == Checkpoint.PREP_E2E_PROVING:
        return st
    return _advance(st, checkpoint)


def _advance(st: CheckpointState, to: Checkpoint) -> CheckpointState:
    from ..emulator import native

    order = list(Checkpoint)
    while order.index(st.checkpoint) < order.index(to):
        cur = st.checkpoint
        if cur == Checkpoint.PREP_E2E_PROVING:
            st.trace = native.run_trace(st.vm, st.max_steps)
            assert st.vm.halted, "guest did not halt"
            st.public_values = public_values_from_vm(st.vm, st.cfg)
            st.checkpoint = Checkpoint.PREP_WITNESS_GEN
        elif cur == Checkpoint.PREP_WITNESS_GEN:
            st.proof = prove(st.pk, st.vm, st.trace, st.public_values,
                             device=st.device)
            st.checkpoint = Checkpoint.PREP_VERIFY
        else:  # PREP_VERIFY -> COMPLETE
            st.verified = verify(st.pk.vk, st.proof)
            st.checkpoint = Checkpoint.COMPLETE
    return st
