"""Host RISC-V (rv32im) emulator: decode, VM state, tracer, guest programs."""

from . import rv32im, state, programs  # noqa: F401
from .state import VMState, StepRecord, Platform, make_program  # noqa: F401
