"""Opcode chip circuits + witgen.

Copy of ``ceno_tpu/zkvm/chips/__init__.py``: the port keeps its own, with the same
relative imports.
"""

from . import common, opcodes, opcodes2, opcodes3  # noqa: F401


_CHIP_CACHE = None


def build_all_chips():
    """Full opcode registry in canonical proving order (Rv32imConfig mirror:
    rv32im opcodes, then the precompile ecall/core pairs). The registry is
    program-independent, so it is built once per process — expression
    expansion for the keccak core chip alone costs seconds."""
    global _CHIP_CACHE
    if _CHIP_CACHE is None:
        from .keccak import build_keccak_core_chip, build_keccak_ecall_chip
        from .pubio import build_pubio_commit_chip
        from .sha256 import build_sha_extend_chip
        from .u256 import build_uint256_mul_chip
        from .weierstrass import build_curve_chips

        _CHIP_CACHE = (
            opcodes.build_opcode_chips()
            + opcodes2.build_extended_chips()
            + opcodes3.build_mul_chips()
            + [build_keccak_ecall_chip(), build_keccak_core_chip(),
               build_pubio_commit_chip(), build_sha_extend_chip(),
               build_uint256_mul_chip()]
            + build_curve_chips()
        )
    return _CHIP_CACHE
