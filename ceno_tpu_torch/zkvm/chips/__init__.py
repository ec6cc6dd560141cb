"""Opcode chip circuits + witgen: the chips of ``opcodes.py``.

The reference's ``build_all_chips`` also registers the chips of
``opcodes2.py``, ``opcodes3.py`` and the precompiles; those are not ported yet.
"""

from . import common, opcodes  # noqa: F401
