"""zkVM layer: public-value layout, the opcode chips and their witgen.

The scheme (keygen, prove, verify), the table chips and serialization are not
ported yet.
"""

from . import layout, witgen  # noqa: F401
