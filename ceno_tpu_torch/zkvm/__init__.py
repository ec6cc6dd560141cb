"""zkVM layer: the public-value layout, the chip and table registry and its
witgen, the scheme (keygen, prove, verify), proof serialization and the
end-to-end pipeline.
"""

from . import layout, tables, witgen, scheme, e2e  # noqa: F401
