"""Host-side guest IO: hints serialization (CenoStdin mirror) + println.

Copy of ``ceno_tpu/host/__init__.py``: the port keeps its own, with the same
relative imports.
"""

from .stdin import CenoStdin, from_words, to_item_words  # noqa: F401
from .messages import read_all_messages, run  # noqa: F401
