"""Hierarchical span timing for the proving pipeline.

Copy of ``ceno_tpu/utils/spans.py``: nested named spans with wall-clock
totals and call counts, collected into a tree report. Zero-cost when disabled
(the default). Host wall clock only: a span around device work measures the
device time only where the code inside it waits for the device (a copy to the
host or ``torch.cuda.synchronize()``). Each thread nests its spans on a stack
of its own, so a span opened on a worker thread (the sharded prover's witgen,
``zkvm/shard.prove_shards``) starts at the tree's root; a lock guards the
tree, which the threads share.

Usage::

    from ceno_tpu_torch.utils import spans
    spans.enable()
    with spans.span("prove"):
        with spans.span("commit"):
            ...
    print(spans.report())
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

_enabled = False
_local = threading.local()  # .stack: this thread's open spans
_tree: dict = {}
_lock = threading.Lock()


def enable() -> None:
    global _enabled, _tree, _local
    _enabled = True
    _tree = {}
    _local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def span(name: str):
    if not _enabled:
        yield
        return
    stack = _stack()
    node = _node(name, stack)
    stack.append(node)
    t0 = time.time()
    try:
        yield
    finally:
        with _lock:
            node["total"] += time.time() - t0
            node["count"] += 1
        stack.pop()


def _node(name: str, stack: list) -> dict:
    children = stack[-1]["children"] if stack else _tree
    with _lock:
        return children.setdefault(name, {"total": 0.0, "count": 0, "children": {}})


def report(min_seconds: float = 0.01) -> str:
    lines = []

    def walk(children, depth):
        for name, node in sorted(
            children.items(), key=lambda kv: -kv[1]["total"]
        ):
            if node["total"] < min_seconds:
                continue
            lines.append(
                f"{'  ' * depth}{name}: {node['total']:.2f}s"
                + (f" x{node['count']}" if node["count"] > 1 else "")
            )
            walk(node["children"], depth + 1)

    walk(_tree, 0)
    return "\n".join(lines)


def tree() -> dict:
    return _tree
