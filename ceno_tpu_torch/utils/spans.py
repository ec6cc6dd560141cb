"""Hierarchical span timing for the proving pipeline.

Copy of ``ceno_tpu/utils/spans.py``: nested named spans with wall-clock
totals and call counts, collected into a tree report. Zero-cost when disabled
(the default). Host wall clock only: a span around device work measures the
device time only where the code inside it waits for the device (a copy to the
host or ``torch.cuda.synchronize()``).

Usage::

    from ceno_tpu_torch.utils import spans
    spans.enable()
    with spans.span("prove"):
        with spans.span("commit"):
            ...
    print(spans.report())
"""

from __future__ import annotations

import time
from contextlib import contextmanager

_enabled = False
_stack: list = []
_tree: dict = {}


def enable() -> None:
    global _enabled, _tree, _stack
    _enabled = True
    _tree = {}
    _stack = []


def disable() -> None:
    global _enabled
    _enabled = False


@contextmanager
def span(name: str):
    if not _enabled:
        yield
        return
    node = _node(name)
    _stack.append(node)
    t0 = time.time()
    try:
        yield
    finally:
        node["total"] += time.time() - t0
        node["count"] += 1
        _stack.pop()


def _node(name: str) -> dict:
    children = _stack[-1]["children"] if _stack else _tree
    if name not in children:
        children[name] = {"total": 0.0, "count": 0, "children": {}}
    return children[name]


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
