"""Per-circuit statistics reporting.

Role mirror of the reference's ``riscv_stats`` tool
(ceno_zkvm/src/bin/riscv_stats.rs + stats.rs:17-244 — SURVEY.md §5): a
static per-chip report (witness columns, read/write/lookup record counts,
zero-constraint degree histogram, main-sumcheck term count) plus, given a
guest trace, dynamic counts (num_instances, padded rows) and a proof-size
breakdown. Exposed as ``python -m ceno_tpu_torch stats``.

Copy of ``ceno_tpu/utils/stats.py`` over the port's chips, tables and
serializer: ``format_table`` gives the reference's text character for
character.
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field


@dataclass
class CircuitStats:
    name: str
    kind: str                  # opcode | table | shard | dyn_ram
    witnesses: int = 0
    fixed: int = 0
    structural: int = 0
    reads: int = 0
    writes: int = 0
    lookups: int = 0
    zeros: int = 0
    zero_degrees: dict = field(default_factory=dict)
    main_terms: int = 0
    num_instances: int | None = None
    padded_rows: int | None = None


def _expr_degree(terms) -> int:
    return max((len(t.cols) for t in terms), default=0)


def circuit_stats(name: str, cb, compiled, kind: str) -> CircuitStats:
    from ..mle import expression as E

    degs = Counter()
    for zname, expr in cb.zeros:
        degs[_expr_degree(E.to_terms(expr))] += 1
    return CircuitStats(
        name=name,
        kind=kind,
        witnesses=len(cb.wit_names),
        fixed=len(cb.fixed_names),
        structural=len(cb.structural),
        reads=len(cb.r_records),
        writes=len(cb.w_records),
        lookups=len(cb.lk_records),
        zeros=len(cb.zeros),
        zero_degrees=dict(sorted(degs.items())),
        main_terms=sum(len(s.terms) for s in compiled.slots),
    )


def report(opcode_chips, shard_chips, dyn_chips, tables, assigned=None) -> list:
    """CircuitStats per registry chip; dynamic fields filled from an
    assigned witness list when provided."""
    out = []
    kinds = (
        [("opcode", c.name, c.cb, c.compiled) for c in opcode_chips]
        + [("shard", c.name, c.cb, c.compiled) for c in shard_chips]
        + [("dyn_ram", c.name, c.cb, c.compiled) for c in dyn_chips]
        + [("table", t.name, t.cb, t.compiled) for t in tables]
    )
    by_name = {}
    for kind, name, cb, compiled in kinds:
        st = circuit_stats(name, cb, compiled, kind)
        by_name[name] = st
        out.append(st)
    if assigned is not None:
        for a in assigned:
            st = by_name.get(a.name)
            if st is not None:
                st.num_instances = a.num_instances
                st.padded_rows = a.n_rows
    return out


def format_table(stats: list, only_active: bool = False) -> str:
    rows = [
        ("circuit", "kind", "wit", "fix", "r", "w", "lk", "zero",
         "terms", "inst", "rows")
    ]
    tot = [0] * 7
    for s in stats:
        if only_active and not s.num_instances:
            continue
        rows.append((
            s.name, s.kind, str(s.witnesses), str(s.fixed), str(s.reads),
            str(s.writes), str(s.lookups), str(s.zeros), str(s.main_terms),
            "" if s.num_instances is None else str(s.num_instances),
            "" if s.padded_rows is None else str(s.padded_rows),
        ))
        for i, v in enumerate((s.witnesses, s.fixed, s.reads, s.writes,
                               s.lookups, s.zeros, s.main_terms)):
            tot[i] += v
    rows.append(("TOTAL", "", *[str(v) for v in tot], "", ""))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, r in enumerate(rows):
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip())
        if i == 0:
            lines.append("-" * (sum(widths) + 2 * (len(widths) - 1)))
    return "\n".join(lines)


def proof_size_breakdown(proof) -> dict:
    """Bytes per proof component (serialized sizes)."""
    from ..zkvm.serialize import _encode
    import io

    def nbytes(obj) -> int:
        buf = io.BytesIO()
        _encode(buf, obj, 0)
        return buf.tell()

    out = {
        "public_values": nbytes(proof.public_values),
        "witness_roots": nbytes(proof.witness_roots),
        "tower_groups": nbytes(proof.tower_groups),
        "class_main": nbytes(proof.class_main),
        "ec_proofs": nbytes(proof.ec_proofs),
        "witness_openings": nbytes(proof.witness_openings),
        "fixed_openings": nbytes(proof.fixed_openings),
    }
    out["total"] = sum(out.values())
    return out
