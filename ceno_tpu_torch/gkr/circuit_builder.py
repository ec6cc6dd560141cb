"""Circuit DSL: the constraint system chips are built from.

Role mirror of the reference's ``CircuitBuilder``/``ConstraintSystem``
(gkr_iop/src/circuit_builder.rs:102,572 — SURVEY.md §2.2): a chip declares
witness/fixed/structural columns, read/write/lookup records (RLC'd with the
global transcript challenges), and named zero constraints. The offline
memory-checking conventions follow chip_handler (SURVEY.md §2.3): a read of
(id, v) at time ts emits read-record (ram_type, id, v, prev_ts) AND
write-record (ram_type, id, v, ts), with ts ordering enforced by range lookups.

Padding contract (fixed for the whole framework): witness columns are
zero-padded to a power of two. Tower inputs are the PADDED record expressions
  product records:   sel*(rec - 1) + 1        (padding rows contribute 1)
  lookup chip side:  p = sel, q = sel*(rec - 1) + 1   (padding adds 0/1)
  lookup table side: p = -mult * sel, q = sel*(rec - 1) + 1
where sel is the prefix selector (1 on the first num_instances rows). The
main zerocheck then proves claims of the shape sel_eq*(rec - 1) = claim - 1
(the reference's zerocheck_layer.rs:121-133 trick) plus the named zero
constraints batched with alpha powers.

Copy of ``ceno_tpu/gkr/circuit_builder.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..mle import expression as E

# RLC challenge ids (transcript order fixed in zkvm scheme)
ALPHA = E.Challenge(0)
BETA = E.Challenge(1)

# RAM types (mirror of gkr_iop RAMType, SURVEY.md §2.2)
RAM_GLOBAL_STATE = 0
RAM_REGISTER = 1
RAM_MEMORY = 2
RAM_CUSTOM = 3

# Lookup table tags (mirror of LookupTable enum)
LK_RANGE16 = 0   # 16-bit range
LK_RANGE8 = 1
LK_AND = 2
LK_OR = 3
LK_XOR = 4
LK_LTU = 5
LK_POW2 = 6
LK_INSTRUCTION = 7
LK_RANGE5 = 8
LK_RANGE12 = 9
LK_RANGE4 = 10
LK_SHL = 11   # (x u16, s<16) -> (lo, hi) of x * 2^s
LK_SRL = 12   # (x u16, s<16) -> (x >> s, x & (2^s - 1))
LK_POW2 = 13  # (s<=16) -> 2^s
LK_AND8 = 14  # (a u8, b u8) -> a & b
LK_OR8 = 15
LK_XOR8 = 16


@dataclass
class StructuralSpec:
    """Verifier-evaluable column (StructuralWitInType mirror — the
    reference's 7 variants, multilinear_extensions StructuralWitInType,
    analytic evals gkr_iop/src/utils.rs:215-310).

    kinds (i = hypercube row index, LSB-first variables):
      'incremental'          start + step*i  (start - step*i if descending)
      'incremental_dynamic'  like incremental with start = pv[start]
                             (EqualDistanceDynamicSequence: the offset is a
                             public-value slot, known to the verifier)
      'stacked_incremental'  [0 | 0 | 0,1 | 0..3 | ...]: i - 2^floor(log2 i)
      'stacked_constant'     [0 | 0 | 1,1 | 2,2,2,2 | ...]: floor(log2 i)
      'inner_repeat'         i >> k  (each value repeated 2^k times)
      'outer_repeat'         i mod 2^k  ([0..2^k-1] tiled)
      'empty'                all zeros
    """

    kind: str
    start: int = 0
    step: int = 1
    descending: bool = False
    k: int = 0


@dataclass
class CircuitBuilder:
    name: str = "chip"
    wit_names: list = field(default_factory=list)
    fixed_names: list = field(default_factory=list)
    structural: list = field(default_factory=list)  # list[StructuralSpec]
    r_records: list = field(default_factory=list)   # raw RLC exprs (unpadded)
    w_records: list = field(default_factory=list)
    r_fields: list = field(default_factory=list)    # raw field exprs per record
    w_fields: list = field(default_factory=list)    # (shard planner ground truth)
    lk_records: list = field(default_factory=list)  # chip-side lookups
    lk_table: list = field(default_factory=list)    # (mult_expr, rec_expr)
    zeros: list = field(default_factory=list)       # (name, expr)
    lk_fields: list = field(default_factory=list)       # (tag, [field exprs])
    lk_table_fields: list = field(default_factory=list)  # (tag, [field exprs])

    # -- columns ------------------------------------------------------------

    def create_witin(self, name: str) -> E.Wit:
        self.wit_names.append(name)
        return E.Wit(len(self.wit_names) - 1)

    def create_fixed(self, name: str) -> E.Fix:
        self.fixed_names.append(name)
        return E.Fix(len(self.fixed_names) - 1)

    def create_structural(self, spec: StructuralSpec) -> E.Structural:
        self.structural.append(spec)
        return E.Structural(len(self.structural) - 1)

    # -- records ------------------------------------------------------------

    def rlc(self, fields: list) -> E.Expr:
        """alpha + sum_i beta^{i+1} * field_i (record compression)."""
        acc = ALPHA
        for i, f in enumerate(fields):
            acc = acc + E.ChallengePow(1, i + 1) * E._lift(f)
        return acc

    def read_record(self, fields: list) -> None:
        self.r_records.append(self.rlc(fields))
        self.r_fields.append([E._lift(f) for f in fields])

    def write_record(self, fields: list) -> None:
        self.w_records.append(self.rlc(fields))
        self.w_fields.append([E._lift(f) for f in fields])

    def lk_record(self, table_tag: int, fields: list) -> None:
        fields = [E._lift(f) for f in fields]
        self.lk_records.append(self.rlc([E.Const(table_tag)] + fields))
        self.lk_fields.append((table_tag, fields))

    def lk_table_record(self, table_tag: int, mult_expr, fields: list) -> None:
        fields = [E._lift(f) for f in fields]
        self.lk_table.append(
            (E._lift(mult_expr), self.rlc([E.Const(table_tag)] + fields))
        )
        self.lk_table_fields.append((table_tag, fields))

    # -- constraints --------------------------------------------------------

    def require_zero(self, name: str, expr) -> None:
        self.zeros.append((name, E._lift(expr)))

    def require_equal(self, name: str, a, b) -> None:
        self.require_zero(name, E._lift(a) - E._lift(b))

    # -- common gadget-level helpers ---------------------------------------

    def assert_bit(self, name: str, expr) -> None:
        e = E._lift(expr)
        self.require_zero(name, e * (e - 1))

    def assert_u16(self, expr) -> None:
        self.lk_record(LK_RANGE16, [expr])

    def assert_u8(self, expr) -> None:
        self.lk_record(LK_RANGE8, [expr])

    def assert_u5(self, expr) -> None:
        self.lk_record(LK_RANGE5, [expr])

    def assert_u4(self, expr) -> None:
        self.lk_record(LK_RANGE4, [expr])

    def assert_u12(self, expr) -> None:
        self.lk_record(LK_RANGE12, [expr])

    def lk_and8(self, a, b, out) -> None:
        self.lk_record(LK_AND8, [a, b, out])

    def lk_xor8(self, a, b, out) -> None:
        self.lk_record(LK_XOR8, [a, b, out])

    # RAM conventions (chip_handler mirror): every access emits paired records
    def ram_read(self, ram_type: int, ident, value_fields: list, prev_ts, ts) -> None:
        self.read_record([E.Const(ram_type), ident] + list(value_fields) + [prev_ts])
        self.write_record([E.Const(ram_type), ident] + list(value_fields) + [ts])

    def ram_write(
        self, ram_type: int, ident, prev_value_fields: list, value_fields: list, prev_ts, ts
    ) -> None:
        self.read_record([E.Const(ram_type), ident] + list(prev_value_fields) + [prev_ts])
        self.write_record([E.Const(ram_type), ident] + list(value_fields) + [ts])
