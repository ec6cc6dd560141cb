"""Shard-RAM and EC-tree chips: the cross-shard RAM continuation bus.

Role mirror of the reference's ``ShardRamCircuit``/``ShardRamEcTreeCircuit``
(ceno_zkvm tables/shard_ram.rs:184-430 — SURVEY.md §2.3): each cross-shard
RAM token (addr, ram_type, value, holder_shard, clk) hashes to a point on
the septic curve via in-circuit Poseidon2; the y[6] sign half encodes the
transfer direction, so an exported token's point and the importing shard's
point are exact negatives and cancel in the cross-shard EC sum.

The reference gates one chip's read/write record groups on disjoint
prefix-selector ranges ("local reads ++ local writes"). Here each direction
is its OWN chip so the framework's single-prefix-selector chips apply
unchanged:

  shard_ram_in  (import): inserts the local WRITE record (addr, v, clk)
      that the shard's first read of the cell consumes; emits the EC point
      as a Custom-bus WRITE; y6 in [1, (p-1)/2].
  shard_ram_out (export): inserts the local READ record consuming the
      cell's dangling last write; emits the EC point as a Custom-bus READ;
      y6 in [(p+1)/2, p-1]; token shard pinned to PV shard_id.
  ec_tree_in / ec_tree_out: leaf rows replay the Custom-bus records
      (cancelling the shard_ram rows), and the x/y/s columns carry the
      Quark binary-tree accumulation proven by gkr/eccquark.py, whose
      exported sum is bound to the PV rw-sum slots.

Token uniqueness gives distinct x coordinates within a tree w.h.p. (the
hash input includes holder shard and clk), so affine addition with a
witnessed slope is total on the tree.

Copy of ``ceno_tpu/zkvm/chips/shard_ram.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ...fields import babybear as bb
from ...fields import septic as S
from ...gkr.chip import compile_chip
from ...gkr.circuit_builder import (
    CircuitBuilder,
    RAM_CUSTOM,
)
from ...hash import poseidon2 as p2
from ...mle import expression as E
from ..layout import PV_SHARD_ID
from .poseidon2_gadget import Lin, assign_poseidon2, build_poseidon2

TAG_EC_POINT = 1  # CustomRWTag::ShardRamEcPoint mirror

# (i, k) -> [(component, coeff)] for the septic product (z^7 = 2z + 5)
_MUL_TABLE = []
for _i in range(7):
    row = []
    for _k in range(7):
        idx = _i + _k
        row.append([(idx, 1)] if idx < 7 else [(idx - 7, 5), (idx - 7 + 1, 2)])
    _MUL_TABLE.append(row)

HALF = (bb.P - 1) // 2  # 60 * 2^24 for BabyBear


@dataclass
class ShardChipDef:
    name: str
    kind: str  # 'shard_ram_in' | 'shard_ram_out' | 'ec_tree_in' | 'ec_tree_out'
    cb: CircuitBuilder
    compiled: object


def _septic_prod_expr(a_cols, b_cols, comp):
    """sum over (i,k) contributing to component ``comp`` of a*b."""
    acc = None
    for i in range(7):
        for k in range(7):
            for c, cf in _MUL_TABLE[i][k]:
                if c != comp:
                    continue
                t = a_cols[i] * b_cols[k] * cf if cf != 1 else a_cols[i] * b_cols[k]
                acc = t if acc is None else acc + t
    return acc


def build_shard_ram_chip(direction: str) -> ShardChipDef:
    assert direction in ("in", "out")
    cb = CircuitBuilder(f"shard_ram_{direction}")
    addr = cb.create_witin("addr")
    is_reg = cb.create_witin("is_reg")
    v_lo = cb.create_witin("v_lo")
    v_hi = cb.create_witin("v_hi")
    shard = cb.create_witin("shard")
    clk = cb.create_witin("clk")
    nonce = cb.create_witin("nonce")
    cb.assert_bit("is_reg_bit", is_reg)
    # RAM_REGISTER = 1, RAM_MEMORY = 2: type = 2 - is_reg
    ram_type_expr = 2 - is_reg

    # local record: import inserts the write the first local read consumes;
    # export inserts the read consuming the dangling last write
    local_rec = [ram_type_expr, addr, v_lo, v_hi, clk]
    if direction == "in":
        cb.write_record(local_rec)
    else:
        cb.read_record(local_rec)
        cb.require_zero("shard_is_pv", shard - E.Instance(PV_SHARD_ID))

    # x = poseidon2([addr, ram_type, v_lo, v_hi, shard, clk, nonce, 0...])[0..7]
    lins = [
        Lin.col(addr),
        Lin({is_reg: bb.P - 1}, 2),
        Lin.col(v_lo),
        Lin.col(v_hi),
        Lin.col(shard),
        Lin.col(clk),
        Lin.col(nonce),
    ] + [Lin.const_(0) for _ in range(p2.WIDTH - 7)]
    outs = build_poseidon2(cb, "p2", lins)
    x = [cb.create_witin(f"x{i}") for i in range(7)]
    for i in range(7):
        cb.require_zero(f"x{i}_tie", x[i] - outs[i].to_expr())

    # y on curve: witness x2 = x*x, then y^2 = x2*x + 2x + 26 z^5
    y = [cb.create_witin(f"y{i}") for i in range(7)]
    x2 = [cb.create_witin(f"x2_{i}") for i in range(7)]
    for c in range(7):
        cb.require_zero(f"x2_{c}_def", x2[c] - _septic_prod_expr(x, x, c))
    for c in range(7):
        rhs = _septic_prod_expr(x2, x, c) + x[c] * 2
        if c == 5:
            rhs = rhs + 26
        cb.require_zero(f"curve_{c}", _septic_prod_expr(y, y, c) - rhs)

    # y6 sign binding (tables/shard_ram.rs:295-330): y6_lo < (p-1)/2 via
    # byte limbs with top byte <= 59 (b3 + d = 59, both u8)
    bts = [cb.create_witin(f"y6b{i}") for i in range(4)]
    d = cb.create_witin("y6b3_cap")
    for b_ in bts:
        cb.assert_u8(b_)
    cb.assert_u8(d)
    cb.require_zero("y6b3_lt60", bts[3] + d - 59)
    y6_lo = bts[0] + bts[1] * (1 << 8) + bts[2] * (1 << 16) + bts[3] * (1 << 24)
    if direction == "in":
        cb.require_zero("y6_read_half", y[6] - (y6_lo + 1))
    else:
        cb.require_zero("y6_write_half", y[6] + y6_lo + 1)

    # Custom-bus EC point record, cancelled by the matching ec_tree leaf
    ec_rec = [E.Const(RAM_CUSTOM), E.Const(TAG_EC_POINT)] + x + y
    if direction == "in":
        cb.write_record(ec_rec)
    else:
        cb.read_record(ec_rec)

    return ShardChipDef(cb.name, f"shard_ram_{direction}", cb, compile_chip(cb))


def build_ec_tree_chip(direction: str) -> ShardChipDef:
    assert direction in ("in", "out")
    cb = CircuitBuilder(f"ec_tree_{direction}")
    x = [cb.create_witin(f"x{i}") for i in range(7)]
    y = [cb.create_witin(f"y{i}") for i in range(7)]
    for i in range(7):
        cb.create_witin(f"s{i}")
    ec_rec = [E.Const(RAM_CUSTOM), E.Const(TAG_EC_POINT)] + x + y
    # mirror of the shard_ram side: in-tree READS what shard_ram_in wrote
    if direction == "in":
        cb.read_record(ec_rec)
    else:
        cb.write_record(ec_rec)
    return ShardChipDef(cb.name, f"ec_tree_{direction}", cb, compile_chip(cb))


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

@dataclass
class Tokens:
    """Column arrays over one direction's tokens for one shard."""

    is_reg: np.ndarray   # (T,) 0/1
    addr: np.ndarray     # (T,) register id or word address... (field value)
    value: np.ndarray    # (T,) u32
    shard: np.ndarray    # (T,) holder shard id
    clk: np.ndarray      # (T,) global timestamp of the token

    @property
    def n(self) -> int:
        return int(self.is_reg.shape[0])

    @staticmethod
    def empty() -> "Tokens":
        z = np.zeros(0, np.uint64)
        return Tokens(z, z.copy(), z.copy(), z.copy(), z.copy())


def tokens_to_points(tok: Tokens):
    """Hash-to-curve with nonce search (tables/shard_ram.rs:115-180 mirror).

    Returns (nonce (T,), x (T,7), y (T,7)) with y oriented into the READ
    half (y6 in [1,(p-1)/2]); the write side negates."""
    t = tok.n
    nonce = np.zeros(t, np.uint64)
    xs = np.zeros((t, 7), np.uint64)
    ys = np.zeros((t, 7), np.uint64)
    pending = np.ones(t, bool)
    inputs = np.zeros((t, p2.WIDTH), np.uint64)
    inputs[:, 0] = tok.addr
    inputs[:, 1] = np.where(tok.is_reg == 1, 1, 2)
    inputs[:, 2] = tok.value & 0xFFFF
    inputs[:, 3] = tok.value >> 16
    inputs[:, 4] = tok.shard
    inputs[:, 5] = tok.clk
    for _ in range(64):
        if not pending.any():
            break
        idx = np.nonzero(pending)[0]
        inputs[idx, 6] = nonce[idx]
        out = p2.permute_host(inputs[idx].T.copy()).T  # (k, 16)
        x_try = out[:, :7]
        y_try, ok = S.from_x(x_try)
        ok &= y_try[:, 6] != 0  # y6 = 0 cannot encode a direction
        good = idx[ok]
        xs[good] = x_try[ok]
        ys[good] = y_try[ok]
        pending[good] = False
        nonce[idx[~ok]] += 1
    else:
        raise RuntimeError("hash-to-curve: nonce search exhausted")
    # orient into the read half
    flip = ys[:, 6] > HALF
    ys = np.where(flip[:, None], S.neg(ys), ys)
    return nonce, xs, ys


def assign_shard_ram(chip: ShardChipDef, tok: Tokens) -> np.ndarray:
    """Witness matrix (n_wit, pad) for a shard_ram_{in,out} chip."""
    direction = chip.kind.rsplit("_", 1)[1]
    t = tok.n
    nonce, xs, ys = tokens_to_points(tok)
    if direction == "out":
        ys = S.neg(ys)  # write half
    inputs = np.zeros((t, p2.WIDTH), np.uint64)
    inputs[:, 0] = tok.addr
    inputs[:, 1] = np.where(tok.is_reg == 1, 1, 2)
    inputs[:, 2] = tok.value & 0xFFFF
    inputs[:, 3] = tok.value >> 16
    inputs[:, 4] = tok.shard
    inputs[:, 5] = tok.clk
    inputs[:, 6] = nonce
    u_vals, w_vals, final = assign_poseidon2(inputs)
    x2 = S.square(xs)
    y6_lo = np.where(ys[:, 6] > HALF, bb.P - 1 - ys[:, 6], ys[:, 6] - 1)
    cols = {
        "addr": tok.addr,
        "is_reg": tok.is_reg,
        "v_lo": tok.value & 0xFFFF,
        "v_hi": tok.value >> 16,
        "shard": tok.shard,
        "clk": tok.clk,
        "nonce": nonce,
        "y6b0": y6_lo & 0xFF,
        "y6b1": (y6_lo >> 8) & 0xFF,
        "y6b2": (y6_lo >> 16) & 0xFF,
        "y6b3": y6_lo >> 24,
        "y6b3_cap": 59 - (y6_lo >> 24),
    }
    for i in range(7):
        cols[f"x{i}"] = xs[:, i]
        cols[f"y{i}"] = ys[:, i]
        cols[f"x2_{i}"] = x2[:, i]
    site = 0
    for name in chip.cb.wit_names:
        if name.endswith("_u") and name.startswith("p2_"):
            cols[name] = u_vals[site]
        elif name.endswith("_w") and name.startswith("p2_"):
            cols[name] = w_vals[site]
            site += 1
    n_pad = max(2, 1 << max(0, (t - 1).bit_length()))
    wit = np.zeros((len(chip.cb.wit_names), n_pad), np.uint64)
    for i, name in enumerate(chip.cb.wit_names):
        wit[i, :t] = np.asarray(cols[name], np.uint64) % np.uint64(bb.P)
    return wit


def assign_ec_tree(chip: ShardChipDef, tok: Tokens):
    """Witness (21, 2*pad) for an ec_tree chip + the tree's final sum (2,7)."""
    from ...gkr import eccquark as Q

    direction = chip.kind.rsplit("_", 1)[1]
    t = tok.n
    if t == 0:
        return np.zeros((21, 4), np.uint64), np.zeros((2, 7), np.uint64)
    _, xs, ys = tokens_to_points(tok)
    if direction == "out":
        ys = S.neg(ys)
    half = max(2, 1 << max(0, (t - 1).bit_length()))
    x, y, s, final = Q.build_tree_witness(xs, ys, 2 * half)
    wit = np.concatenate([x, y, s], axis=0)  # names x0..6, y0..6, s0..6
    return wit, final


def build_shard_chips() -> list[ShardChipDef]:
    return [
        build_shard_ram_chip("in"),
        build_shard_ram_chip("out"),
        build_ec_tree_chip("in"),
        build_ec_tree_chip("out"),
    ]
