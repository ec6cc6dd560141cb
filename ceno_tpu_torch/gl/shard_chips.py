"""GL shard-RAM and EC-tree chips: the cross-shard RAM bus over Goldilocks.

Copy of ``ceno_tpu/gl/shard_chips.py`` over the port's gkr/chip.py,
gkr/circuit_builder.py and zkvm/chips/shard_ram.py: the GL configuration of
zkvm/chips/shard_ram.py (reference ShardRamCircuit / ShardRamEcTreeCircuit,
ceno_zkvm tables/shard_ram.rs:184-430). Each cross-shard RAM token hashes to
a point on the GL quintic multiset-hash curve y^2 = x^3 + x + 13 over
F_p[z]/(z^5 - 3) (fields/gl5_host.py) through in-circuit Poseidon2-GL
(gl/gadget.py); the y[4] sign half encodes the transfer direction, and the
per-shard EC tree sums (proved by gl/eccquark.py) are bound to the public
values.

These chips are GL-only circuits: their constants (2^31, 2^47 limb weights,
Poseidon2-GL round constants) exceed BabyBear's modulus, so they are built
with explicit ``E.Const`` nodes (never the int sugar, which lifts mod bb.P)
and must never be proved under the BabyBear scheme. gl/scheme.keygen_gl
swaps them into the shard-chip meta slots in place of the septic versions,
and zkvm/witgen.generate_witness reaches their assigners through the
``assign_shard_fn`` / ``assign_tree_fn`` hooks.

Sign binding is exact (unlike a plain power-of-two range bound):
(p-1)/2 = 2^31 * (2^32 - 1), so y4_lo = y4 - 1 in [0, (p-1)/2) decomposes
uniquely as a + c*2^31 with a in [0, 2^31) (u16 + u15 limbs) and
c in [0, 2^32 - 2] (two u16 limbs, c != 2^32 - 1 enforced by an inverse
witness on 2*0xFFFF - c0 - c1). A sloppy 2^63 bound would leave a ~2^-31
window where both orientations of y pass, which a nonce-grinding prover
could reach to flip a token's direction in the EC sum. Host numpy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..fields import gl_host as gl
from ..fields import gl5_host as G5
from ..gkr.chip import compile_chip
from ..gkr.circuit_builder import CircuitBuilder, RAM_CUSTOM
from ..mle import expression as E
from ..zkvm.layout import PV_SHARD_ID
from ..zkvm.chips.shard_ram import TAG_EC_POINT, Tokens
from . import poseidon2 as p2g
from .gadget import GlLin, build_poseidon2_gl, assign_poseidon2_gl

P = gl.P
_P = np.uint64(P)
HALF = (P - 1) // 2  # 2^31 * (2^32 - 1)

# (i, k) -> [(component, coeff)] for the quintic product (z^5 = 3)
_MUL_TABLE = []
for _i in range(5):
    row = []
    for _k in range(5):
        idx = _i + _k
        row.append([(idx, 1)] if idx < 5 else [(idx - 5, 3)])
    _MUL_TABLE.append(row)


@dataclass
class GlShardChipDef:
    name: str
    kind: str  # 'shard_ram_in' | 'shard_ram_out' | 'ec_tree_in' | 'ec_tree_out'
    cb: CircuitBuilder
    compiled: object
    # witgen hooks consumed by zkvm/witgen.generate_witness (GL dispatch)
    assign_shard_fn: object = None
    assign_tree_fn: object = None


def _quintic_prod_expr(a_cols, b_cols, comp):
    """sum over (i,k) contributing to component ``comp`` of a*b."""
    acc = None
    for i in range(5):
        for k in range(5):
            for c, cf in _MUL_TABLE[i][k]:
                if c != comp:
                    continue
                t = a_cols[i] * b_cols[k]
                if cf != 1:
                    t = t * E.Const(cf)
                acc = t if acc is None else acc + t
    return acc


def build_shard_ram_chip_gl(direction: str) -> GlShardChipDef:
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
    ram_type_expr = 2 - is_reg  # RAM_REGISTER = 1, RAM_MEMORY = 2

    local_rec = [ram_type_expr, addr, v_lo, v_hi, clk]
    if direction == "in":
        cb.write_record(local_rec)
    else:
        cb.read_record(local_rec)
        cb.require_zero("shard_is_pv", shard - E.Instance(PV_SHARD_ID))

    # x = poseidon2_gl([addr, ram_type, v_lo, v_hi, shard, clk, nonce, 0])[0..5]
    lins = [
        GlLin.col(addr),
        GlLin({is_reg: P - 1}, 2),
        GlLin.col(v_lo),
        GlLin.col(v_hi),
        GlLin.col(shard),
        GlLin.col(clk),
        GlLin.col(nonce),
        GlLin.const_(0),
    ]
    outs = build_poseidon2_gl(cb, "p2", lins)
    x = [cb.create_witin(f"x{i}") for i in range(5)]
    for i in range(5):
        cb.require_zero(f"x{i}_tie", x[i] - outs[i].to_expr())

    # y on curve: witness x2 = x*x, then y^2 = x2*x + A*x + B
    y = [cb.create_witin(f"y{i}") for i in range(5)]
    x2 = [cb.create_witin(f"x2_{i}") for i in range(5)]
    for c in range(5):
        cb.require_zero(f"x2_{c}_def", x2[c] - _quintic_prod_expr(x, x, c))
    for c in range(5):
        rhs = _quintic_prod_expr(x2, x, c) + x[c] * G5.A_COEFF
        if c == 0:
            rhs = rhs + G5.B_COEFF
        cb.require_zero(f"curve_{c}", _quintic_prod_expr(y, y, c) - rhs)

    # y4 sign binding, EXACT bound (module docstring): y4_lo = a + c*2^31
    a0 = cb.create_witin("y4a0")
    a1 = cb.create_witin("y4a1")
    c0 = cb.create_witin("y4c0")
    c1 = cb.create_witin("y4c1")
    dinv = cb.create_witin("y4dinv")
    cb.assert_u16(a0)
    cb.assert_u16(a1)
    cb.assert_u16(a1 * 2)  # a1 < 2^15
    cb.assert_u16(c0)
    cb.assert_u16(c1)
    # c != 2^32 - 1  <=>  d = 2*0xFFFF - c0 - c1 != 0 (c0, c1 <= 0xFFFF)
    d_expr = E.Const(2 * 0xFFFF) - c0 - c1
    cb.require_zero("y4c_cap", dinv * d_expr - 1)
    y4_lo = (
        a0
        + a1 * E.Const(1 << 16)
        + c0 * E.Const(1 << 31)
        + c1 * E.Const(1 << 47)
    )
    if direction == "in":
        cb.require_zero("y4_read_half", y[4] - (y4_lo + 1))
    else:
        cb.require_zero("y4_write_half", y[4] + y4_lo + 1)

    ec_rec = [E.Const(RAM_CUSTOM), E.Const(TAG_EC_POINT)] + x + y
    if direction == "in":
        cb.write_record(ec_rec)
    else:
        cb.read_record(ec_rec)

    return GlShardChipDef(
        cb.name, f"shard_ram_{direction}", cb, compile_chip(cb),
        assign_shard_fn=assign_shard_ram_gl,
    )


def build_ec_tree_chip_gl(direction: str) -> GlShardChipDef:
    assert direction in ("in", "out")
    cb = CircuitBuilder(f"ec_tree_{direction}")
    x = [cb.create_witin(f"x{i}") for i in range(5)]
    y = [cb.create_witin(f"y{i}") for i in range(5)]
    for i in range(5):
        cb.create_witin(f"s{i}")
    ec_rec = [E.Const(RAM_CUSTOM), E.Const(TAG_EC_POINT)] + x + y
    if direction == "in":
        cb.read_record(ec_rec)
    else:
        cb.write_record(ec_rec)
    return GlShardChipDef(
        cb.name, f"ec_tree_{direction}", cb, compile_chip(cb),
        assign_tree_fn=assign_ec_tree_gl,
    )


_CHIPS_CACHE = None


def build_gl_shard_chips() -> list:
    global _CHIPS_CACHE
    if _CHIPS_CACHE is None:
        _CHIPS_CACHE = [
            build_shard_ram_chip_gl("in"),
            build_shard_ram_chip_gl("out"),
            build_ec_tree_chip_gl("in"),
            build_ec_tree_chip_gl("out"),
        ]
    return _CHIPS_CACHE


# ---------------------------------------------------------------------------
# Witness generation
# ---------------------------------------------------------------------------

def _hash_inputs(tok: Tokens) -> np.ndarray:
    inputs = np.zeros((tok.n, p2g.WIDTH), np.uint64)
    inputs[:, 0] = tok.addr
    inputs[:, 1] = np.where(tok.is_reg == 1, 1, 2)
    inputs[:, 2] = tok.value & 0xFFFF
    inputs[:, 3] = tok.value >> 16
    inputs[:, 4] = tok.shard
    inputs[:, 5] = tok.clk
    return inputs


def tokens_to_points_gl(tok: Tokens):
    """Hash-to-curve with nonce search (shard_ram.tokens_to_points GL
    mirror). Returns (nonce (T,), x (T,5), y (T,5)) with y oriented into
    the READ half (y4 in [1, (p-1)/2]); the write side negates."""
    t = tok.n
    nonce = np.zeros(t, np.uint64)
    xs = np.zeros((t, 5), np.uint64)
    ys = np.zeros((t, 5), np.uint64)
    pending = np.ones(t, bool)
    inputs = _hash_inputs(tok)
    for _ in range(64):
        if not pending.any():
            break
        idx = np.nonzero(pending)[0]
        inputs[idx, 6] = nonce[idx]
        out = p2g.permute_host(inputs[idx].T.copy()).T  # (k, 8)
        x_try = out[:, :5]
        y_try, ok = G5.from_x(x_try)
        ok &= y_try[:, 4] != 0  # y4 = 0 cannot encode a direction
        good = idx[ok]
        xs[good] = x_try[ok]
        ys[good] = y_try[ok]
        pending[good] = False
        nonce[idx[~ok]] += 1
    else:
        raise RuntimeError("gl hash-to-curve: nonce search exhausted")
    flip = ys[:, 4] > HALF
    ys = np.where(flip[:, None], G5.neg(ys), ys)
    return nonce, xs, ys


def assign_shard_ram_gl(chip: GlShardChipDef, tok: Tokens) -> np.ndarray:
    """Witness matrix (n_wit, pad) for a GL shard_ram_{in,out} chip."""
    direction = chip.kind.rsplit("_", 1)[1]
    t = tok.n
    nonce, xs, ys = tokens_to_points_gl(tok)
    if direction == "out":
        ys = G5.neg(ys)  # write half
    inputs = _hash_inputs(tok)
    inputs[:, 6] = nonce
    u_vals, w_vals, _final = assign_poseidon2_gl(inputs)
    x2 = G5.square(xs)
    y4 = ys[:, 4]
    y4_lo = np.where(y4 > HALF, _P - 1 - y4, y4 - 1)
    a = y4_lo & np.uint64((1 << 31) - 1)
    c = y4_lo >> np.uint64(31)
    cols = {
        "addr": tok.addr,
        "is_reg": tok.is_reg,
        "v_lo": tok.value & 0xFFFF,
        "v_hi": tok.value >> 16,
        "shard": tok.shard,
        "clk": tok.clk,
        "nonce": nonce,
        "y4a0": a & np.uint64(0xFFFF),
        "y4a1": a >> np.uint64(16),
        "y4c0": c & np.uint64(0xFFFF),
        "y4c1": c >> np.uint64(16),
    }
    d = (np.uint64(2 * 0xFFFF) - cols["y4c0"]) - cols["y4c1"]
    cols["y4dinv"] = gl.inv(d)
    for i in range(5):
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
        wit[i, :t] = np.asarray(cols[name], np.uint64) % _P
    return wit


def assign_ec_tree_gl(chip: GlShardChipDef, tok: Tokens):
    """Witness (15, 2*pad) for a GL ec_tree chip + the tree sum (2, 5)."""
    from . import eccquark as Q

    direction = chip.kind.rsplit("_", 1)[1]
    t = tok.n
    if t == 0:
        return np.zeros((15, 4), np.uint64), np.zeros((2, 5), np.uint64)
    _, xs, ys = tokens_to_points_gl(tok)
    if direction == "out":
        ys = G5.neg(ys)
    half = max(2, 1 << max(0, (t - 1).bit_length()))
    x, y, s, final = Q.build_tree_witness(xs, ys, 2 * half)
    wit = np.concatenate([x, y, s], axis=0)  # names x0..4, y0..4, s0..4
    return wit, final
