"""In-circuit Poseidon2 permutation (width 16) for the shard-RAM hash-to-curve.

Role mirror of the reference's ``gadgets/poseidon2.rs`` (used by
``ShardRamConfig`` — tables/shard_ram.rs:201,285 — SURVEY.md §2.3): the
shard-RAM chip must prove x = poseidon2(record)[0..7] for every cross-shard
token, binding the EC point's x-coordinate to the hashed record fields.

Constraint shape: the permutation's linear layers (external M4-circulant,
internal diag+ones) stay SYMBOLIC — the state is carried as flat
linear-combination dicts over already-witnessed columns (NOT expression
trees: the diag+ones recursion shares subtrees, and a naive tree expansion
revisits every path, blowing up 16^13-fold). Only the sbox sites cost
witnesses; each adds two columns and two constraints:

    u = state_lane + rc      (linear tie-down, <= ~35 terms)
    w = u^7                  (single degree-7 monomial)

after which the lane's linear form is just {w: 1}. Per permutation:
8 external rounds x 16 lanes + 13 internal rounds = 141 sites = 282 columns.
The parameters mirror hash/poseidon2.py exactly (same RC tables, same round
structure); assign_poseidon2() replays the host permutation capturing the
u/w values in build order.

Copy of ``ceno_tpu/zkvm/chips/poseidon2_gadget.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import numpy as np

from ...fields import babybear as bb
from ...hash import poseidon2 as p2
from ...mle import expression as E

_P = np.uint64(bb.P)
P = bb.P


class Lin:
    """Flat linear combination {col_expr_key: coeff} + const (mod p)."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=0):
        self.terms = dict(terms or {})
        self.const = const % P

    @staticmethod
    def col(c):
        return Lin({c: 1})

    @staticmethod
    def const_(v):
        return Lin({}, v)

    def __add__(self, other):
        if isinstance(other, int):
            return Lin(self.terms, self.const + other)
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = (out.get(k, 0) + v) % P
        return Lin(out, self.const + other.const)

    def scale(self, s: int):
        s %= P
        return Lin({k: v * s % P for k, v in self.terms.items()}, self.const * s)

    def to_expr(self):
        acc = E.Const(self.const) if self.const else None
        for col, cf in self.terms.items():
            if cf == 0:
                continue
            t = col if cf == 1 else col * cf
            acc = t if acc is None else acc + t
        return acc if acc is not None else E.Const(0)


def _m4(v):
    """M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on 4 Lin rows."""
    s = v[0] + v[1] + v[2] + v[3]
    return [
        s + v[0] + v[1].scale(2),
        s + v[1] + v[2].scale(2),
        s + v[2] + v[3].scale(2),
        s + v[3] + v[0].scale(2),
    ]


def _external_linear(state):
    blocks = [state[4 * i : 4 * i + 4] for i in range(4)]
    t = [blocks[0][j] + blocks[1][j] + blocks[2][j] + blocks[3][j] for j in range(4)]
    out = []
    for i in range(4):
        out.extend(_m4([blocks[i][j] + t[j] for j in range(4)]))
    return out


def _internal_linear(state):
    s = state[0]
    for lane in state[1:]:
        s = s + lane
    return [s + state[i].scale(int(p2.INTERNAL_DIAG[i])) for i in range(p2.WIDTH)]


def build_poseidon2(cb, prefix: str, input_lins: list) -> list:
    """Adds the permutation constraints to ``cb``.

    ``input_lins``: 16 ``Lin`` forms over already-created columns.
    Returns the 16 output ``Lin`` forms (linear in the last round's w cols).
    Witness columns are created in the exact order assign_poseidon2 emits
    values: u then w per site, sites in round-major lane-minor order."""
    assert len(input_lins) == p2.WIDTH
    state = list(input_lins)

    def sbox_site(tag: str, lin: Lin, rc: int):
        u = cb.create_witin(f"{prefix}_{tag}_u")
        w = cb.create_witin(f"{prefix}_{tag}_w")
        cb.require_zero(
            f"{prefix}_{tag}_pre", u - (lin + int(rc)).to_expr()
        )
        cb.require_zero(f"{prefix}_{tag}_pow", w - u * u * u * u * u * u * u)
        return Lin.col(w)

    state = _external_linear(state)
    half = p2.ROUNDS_F // 2
    for r in range(half):
        state = [
            sbox_site(f"e{r}l{i}", state[i], p2.RC_EXTERNAL[r][i])
            for i in range(p2.WIDTH)
        ]
        state = _external_linear(state)
    for r in range(p2.ROUNDS_P):
        state[0] = sbox_site(f"i{r}", state[0], p2.RC_INTERNAL[r])
        state = _internal_linear(state)
    for r in range(half, p2.ROUNDS_F):
        state = [
            sbox_site(f"e{r}l{i}", state[i], p2.RC_EXTERNAL[r][i])
            for i in range(p2.WIDTH)
        ]
        state = _external_linear(state)
    return state


def assign_poseidon2(inputs: np.ndarray):
    """Replay the permutation over rows, capturing every sbox site.

    ``inputs``: (N, 16) canonical. Returns (u_vals, w_vals, final_state):
    u/w value lists in build order (each (N,)), final state (N, 16).
    final_state == hash/poseidon2.permute_host(inputs.T).T by construction."""
    st = np.asarray(inputs, np.uint64).T % _P  # (16, N)
    u_vals, w_vals = [], []

    def sbox(vals, rc):
        u = (vals + np.uint64(rc)) % _P
        u2 = u * u % _P
        u4 = u2 * u2 % _P
        w = u4 * u2 % _P * u % _P
        u_vals.append(u)
        w_vals.append(w)
        return w

    st = p2._h_external_linear(st)
    half = p2.ROUNDS_F // 2
    for r in range(half):
        st = np.stack(
            [sbox(st[i], p2.RC_EXTERNAL[r][i]) for i in range(p2.WIDTH)]
        )
        st = p2._h_external_linear(st)
    for r in range(p2.ROUNDS_P):
        st = st.copy()
        st[0] = sbox(st[0], p2.RC_INTERNAL[r])
        st = p2._h_internal_linear(st)
    for r in range(half, p2.ROUNDS_F):
        st = np.stack(
            [sbox(st[i], p2.RC_EXTERNAL[r][i]) for i in range(p2.WIDTH)]
        )
        st = p2._h_external_linear(st)
    return u_vals, w_vals, st.T.copy()
