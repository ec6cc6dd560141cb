"""In-circuit Poseidon2-GL permutation (width 8) for the GL shard-RAM hash.

Copy of ``ceno_tpu/gl/gadget.py`` over the port's gl/poseidon2.py tables and
mle/expression.py: the GL configuration of zkvm/chips/poseidon2_gadget.py
(reference gadgets/poseidon2.rs). The linear layers stay symbolic as flat
linear-combination dicts; only the sbox sites cost witnesses (u = lane + rc
tie, w = u^7 monomial). Per permutation: 8 external rounds x 8 lanes + 22
internal rounds = 86 sites = 172 columns.

The BabyBear gadget's ``Lin`` reduces coefficients mod bb.P and the int
sugar on expressions lifts constants mod bb.P (mle/expression._lift), so a
GL-only chip cannot reuse it: ``GlLin`` reduces mod gl.P and emits explicit
``E.Const`` nodes (eval_expr_gl re-reduces mod gl.P; the values round-trip
exactly because they are already canonical GL). assign_poseidon2_gl()
replays the host permutation, capturing the u/w values in build order.
Host numpy.
"""

from __future__ import annotations

import numpy as np

from ..fields import gl_host as gl
from . import poseidon2 as p2g
from ..mle import expression as E

P = gl.P
_P = np.uint64(P)


class GlLin:
    """Flat linear combination {col_expr_key: coeff} + const (mod gl.P)."""

    __slots__ = ("terms", "const")

    def __init__(self, terms=None, const=0):
        self.terms = dict(terms or {})
        self.const = const % P

    @staticmethod
    def col(c):
        return GlLin({c: 1})

    @staticmethod
    def const_(v):
        return GlLin({}, v)

    def __add__(self, other):
        if isinstance(other, int):
            return GlLin(self.terms, self.const + other)
        out = dict(self.terms)
        for k, v in other.terms.items():
            out[k] = (out.get(k, 0) + v) % P
        return GlLin(out, self.const + other.const)

    def scale(self, s: int):
        s %= P
        return GlLin(
            {k: v * s % P for k, v in self.terms.items()}, self.const * s
        )

    def to_expr(self):
        acc = E.Const(self.const) if self.const else None
        for col, cf in self.terms.items():
            if cf == 0:
                continue
            t = col if cf == 1 else E.Prod([col, E.Const(cf)])
            acc = t if acc is None else acc + t
        return acc if acc is not None else E.Const(0)


def _m4(v):
    """M4 = [[2,3,1,1],[1,2,3,1],[1,1,2,3],[3,1,1,2]] on 4 GlLin rows."""
    s = v[0] + v[1] + v[2] + v[3]
    return [
        s + v[0] + v[1].scale(2),
        s + v[1] + v[2].scale(2),
        s + v[2] + v[3].scale(2),
        s + v[3] + v[0].scale(2),
    ]


def _external_linear(state):
    """circ(2*M4, M4) for width 8 = 2 blocks (gl/poseidon2._external_linear)."""
    blocks = [state[0:4], state[4:8]]
    t = [blocks[0][j] + blocks[1][j] for j in range(4)]
    out = []
    for i in range(2):
        out.extend(_m4([blocks[i][j] + t[j] for j in range(4)]))
    return out


def _internal_linear(state):
    s = state[0]
    for lane in state[1:]:
        s = s + lane
    return [
        s + state[i].scale(int(p2g.INTERNAL_DIAG[i])) for i in range(p2g.WIDTH)
    ]


def build_poseidon2_gl(cb, prefix: str, input_lins: list) -> list:
    """Adds the GL permutation constraints to ``cb``; returns the 8 output
    ``GlLin`` forms. Witness columns are created in the exact order
    assign_poseidon2_gl emits values (u then w per site, round-major)."""
    assert len(input_lins) == p2g.WIDTH
    state = list(input_lins)

    def sbox_site(tag: str, lin: GlLin, rc: int):
        u = cb.create_witin(f"{prefix}_{tag}_u")
        w = cb.create_witin(f"{prefix}_{tag}_w")
        cb.require_zero(f"{prefix}_{tag}_pre", u - (lin + int(rc)).to_expr())
        cb.require_zero(f"{prefix}_{tag}_pow", w - u * u * u * u * u * u * u)
        return GlLin.col(w)

    state = _external_linear(state)
    half = p2g.ROUNDS_F // 2
    for r in range(half):
        state = [
            sbox_site(f"e{r}l{i}", state[i], p2g.RC_EXTERNAL[r][i])
            for i in range(p2g.WIDTH)
        ]
        state = _external_linear(state)
    for r in range(p2g.ROUNDS_P):
        state[0] = sbox_site(f"i{r}", state[0], p2g.RC_INTERNAL[r])
        state = _internal_linear(state)
    for r in range(half, p2g.ROUNDS_F):
        state = [
            sbox_site(f"e{r}l{i}", state[i], p2g.RC_EXTERNAL[r][i])
            for i in range(p2g.WIDTH)
        ]
        state = _external_linear(state)
    return state


def assign_poseidon2_gl(inputs: np.ndarray):
    """Replay the GL permutation over rows, capturing every sbox site.

    ``inputs``: (N, 8) canonical. Returns (u_vals, w_vals, final_state):
    u/w value lists in build order (each (N,)), final state (N, 8) ==
    gl/poseidon2.permute_host(inputs.T).T by construction."""
    st = np.asarray(inputs, np.uint64).T % _P  # (8, N)
    u_vals, w_vals = [], []

    def sbox(vals, rc):
        u = gl.add(vals, np.uint64(rc))
        u2 = gl.mul(u, u)
        u4 = gl.mul(u2, u2)
        w = gl.mul(gl.mul(u4, u2), u)
        u_vals.append(u)
        w_vals.append(w)
        return w

    st = p2g._external_linear(st)
    half = p2g.ROUNDS_F // 2
    for r in range(half):
        st = np.stack(
            [sbox(st[i], p2g.RC_EXTERNAL[r][i]) for i in range(p2g.WIDTH)]
        )
        st = p2g._external_linear(st)
    for r in range(p2g.ROUNDS_P):
        st = st.copy()
        st[0] = sbox(st[0], p2g.RC_INTERNAL[r])
        st = p2g._internal_linear(st)
    for r in range(half, p2g.ROUNDS_F):
        st = np.stack(
            [sbox(st[i], p2g.RC_EXTERNAL[r][i]) for i in range(p2g.WIDTH)]
        )
        st = p2g._external_linear(st)
    return u_vals, w_vals, st.T.copy()
