"""In-circuit BabyBearExt4 arithmetic gadgets — the recursion building
blocks (RECURSION.md build order #1; reference role: the field arithmetic
the recursion VM's AIR tables express, ceno_recursion_v2).

An ext4 value in-circuit is 4 base-field wires (component order matches
fields/ext4_host.py: a = a0 + a1 x + a2 x^2 + a3 x^3, x^4 = 11). All
gadget constraints are plain FIELD equations (mod-p semantics) — the
rule that integer constraints stay below p applies to integer-semantics limb
constraints, not these.

Each product gadget allocates 4 witness wires for the result and emits the
4 degree-2 schoolbook+reduction equations; witgen mirrors live next to the
builders so circuits and assignment can't drift (ChipDef.assign checks
exact column-name sets).

Copy of ``ceno_tpu/gkr/gadgets.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import numpy as np

from ..fields import babybear as bb
from ..fields import ext4_host as exth
from ..mle import expression as E

W = 11  # x^4 = 11


class ExtWire:
    """4 expression components representing one ext4 value in-circuit."""

    __slots__ = ("c",)

    def __init__(self, c0, c1, c2, c3):
        self.c = [E._lift(c0), E._lift(c1), E._lift(c2), E._lift(c3)]

    @staticmethod
    def constant(val) -> "ExtWire":
        v = np.asarray(val, np.uint64)
        return ExtWire(int(v[0]), int(v[1]), int(v[2]), int(v[3]))

    def add(self, other: "ExtWire") -> "ExtWire":
        return ExtWire(*[self.c[i] + other.c[i] for i in range(4)])

    def sub(self, other: "ExtWire") -> "ExtWire":
        return ExtWire(*[self.c[i] - other.c[i] for i in range(4)])

    def scale(self, k: int) -> "ExtWire":
        return ExtWire(*[self.c[i] * k for i in range(4)])


def ext_witness(cb, name: str) -> ExtWire:
    """Allocate 4 witness wires for one ext4 value."""
    return ExtWire(*[cb.create_witin(f"{name}_{i}") for i in range(4)])


def ext_mul_exprs(a: ExtWire, b: ExtWire) -> list:
    """The 4 component expressions of a*b (degree 2, x^4 = 11 reduction)."""
    a0, a1, a2, a3 = a.c
    b0, b1, b2, b3 = b.c
    return [
        a0 * b0 + (a1 * b3 + a2 * b2 + a3 * b1) * W,
        a0 * b1 + a1 * b0 + (a2 * b3 + a3 * b2) * W,
        a0 * b2 + a1 * b1 + a2 * b0 + a3 * b3 * W,
        a0 * b3 + a1 * b2 + a2 * b1 + a3 * b0,
    ]


def ext_mul(cb, name: str, a: ExtWire, b: ExtWire) -> ExtWire:
    """c = a * b: allocates the result wires and constrains them."""
    c = ext_witness(cb, name)
    prods = ext_mul_exprs(a, b)
    for i in range(4):
        cb.require_zero(f"{name}_mul_{i}", prods[i] - c.c[i])
    return c


def ext_require_equal(cb, name: str, a: ExtWire, b: ExtWire) -> None:
    for i in range(4):
        cb.require_zero(f"{name}_{i}", a.c[i] - b.c[i])


# -- witgen mirrors ----------------------------------------------------------

def assign_ext(cols: dict, name: str, values: np.ndarray) -> None:
    """Fill the 4 component columns of an ext wire. values: (n, 4)."""
    v = np.asarray(values, np.uint64)
    for i in range(4):
        cols[f"{name}_{i}"] = v[..., i]


def ext_mul_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return exth.mul(np.asarray(a, np.uint64), np.asarray(b, np.uint64))


# -- Lagrange extrapolation gadget --------------------------------------------

def lagrange_coeff_consts(deg: int) -> list:
    """Barycentric-style denominators: inv(prod_{j!=k}(k-j)) mod p."""
    out = []
    for k in range(deg + 1):
        den = 1
        for j in range(deg + 1):
            if j != k:
                den = den * ((k - j) % bb.P) % bb.P
        out.append(pow(den, bb.P - 2, bb.P))
    return out


def lagrange_extrapolate_gadget(cb, name: str, ys: list, r: ExtWire,
                                deg: int) -> ExtWire:
    """out = the degree-`deg` polynomial through (k, ys[k]) evaluated at r.

    ys: list of deg+1 ExtWires (the sumcheck round message nodes); r the
    (ext) challenge. The verifier identity is
        out = sum_k ys[k] * d_k * prod_{j != k} (r - j)
    with constant d_k = lagrange_coeff_consts. Uses prefix/suffix products
    of (r - j) so the gadget allocates 2*(deg+1) + deg+1 + 1 ext products —
    the same shape sumcheck/verifier.py::lagrange_extrapolate computes on
    host (this is the per-round core of the recursive verifier)."""
    dens = lagrange_coeff_consts(deg)
    diffs = [r.sub(ExtWire.constant(exth.from_base(j))) for j in range(deg + 1)]
    # prefix[k] = prod diffs[0..k), suffix[k] = prod diffs(k..deg]
    prefix = [ExtWire.constant(exth.one())]
    for k in range(deg):
        prefix.append(ext_mul(cb, f"{name}_pre{k}", prefix[-1], diffs[k]))
    suffix = [ExtWire.constant(exth.one())]
    for k in range(deg, 0, -1):
        suffix.append(ext_mul(cb, f"{name}_suf{k}", suffix[-1], diffs[k]))
    suffix = suffix[::-1]  # suffix[k] = prod_{j>k} diffs[j]
    acc = None
    for k in range(deg + 1):
        basis = ext_mul(cb, f"{name}_bas{k}", prefix[k], suffix[k])
        term = ext_mul(cb, f"{name}_trm{k}",
                       basis.scale(dens[k]), ys[k])
        acc = term if acc is None else acc.add(term)
    out = ext_witness(cb, f"{name}_out")
    ext_require_equal(cb, f"{name}_eq", acc, out)
    return out


def assign_lagrange(cols: dict, name: str, ys_vals: np.ndarray,
                    r_vals: np.ndarray, deg: int) -> np.ndarray:
    """Witgen mirror of the gadget: fills every intermediate column.
    ys_vals (n, deg+1, 4), r_vals (n, 4); returns out (n, 4)."""
    ys_vals = np.asarray(ys_vals, np.uint64)
    r_vals = np.asarray(r_vals, np.uint64)
    n = r_vals.shape[0]
    dens = lagrange_coeff_consts(deg)
    diffs = [exth.sub(r_vals, exth.from_base(np.full(n, j, np.uint64)))
             for j in range(deg + 1)]
    prefix = [np.broadcast_to(exth.one(), (n, 4)).copy()]
    for k in range(deg):
        v = ext_mul_host(prefix[-1], diffs[k])
        assign_ext(cols, f"{name}_pre{k}", v)
        prefix.append(v)
    suffix = [np.broadcast_to(exth.one(), (n, 4)).copy()]
    for k in range(deg, 0, -1):
        v = ext_mul_host(suffix[-1], diffs[k])
        assign_ext(cols, f"{name}_suf{k}", v)
        suffix.append(v)
    suffix = suffix[::-1]
    acc = np.zeros((n, 4), np.uint64)
    for k in range(deg + 1):
        basis = ext_mul_host(prefix[k], suffix[k])
        assign_ext(cols, f"{name}_bas{k}", basis)
        scaled = exth.mul_base(basis, np.uint64(dens[k]))
        term = ext_mul_host(scaled, ys_vals[:, k])
        assign_ext(cols, f"{name}_trm{k}", term)
        acc = exth.add(acc, term)
    assign_ext(cols, f"{name}_out", acc)
    return acc
