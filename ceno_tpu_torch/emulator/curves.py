"""Host-side curve arithmetic for the EC/fptower syscalls.

Mirror of the reference's emulator-side precompile execution
(ceno_emul/src/syscalls/{secp256k1,secp256r1,bn254/*}.rs, which delegate to
the secp/k256/p256/substrate-bn crates). Pure python-int math; validation
mirrors those libraries' parsers: coordinates must be canonical (< p) and
points on the curve, else the ecall raises (no valid trace exists, matching
the reference's panic).

Guest contract notes:
  * ADD requires x(P) != x(Q): doubling must use the DOUBLE syscall and
    P + (-P) is rejected (the sp1-patched guest crypto libs route these
    separately; the chord-rule circuit is undefined there).
  * DOUBLE requires y != 0 (never true on these odd-order curves).

Copy of ``ceno_tpu/emulator/curves.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

CURVES = {
    "secp256k1": dict(
        p=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F,
        a=0,
        b=7,
        order=0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141,
    ),
    "secp256r1": dict(
        p=0xFFFFFFFF00000001000000000000000000000000FFFFFFFFFFFFFFFFFFFFFFFF,
        a=-3,
        b=0x5AC635D8AA3A93E7B3EBBD55769886BC651D06B0CC53B0F63BCE3C3E27D2604B,
        order=0xFFFFFFFF00000000FFFFFFFFFFFFFFFFBCE6FAADA7179E84F3B9CAC2FC632551,
    ),
    "bn254": dict(
        p=21888242871839275222246405745257275088696311157297823662689037894645226208583,
        a=0,
        b=3,
        order=None,
    ),
}


def words_to_int(words):
    return sum(int(w) << (32 * i) for i, w in enumerate(words))


def int_to_words(v: int, n: int = 8):
    return [(v >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def check_on_curve(curve: str, x: int, y: int) -> None:
    c = CURVES[curve]
    p = c["p"]
    if not (0 <= x < p and 0 <= y < p):
        raise RuntimeError(f"{curve}: coordinate not canonical")
    if (y * y - (x * x * x + c["a"] * x + c["b"])) % p:
        raise RuntimeError(f"{curve}: point not on curve")


def ec_add(curve: str, x1: int, y1: int, x2: int, y2: int):
    c = CURVES[curve]
    p = c["p"]
    check_on_curve(curve, x1, y1)
    check_on_curve(curve, x2, y2)
    if x1 == x2:
        raise RuntimeError(
            f"{curve}_add: P and Q share an x coordinate (use DOUBLE; "
            "P + -P is rejected)"
        )
    lam = (y2 - y1) * pow(x2 - x1, p - 2, p) % p
    x3 = (lam * lam - x1 - x2) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return x3, y3


def ec_double(curve: str, x1: int, y1: int):
    c = CURVES[curve]
    p = c["p"]
    check_on_curve(curve, x1, y1)
    if y1 == 0:
        raise RuntimeError(f"{curve}_double: y = 0")
    lam = (3 * x1 * x1 + c["a"]) * pow(2 * y1, p - 2, p) % p
    x3 = (lam * lam - 2 * x1) % p
    y3 = (lam * (x1 - x3) - y1) % p
    return x3, y3


def decompress_y(curve: str, x: int, y_is_odd: int) -> int:
    c = CURVES[curve]
    p = c["p"]
    if not 0 <= x < p:
        raise RuntimeError(f"{curve}_decompress: x not canonical")
    if y_is_odd not in (0, 1):
        raise RuntimeError("y_is_odd must be 0/1")
    rhs = (x * x * x + c["a"] * x + c["b"]) % p
    y = pow(rhs, (p + 1) // 4, p)  # both moduli are 3 mod 4
    if y * y % p != rhs:
        raise RuntimeError(f"{curve}_decompress: x has no square root")
    if y & 1 != y_is_odd:
        y = p - y
    return y


def scalar_invert(curve: str, s: int) -> int:
    n = CURVES[curve]["order"]
    if not 0 < s < n:
        raise RuntimeError(f"{curve}_invert: scalar out of range")
    return pow(s, n - 2, n)


def fp_op(curve: str, op: str, x: int, y: int) -> int:
    p = CURVES[curve]["p"]
    if not (0 <= x < p and 0 <= y < p):
        raise RuntimeError(f"{curve}_fp_{op}: operand not canonical")
    return (x + y) % p if op == "add" else (x * y) % p


def fp2_op(curve: str, op: str, x0: int, x1: int, y0: int, y1: int):
    p = CURVES[curve]["p"]
    for v in (x0, x1, y0, y1):
        if not 0 <= v < p:
            raise RuntimeError(f"{curve}_fp2_{op}: operand not canonical")
    if op == "add":
        return (x0 + y0) % p, (x1 + y1) % p
    # u^2 = -1
    return (x0 * y0 - x1 * y1) % p, (x0 * y1 + x1 * y0) % p
