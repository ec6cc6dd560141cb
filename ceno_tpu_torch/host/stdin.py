"""Hints input builder: bit-exact mirror of the reference host serde.

Role mirror of ``ceno_host::CenoStdin`` (ceno_host/src/lib.rs:27-113) over
the ``ceno_serde`` word format (ceno_serde/src/serializer.rs:94-310):

  * bool/u8/u16/u32/char -> one u32 word; i* sign-extend into the unsigned
    encoding; u64/i64 -> two LE words;
  * str / bytes -> length word + the bytes zero-padded to a word boundary;
  * sequences (python list) -> length word + elements; tuples -> elements
    only (fixed arity); ``None``/values wrap as Option tags 0/1 via
    :class:`Some`;
  * the finalized buffer is ``[data_offset_bytes, alignment,
    len_0, len_1, ...]`` header words followed by every item's serialized
    blob back-to-back, word-aligned (Items::finalise).

Python ints default to u32 when in range, u64 otherwise; use the explicit
wrappers (:class:`U64`, :class:`I32`...) to pin a width. The resulting words
load into the hints RAM window (``VMState.init_memory`` /CLI ``--hints-file``)
and guests walk them exactly like ceno_rt's mmio reader.

Copy of ``ceno_tpu/host/stdin.py``: the port keeps its own.
"""

from __future__ import annotations

from dataclasses import dataclass

WORD = 4


@dataclass
class U64:
    value: int


@dataclass
class I32:
    value: int


@dataclass
class I64:
    value: int


@dataclass
class Some:
    value: object


NONE = object()  # explicit Option::None sentinel


class _Writer:
    def __init__(self):
        self.words: list[int] = []

    def word(self, v: int) -> None:
        self.words.append(v & 0xFFFFFFFF)

    def padded_bytes(self, b: bytes) -> None:
        b = b + b"\0" * (-len(b) % WORD)
        for i in range(0, len(b), WORD):
            self.word(int.from_bytes(b[i : i + WORD], "little"))

    def value(self, v) -> None:
        if v is NONE:
            self.word(0)
        elif isinstance(v, Some):
            self.word(1)
            self.value(v.value)
        elif isinstance(v, bool):
            self.word(1 if v else 0)
        elif isinstance(v, U64):
            self.word(v.value & 0xFFFFFFFF)
            self.word((v.value >> 32) & 0xFFFFFFFF)
        elif isinstance(v, (I32,)):
            self.word(v.value & 0xFFFFFFFF)
        elif isinstance(v, I64):
            self.word(v.value & 0xFFFFFFFF)
            self.word((v.value >> 32) & 0xFFFFFFFF)
        elif isinstance(v, int):
            if 0 <= v < (1 << 32):
                self.word(v)
            elif -(1 << 31) <= v < 0:
                self.word(v & 0xFFFFFFFF)
            elif 0 <= v < (1 << 64):
                self.value(U64(v))
            else:
                raise ValueError(f"int {v} out of u64 range; wrap explicitly")
        elif isinstance(v, str):
            b = v.encode()
            self.word(len(b))
            self.padded_bytes(b)
        elif isinstance(v, (bytes, bytearray)):
            self.word(len(v))
            self.padded_bytes(bytes(v))
        elif isinstance(v, list):
            self.word(len(v))
            for e in v:
                self.value(e)
        elif isinstance(v, tuple):
            for e in v:
                self.value(e)
        else:
            raise TypeError(f"cannot serialize {type(v).__name__}")


def to_item_words(value) -> list[int]:
    """ceno_serde::to_vec mirror: one value -> u32 words."""
    w = _Writer()
    w.value(value)
    return w.words


class CenoStdin:
    """Accumulates hint items; ``to_words()`` yields the finalized buffer."""

    def __init__(self):
        self.items: list[list[int]] = []

    def write(self, value) -> "CenoStdin":
        self.items.append(to_item_words(value))
        return self

    def to_words(self) -> list[int]:
        header = [0, WORD] + [len(it) * WORD for it in self.items]
        data_offset = len(header) * WORD  # already word-aligned
        header[0] = data_offset
        out = list(header)
        for it in self.items:
            out.extend(it)
        return out

    def to_bytes(self) -> bytes:
        return b"".join(w.to_bytes(WORD, "little") for w in self.to_words())


class _Reader:
    def __init__(self, words: list[int]):
        self.words = words
        self.pos = 0

    def word(self) -> int:
        v = self.words[self.pos]
        self.pos += 1
        return v

    def padded_bytes(self, n: int) -> bytes:
        k = -(-n // WORD)
        out = b"".join(
            self.words[self.pos + i].to_bytes(WORD, "little") for i in range(k)
        )
        self.pos += k
        return out[:n]


def from_words(words: list[int], schema) -> list:
    """Decode a finalized hints buffer given per-item schemas.

    schema: list of type descriptors, one per item —
    'u32' | 'u64' | 'str' | 'bytes' | ('list', inner) | ('tuple', [inner...])
    | ('option', inner)."""
    data_offset = words[0]
    alignment = words[1]
    if alignment != WORD:
        raise ValueError("unsupported hint alignment")
    n_items = data_offset // WORD - 2
    lens = words[2 : 2 + n_items]
    body = words[data_offset // WORD :]
    out = []
    off = 0
    for ln, sch in zip(lens, schema):
        r = _Reader(body[off : off + ln // WORD])
        out.append(_decode(r, sch))
        off += ln // WORD
    return out


def _decode(r: _Reader, sch):
    if sch == "u32":
        return r.word()
    if sch == "u64":
        lo = r.word()
        return lo | (r.word() << 32)
    if sch == "bool":
        return bool(r.word())
    if sch == "str":
        n = r.word()
        return r.padded_bytes(n).decode()
    if sch == "bytes":
        n = r.word()
        return r.padded_bytes(n)
    kind, inner = sch[0], sch[1]
    if kind == "list":
        n = r.word()
        return [_decode(r, inner) for _ in range(n)]
    if kind == "tuple":
        return tuple(_decode(r, s) for s in inner)
    if kind == "option":
        return _decode(r, inner) if r.word() else None
    raise ValueError(f"unknown schema {sch!r}")
