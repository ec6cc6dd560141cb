"""Proof (de)serialization: flat, data-only, versioned binary format.

Proof bytes come from an UNTRUSTED prover, so deserialization must never
execute code (the round-1 pickle stopgap was arbitrary-code-execution — see
ADVICE.md). Format v2 is a tagged tree encoding with an explicit dataclass
whitelist: every node is one of None / bool / int / str / bytes / list /
dict / numpy array / whitelisted dataclass, reconstructed field by field.
Numpy arrays carry an explicit dtype code and shape and are bounds-checked.

The verifying key is NOT serialized: keygen is deterministic from
(program, config, params), so verifiers re-derive it from the guest program
(the CLI does exactly this), mirroring how the reference's vk is reproducible
from the circuit registry. The embedded cfg/params are informational; the CLI
verifier pins its own and rejects proofs whose embedded copies differ
(ADVICE.md: an attacker must not choose n_queries/blowup).

Counterpart of ``ceno_tpu/zkvm/serialize.py``: the same format, byte for
byte. Its whitelist holds the port's own classes of the reference's: a
shard's proof with either inner opening (Basefold's or WHIR's), the EC-sum
quark's, the sharded proof's and the aggregation proof's. Every array of a
proof object must be numpy, ``uint64`` exactly where the reference has one:
a tensor raises, and another dtype encodes to other bytes.
"""

from __future__ import annotations

import dataclasses
import io
import struct

import numpy as np

MAGIC = b"CENOTPU3"  # v3: packed uint32 payloads for sub-2^32 uint64 arrays

# Hard ceilings for untrusted input (a 2^24-row proof is far below these).
MAX_ARRAY_BYTES = 1 << 31
MAX_CONTAINER = 1 << 22
MAX_DEPTH = 32

_DTYPES = {0: np.uint64, 1: np.uint32, 2: np.int32, 3: np.int64, 4: np.uint8}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def _whitelist():
    """name -> class map of every dataclass allowed in a proof tree."""
    from ..gkr.chip import ChipProof, ClassMainProof
    from ..gkr.tower import TowerProof
    from ..pcs.basefold import BasefoldParams, OpeningProof, QueryProof
    from ..pcs.jagged import JaggedOpening
    from ..pcs.whir import WhirProof, WhirIter, WhirQuerySet
    from .tables import ZKVMConfig
    from ..emulator.state import Platform
    from .scheme import ZKVMProof
    from ..gkr.eccquark import EccQuarkProof
    from .shard import ShardedProof
    from .aggregate import AggProof, ShardGeometry

    classes = [
        ZKVMProof, ChipProof, ClassMainProof, TowerProof,
        OpeningProof, QueryProof, JaggedOpening,
        WhirProof, WhirIter, WhirQuerySet,
        BasefoldParams, ZKVMConfig, Platform, EccQuarkProof, ShardedProof,
        AggProof, ShardGeometry,
    ]
    return {c.__name__: c for c in classes}


class ProofFormatError(Exception):
    pass


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def _w_varint(buf: io.BytesIO, n: int) -> None:
    if n < 0:
        raise ProofFormatError("negative length")
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def _encode(buf: io.BytesIO, obj, depth: int = 0) -> None:
    if depth > MAX_DEPTH:
        raise ProofFormatError("encode depth exceeded")
    if obj is None:
        buf.write(b"N")
    elif isinstance(obj, bool):
        buf.write(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        buf.write(b"I")
        buf.write(struct.pack("<q", int(obj)))
    elif isinstance(obj, str):
        raw = obj.encode()
        buf.write(b"S")
        _w_varint(buf, len(raw))
        buf.write(raw)
    elif isinstance(obj, bytes):
        buf.write(b"B")
        _w_varint(buf, len(obj))
        buf.write(obj)
    elif isinstance(obj, np.ndarray):
        code = _DTYPE_CODES.get(obj.dtype)
        if code is None:
            raise ProofFormatError(f"unsupported dtype {obj.dtype}")
        if obj.dtype == np.uint64 and (
            obj.size == 0 or int(obj.max()) < (1 << 32)
        ):
            # canonical BabyBear values are < 2^31: pack the payload as
            # uint32 (halves the proof; decode restores uint64)
            buf.write(b"a")
            _w_varint(buf, obj.ndim)
            for s in obj.shape:
                _w_varint(buf, s)
            buf.write(np.ascontiguousarray(obj.astype(np.uint32)).tobytes())
        else:
            buf.write(b"A")
            buf.write(bytes([code]))
            _w_varint(buf, obj.ndim)
            for s in obj.shape:
                _w_varint(buf, s)
            buf.write(np.ascontiguousarray(obj).tobytes())
    elif isinstance(obj, (list, tuple)):
        buf.write(b"L")
        _w_varint(buf, len(obj))
        for v in obj:
            _encode(buf, v, depth + 1)
    elif isinstance(obj, dict):
        buf.write(b"D")
        _w_varint(buf, len(obj))
        for k, v in obj.items():
            _encode(buf, k, depth + 1)
            _encode(buf, v, depth + 1)
    elif dataclasses.is_dataclass(obj):
        name = type(obj).__name__
        buf.write(b"C")
        _encode(buf, name, depth + 1)
        fields = dataclasses.fields(obj)
        _w_varint(buf, len(fields))
        for f in fields:
            _encode(buf, f.name, depth + 1)
            _encode(buf, getattr(obj, f.name), depth + 1)
    else:
        raise ProofFormatError(f"unsupported type {type(obj)}")


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.data):
            raise ProofFormatError("truncated input")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        n = shift = 0
        while True:
            b = self.take(1)[0]
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
            if shift > 63:
                raise ProofFormatError("varint overflow")
        return n


def _decode(r: _Reader, wl: dict, depth: int = 0):
    if depth > MAX_DEPTH:
        raise ProofFormatError("decode depth exceeded")
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"I":
        return struct.unpack("<q", r.take(8))[0]
    if tag == b"S":
        return r.take(r.varint()).decode()
    if tag == b"B":
        return r.take(r.varint())
    if tag == b"A":
        code = r.take(1)[0]
        if code not in _DTYPES:
            raise ProofFormatError(f"bad dtype code {code}")
        dt = np.dtype(_DTYPES[code])
        ndim = r.varint()
        if ndim > 8:
            raise ProofFormatError("array rank too large")
        shape = tuple(r.varint() for _ in range(ndim))
        count = 1
        for s in shape:
            count *= s
        nbytes = count * dt.itemsize
        if nbytes > MAX_ARRAY_BYTES:
            raise ProofFormatError("array too large")
        return np.frombuffer(r.take(nbytes), dtype=dt).reshape(shape).copy()
    if tag == b"a":  # packed uint64 (uint32 payload)
        ndim = r.varint()
        if ndim > 8:
            raise ProofFormatError("array rank too large")
        shape = tuple(r.varint() for _ in range(ndim))
        count = 1
        for s_ in shape:
            count *= s_
        nbytes = count * 4
        if nbytes > MAX_ARRAY_BYTES:
            raise ProofFormatError("array too large")
        return (
            np.frombuffer(r.take(nbytes), dtype=np.uint32)
            .reshape(shape).astype(np.uint64)
        )
    if tag == b"L":
        n = r.varint()
        if n > MAX_CONTAINER:
            raise ProofFormatError("list too large")
        return [_decode(r, wl, depth + 1) for _ in range(n)]
    if tag == b"D":
        n = r.varint()
        if n > MAX_CONTAINER:
            raise ProofFormatError("dict too large")
        out = {}
        for _ in range(n):
            k = _decode(r, wl, depth + 1)
            if not isinstance(k, (str, int)):
                raise ProofFormatError("dict key must be str or int")
            out[k] = _decode(r, wl, depth + 1)
        return out
    if tag == b"C":
        name = _decode(r, wl, depth + 1)
        cls = wl.get(name)
        if cls is None:
            raise ProofFormatError(f"dataclass {name!r} not allowed")
        nf = r.varint()
        allowed = {f.name for f in dataclasses.fields(cls)}
        if nf > len(allowed):
            raise ProofFormatError(f"{name}: too many fields")
        kwargs = {}
        for _ in range(nf):
            fname = _decode(r, wl, depth + 1)
            if fname not in allowed:
                raise ProofFormatError(f"{name}: unknown field {fname!r}")
            kwargs[fname] = _decode(r, wl, depth + 1)
        return cls(**kwargs)
    raise ProofFormatError(f"bad tag {tag!r}")


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------

def proof_to_bytes(proof, public_values: np.ndarray, cfg, params) -> bytes:
    buf = io.BytesIO()
    buf.write(MAGIC)
    _encode(
        buf,
        {
            "proof": proof,
            "public_values": np.asarray(public_values, np.uint64),
            "cfg": cfg,
            "params": params,
        },
    )
    return buf.getvalue()


def agg_proof_to_bytes(aproof, params) -> bytes:
    """Serialize an aggregation proof (zkvm/aggregate.py::AggProof). The
    AggKey is NOT serialized — it is key material the verifier derives from
    the shard vk / proof geometry (like the shard VerifyingKey)."""
    buf = io.BytesIO()
    buf.write(MAGIC)
    _encode(buf, {"agg_proof": aproof, "params": params})
    return buf.getvalue()


def agg_proof_from_bytes(data: bytes):
    if data[:8] != MAGIC:
        raise ProofFormatError("not a ceno-tpu proof (bad magic)")
    r = _Reader(data[8:])
    try:
        obj = _decode(r, _whitelist())
    except ProofFormatError:
        raise
    except Exception as e:
        raise ProofFormatError(f"malformed proof: {type(e).__name__}") from None
    if r.pos != len(r.data):
        raise ProofFormatError("trailing bytes after proof")
    if not isinstance(obj, dict):
        raise ProofFormatError("top-level object must be a dict")
    try:
        return obj["agg_proof"], obj["params"]
    except KeyError as e:
        raise ProofFormatError(f"missing top-level key {e}") from None


def proof_from_bytes(data: bytes):
    if data[:8] != MAGIC:
        raise ProofFormatError("not a ceno-tpu proof (bad magic)")
    r = _Reader(data[8:])
    try:
        obj = _decode(r, _whitelist())
    except ProofFormatError:
        raise
    except Exception as e:  # malformed input must NEVER escape as an
        # implementation-detail exception (the decoder is an attacker
        # surface; callers catch ProofFormatError only)
        raise ProofFormatError(f"malformed proof: {type(e).__name__}") from None
    if r.pos != len(r.data):
        raise ProofFormatError("trailing bytes after proof")
    if not isinstance(obj, dict):
        raise ProofFormatError("top-level object must be a dict")
    try:
        return obj["proof"], obj["public_values"], obj["cfg"], obj["params"]
    except KeyError as e:
        raise ProofFormatError(f"missing top-level key {e}") from None
