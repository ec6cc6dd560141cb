"""ELF32 riscv executable loader (and a minimal writer for fixtures).

Role mirror of the reference's ``Program::load_elf`` (ceno_emul/src/elf.rs:79-263):
parse a little-endian ELF32 ``ET_EXEC`` for ``EM_RISCV``, collect PT_LOAD
segments into a word-addressed memory image, take the single executable
segment as the instruction stream, zero-fill the bss tail up to the highest
symbol in each segment, pad the static image to a power of two, and read the
heap start from the ``_sheap`` symbol.

The writer (``write_elf``) produces the same shape of file from assembled
words + a data image so the loader round-trips without a riscv toolchain in
the environment; real guest ELFs linked against the reference's memory map
load identically.

Copy of ``ceno_tpu/emulator/elf.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

WORD_SIZE = 4

EM_RISCV = 243
ET_EXEC = 2
PT_LOAD = 1
PF_X, PF_W, PF_R = 1, 2, 4
SHT_SYMTAB = 2
SHT_STRTAB = 3


class ElfError(Exception):
    pass


@dataclass
class Program:
    """Loaded guest program (elf.rs:35-46 mirror)."""

    entry: int
    base_address: int          # lowest address of the executable segment
    sheap: int                 # heap start (_sheap symbol)
    instructions: list         # instruction words, contiguous from base_address
    image: dict = field(default_factory=dict)  # BYTE addr -> u32 word (all static data)

    @property
    def program_words(self) -> dict:
        """word_addr -> insn word, the VMState.program representation."""
        return {
            (self.base_address >> 2) + i: w
            for i, w in enumerate(self.instructions)
        }

    def data_image(self) -> dict:
        """word_addr -> u32 for the non-executable part of the static image."""
        text_lo = self.base_address
        text_hi = self.base_address + 4 * len(self.instructions)
        return {
            addr >> 2: w
            for addr, w in self.image.items()
            if not text_lo <= addr < text_hi
        }


def _u16(b, off):
    return struct.unpack_from("<H", b, off)[0]


def _u32(b, off):
    return struct.unpack_from("<I", b, off)[0]


def load_elf(data: bytes, max_mem: int = 1 << 32) -> Program:
    """Parse an ELF32 riscv executable (elf.rs:79-263 semantics)."""
    if len(data) < 52 or data[:4] != b"\x7fELF":
        raise ElfError("not an ELF file")
    if data[4] != 1:
        raise ElfError("not a 32-bit ELF")
    if data[5] != 1:
        raise ElfError("not little-endian")
    if _u16(data, 18) != EM_RISCV:
        raise ElfError("invalid machine type, must be RISC-V")
    if _u16(data, 16) != ET_EXEC:
        raise ElfError("invalid ELF type, must be executable")
    entry = _u32(data, 24)
    if entry >= max_mem or entry % WORD_SIZE != 0:
        raise ElfError("invalid entrypoint")

    phoff, shoff = _u32(data, 28), _u32(data, 32)
    phentsize, phnum = _u16(data, 42), _u16(data, 44)
    shentsize, shnum = _u16(data, 46), _u16(data, 48)
    if phnum > 256:
        raise ElfError("too many program headers")

    symbols = _symbols(data, shoff, shentsize, shnum)

    image: dict = {}
    instructions: list = []
    base_address = None
    for i in range(phnum):
        off = phoff + i * phentsize
        p_type = _u32(data, off)
        if p_type != PT_LOAD:
            continue
        p_offset = _u32(data, off + 4)
        vaddr = _u32(data, off + 8)
        filesz = _u32(data, off + 16)
        memsz = _u32(data, off + 20)
        flags = _u32(data, off + 24)
        if filesz >= max_mem or memsz >= max_mem:
            raise ElfError("invalid segment size")
        if vaddr % WORD_SIZE != 0:
            raise ElfError(f"vaddr {vaddr:#010x} is unaligned")
        if flags & PF_X:
            if base_address is not None:
                raise ElfError("only one executable segment is supported")
            base_address = vaddr
        for j in range(0, filesz, WORD_SIZE):
            addr = vaddr + j
            if addr >= max_mem:
                raise ElfError(f"address {addr:#x} exceeds max")
            chunk = data[p_offset + j : p_offset + min(j + 4, filesz)]
            word = int.from_bytes(chunk.ljust(4, b"\0"), "little")
            image[addr] = word
            if flags & PF_X:
                instructions.append(word)
        # zero-fill the bss tail only up to the highest symbol in range
        in_range = [a for a in symbols if vaddr <= a < vaddr + memsz]
        if in_range:
            zero_upper = max(0, max(in_range) - vaddr)
            start = (filesz + WORD_SIZE - 1) // WORD_SIZE * WORD_SIZE
            for j in range(start, int(zero_upper) + 1, WORD_SIZE):
                addr = vaddr + j
                if addr >= max_mem:
                    raise ElfError("zero-fill exceeds max")
                image.setdefault(addr, 0)

    if base_address is None:
        raise ElfError("no executable segment")
    if entry < base_address or entry - base_address > 4 * len(instructions):
        raise ElfError("entrypoint outside the executable segment")

    sheap = None
    for addr, name in symbols.items():
        if name == "_sheap":
            sheap = addr
    if sheap is None:
        raise ElfError("unable to find _sheap symbol")

    # pad the static image to the next power of two past the last address
    addrs = sorted(image)
    n = len(addrs)
    if n == 0:
        raise ElfError("empty image")
    target = 1 << (n - 1).bit_length()
    last = addrs[-1]
    for _ in range(target - n):
        last += WORD_SIZE
        image[last] = 0
    if last >= sheap:
        raise ElfError("padded static image overlaps the heap start")

    return Program(entry, base_address, sheap, instructions, image)


def _symbols(data, shoff, shentsize, shnum) -> dict:
    """addr -> name from .symtab (elf.rs:266-283 mirror)."""
    out: dict = {}
    sections = []
    for i in range(shnum):
        off = shoff + i * shentsize
        sections.append(
            dict(
                sh_type=_u32(data, off + 4),
                sh_offset=_u32(data, off + 16),
                sh_size=_u32(data, off + 20),
                sh_link=_u32(data, off + 24),
                sh_entsize=_u32(data, off + 36),
            )
        )
    for s in sections:
        if s["sh_type"] != SHT_SYMTAB or not s["sh_entsize"]:
            continue
        strtab = sections[s["sh_link"]]
        for off in range(s["sh_offset"], s["sh_offset"] + s["sh_size"],
                         s["sh_entsize"]):
            st_name = _u32(data, off)
            st_value = _u32(data, off + 4)
            if st_value == 0 or st_name == 0:
                continue
            end = data.index(b"\0", strtab["sh_offset"] + st_name)
            name = data[strtab["sh_offset"] + st_name : end].decode()
            if name:
                out[st_value] = name
    return out


def vm_from_program(prog: Program, platform=None):
    """VMState for a loaded guest: text as ROM, static data as init image."""
    from .state import VMState, Platform

    platform = platform or Platform()
    vm = VMState(prog.program_words, prog.entry, platform=platform)
    for waddr, word in prog.data_image().items():
        vm.init_memory(waddr << 2, word)
    return vm


def load_elf_vm(data: bytes, platform=None):
    return vm_from_program(load_elf(data), platform)


# ---------------------------------------------------------------------------
# Writer (test fixtures; mirrors what a linked riscv32 guest looks like)
# ---------------------------------------------------------------------------

def write_elf(
    text_words: list[int],
    text_base: int,
    entry: int | None = None,
    data: dict | None = None,      # byte addr -> u32 (one contiguous RW segment)
    sheap: int = 0x1000_0000,
    bss_words: int = 0,
    symbols: dict | None = None,   # extra name -> addr
) -> bytes:
    """Produce a loadable ELF32 riscv ET_EXEC image."""
    entry = text_base if entry is None else entry
    data = dict(data or {})
    symtab_syms = dict(symbols or {})
    symtab_syms["_sheap"] = sheap

    segs = [(text_base, b"".join(struct.pack("<I", w & 0xFFFFFFFF)
                                 for w in text_words), PF_R | PF_X, 0)]
    if data:
        addrs = sorted(data)
        lo, hi = addrs[0], addrs[-1]
        blob = bytearray(hi - lo + 4)
        for a, w in data.items():
            struct.pack_into("<I", blob, a - lo, w & 0xFFFFFFFF)
        segs.append((lo, bytes(blob), PF_R | PF_W, bss_words * 4))
        if bss_words:
            symtab_syms.setdefault("_ebss", hi + 4 + bss_words * 4 - 4)

    # layout: ehdr | phdrs | seg blobs | symtab | strtab | shdrs
    ehdr_size, phdr_size, shdr_size = 52, 32, 40
    off = ehdr_size + phdr_size * len(segs)
    phdrs, blobs = [], []
    for vaddr, blob, flags, extra_mem in segs:
        phdrs.append((PT_LOAD, off, vaddr, vaddr, len(blob),
                      len(blob) + extra_mem, flags, 4))
        blobs.append((off, blob))
        off += len(blob)

    strtab = bytearray(b"\0")
    syms = bytearray(b"\0" * 16)  # null symbol
    for name, addr in symtab_syms.items():
        st_name = len(strtab)
        strtab += name.encode() + b"\0"
        syms += struct.pack("<IIIBBH", st_name, addr, 0, 0, 0, 1)
    symtab_off = off
    off += len(syms)
    strtab_off = off
    off += len(strtab)
    shoff = off

    # sections: null, .symtab, .strtab
    shdrs = [
        (0,) * 10,
        (0, SHT_SYMTAB, 0, 0, symtab_off, len(syms), 2, 1, 4, 16),
        (0, SHT_STRTAB, 0, 0, strtab_off, len(strtab), 0, 0, 1, 0),
    ]

    out = bytearray()
    out += b"\x7fELF" + bytes([1, 1, 1, 0]) + b"\0" * 8
    out += struct.pack(
        "<HHIIIIIHHHHHH", ET_EXEC, EM_RISCV, 1, entry,
        ehdr_size, shoff, 0, ehdr_size, phdr_size, len(segs),
        shdr_size, len(shdrs), 2,
    )
    for p in phdrs:
        out += struct.pack("<IIIIIIII", *p)
    for o, blob in blobs:
        out += b"\0" * (o - len(out))
        out += blob
    out += syms
    out += strtab
    for s in shdrs:
        out += struct.pack("<IIIIIIIIII", *s)
    return bytes(out)
