"""rv32im instruction set: kinds, decode, and a mini-assembler.

Role mirror of the reference's ``ceno_emul`` ISA layer (rv32im.rs:168-218,
SURVEY.md §2.1): the 45 InsnKind variants, format classification, and a
decoder from raw 32-bit words. The assembler exists because this environment
has no riscv toolchain — test guests are written directly in it (the ELF
loader in elf.py accepts external riscv32im ELFs too).

Copy of ``ceno_tpu/emulator/rv32im.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass

# Instruction kinds (mirror InsnKind)
KINDS = [
    "ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA", "OR", "AND",
    "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU",
    "ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI", "SLLI", "SRLI", "SRAI",
    "LB", "LH", "LW", "LBU", "LHU", "JALR",
    "SB", "SH", "SW",
    "BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU",
    "LUI", "AUIPC", "JAL", "ECALL", "INVALID",
    # pseudo-kinds: never produced by decode(); the trace re-kinds ECALL
    # steps by syscall code so each syscall routes to its own chip
    "SYS_KECCAK", "SYS_COMMIT", "SYS_SHA_EXTEND", "SYS_UINT256_MUL",
    "SYS_SECP256K1_ADD", "SYS_SECP256K1_DOUBLE", "SYS_SECP256K1_DECOMPRESS",
    "SYS_SECP256K1_SCALAR_INVERT",
    "SYS_SECP256R1_ADD", "SYS_SECP256R1_DOUBLE", "SYS_SECP256R1_DECOMPRESS",
    "SYS_SECP256R1_SCALAR_INVERT",
    "SYS_BN254_ADD", "SYS_BN254_DOUBLE", "SYS_BN254_FP_ADD",
    "SYS_BN254_FP_MUL", "SYS_BN254_FP2_ADD", "SYS_BN254_FP2_MUL",
]
K = {name: i for i, name in enumerate(KINDS)}

R_KINDS = {K[x] for x in [
    "ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA", "OR", "AND",
    "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU"]}
I_ARITH_KINDS = {K[x] for x in [
    "ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI", "SLLI", "SRLI", "SRAI"]}
LOAD_KINDS = {K[x] for x in ["LB", "LH", "LW", "LBU", "LHU"]}
STORE_KINDS = {K[x] for x in ["SB", "SH", "SW"]}
BRANCH_KINDS = {K[x] for x in ["BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"]}


@dataclass
class DecodedInsn:
    kind: int
    rd: int
    rs1: int
    rs2: int
    imm: int  # sign-extended where applicable
    raw: int

    @property
    def name(self):
        return KINDS[self.kind]


def _sext(v: int, bits: int) -> int:
    m = 1 << (bits - 1)
    return (v ^ m) - m


_R_FUNCT = {
    (0b000, 0): "ADD", (0b000, 0x20): "SUB", (0b001, 0): "SLL",
    (0b010, 0): "SLT", (0b011, 0): "SLTU", (0b100, 0): "XOR",
    (0b101, 0): "SRL", (0b101, 0x20): "SRA", (0b110, 0): "OR", (0b111, 0): "AND",
    (0b000, 1): "MUL", (0b001, 1): "MULH", (0b010, 1): "MULHSU", (0b011, 1): "MULHU",
    (0b100, 1): "DIV", (0b101, 1): "DIVU", (0b110, 1): "REM", (0b111, 1): "REMU",
}
_I_FUNCT = {0b000: "ADDI", 0b010: "SLTI", 0b011: "SLTIU", 0b100: "XORI",
            0b110: "ORI", 0b111: "ANDI"}
_L_FUNCT = {0b000: "LB", 0b001: "LH", 0b010: "LW", 0b100: "LBU", 0b101: "LHU"}
_S_FUNCT = {0b000: "SB", 0b001: "SH", 0b010: "SW"}
_B_FUNCT = {0b000: "BEQ", 0b001: "BNE", 0b100: "BLT", 0b101: "BGE",
            0b110: "BLTU", 0b111: "BGEU"}


def decode(word: int) -> DecodedInsn:
    op = word & 0x7F
    rd = (word >> 7) & 0x1F
    f3 = (word >> 12) & 0x7
    rs1 = (word >> 15) & 0x1F
    rs2 = (word >> 20) & 0x1F
    f7 = (word >> 25) & 0x7F
    if op == 0x33:  # R
        name = _R_FUNCT.get((f3, f7))
        if name:
            return DecodedInsn(K[name], rd, rs1, rs2, 0, word)
    elif op == 0x13:  # I arith
        if f3 == 0b001 and f7 == 0:
            return DecodedInsn(K["SLLI"], rd, rs1, 0, rs2, word)
        if f3 == 0b101:
            return DecodedInsn(K["SRAI" if f7 == 0x20 else "SRLI"], rd, rs1, 0, rs2, word)
        name = _I_FUNCT.get(f3)
        if name:
            return DecodedInsn(K[name], rd, rs1, 0, _sext(word >> 20, 12), word)
    elif op == 0x03:  # loads
        name = _L_FUNCT.get(f3)
        if name:
            return DecodedInsn(K[name], rd, rs1, 0, _sext(word >> 20, 12), word)
    elif op == 0x67 and f3 == 0:  # JALR
        return DecodedInsn(K["JALR"], rd, rs1, 0, _sext(word >> 20, 12), word)
    elif op == 0x23:  # stores
        name = _S_FUNCT.get(f3)
        if name:
            imm = _sext((f7 << 5) | rd, 12)
            return DecodedInsn(K[name], 0, rs1, rs2, imm, word)
    elif op == 0x63:  # branches
        name = _B_FUNCT.get(f3)
        if name:
            imm = ((word >> 31) << 12) | (((word >> 7) & 1) << 11) | \
                  (((word >> 25) & 0x3F) << 5) | (((word >> 8) & 0xF) << 1)
            return DecodedInsn(K[name], 0, rs1, rs2, _sext(imm, 13), word)
    elif op == 0x37:
        return DecodedInsn(K["LUI"], rd, 0, 0, word & 0xFFFFF000, word)
    elif op == 0x17:
        return DecodedInsn(K["AUIPC"], rd, 0, 0, word & 0xFFFFF000, word)
    elif op == 0x6F:
        imm = ((word >> 31) << 20) | (((word >> 12) & 0xFF) << 12) | \
              (((word >> 20) & 1) << 11) | (((word >> 21) & 0x3FF) << 1)
        return DecodedInsn(K["JAL"], rd, 0, 0, _sext(imm, 21), word)
    elif op == 0x73 and word in (0x73,):
        return DecodedInsn(K["ECALL"], 0, 0, 0, 0, word)
    return DecodedInsn(K["INVALID"], 0, 0, 0, 0, word)


# ---------------------------------------------------------------------------
# Mini-assembler
# ---------------------------------------------------------------------------

_REGS = {f"x{i}": i for i in range(32)}
_REGS.update({
    "zero": 0, "ra": 1, "sp": 2, "gp": 3, "tp": 4, "t0": 5, "t1": 6, "t2": 7,
    "s0": 8, "fp": 8, "s1": 9, "a0": 10, "a1": 11, "a2": 12, "a3": 13,
    "a4": 14, "a5": 15, "a6": 16, "a7": 17,
    **{f"s{i}": 16 + i for i in range(2, 12)},
    **{f"t{i}": 25 + i for i in range(3, 7)},
})


def _enc_r(name, rd, rs1, rs2):
    f3, f7 = next((k for k, v in _R_FUNCT.items() if v == name))
    return 0x33 | (rd << 7) | (f3 << 12) | (rs1 << 15) | (rs2 << 20) | (f7 << 25)


def _enc_i(op, f3, rd, rs1, imm, f7=0):
    return op | (rd << 7) | (f3 << 12) | (rs1 << 15) | ((imm & 0xFFF) << 20) | (f7 << 25)


def assemble(src: str, base: int = 0x0800_0000) -> list[int]:
    """Two-pass assembler: returns list of 32-bit instruction words."""
    lines = []
    for raw in src.strip().splitlines():
        line = raw.split("#")[0].strip()
        if line:
            lines.append(line)
    # pass 1: labels (LI always expands to exactly 2 words)
    labels = {}
    pc = base
    prog = []
    for line in lines:
        if line.endswith(":"):
            labels[line[:-1]] = pc
        else:
            prog.append((pc, line))
            pc += 8 if line.split()[0].upper() == "LI" else 4
    words = []
    for pc, line in prog:
        parts = line.replace(",", " ").split()
        op = parts[0].upper()
        args = parts[1:]

        def reg(a):
            return _REGS[a.lower()]

        def imm(a):
            if a in labels:
                return labels[a]
            return int(a, 0)

        if op in ("ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA",
                  "OR", "AND", "MUL", "MULH", "MULHSU", "MULHU", "DIV",
                  "DIVU", "REM", "REMU"):
            words.append(_enc_r(op, reg(args[0]), reg(args[1]), reg(args[2])))
        elif op in ("ADDI", "SLTI", "SLTIU", "XORI", "ORI", "ANDI"):
            f3 = next(k for k, v in _I_FUNCT.items() if v == op)
            words.append(_enc_i(0x13, f3, reg(args[0]), reg(args[1]), imm(args[2])))
        elif op in ("SLLI", "SRLI", "SRAI"):
            f3 = 0b001 if op == "SLLI" else 0b101
            f7 = 0x20 if op == "SRAI" else 0
            sh = imm(args[2]) & 0x1F
            words.append(_enc_i(0x13, f3, reg(args[0]), reg(args[1]), sh | (f7 << 5)))
        elif op in ("LB", "LH", "LW", "LBU", "LHU"):
            f3 = next(k for k, v in _L_FUNCT.items() if v == op)
            off, rs1 = args[1].split("(")
            words.append(_enc_i(0x03, f3, reg(args[0]), reg(rs1[:-1]), imm(off or "0")))
        elif op in ("SB", "SH", "SW"):
            f3 = next(k for k, v in _S_FUNCT.items() if v == op)
            off, rs1 = args[1].split("(")
            i = imm(off or "0")
            words.append(
                0x23 | ((i & 0x1F) << 7) | (f3 << 12) | (reg(rs1[:-1]) << 15)
                | (reg(args[0]) << 20) | (((i >> 5) & 0x7F) << 25)
            )
        elif op in ("BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"):
            f3 = next(k for k, v in _B_FUNCT.items() if v == op)
            target = imm(args[2])
            off = target - pc
            assert off % 2 == 0 and -4096 <= off < 4096
            words.append(
                0x63 | (((off >> 11) & 1) << 7) | (((off >> 1) & 0xF) << 8)
                | (f3 << 12) | (reg(args[0]) << 15) | (reg(args[1]) << 20)
                | (((off >> 5) & 0x3F) << 25) | (((off >> 12) & 1) << 31)
            )
        elif op == "LUI":
            words.append(0x37 | (reg(args[0]) << 7) | (imm(args[1]) & 0xFFFFF) << 12)
        elif op == "AUIPC":
            words.append(0x17 | (reg(args[0]) << 7) | (imm(args[1]) & 0xFFFFF) << 12)
        elif op == "JAL":
            rd = reg(args[0]) if len(args) == 2 else 0
            target = imm(args[-1])
            off = target - pc
            assert off % 2 == 0
            words.append(
                0x6F | (rd << 7) | (((off >> 12) & 0xFF) << 12)
                | (((off >> 11) & 1) << 20) | (((off >> 1) & 0x3FF) << 21)
                | (((off >> 20) & 1) << 31)
            )
        elif op == "JALR":
            if "(" in args[-1]:
                off, rs1 = args[-1].split("(")
                words.append(_enc_i(0x67, 0, reg(args[0]), reg(rs1[:-1]), imm(off or "0")))
            else:
                words.append(_enc_i(0x67, 0, reg(args[0]), reg(args[1]), imm(args[2])))
        elif op == "ECALL":
            words.append(0x73)
        elif op == "LI":  # pseudo: lui+addi or addi
            v = imm(args[1]) & 0xFFFFFFFF
            lo = _sext(v & 0xFFF, 12)
            hi = (v - lo) >> 12 & 0xFFFFF
            if hi:
                words.append(0x37 | (reg(args[0]) << 7) | (hi << 12))
                if lo:
                    words.append(_enc_i(0x13, 0, reg(args[0]), reg(args[0]), lo))
                else:
                    # keep length == label math: emit a nop-like addi 0
                    words.append(_enc_i(0x13, 0, reg(args[0]), reg(args[0]), 0))
            else:
                words.append(_enc_i(0x13, 0, reg(args[0]), 0, lo))
                words.append(_enc_i(0x13, 0, 0, 0, 0))  # nop for fixed size
        elif op == "NOP":
            words.append(_enc_i(0x13, 0, 0, 0, 0))
        elif op == "MV":
            words.append(_enc_i(0x13, 0, reg(args[0]), reg(args[1]), 0))
        elif op == "J":
            target = imm(args[0])
            off = target - pc
            words.append(
                0x6F | (0 << 7) | (((off >> 12) & 0xFF) << 12)
                | (((off >> 11) & 1) << 20) | (((off >> 1) & 0x3FF) << 21)
                | (((off >> 20) & 1) << 31)
            )
        else:
            raise ValueError(f"unknown mnemonic {op}")
    return words
