"""VM state + step execution with trace recording.

Role mirror of ``ceno_emul``'s ``VMState``/``Tracer`` (vm_state.rs:21,
tracer.rs:298 — SURVEY.md §2.1/§3.4). Conventions copied as protocol facts:
  * 4 subcycles per instruction, slots RS1=0, RS2=1, RD=2, MEM=3
    (tracer.rs:306,1219-1223); cycle numbering starts at CYCLE_START.
  * the reference Platform memory map (platform.rs:90-94): rom
    0x0800_0000.., heap 0x1000_0000.., hints 0x2800_0000.., stack
    0x3000_0000...
  * ecall: code in t0 (x5); HALT = 0 with exit code in a0.
Each step records (pc, next_pc, kind, reg/mem reads+writes with previous
timestamps) — exactly the inputs the opcode circuits' witgen needs for
offline memory checking.

Copy of ``ceno_tpu/emulator/state.py``: the port keeps its own, with the same
relative imports.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .rv32im import decode, DecodedInsn, K, LOAD_KINDS, STORE_KINDS, BRANCH_KINDS

WORD = 0xFFFFFFFF

SUBCYCLE_RS1 = 0
SUBCYCLE_RS2 = 1
SUBCYCLE_RD = 2
SUBCYCLE_MEM = 3
SUBCYCLES_PER_INSN = 4
CYCLE_START = 4  # first instruction's base timestamp; init accesses use ts 0


@dataclass
class Platform:
    rom_start: int = 0x0800_0000
    heap_start: int = 0x1000_0000
    hints_start: int = 0x2800_0000
    stack_start: int = 0x3000_0000
    stack_top: int = 0x4000_0000
    # guest println region (ceno_rt INFO_OUT_ADDR role): length-prefixed
    # byte messages written with plain stores, read back by the host. The
    # reference parks it at 0x4000_0000; here it sits right above the heap
    # (whose reference extent is 0x1000_0000..0x2000_0000, platform.rs:90)
    # because this framework's u16+u12 address decomposition needs word
    # addresses < 2^28, i.e. byte addresses < 0x4000_0000.
    info_start: int = 0x2000_0000
    info_end: int = 0x2800_0000

    # ecall codes (mirror ceno_emul syscalls.rs)
    ECALL_HALT = 0
    ECALL_KECCAK = 0x01_01_09
    ECALL_COMMIT = 0x01_01_20
    ECALL_SHA_EXTEND = 0x30_01_05
    ECALL_UINT256_MUL = 0x01_01_1D
    ECALL_SECP256K1_ADD = 0x01_01_0A
    ECALL_SECP256K1_DOUBLE = 0x01_01_0B
    ECALL_SECP256K1_DECOMPRESS = 0x01_01_0C
    ECALL_SECP256K1_SCALAR_INVERT = 0x01_01_30
    ECALL_SECP256R1_ADD = 0x01_01_2C
    ECALL_SECP256R1_DOUBLE = 0x01_01_2D
    ECALL_SECP256R1_DECOMPRESS = 0x01_01_2E
    ECALL_SECP256R1_SCALAR_INVERT = 0x01_01_31
    ECALL_BN254_ADD = 0x01_01_0E
    ECALL_BN254_DOUBLE = 0x01_01_0F
    ECALL_BN254_FP_ADD = 0x01_01_26
    ECALL_BN254_FP_MUL = 0x01_01_28
    ECALL_BN254_FP2_ADD = 0x01_01_29
    ECALL_BN254_FP2_MUL = 0x01_01_2B


# curve/fptower ecall code -> (curve, op) for the generic dispatcher
_EC_CODES = {
    Platform.ECALL_SECP256K1_ADD: ("secp256k1", "add"),
    Platform.ECALL_SECP256K1_DOUBLE: ("secp256k1", "double"),
    Platform.ECALL_SECP256K1_DECOMPRESS: ("secp256k1", "decompress"),
    Platform.ECALL_SECP256K1_SCALAR_INVERT: ("secp256k1", "invert"),
    Platform.ECALL_SECP256R1_ADD: ("secp256r1", "add"),
    Platform.ECALL_SECP256R1_DOUBLE: ("secp256r1", "double"),
    Platform.ECALL_SECP256R1_DECOMPRESS: ("secp256r1", "decompress"),
    Platform.ECALL_SECP256R1_SCALAR_INVERT: ("secp256r1", "invert"),
    Platform.ECALL_BN254_ADD: ("bn254", "add"),
    Platform.ECALL_BN254_DOUBLE: ("bn254", "double"),
    Platform.ECALL_BN254_FP_ADD: ("bn254", "fp_add"),
    Platform.ECALL_BN254_FP_MUL: ("bn254", "fp_mul"),
    Platform.ECALL_BN254_FP2_ADD: ("bn254", "fp2_add"),
    Platform.ECALL_BN254_FP2_MUL: ("bn254", "fp2_mul"),
}


# ecall code -> pseudo-kind name (rv32im.KINDS) for trace re-kinding
SYSCALL_KIND_NAMES = {
    Platform.ECALL_KECCAK: "SYS_KECCAK",
    Platform.ECALL_COMMIT: "SYS_COMMIT",
    Platform.ECALL_SHA_EXTEND: "SYS_SHA_EXTEND",
    Platform.ECALL_UINT256_MUL: "SYS_UINT256_MUL",
    **{
        code: "SYS_{}_{}".format(
            c.upper(), "SCALAR_INVERT" if op == "invert" else op.upper()
        )
        for code, (c, op) in _EC_CODES.items()
    },
}


@dataclass
class StepRecord:
    cycle: int           # base timestamp (CYCLE_START + 4*step_index)
    pc: int
    next_pc: int
    insn: DecodedInsn
    rs1: tuple | None = None    # (reg, value, prev_ts)
    rs2: tuple | None = None
    rd: tuple | None = None     # (reg, prev_value, new_value, prev_ts)
    mem: tuple | None = None    # (addr, prev_value, new_value, prev_ts) word-addressed
    # syscall bulk memory ops (keccak: 50 words), same tuple shape as mem
    sys_mem: list | None = None


@dataclass
class VMState:
    program: dict            # word_addr -> insn word
    entry: int
    platform: Platform = field(default_factory=Platform)
    pc: int = 0
    regs: list = field(default_factory=lambda: [0] * 32)
    mem: dict = field(default_factory=dict)          # word_addr -> u32
    reg_ts: list = field(default_factory=lambda: [0] * 32)
    mem_ts: dict = field(default_factory=dict)       # word_addr -> ts
    cycle: int = CYCLE_START
    halted: bool = False
    exit_code: int = 0
    # init snapshots for table circuits
    mem_init: dict = field(default_factory=dict)
    touched: set = field(default_factory=set)
    # PUB_IO_COMMIT digest words (None until the guest commits)
    pubio_digest: list | None = None

    def __post_init__(self):
        self.pc = self.entry
        self.regs[2] = self.platform.stack_top - 0x100  # sp

    # -- memory -------------------------------------------------------------

    def load_word(self, addr: int) -> int:
        waddr = addr >> 2
        return self.mem.get(waddr, 0)

    def store_word(self, addr: int, value: int) -> None:
        self.mem[addr >> 2] = value & WORD

    def init_memory(self, addr: int, value: int) -> None:
        """Pre-execution memory image (program data, hints)."""
        waddr = addr >> 2
        self.mem[waddr] = value & WORD
        self.mem_init[waddr] = value & WORD

    # -- one step -----------------------------------------------------------

    def step(self) -> StepRecord:
        assert not self.halted
        word = self.program.get(self.pc >> 2)
        if word is None:
            raise RuntimeError(f"pc {self.pc:#x} outside program")
        insn = decode(word)
        k = insn.kind
        ts = self.cycle
        rec = StepRecord(ts, self.pc, self.pc + 4, insn)

        def read_reg(r, slot):
            v = self.regs[r]
            prev = self.reg_ts[r]
            self.reg_ts[r] = ts + slot
            return (r, v, prev)

        def write_reg(r, v, slot):
            prev_v = self.regs[r]
            prev = self.reg_ts[r]
            if r != 0:
                self.regs[r] = v & WORD
            self.reg_ts[r] = ts + slot
            return (r, prev_v, self.regs[r], prev)

        name = insn.name
        if k in LOAD_KINDS or name == "JALR" or k in STORE_KINDS or k in BRANCH_KINDS \
           or name in ("ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA",
                        "OR", "AND", "MUL", "MULH", "MULHSU", "MULHU", "DIV",
                        "DIVU", "REM", "REMU", "ADDI", "SLTI", "SLTIU", "XORI",
                        "ORI", "ANDI", "SLLI", "SRLI", "SRAI"):
            rec.rs1 = read_reg(insn.rs1, SUBCYCLE_RS1)
        if k in STORE_KINDS or k in BRANCH_KINDS or name in (
            "ADD", "SUB", "SLL", "SLT", "SLTU", "XOR", "SRL", "SRA", "OR",
            "AND", "MUL", "MULH", "MULHSU", "MULHU", "DIV", "DIVU", "REM", "REMU",
        ):
            rec.rs2 = read_reg(insn.rs2, SUBCYCLE_RS2)

        a = rec.rs1[1] if rec.rs1 else 0
        b = rec.rs2[1] if rec.rs2 else 0
        imm = insn.imm
        sa = (a ^ 0x80000000) - 0x80000000
        sb = (b ^ 0x80000000) - 0x80000000
        next_pc = self.pc + 4
        result = None

        if name == "ADD":
            result = a + b
        elif name == "SUB":
            result = a - b
        elif name == "SLL":
            result = a << (b & 31)
        elif name == "SLT":
            result = int(sa < sb)
        elif name == "SLTU":
            result = int(a < b)
        elif name == "XOR":
            result = a ^ b
        elif name == "SRL":
            result = a >> (b & 31)
        elif name == "SRA":
            result = sa >> (b & 31)
        elif name == "OR":
            result = a | b
        elif name == "AND":
            result = a & b
        elif name == "MUL":
            result = a * b
        elif name == "MULH":
            result = (sa * sb) >> 32
        elif name == "MULHSU":
            result = (sa * b) >> 32
        elif name == "MULHU":
            result = (a * b) >> 32
        elif name == "DIV":
            if b == 0:
                result = -1
            else:
                q = abs(sa) // abs(sb)
                result = q if (sa < 0) == (sb < 0) else -q
        elif name == "DIVU":
            result = WORD if b == 0 else a // b
        elif name == "REM":
            if b == 0:
                result = sa
            else:
                q = abs(sa) // abs(sb)
                if (sa < 0) != (sb < 0):
                    q = -q
                result = sa - q * sb
        elif name == "REMU":
            result = a if b == 0 else a % b
        elif name == "ADDI":
            result = a + imm
        elif name == "SLTI":
            result = int(sa < imm)
        elif name == "SLTIU":
            result = int(a < (imm & WORD))
        elif name == "XORI":
            result = a ^ (imm & WORD)
        elif name == "ORI":
            result = a | (imm & WORD)
        elif name == "ANDI":
            result = a & (imm & WORD)
        elif name == "SLLI":
            result = a << (imm & 31)
        elif name == "SRLI":
            result = a >> (imm & 31)
        elif name == "SRAI":
            result = sa >> (imm & 31)
        elif name == "LUI":
            result = imm
        elif name == "AUIPC":
            result = self.pc + imm
        elif name == "JAL":
            result = self.pc + 4
            next_pc = self.pc + imm
        elif name == "JALR":
            result = self.pc + 4
            next_pc = (a + imm) & ~1
        elif name in ("BEQ", "BNE", "BLT", "BGE", "BLTU", "BGEU"):
            taken = {
                "BEQ": a == b, "BNE": a != b, "BLT": sa < sb,
                "BGE": sa >= sb, "BLTU": a < b, "BGEU": a >= b,
            }[name]
            if taken:
                next_pc = self.pc + imm
        elif name in ("LB", "LH", "LW", "LBU", "LHU"):
            addr = (a + imm) & WORD
            waddr = addr >> 2
            mval = self.mem.get(waddr, 0)
            prev_ts = self.mem_ts.get(waddr, 0)
            self.mem_ts[waddr] = ts + SUBCYCLE_MEM
            self.touched.add(waddr)
            rec.mem = (waddr, mval, mval, prev_ts)
            shift = (addr & 3) * 8
            if name == "LW":
                result = mval
            elif name == "LBU":
                result = (mval >> shift) & 0xFF
            elif name == "LB":
                result = _sext8((mval >> shift) & 0xFF)
            elif name == "LHU":
                result = (mval >> shift) & 0xFFFF
            elif name == "LH":
                result = _sext16((mval >> shift) & 0xFFFF)
        elif name in ("SB", "SH", "SW"):
            addr = (a + imm) & WORD
            waddr = addr >> 2
            prev = self.mem.get(waddr, 0)
            prev_ts = self.mem_ts.get(waddr, 0)
            shift = (addr & 3) * 8
            if name == "SW":
                new = b
            elif name == "SH":
                mask = 0xFFFF << shift
                new = (prev & ~mask) | ((b & 0xFFFF) << shift)
            else:
                mask = 0xFF << shift
                new = (prev & ~mask) | ((b & 0xFF) << shift)
            self.mem[waddr] = new & WORD
            self.mem_ts[waddr] = ts + SUBCYCLE_MEM
            self.touched.add(waddr)
            rec.mem = (waddr, prev, new & WORD, prev_ts)
        elif name == "ECALL":
            code = self.regs[5]  # t0
            rec.rs1 = read_reg(5, SUBCYCLE_RS1)
            if code == Platform.ECALL_HALT:
                self.halted = True
                self.exit_code = self.regs[10]
                rec.rs2 = read_reg(10, SUBCYCLE_RS2)
                next_pc = self.pc  # halt loops
            elif code == Platform.ECALL_COMMIT:
                # pubio_commit.rs mirror: a0 points at the 8-word digest the
                # guest computed over its public outputs; the syscall READS
                # them (values preserved) and pins them for the PV binding.
                rec.rs2 = read_reg(10, SUBCYCLE_RS2)
                ptr = rec.rs2[1]
                if ptr & 3:
                    raise RuntimeError("commit digest_ptr must be word-aligned")
                base_w = ptr >> 2
                rec.sys_mem = []
                digest = []
                for i in range(8):
                    waddr = base_w + i
                    v = self.mem.get(waddr, 0)
                    prev_ts = self.mem_ts.get(waddr, 0)
                    self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                    self.touched.add(waddr)
                    rec.sys_mem.append((waddr, v, v, prev_ts))
                    digest.append(v)
                self.pubio_digest = digest
            elif code == Platform.ECALL_KECCAK:
                # keccak_permute.rs mirror: a0 = state_ptr -> permute 50
                # words in place. All 50 addresses are distinct, so one
                # shared mem subcycle keeps offline checking monotone.
                from .keccak import keccakf, words_to_lanes, lanes_to_words

                rec.rs2 = read_reg(10, SUBCYCLE_RS2)  # state_ptr
                ptr = rec.rs2[1]
                if ptr & 3:
                    raise RuntimeError("keccak state_ptr must be word-aligned")
                base_w = ptr >> 2
                words = [self.mem.get(base_w + i, 0) for i in range(50)]
                out = lanes_to_words(keccakf(words_to_lanes(words)))
                rec.sys_mem = []
                for i in range(50):
                    waddr = base_w + i
                    prev_ts = self.mem_ts.get(waddr, 0)
                    self.mem[waddr] = out[i]
                    self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                    self.touched.add(waddr)
                    rec.sys_mem.append((waddr, words[i], out[i], prev_ts))
            elif code == Platform.ECALL_SHA_EXTEND:
                # sha256.rs:extend mirror: one message-schedule round.
                # a0 = &w[i]; reads w[i-2], w[i-7], w[i-15], w[i-16]
                # (values preserved), writes w[i]. sys_mem order is the
                # circuit contract: [-2, -7, -15, -16, write@0].
                rec.rs2 = read_reg(10, SUBCYCLE_RS2)  # state_ptr
                ptr = rec.rs2[1]
                if ptr & 3:
                    raise RuntimeError("sha_extend state_ptr must be word-aligned")
                base_w = ptr >> 2
                if base_w < 16:
                    raise RuntimeError("sha_extend pointer below w[16]")
                rec.sys_mem = []
                vals = {}
                for off in (2, 7, 15, 16):
                    waddr = base_w - off
                    v = self.mem.get(waddr, 0)
                    prev_ts = self.mem_ts.get(waddr, 0)
                    self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                    self.touched.add(waddr)
                    rec.sys_mem.append((waddr, v, v, prev_ts))
                    vals[off] = v
                s0 = (_ror32(vals[15], 7) ^ _ror32(vals[15], 18)
                      ^ (vals[15] >> 3))
                s1 = (_ror32(vals[2], 17) ^ _ror32(vals[2], 19)
                      ^ (vals[2] >> 10))
                new = (vals[16] + s0 + vals[7] + s1) & WORD
                prev = self.mem.get(base_w, 0)
                prev_ts = self.mem_ts.get(base_w, 0)
                self.mem[base_w] = new
                self.mem_ts[base_w] = ts + SUBCYCLE_MEM
                self.touched.add(base_w)
                rec.sys_mem.append((base_w, prev, new, prev_ts))
            elif code == Platform.ECALL_UINT256_MUL:
                # uint256.rs mirror: a0 = &x (8 words, overwritten with the
                # result), a1 = &y (8 words) with the modulus at a1+32.
                # result = x*y mod m (m == 0 means mod 2^256). a1 rides the
                # rd record slot (preserving write) since ecalls only have
                # two rs slots. sys_mem order: x writes, y reads, m reads.
                rec.rs2 = read_reg(10, SUBCYCLE_RS2)  # x_ptr
                rec.rd = write_reg(11, self.regs[11], SUBCYCLE_RD)  # y_ptr
                x_ptr, y_ptr = rec.rs2[1], rec.rd[2]
                if (x_ptr | y_ptr) & 3:
                    raise RuntimeError("uint256 pointers must be word-aligned")
                xw, yw = x_ptr >> 2, y_ptr >> 2

                def rd256(base):
                    return [self.mem.get(base + i, 0) for i in range(8)]

                def val(words):
                    return sum(w << (32 * i) for i, w in enumerate(words))

                x, y = val(rd256(xw)), val(rd256(yw))
                m = val(rd256(yw + 8))
                r = (x * y) % m if m else (x * y) & ((1 << 256) - 1)
                rec.sys_mem = []
                for i in range(8):  # x write ops
                    waddr = xw + i
                    prev = self.mem.get(waddr, 0)
                    prev_ts = self.mem_ts.get(waddr, 0)
                    new = (r >> (32 * i)) & WORD
                    self.mem[waddr] = new
                    self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                    self.touched.add(waddr)
                    rec.sys_mem.append((waddr, prev, new, prev_ts))
                for i in range(16):  # y then m read ops
                    waddr = yw + i
                    v = self.mem.get(waddr, 0)
                    prev_ts = self.mem_ts.get(waddr, 0)
                    self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                    self.touched.add(waddr)
                    rec.sys_mem.append((waddr, v, v, prev_ts))
            elif code in _EC_CODES:
                # curve / field-tower precompiles (emulator/curves.py)
                from . import curves as CV

                curve, op = _EC_CODES[code]
                rec.rs2 = read_reg(10, SUBCYCLE_RS2)  # a0
                rec.sys_mem = []
                a0v = rec.rs2[1]
                if op != "double" and op != "invert":
                    rec.rd = write_reg(11, self.regs[11], SUBCYCLE_RD)
                    a1v = rec.rd[2]
                else:
                    a1v = 0
                if a0v & 3 or (op in ("add", "fp_add", "fp_mul", "fp2_add",
                                      "fp2_mul") and a1v & 3):
                    raise RuntimeError(f"{curve}_{op}: unaligned pointer")

                def peek(base_w, n):
                    return [self.mem.get(base_w + i, 0) for i in range(n)]

                def sys_read(base_w, n):
                    for i in range(n):
                        waddr = base_w + i
                        v = self.mem.get(waddr, 0)
                        prev_ts = self.mem_ts.get(waddr, 0)
                        self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                        self.touched.add(waddr)
                        rec.sys_mem.append((waddr, v, v, prev_ts))

                def sys_write(base_w, new_words):
                    for i, nw in enumerate(new_words):
                        waddr = base_w + i
                        prev = self.mem.get(waddr, 0)
                        prev_ts = self.mem_ts.get(waddr, 0)
                        self.mem[waddr] = nw & WORD
                        self.mem_ts[waddr] = ts + SUBCYCLE_MEM
                        self.touched.add(waddr)
                        rec.sys_mem.append((waddr, prev, nw & WORD, prev_ts))

                xw, yw = a0v >> 2, a1v >> 2
                w2i, i2w = CV.words_to_int, CV.int_to_words
                if op == "add":
                    pw = peek(xw, 16)
                    qw = peek(yw, 16)
                    x3, y3 = CV.ec_add(
                        curve, w2i(pw[:8]), w2i(pw[8:]),
                        w2i(qw[:8]), w2i(qw[8:]),
                    )
                    sys_write(xw, i2w(x3) + i2w(y3))
                    sys_read(yw, 16)
                elif op == "double":
                    pw = peek(xw, 16)
                    x3, y3 = CV.ec_double(curve, w2i(pw[:8]), w2i(pw[8:]))
                    sys_write(xw, i2w(x3) + i2w(y3))
                elif op == "decompress":
                    x = w2i(peek(xw, 8))
                    y = CV.decompress_y(curve, x, a1v)
                    sys_read(xw, 8)
                    sys_write(xw + 8, i2w(y))
                elif op == "invert":
                    s = w2i(peek(xw, 8))
                    sys_write(xw, i2w(CV.scalar_invert(curve, s)))
                elif op in ("fp_add", "fp_mul"):
                    x = w2i(peek(xw, 8))
                    y = w2i(peek(yw, 8))
                    r = CV.fp_op(curve, op[3:], x, y)
                    sys_write(xw, i2w(r))
                    sys_read(yw, 8)
                else:  # fp2_add / fp2_mul
                    xv = peek(xw, 16)
                    yv = peek(yw, 16)
                    r0, r1 = CV.fp2_op(
                        curve, op[4:], w2i(xv[:8]), w2i(xv[8:]),
                        w2i(yv[:8]), w2i(yv[8:]),
                    )
                    sys_write(xw, i2w(r0) + i2w(r1))
                    sys_read(yw, 16)
            else:
                raise RuntimeError(f"unsupported ecall code {code:#x}")
        else:
            raise RuntimeError(f"cannot execute {name}")

        if result is not None:
            rec.rd = write_reg(insn.rd, result & WORD, SUBCYCLE_RD)

        rec.next_pc = next_pc
        self.pc = next_pc
        self.cycle += SUBCYCLES_PER_INSN
        return rec

    def run(self, max_steps: int = 1 << 24):
        """Run to halt; returns list of StepRecords (FullTracer mirror)."""
        records = []
        for _ in range(max_steps):
            if self.halted:
                break
            records.append(self.step())
        return records


def _ror32(v, r):
    return ((v >> r) | (v << (32 - r))) & WORD


def _sext8(v):
    return (v ^ 0x80) - 0x80 & WORD


def _sext16(v):
    return (v ^ 0x8000) - 0x8000 & WORD


def make_program(words: list[int], base: int = 0x0800_0000) -> dict:
    return {(base >> 2) + i: w for i, w in enumerate(words)}
