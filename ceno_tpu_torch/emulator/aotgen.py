"""AOT preflight backend: guest basic blocks compiled to native code.

Role mirror of the reference emulator's AOT backend (ceno_emul/src/aot.rs:
preflight basic blocks are compiled to machine code so the shard planner
can scan a long execution far faster than the tracing interpreter). Here
the codegen emits C: each basic block of the guest becomes straight-line
code over the VM registers (no decode, no dispatch, no step rows, no
timestamp bookkeeping — values and control flow only), compiled once per
program with the system toolchain and cached by program digest. ECALLs
call the SAME do_ecall the tracing interpreter uses (emulator.cpp), so
syscall semantics cannot drift.

The compiled entry point ``aot_preflight`` executes the guest while
replaying zkvm/shard.py::plan_boundaries' exact cost/boundary logic
per step (cost-by-kind table, syscall re-kinding by t0 code) and tallies
per-kind step counts — the preflight shard plan without a trace.

Equivalence with the interpreter (final state, counts, boundaries) is
asserted in tests/test_emulator_aot.py; speed is measured by
tools/bench_preflight.py.

Counterpart of ``ceno_tpu/emulator/aotgen.py``. The generated source
includes the port's own ``native/emulator.cpp`` by its absolute path, and
the library is built into the git-ignored ``ceno_tpu_torch/_build/aot/``
(not next to the source), keyed by a hash of the program, the entry, the
emulator source and the flags, so an edited ``emulator.cpp`` is rebuilt.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

from .rv32im import (
    BRANCH_KINDS, I_ARITH_KINDS, K, KINDS, LOAD_KINDS, R_KINDS, STORE_KINDS,
    decode,
)

_EMU_SRC = Path(__file__).resolve().parent / "native" / "emulator.cpp"
_AOT_DIR = Path(__file__).resolve().parent.parent / "_build" / "aot"
_FLAGS = ("-O2", "-shared", "-fPIC")

_TERMINATORS = BRANCH_KINDS | {K["JAL"], K["JALR"], K["ECALL"], K["INVALID"]}


def _blocks(program: dict, entry: int):
    """program: {word_addr: insn_word} -> (leaders set, {addr: Decoded})."""
    insns = {w: decode(word) for w, word in program.items()}
    addrs = sorted(insns)
    leaders = set()
    if addrs:
        leaders.add(addrs[0])
    if entry >> 2 in insns:
        leaders.add(entry >> 2)
    prev_term = False
    for w in addrs:
        if prev_term:
            leaders.add(w)
        d = insns[w]
        prev_term = d.kind in _TERMINATORS
        if d.kind in BRANCH_KINDS or d.kind == K["JAL"]:
            tgt = ((w << 2) + d.imm) >> 2
            if tgt in insns:
                leaders.add(tgt)
            if w + 1 in insns:
                leaders.add(w + 1)  # fallthrough / return-address target
        elif d.kind in (K["JALR"], K["ECALL"]):
            if w + 1 in insns:
                leaders.add(w + 1)
    return leaders, insns


_BINOPS = {
    "ADD": "A + B", "SUB": "A - B", "SLL": "A << (B & 31u)",
    "SLT": "(uint32_t)((int32_t)A < (int32_t)B)", "SLTU": "(uint32_t)(A < B)",
    "XOR": "A ^ B", "SRL": "A >> (B & 31u)",
    "SRA": "(uint32_t)((int32_t)A >> (B & 31u))",
    "OR": "A | B", "AND": "A & B",
    "MUL": "A * B",
    "MULH": "(uint32_t)(((int64_t)(int32_t)A * (int32_t)B) >> 32)",
    "MULHSU": "(uint32_t)(((int64_t)(int32_t)A * (uint64_t)B) >> 32)",
    "MULHU": "(uint32_t)(((uint64_t)A * B) >> 32)",
}
_BRANCH_COND = {
    "BEQ": "A == B", "BNE": "A != B",
    "BLT": "(int32_t)A < (int32_t)B", "BGE": "(int32_t)A >= (int32_t)B",
    "BLTU": "A < B", "BGEU": "A >= B",
}


def _imm_u32(imm: int) -> str:
    return f"{imm & 0xFFFFFFFF}u"


def _gen_insn(out: list, w: int, d, leaders: set, insns: dict):
    """Emit preflight C for one instruction at word address ``w``."""
    pc = w << 2
    name = KINDS[d.kind]
    A = f"R[{d.rs1}]"
    B = f"R[{d.rs2}]"
    imm = _imm_u32(d.imm)

    def setrd(expr: str):
        if d.rd != 0:
            out.append(f"    R[{d.rd}] = {expr};")
        elif any(tok in expr for tok in ("mem_rd", "/", "%")):
            out.append(f"    (void)({expr});")

    def goto_pc(target_pc: int):
        tw = target_pc >> 2
        if tw in insns:
            assert tw in leaders, hex(target_pc)
            out.append(f"    goto L_{target_pc:08x};")
        else:
            out.append("    return -1;  /* jump out of program */")

    if name in ("DIV", "DIVU", "REM", "REMU"):
        out.append(f"    STEPK({d.kind});")
        if d.rd != 0:
            out.append(f"    R[{d.rd}] = {name.lower()}32({A}, {B});")
        return
    if d.kind in R_KINDS:
        out.append(f"    STEPK({d.kind});")
        setrd(_BINOPS[name].replace("A", A).replace("B", B))
        return
    if d.kind in I_ARITH_KINDS:
        out.append(f"    STEPK({d.kind});")
        expr = {
            "ADDI": f"{A} + {imm}",
            "SLTI": f"(uint32_t)((int32_t){A} < (int32_t){imm})",
            "SLTIU": f"(uint32_t)({A} < {imm})",
            "XORI": f"{A} ^ {imm}", "ORI": f"{A} | {imm}",
            "ANDI": f"{A} & {imm}",
            "SLLI": f"{A} << ({d.imm & 31}u)",
            "SRLI": f"{A} >> ({d.imm & 31}u)",
            "SRAI": f"(uint32_t)((int32_t){A} >> ({d.imm & 31}u))",
        }[name]
        setrd(expr)
        return
    if d.kind in LOAD_KINDS:
        out.append(f"    STEPK({d.kind});")
        out.append(f"    {{ uint32_t ad_ = {A} + {imm};")
        out.append("      uint32_t mv_ = mem_rd(vm, ad_ >> 2);")
        out.append("      uint32_t sh_ = (ad_ & 3u) * 8u;")
        expr = {
            "LW": "mv_",
            "LBU": "(mv_ >> sh_) & 0xffu",
            "LB": "(uint32_t)(int32_t)(int8_t)((mv_ >> sh_) & 0xffu)",
            "LHU": "(mv_ >> sh_) & 0xffffu",
            "LH": "(uint32_t)(int32_t)(int16_t)((mv_ >> sh_) & 0xffffu)",
        }[name]
        if d.rd != 0:
            out.append(f"      R[{d.rd}] = {expr}; }}")
        else:
            out.append("      (void)mv_; (void)sh_; }")
        return
    if d.kind in STORE_KINDS:
        out.append(f"    STEPK({d.kind});")
        out.append(f"    {{ uint32_t ad_ = {A} + {imm};")
        out.append("      uint32_t wa_ = ad_ >> 2;")
        if name == "SW":
            out.append(f"      vm->mem[wa_] = {B}; }}")
        else:
            mask = "0xffffu" if name == "SH" else "0xffu"
            out.append("      uint32_t pv_ = mem_rd(vm, wa_);")
            out.append("      uint32_t sh_ = (ad_ & 3u) * 8u;")
            out.append(
                f"      vm->mem[wa_] = (pv_ & ~({mask} << sh_)) |"
                f" (({B} & {mask}) << sh_); }}"
            )
        return
    if d.kind in BRANCH_KINDS:
        cond = _BRANCH_COND[name].replace("A", A).replace("B", B)
        out.append(f"    STEPK({d.kind});")
        out.append(f"    if ({cond}) {{")
        tgt = pc + d.imm
        tw = tgt >> 2
        if tw in insns:
            out.append(f"      goto L_{tgt & 0xFFFFFFFF:08x};")
        else:
            out.append("      return -1;")
        out.append("    }")
        return
    if name == "LUI":
        out.append(f"    STEPK({d.kind});")
        setrd(imm)
        return
    if name == "AUIPC":
        out.append(f"    STEPK({d.kind});")
        setrd(f"{(pc + d.imm) & 0xFFFFFFFF}u")
        return
    if name == "JAL":
        out.append(f"    STEPK({d.kind});")
        setrd(f"{(pc + 4) & 0xFFFFFFFF}u")
        goto_pc((pc + d.imm) & 0xFFFFFFFF)
        return
    if name == "JALR":
        out.append(f"    STEPK({d.kind});")
        out.append(f"    {{ uint32_t t_ = ({A} + {imm}) & ~1u;")
        setrd(f"{(pc + 4) & 0xFFFFFFFF}u")
        out.append("      vm->pc = t_; goto dispatch; }")
        return
    if name == "ECALL":
        # cost/count kind is the syscall pseudo-kind (trace re-kinding)
        out.append(f"    vm->pc = {pc}u;")
        out.append("    { int32_t k_ = sys_kind(vm->regs[5], sys_codes,"
                   " sys_kinds, n_sys);")
        out.append("      if (k_ < 0) return -2;")
        out.append("      STEPK(k_);")
        out.append(f"      uint32_t np_ = {pc}u + 4u;")
        out.append("      int rc_ = do_ecall(vm, nullptr, 0, np_);")
        out.append("      if (rc_) return rc_;")
        out.append("      if (vm->halted) goto done;")
        out.append("      vm->pc = np_; }")
        goto_pc(pc + 4)
        return
    out.append("    return -3;  /* INVALID */")


def generate(program: dict, entry: int) -> str:
    """Generate the per-program preflight C source."""
    leaders, insns = _blocks(program, entry)
    addrs = sorted(insns)
    out = [
        "// generated by ceno_tpu_torch/emulator/aotgen.py — do not edit",
        f'#include "{_EMU_SRC}"',
        "",
        "static inline uint32_t mem_rd(Vm *vm, uint32_t w) {",
        "  auto it = vm->mem.find(w);",
        "  return it == vm->mem.end() ? 0u : it->second;",
        "}",
        "static inline uint32_t div32(uint32_t a, uint32_t b) {",
        "  if (b == 0) return 0xffffffffu;",
        "  int32_t sa = (int32_t)a, sb = (int32_t)b;",
        "  int64_t q = (int64_t)(sa < 0 ? -(int64_t)sa : sa)"
        " / (sb < 0 ? -(int64_t)sb : sb);",
        "  return (uint32_t)(((sa < 0) != (sb < 0)) ? -q : q);",
        "}",
        "static inline uint32_t divu32(uint32_t a, uint32_t b) {",
        "  return b == 0 ? 0xffffffffu : a / b;",
        "}",
        "static inline uint32_t rem32(uint32_t a, uint32_t b) {",
        "  if (b == 0) return a;",
        "  int32_t sa = (int32_t)a, sb = (int32_t)b;",
        "  int64_t q = (int64_t)(sa < 0 ? -(int64_t)sa : sa)"
        " / (sb < 0 ? -(int64_t)sb : sb);",
        "  if ((sa < 0) != (sb < 0)) q = -q;",
        "  return (uint32_t)(sa - (int32_t)(q * sb));",
        "}",
        "static inline uint32_t remu32(uint32_t a, uint32_t b) {",
        "  return b == 0 ? a : a % b;",
        "}",
        "static inline int32_t sys_kind(uint32_t code, const uint32_t *codes,",
        "                               const int32_t *kinds, int64_t n) {",
        f"  if (code == 0) return {K['ECALL']};  // halt",
        "  for (int64_t i = 0; i < n; i++)",
        "    if (codes[i] == code) return kinds[i];",
        "  return -1;",
        "}",
        "",
        'extern "C" {',
        "",
        "// plan_boundaries' exact per-step cost/boundary logic, fused into",
        "// native basic-block execution. Returns steps executed (>= 0) or a",
        "// negative emulator error code; *n_bounds_out = interior boundary",
        "// count (bounds[] receives up to bounds_cap of them).",
        "int64_t aot_preflight(void *h, int64_t max_steps,",
        "                      const int64_t *cost,",
        "                      const uint32_t *sys_codes,",
        "                      const int32_t *sys_kinds, int64_t n_sys,",
        "                      int64_t max_cells, int64_t max_sps,",
        "                      int64_t *bounds, int64_t bounds_cap,",
        "                      int64_t *n_bounds_out,",
        "                      int64_t *kind_counts) {",
        "  Vm *vm = (Vm *)h;",
        "  uint32_t *R = vm->regs;",
        "  int64_t steps = 0, nb = 0, cur_cells = 0, cur_steps = 0;",
        "#define STEPK(KI) do { \\",
        "    if (steps >= max_steps) return -4; \\",
        "    int64_t c_ = cost[(KI)]; \\",
        "    if ((max_cells >= 0 && cur_cells + c_ > max_cells"
        " && cur_steps > 0) \\",
        "        || (max_sps >= 0 && cur_steps >= max_sps)) { \\",
        "      if (nb < bounds_cap) bounds[nb] = steps; \\",
        "      nb++; cur_cells = 0; cur_steps = 0; \\",
        "    } \\",
        "    cur_cells += c_; cur_steps++; kind_counts[(KI)]++; steps++; \\",
        "    vm->cycle += 4; \\",
        "  } while (0)",
        "  goto dispatch;",
        "done:",
        "  *n_bounds_out = nb;",
        "  return steps;",
        "dispatch:",
        "  if (vm->halted) goto done;",
        "  switch (vm->pc) {",
    ]
    # dispatch cases for every leader
    for w in sorted(leaders):
        out.append(f"  case {w << 2}u: goto L_{(w << 2) & 0xFFFFFFFF:08x};")
    out.append("  default: return -5;  /* unknown jump target */")
    out.append("  }")
    # block bodies in address order; execution falls through block to block
    for i, w in enumerate(addrs):
        if w in leaders:
            out.append(f"L_{(w << 2) & 0xFFFFFFFF:08x}:")
        _gen_insn(out, w, insns[w], leaders, insns)
        nxt = addrs[i + 1] if i + 1 < len(addrs) else None
        if nxt != w + 1:
            # address gap (or program end): falling off this insn is an
            # out-of-program fetch, like the interpreter's missing-pc error
            out.append("    return -1;  /* fell into a program gap */")
    out.append("  return -1;  /* ran off the end of the program */")
    out.append("#undef STEPK")
    out.append("}")
    out.append("")
    out.append('}  // extern "C"')
    return "\n".join(out) + "\n"


def build(program: dict, entry: int) -> Path | None:
    """Generate + compile the per-program preflight .so (digest-cached).
    Returns the library path, or None if no toolchain is available."""
    # entry is codegen input (it seeds the dispatch leader set), so it
    # must key the cache: same words + different entry = different blocks
    digest = hashlib.sha256(
        repr((sorted(program.items()), int(entry), _FLAGS)).encode()
        + _EMU_SRC.read_bytes()
    ).hexdigest()[:20]
    so = _AOT_DIR / f"preflight_{digest}.so"
    if so.exists():
        return so
    _AOT_DIR.mkdir(parents=True, exist_ok=True)
    src_path = _AOT_DIR / f"preflight_{digest}.cpp"
    src_path.write_text(generate(program, entry))
    tmp = so.with_name(f"{so.name}.tmp{os.getpid()}")
    for cc in ("c++", "g++", "cc"):
        try:
            subprocess.run(
                [cc, *_FLAGS, str(src_path), "-o", str(tmp)],
                check=True, capture_output=True,
            )
        except (subprocess.CalledProcessError, FileNotFoundError):
            continue
        os.replace(tmp, so)
        return so
    return None
