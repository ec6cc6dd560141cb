// rv32im trace-generating interpreter (native witgen front-end).
//
// Role mirror of the reference's emulator fast path (ceno_emul's AOT backend,
// SURVEY.md §2.1) re-targeted at this framework: executes the guest and fills
// flat step-record arrays (one row per instruction) that witgen consumes.
// Semantics are locked to ceno_tpu/emulator/state.py: 4 subcycles per
// instruction (RS1=0, RS2=1, RD=2, MEM=3), cycle starts at 4, ecall with
// t0=0 halts with exit code in a0. Memory is a paged sparse store.
//
// Copy of ceno_tpu/emulator/native/emulator.cpp. ceno_tpu_torch/emulator/native.py
// builds it with c++ -O2 -shared -fPIC into ceno_tpu_torch/_build/ on first
// use (no external dependencies).

#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

extern "C" {

struct StepRow {
  uint32_t pc;
  uint32_t next_pc;
  uint32_t cycle;
  int32_t kind;         // InsnKind index (python rv32im.K order)
  int32_t rd, rs1, rs2; // register ids (-1 when absent)
  int32_t imm;          // sign-extended
  uint32_t rs1_val, rs2_val;
  uint32_t rd_prev, rd_val;
  uint32_t rs1_prev_ts, rs2_prev_ts, rd_prev_ts;
  int32_t sys_idx;      // bulk-syscall block index (-1 when absent)
  int64_t mem_waddr;    // -1 when absent
  uint32_t mem_prev, mem_val, mem_prev_ts;
};

// Must match ceno_tpu/emulator/rv32im.py KINDS order.
enum Kind {
  ADD, SUB, SLL, SLT, SLTU, XOR_, SRL, SRA, OR_, AND_,
  MUL, MULH, MULHSU, MULHU, DIV_, DIVU, REM_, REMU,
  ADDI, SLTI, SLTIU, XORI, ORI, ANDI, SLLI, SRLI, SRAI,
  LB, LH, LW, LBU, LHU, JALR,
  SB, SH, SW,
  BEQ, BNE, BLT, BGE, BLTU, BGEU,
  LUI, AUIPC, JAL, ECALL, INVALID,
};

struct Decoded {
  int32_t kind, rd, rs1, rs2, imm;
};

static int32_t sext(uint32_t v, int bits) {
  uint32_t m = 1u << (bits - 1);
  return (int32_t)((v ^ m) - m);
}

static Decoded decode(uint32_t w) {
  Decoded d{INVALID, 0, 0, 0, 0};
  uint32_t op = w & 0x7f, f3 = (w >> 12) & 7, f7 = (w >> 25) & 0x7f;
  d.rd = (w >> 7) & 0x1f;
  d.rs1 = (w >> 15) & 0x1f;
  d.rs2 = (w >> 20) & 0x1f;
  switch (op) {
  case 0x33: { // R
    static const int r0[8] = {ADD, SLL, SLT, SLTU, XOR_, SRL, OR_, AND_};
    static const int rm[8] = {MUL, MULH, MULHSU, MULHU, DIV_, DIVU, REM_, REMU};
    if (f7 == 0) d.kind = r0[f3];
    else if (f7 == 0x20) d.kind = f3 == 0 ? SUB : (f3 == 5 ? SRA : INVALID);
    else if (f7 == 1) d.kind = rm[f3];
    break;
  }
  case 0x13: { // I arith
    static const int i0[8] = {ADDI, SLLI, SLTI, SLTIU, XORI, SRLI, ORI, ANDI};
    d.kind = i0[f3];
    if (f3 == 1) d.imm = d.rs2;
    else if (f3 == 5) { d.kind = f7 == 0x20 ? SRAI : SRLI; d.imm = d.rs2; }
    else d.imm = sext(w >> 20, 12);
    break;
  }
  case 0x03: { // loads
    static const int l[8] = {LB, LH, LW, INVALID, LBU, LHU, INVALID, INVALID};
    d.kind = l[f3];
    d.imm = sext(w >> 20, 12);
    break;
  }
  case 0x67:
    if (f3 == 0) { d.kind = JALR; d.imm = sext(w >> 20, 12); }
    break;
  case 0x23: { // stores
    static const int s[8] = {SB, SH, SW, INVALID, INVALID, INVALID, INVALID, INVALID};
    d.kind = s[f3];
    d.imm = sext((f7 << 5) | d.rd, 12);
    break;
  }
  case 0x63: { // branches
    static const int b[8] = {BEQ, BNE, INVALID, INVALID, BLT, BGE, BLTU, BGEU};
    d.kind = b[f3];
    uint32_t imm = ((w >> 31) << 12) | (((w >> 7) & 1) << 11) |
                   (((w >> 25) & 0x3f) << 5) | (((w >> 8) & 0xf) << 1);
    d.imm = sext(imm, 13);
    break;
  }
  case 0x37: d.kind = LUI; d.imm = (int32_t)(w & 0xfffff000u); break;
  case 0x17: d.kind = AUIPC; d.imm = (int32_t)(w & 0xfffff000u); break;
  case 0x6f: {
    d.kind = JAL;
    uint32_t imm = ((w >> 31) << 20) | (((w >> 12) & 0xff) << 12) |
                   (((w >> 20) & 1) << 11) | (((w >> 21) & 0x3ff) << 1);
    d.imm = sext(imm, 21);
    break;
  }
  case 0x73: if (w == 0x73) d.kind = ECALL; break;
  }
  return d;
}

struct Vm {
  std::unordered_map<uint32_t, uint32_t> mem;     // word addr -> value
  std::unordered_map<uint32_t, uint32_t> mem_ts;  // word addr -> last ts
  std::unordered_map<uint32_t, Decoded> prog;     // word addr -> decoded
  uint32_t regs[32] = {0};
  uint32_t reg_ts[32] = {0};
  uint32_t pc = 0, cycle = 4;
  int halted = 0;
  uint32_t exit_code = 0;
  // bulk-syscall memory ops: fixed 50-entry blocks (keccak 50, commit 8+pad)
  std::vector<uint32_t> sys_addr, sys_prev, sys_val, sys_pts;
  int64_t sys_blocks = 0;
  uint32_t pubio_digest[8] = {0};
  int pubio_committed = 0;
};

// ---------------------------------------------------------------------------
// keccak-f[1600] (syscall 0x010109; layout mirror of emulator/keccak.py)
// ---------------------------------------------------------------------------

static const uint64_t KECCAK_RC[24] = {
    0x0000000000000001ull, 0x0000000000008082ull, 0x800000000000808aull,
    0x8000000080008000ull, 0x000000000000808bull, 0x0000000080000001ull,
    0x8000000080008081ull, 0x8000000000008009ull, 0x000000000000008aull,
    0x0000000000000088ull, 0x0000000080008009ull, 0x000000008000000aull,
    0x000000008000808bull, 0x800000000000008bull, 0x8000000000008089ull,
    0x8000000000008003ull, 0x8000000000008002ull, 0x8000000000000080ull,
    0x000000000000800aull, 0x800000008000000aull, 0x8000000080008081ull,
    0x8000000000008080ull, 0x0000000080000001ull, 0x8000000080008008ull,
};
static const int KECCAK_ROT[5][5] = {
    {0, 36, 3, 41, 18}, {1, 44, 10, 45, 2}, {62, 6, 43, 15, 61},
    {28, 55, 25, 21, 56}, {27, 20, 39, 8, 14},
};

static inline uint64_t rotl64(uint64_t v, int r) {
  return r ? (v << r) | (v >> (64 - r)) : v;
}

static void keccakf(uint64_t a[25]) {
  uint64_t c[5], d[5], b[25];
  for (int rnd = 0; rnd < 24; rnd++) {
    for (int x = 0; x < 5; x++)
      c[x] = a[x] ^ a[x + 5] ^ a[x + 10] ^ a[x + 15] ^ a[x + 20];
    for (int x = 0; x < 5; x++)
      d[x] = c[(x + 4) % 5] ^ rotl64(c[(x + 1) % 5], 1);
    for (int x = 0; x < 5; x++)
      for (int y = 0; y < 5; y++)
        b[y + 5 * ((2 * x + 3 * y) % 5)] = rotl64(a[x + 5 * y] ^ d[x],
                                                  KECCAK_ROT[x][y]);
    for (int y = 0; y < 5; y++)
      for (int x = 0; x < 5; x++)
        a[x + 5 * y] = b[x + 5 * y] ^ (~b[(x + 1) % 5 + 5 * y] &
                                       b[(x + 2) % 5 + 5 * y]);
    a[0] ^= KECCAK_RC[rnd];
  }
}

static Vm *g_vm = nullptr;

void *emu_new(uint32_t entry, uint32_t sp) {
  Vm *vm = new Vm();
  vm->pc = entry;
  vm->regs[2] = sp;
  return vm;
}

void emu_free(void *h) { delete (Vm *)h; }

void emu_load_program(void *h, uint32_t base, const uint32_t *words, int64_t n) {
  Vm *vm = (Vm *)h;
  for (int64_t i = 0; i < n; i++)
    vm->prog[(base >> 2) + (uint32_t)i] = decode(words[i]);
}

void emu_init_memory(void *h, uint32_t addr, const uint32_t *words, int64_t n) {
  Vm *vm = (Vm *)h;
  for (int64_t i = 0; i < n; i++)
    vm->mem[(addr >> 2) + (uint32_t)i] = words[i];
}


// ---------------------------------------------------------------------------
// ECALL semantics, shared by the trace interpreter (r != nullptr) and the
// AOT preflight backend (r == nullptr: no step row, no timestamp
// bookkeeping — values and control flow only). Extracted verbatim from the
// interpreter loop; ceno_emul/src/aot.rs role note in emulator/aotgen.py.
// ---------------------------------------------------------------------------

static int do_ecall(Vm *vm, StepRow *rp, uint32_t ts, uint32_t &next_pc) {
  StepRow dummy;
  bool tracing = rp != nullptr;
  StepRow &R = tracing ? *rp : dummy;
  auto read_reg = [&](int reg, int slot) {
    uint32_t v = vm->regs[reg];
    uint32_t prev = vm->reg_ts[reg];
    if (tracing) vm->reg_ts[reg] = ts + slot;
    return std::pair<uint32_t, uint32_t>(v, prev);
  };

      uint32_t code = vm->regs[5];
      auto p = read_reg(5, 0);
      R.rs1 = 5; R.rs1_val = p.first; R.rs1_prev_ts = p.second;
      if (code == 0) {
        auto q = read_reg(10, 1);
        R.rs2 = 10; R.rs2_val = q.first; R.rs2_prev_ts = q.second;
        vm->halted = 1;
        vm->exit_code = vm->regs[10];
        next_pc = vm->pc;
      } else if (code == 0x010109u || code == 0x010120u) {
        // KECCAK_PERMUTE / PUB_IO_COMMIT (keccak_permute.rs /
        // pubio_commit.rs layouts; python mirror in emulator/state.py)
        auto q = read_reg(10, 1);
        R.rs2 = 10; R.rs2_val = q.first; R.rs2_prev_ts = q.second;
        uint32_t ptr = q.first;
        if (ptr & 3) return -2; // misaligned: python path raises cleanly
        uint32_t base_w = ptr >> 2;
        int n_words = code == 0x010109u ? 50 : 8;
        uint32_t words[50];
        for (int i = 0; i < n_words; i++) {
          uint32_t w_ = base_w + (uint32_t)i;
          words[i] = vm->mem.count(w_) ? vm->mem[w_] : 0;
        }
        uint32_t outw[50];
        if (code == 0x010109u) {
          uint64_t lanes[25];
          for (int i = 0; i < 25; i++)
            lanes[i] = (uint64_t)words[2 * i] | ((uint64_t)words[2 * i + 1] << 32);
          keccakf(lanes);
          for (int i = 0; i < 25; i++) {
            outw[2 * i] = (uint32_t)lanes[i];
            outw[2 * i + 1] = (uint32_t)(lanes[i] >> 32);
          }
        } else {
          for (int i = 0; i < 8; i++) vm->pubio_digest[i] = words[i];
          vm->pubio_committed = 1;
          for (int i = 0; i < n_words; i++) outw[i] = words[i];
        }
        R.sys_idx = (int32_t)vm->sys_blocks;
        for (int i = 0; i < 50; i++) {
          uint32_t w_ = base_w + (uint32_t)i;
          if (i < n_words) {
            uint32_t pts = vm->mem_ts.count(w_) ? vm->mem_ts[w_] : 0;
            if (tracing) vm->sys_addr.push_back(w_);
            if (tracing) vm->sys_prev.push_back(words[i]);
            if (tracing) vm->sys_val.push_back(outw[i]);
            if (tracing) vm->sys_pts.push_back(pts);
            vm->mem[w_] = outw[i];
            if (tracing) vm->mem_ts[w_] = ts + 3;
          } else {
            if (tracing) vm->sys_addr.push_back(0);
            if (tracing) vm->sys_prev.push_back(0);
            if (tracing) vm->sys_val.push_back(0);
            if (tracing) vm->sys_pts.push_back(0);
          }
        }
        if (tracing) vm->sys_blocks++;
      } else if (code == 0x300105u) {
        // SHA_EXTEND (sha256.rs:extend mirror; python in emulator/state.py)
        // a0 = &w[i]; block order contract: [-2, -7, -15, -16, write@0]
        auto q = read_reg(10, 1);
        R.rs2 = 10; R.rs2_val = q.first; R.rs2_prev_ts = q.second;
        uint32_t ptr = q.first;
        if (ptr & 3) return -2;
        uint32_t base_w = ptr >> 2;
        if (base_w < 16) return -2;
        static const uint32_t offs[4] = {2, 7, 15, 16};
        uint32_t vals[17]; // indexed by offset
        R.sys_idx = (int32_t)vm->sys_blocks;
        for (int j = 0; j < 4; j++) {
          uint32_t w_ = base_w - offs[j];
          uint32_t v = vm->mem.count(w_) ? vm->mem[w_] : 0;
          uint32_t pts = vm->mem_ts.count(w_) ? vm->mem_ts[w_] : 0;
          if (tracing) vm->sys_addr.push_back(w_);
          if (tracing) vm->sys_prev.push_back(v);
          if (tracing) vm->sys_val.push_back(v);
          if (tracing) vm->sys_pts.push_back(pts);
          if (tracing) vm->mem_ts[w_] = ts + 3;
          vals[offs[j]] = v;
        }
        auto ror = [](uint32_t v, int k) {
          return (v >> k) | (v << (32 - k));
        };
        uint32_t s0 = ror(vals[15], 7) ^ ror(vals[15], 18) ^ (vals[15] >> 3);
        uint32_t s1 = ror(vals[2], 17) ^ ror(vals[2], 19) ^ (vals[2] >> 10);
        uint32_t neww = vals[16] + s0 + vals[7] + s1;
        uint32_t prevw = vm->mem.count(base_w) ? vm->mem[base_w] : 0;
        uint32_t ppts = vm->mem_ts.count(base_w) ? vm->mem_ts[base_w] : 0;
        if (tracing) vm->sys_addr.push_back(base_w);
        if (tracing) vm->sys_prev.push_back(prevw);
        if (tracing) vm->sys_val.push_back(neww);
        if (tracing) vm->sys_pts.push_back(ppts);
        vm->mem[base_w] = neww;
        if (tracing) vm->mem_ts[base_w] = ts + 3;
        for (int j = 5; j < 50; j++) {
          if (tracing) vm->sys_addr.push_back(0);
          if (tracing) vm->sys_prev.push_back(0);
          if (tracing) vm->sys_val.push_back(0);
          if (tracing) vm->sys_pts.push_back(0);
        }
        if (tracing) vm->sys_blocks++;
      } else if (code == 0x01011du) {
        // UINT256_MUL (uint256.rs mirror; python in emulator/state.py):
        // a0 = &x (8 words, overwritten), a1 = &y with modulus at a1+32.
        // a1 rides the rd record slot as a preserving write.
        auto q = read_reg(10, 1);
        R.rs2 = 10; R.rs2_val = q.first; R.rs2_prev_ts = q.second;
        auto a1 = read_reg(11, 2);
        R.rd = 11; R.rd_prev = a1.first; R.rd_val = a1.first;
        R.rd_prev_ts = a1.second;
        uint32_t x_ptr = q.first, y_ptr = a1.first;
        if ((x_ptr | y_ptr) & 3) return -2;
        uint32_t xw = x_ptr >> 2, yw = y_ptr >> 2;
        uint32_t xv[8], yv[8], mv[8];
        for (int i = 0; i < 8; i++) {
          uint32_t w_;
          w_ = xw + (uint32_t)i; xv[i] = vm->mem.count(w_) ? vm->mem[w_] : 0;
          w_ = yw + (uint32_t)i; yv[i] = vm->mem.count(w_) ? vm->mem[w_] : 0;
          w_ = yw + 8 + (uint32_t)i; mv[i] = vm->mem.count(w_) ? vm->mem[w_] : 0;
        }
        // 256x256 -> 512-bit schoolbook on u32 limbs, then mod m (m=0 ->
        // truncate to 256 bits). Division via simple base-2^32 long division.
        uint32_t prod[16] = {0};
        for (int i = 0; i < 8; i++) {
          uint64_t carry = 0;
          for (int j = 0; j < 8; j++) {
            uint64_t cur = (uint64_t)xv[i] * yv[j] + prod[i + j] + carry;
            prod[i + j] = (uint32_t)cur;
            carry = cur >> 32;
          }
          prod[i + 8] = (uint32_t)carry;
        }
        uint32_t res[8] = {0};
        bool m_zero = true;
        for (int i = 0; i < 8; i++) if (mv[i]) m_zero = false;
        if (m_zero) {
          for (int i = 0; i < 8; i++) res[i] = prod[i];
        } else {
          // rem = prod mod m, bit-by-bit from the top (512 iterations)
          uint32_t rem[9] = {0};
          for (int b = 511; b >= 0; b--) {
            uint32_t topcarry = 0;
            for (int i = 0; i < 9; i++) {
              uint32_t nx = (rem[i] << 1) | topcarry;
              topcarry = rem[i] >> 31;
              rem[i] = nx;
            }
            rem[0] |= (prod[b >> 5] >> (b & 31)) & 1u;
            // if rem >= m: rem -= m (m has 8 limbs; rem 9)
            bool ge = rem[8] != 0;
            if (!ge) {
              ge = true;
              for (int i = 7; i >= 0; i--) {
                if (rem[i] != mv[i]) { ge = rem[i] > mv[i]; break; }
              }
            }
            if (ge) {
              uint64_t borrow = 0;
              for (int i = 0; i < 8; i++) {
                uint64_t cur = (uint64_t)rem[i] - mv[i] - borrow;
                rem[i] = (uint32_t)cur;
                borrow = (cur >> 63) & 1;
              }
              rem[8] -= (uint32_t)borrow;
            }
          }
          for (int i = 0; i < 8; i++) res[i] = rem[i];
        }
        R.sys_idx = (int32_t)vm->sys_blocks;
        for (int i = 0; i < 8; i++) {  // x write ops
          uint32_t w_ = xw + (uint32_t)i;
          uint32_t prev = vm->mem.count(w_) ? vm->mem[w_] : 0;
          uint32_t pts = vm->mem_ts.count(w_) ? vm->mem_ts[w_] : 0;
          if (tracing) vm->sys_addr.push_back(w_);
          if (tracing) vm->sys_prev.push_back(prev);
          if (tracing) vm->sys_val.push_back(res[i]);
          if (tracing) vm->sys_pts.push_back(pts);
          vm->mem[w_] = res[i];
          if (tracing) vm->mem_ts[w_] = ts + 3;
        }
        for (int i = 0; i < 16; i++) {  // y then m read ops
          uint32_t w_ = yw + (uint32_t)i;
          uint32_t v = vm->mem.count(w_) ? vm->mem[w_] : 0;
          uint32_t pts = vm->mem_ts.count(w_) ? vm->mem_ts[w_] : 0;
          if (tracing) vm->sys_addr.push_back(w_);
          if (tracing) vm->sys_prev.push_back(v);
          if (tracing) vm->sys_val.push_back(v);
          if (tracing) vm->sys_pts.push_back(pts);
          if (tracing) vm->mem_ts[w_] = ts + 3;
        }
        for (int j = 24; j < 50; j++) {
          if (tracing) vm->sys_addr.push_back(0);
          if (tracing) vm->sys_prev.push_back(0);
          if (tracing) vm->sys_val.push_back(0);
          if (tracing) vm->sys_pts.push_back(0);
        }
        if (tracing) vm->sys_blocks++;
      } else {
        return -2; // unsupported ecall
      }
        return 0;
}

// Returns number of steps executed; halted/exit_code via emu_state.
int64_t emu_run(void *h, StepRow *out, int64_t max_steps) {
  Vm *vm = (Vm *)h;
  int64_t count = 0;
  while (!vm->halted && count < max_steps) {
    auto it = vm->prog.find(vm->pc >> 2);
    if (it == vm->prog.end()) return -1; // pc outside program
    const Decoded &d = it->second;
    StepRow &r = out[count];
    memset(&r, 0, sizeof(StepRow));
    r.pc = vm->pc;
    r.cycle = vm->cycle;
    r.kind = d.kind;
    r.rd = -1; r.rs1 = -1; r.rs2 = -1;
    r.imm = d.imm;
    r.mem_waddr = -1;
    r.sys_idx = -1;
    uint32_t ts = vm->cycle;
    uint32_t next_pc = vm->pc + 4;

    auto read_reg = [&](int reg, int slot) {
      uint32_t v = vm->regs[reg];
      uint32_t prev = vm->reg_ts[reg];
      vm->reg_ts[reg] = ts + slot;
      return std::pair<uint32_t, uint32_t>(v, prev);
    };
    auto write_rd = [&](uint32_t v) {
      r.rd = d.rd;
      r.rd_prev = vm->regs[d.rd];
      r.rd_prev_ts = vm->reg_ts[d.rd];
      if (d.rd != 0) vm->regs[d.rd] = v;
      vm->reg_ts[d.rd] = ts + 2;
      r.rd_val = vm->regs[d.rd];
    };

    uint32_t a = 0, b = 0;
    bool uses_rs1 = true, uses_rs2 = false;
    switch (d.kind) {
    case LUI: case AUIPC: case JAL: case ECALL: uses_rs1 = false; break;
    default: break;
    }
    switch (d.kind) {
    case ADD: case SUB: case SLL: case SLT: case SLTU: case XOR_: case SRL:
    case SRA: case OR_: case AND_: case MUL: case MULH: case MULHSU:
    case MULHU: case DIV_: case DIVU: case REM_: case REMU:
    case SB: case SH: case SW:
    case BEQ: case BNE: case BLT: case BGE: case BLTU: case BGEU:
      uses_rs2 = true;
      break;
    default: break;
    }
    if (d.kind == ECALL) { uses_rs1 = false; uses_rs2 = false; }
    if (uses_rs1) {
      auto p = read_reg(d.rs1, 0);
      a = p.first; r.rs1 = d.rs1; r.rs1_val = a; r.rs1_prev_ts = p.second;
    }
    if (uses_rs2) {
      auto p = read_reg(d.rs2, 1);
      b = p.first; r.rs2 = d.rs2; r.rs2_val = b; r.rs2_prev_ts = p.second;
    }
    int32_t sa = (int32_t)a, sb = (int32_t)b;
    int32_t imm = d.imm;
    bool has_result = false;
    uint32_t result = 0;

    switch (d.kind) {
    case ADD: result = a + b; has_result = true; break;
    case SUB: result = a - b; has_result = true; break;
    case SLL: result = a << (b & 31); has_result = true; break;
    case SLT: result = sa < sb; has_result = true; break;
    case SLTU: result = a < b; has_result = true; break;
    case XOR_: result = a ^ b; has_result = true; break;
    case SRL: result = a >> (b & 31); has_result = true; break;
    case SRA: result = (uint32_t)(sa >> (b & 31)); has_result = true; break;
    case OR_: result = a | b; has_result = true; break;
    case AND_: result = a & b; has_result = true; break;
    case MUL: result = a * b; has_result = true; break;
    case MULH: result = (uint32_t)(((int64_t)sa * sb) >> 32); has_result = true; break;
    case MULHSU: result = (uint32_t)(((int64_t)sa * (uint64_t)b) >> 32); has_result = true; break;
    case MULHU: result = (uint32_t)(((uint64_t)a * b) >> 32); has_result = true; break;
    case DIV_:
      if (b == 0) result = 0xffffffffu;
      else {
        int64_t q = (int64_t)(sa < 0 ? -(int64_t)sa : sa) / (sb < 0 ? -(int64_t)sb : sb);
        result = (uint32_t)(((sa < 0) != (sb < 0)) ? -q : q);
      }
      has_result = true; break;
    case DIVU: result = b == 0 ? 0xffffffffu : a / b; has_result = true; break;
    case REM_:
      if (b == 0) result = a;
      else {
        int64_t q = (int64_t)(sa < 0 ? -(int64_t)sa : sa) / (sb < 0 ? -(int64_t)sb : sb);
        if ((sa < 0) != (sb < 0)) q = -q;
        result = (uint32_t)(sa - (int32_t)(q * sb));
      }
      has_result = true; break;
    case REMU: result = b == 0 ? a : a % b; has_result = true; break;
    case ADDI: result = a + (uint32_t)imm; has_result = true; break;
    case SLTI: result = sa < imm; has_result = true; break;
    case SLTIU: result = a < (uint32_t)imm; has_result = true; break;
    case XORI: result = a ^ (uint32_t)imm; has_result = true; break;
    case ORI: result = a | (uint32_t)imm; has_result = true; break;
    case ANDI: result = a & (uint32_t)imm; has_result = true; break;
    case SLLI: result = a << (imm & 31); has_result = true; break;
    case SRLI: result = a >> (imm & 31); has_result = true; break;
    case SRAI: result = (uint32_t)(sa >> (imm & 31)); has_result = true; break;
    case LUI: result = (uint32_t)imm; has_result = true; break;
    case AUIPC: result = vm->pc + (uint32_t)imm; has_result = true; break;
    case JAL: result = vm->pc + 4; has_result = true; next_pc = vm->pc + (uint32_t)imm; break;
    case JALR: result = vm->pc + 4; has_result = true; next_pc = (a + (uint32_t)imm) & ~1u; break;
    case BEQ: if (a == b) next_pc = vm->pc + (uint32_t)imm; break;
    case BNE: if (a != b) next_pc = vm->pc + (uint32_t)imm; break;
    case BLT: if (sa < sb) next_pc = vm->pc + (uint32_t)imm; break;
    case BGE: if (sa >= sb) next_pc = vm->pc + (uint32_t)imm; break;
    case BLTU: if (a < b) next_pc = vm->pc + (uint32_t)imm; break;
    case BGEU: if (a >= b) next_pc = vm->pc + (uint32_t)imm; break;
    case LB: case LH: case LW: case LBU: case LHU: {
      uint32_t addr = a + (uint32_t)imm;
      uint32_t waddr = addr >> 2;
      uint32_t mval = vm->mem.count(waddr) ? vm->mem[waddr] : 0;
      uint32_t prev_ts = vm->mem_ts.count(waddr) ? vm->mem_ts[waddr] : 0;
      vm->mem_ts[waddr] = ts + 3;
      r.mem_waddr = waddr; r.mem_prev = mval; r.mem_val = mval; r.mem_prev_ts = prev_ts;
      uint32_t shift = (addr & 3) * 8;
      switch (d.kind) {
      case LW: result = mval; break;
      case LBU: result = (mval >> shift) & 0xff; break;
      case LB: result = (uint32_t)sext((mval >> shift) & 0xff, 8); break;
      case LHU: result = (mval >> shift) & 0xffff; break;
      default: result = (uint32_t)sext((mval >> shift) & 0xffff, 16); break;
      }
      has_result = true;
      break;
    }
    case SB: case SH: case SW: {
      uint32_t addr = a + (uint32_t)imm;
      uint32_t waddr = addr >> 2;
      uint32_t prev = vm->mem.count(waddr) ? vm->mem[waddr] : 0;
      uint32_t prev_ts = vm->mem_ts.count(waddr) ? vm->mem_ts[waddr] : 0;
      uint32_t shift = (addr & 3) * 8;
      uint32_t newv;
      if (d.kind == SW) newv = b;
      else if (d.kind == SH) newv = (prev & ~(0xffffu << shift)) | ((b & 0xffff) << shift);
      else newv = (prev & ~(0xffu << shift)) | ((b & 0xff) << shift);
      vm->mem[waddr] = newv;
      vm->mem_ts[waddr] = ts + 3;
      r.mem_waddr = waddr; r.mem_prev = prev; r.mem_val = newv; r.mem_prev_ts = prev_ts;
      break;
    }
    case ECALL: {
      int rc = do_ecall(vm, &r, ts, next_pc);
      if (rc) return rc;
      break;
    }
    default:
      return -3; // cannot execute
    }
    if (has_result) write_rd(result);
    r.next_pc = next_pc;
    vm->pc = next_pc;
    vm->cycle += 4;
    count++;
  }
  return count;
}

void emu_state(void *h, uint32_t *pc, uint32_t *cycle, int *halted,
               uint32_t *exit_code) {
  Vm *vm = (Vm *)h;
  *pc = vm->pc; *cycle = vm->cycle; *halted = vm->halted; *exit_code = vm->exit_code;
}

void emu_regs(void *h, uint32_t *regs, uint32_t *reg_ts) {
  Vm *vm = (Vm *)h;
  memcpy(regs, vm->regs, sizeof(vm->regs));
  memcpy(reg_ts, vm->reg_ts, sizeof(vm->reg_ts));
}

int64_t emu_mem_count(void *h) { return (int64_t)((Vm *)h)->mem_ts.size(); }

// Dump every word with a timestamp (the touched set) plus its value/ts.
void emu_mem_dump(void *h, uint32_t *waddrs, uint32_t *vals, uint32_t *tss) {
  Vm *vm = (Vm *)h;
  int64_t i = 0;
  for (auto &kv : vm->mem_ts) {
    waddrs[i] = kv.first;
    vals[i] = vm->mem.count(kv.first) ? vm->mem[kv.first] : 0;
    tss[i] = kv.second;
    i++;
  }
}

int64_t emu_sys_count(void *h) { return ((Vm *)h)->sys_blocks; }

void emu_sys_dump(void *h, uint32_t *addr, uint32_t *prev, uint32_t *val,
                  uint32_t *pts) {
  Vm *vm = (Vm *)h;
  size_t n = vm->sys_addr.size();
  memcpy(addr, vm->sys_addr.data(), n * 4);
  memcpy(prev, vm->sys_prev.data(), n * 4);
  memcpy(val, vm->sys_val.data(), n * 4);
  memcpy(pts, vm->sys_pts.data(), n * 4);
}

int emu_pubio(void *h, uint32_t *digest8) {
  Vm *vm = (Vm *)h;
  memcpy(digest8, vm->pubio_digest, 8 * 4);
  return vm->pubio_committed;
}

}  // extern "C"
