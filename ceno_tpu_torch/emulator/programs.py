"""Test guest programs written in the mini-assembler.

Stand-ins for the reference's examples/ guest crate (SURVEY.md §2.5) — this
image has no riscv toolchain, so the canonical workloads (fibonacci,
quadratic sorting, is_prime) are hand-assembled. Result convention: a0 holds
the output; halt via ecall with t0=0 (exit code in a0).

Copy of ``ceno_tpu/emulator/programs.py``: the port keeps its own, with the same
relative imports.
"""

from .rv32im import assemble
from .state import VMState, make_program, Platform

ROM = 0x0800_0000

FIBONACCI = """
    li a0, {n}
    li t1, 0        # f0
    li t2, 1        # f1
loop:
    beq a0, zero, done
    add t3, t1, t2
    mv t1, t2
    mv t2, t3
    addi a0, a0, -1
    j loop
done:
    mv a0, t1
    li t0, 0
    ecall
"""

# memory traffic workload: write then read-sum an array on the heap
MEMSUM = """
    li t1, {heap}
    li t2, {n}
    li t3, 0        # i
store_loop:
    beq t3, t2, sum_init
    slli t4, t3, 2
    add t4, t4, t1
    sw t3, 0(t4)
    addi t3, t3, 1
    j store_loop
sum_init:
    li t3, 0
    li a0, 0
sum_loop:
    beq t3, t2, done
    slli t4, t3, 2
    add t4, t4, t1
    lw t5, 0(t4)
    add a0, a0, t5
    addi t3, t3, 1
    j sum_loop
done:
    li t0, 0
    ecall
"""


FIBONACCI_HINTED = """
    li t3, {hints}
    lw a0, 0(t3)    # n from the private-input (hints) region
    li t1, 0
    li t2, 1
loop:
    beq a0, zero, done
    add t3, t1, t2
    mv t1, t2
    mv t2, t3
    addi a0, a0, -1
    j loop
done:
    mv a0, t1
    li t0, 0
    ecall
"""


def fibonacci_hinted_vm(n: int) -> VMState:
    """Fibonacci with the iteration count supplied as a hint word (the
    ceno_rt::read / CenoStdin mechanism, SURVEY.md §2.5/§2.6)."""
    words = assemble(FIBONACCI_HINTED.format(hints=Platform.hints_start), ROM)
    vm = VMState(make_program(words, ROM), ROM)
    vm.init_memory(Platform.hints_start, n)
    return vm


def fibonacci_vm(n: int) -> VMState:
    words = assemble(FIBONACCI.format(n=n), ROM)
    return VMState(make_program(words, ROM), ROM)


def memsum_vm(n: int) -> VMState:
    words = assemble(MEMSUM.format(n=n, heap=Platform.heap_start), ROM)
    return VMState(make_program(words, ROM), ROM)


def fib_expected(n: int) -> int:
    a, b = 0, 1
    for _ in range(n):
        a, b = b, (a + b) & 0xFFFFFFFF
    return a
