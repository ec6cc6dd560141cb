#!/usr/bin/env python3
"""Smoke run of ceno_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``ceno_tpu_torch/csrc`` and checks the port at
the shapes of the 2^20-step fibonacci proof, in phases:

  0. setup: the card's name and power limit, a 600 s watchdog, the build
     (one nvcc per source, all at once: ``poseidon2_merkle.cu``,
     ``sumcheck.cu``, ``gl_commit.cu``);
  1. golden Merkle check: K1 then K2 on the committed fixed-column codeword in
     ``.commit_cache/`` must reproduce its leaves, all 19 levels and the root,
     through K2's tree entry point ``merkle_levels`` and once more through the
     one-level ``compress_level``, level after level;
  2. each kernel against its plain torch version at the main path's shapes
     (K1 on seeded (61, 2^22), (13, 2^19) and (4, 2^21) matrices, K2 over
     each of their trees), bitwise, with the times of both and the card's
     bound for the same work; K2 over every tree from 2^1 to 2^11 leaves,
     across its top launch's threshold; then both on edge words at
     (61, 2^16): all 0, all p - 1 and alternating 0 / p - 1. The sumcheck
     kernels likewise, on seeded banks at the shapes of the main path's
     largest sumchecks (``TOWER_*``, ``CLASS_MAINS``; phase 4 checks that
     the GKR stages run them): K6a and K6b (mixed and ext mode) at the first
     round of tower level 21 of the 2^22 group, with the fused tower's own
     term table, and of the 2^19 and 2^18 class mains; K5/K7 from every
     pos, sq_pos 0, 4 or 8, absorbed or not, with absorbs of up to 96 words
     and up to 70 powers, and timed at the fibonacci prove's steps
     (``DUPLEX_STEPS``: a degree-3 and a degree-4 round, the tower's alpha
     with its powers, a tower level's evals; phase 5 checks that its prove
     makes them) as CUDA graphs of 200 launches, so the host's pace is not
     in the time;
     K6a and K6b also at the shard-RAM class main and the EC-sum quark
     (phase 6 runs them) and at the precompile class mains
     (``PRECOMPILE_CLASS_MAINS``: the keccak core's 2^15 class, the keccak
     ecall's 2^10 class, the secp guest's 2-row class; phase 7 runs them)
     and at the aggregation's class mains (``AGG_CLASS_MAINS``: the 2^15
     class of pcs_merkle_rows, the 2^12 class of fs_duplex, both of degree
     8, the 2-row class of 6,299 terms; phase 9 runs them), K1 and K2 also
     at the aggregation's commit (415, 2^18), K6a and K6b (ext mode) at
     WHIR's first round (the bank [g, w, ones] of 2^19, one term, degree 2;
     phase 13 runs it);
     with ptxas's registers, stack frame and spills for each, and for K6a
     the launch plan its wrapper chose (``terms.round_evals_plan``). The
     Goldilocks commit kernels likewise (``gl_kernels_vs_plain``), at phase
     11's shapes: K14a on a seeded (26, 2^18) matrix at blowup 8, K14b on
     that codeword (26, 2^21) and on a (2, 2^20) first fold tree's leaves,
     K14c over all 21 levels of the (4, 2^21) leaves, every tree from 2^1 to
     2^11 leaves, and all three on edge words at (26, 2^12): all 0, all
     p - 1, 2^32 - 1, 2^32 and alternating 0 / p - 1; their bounds count the
     IMAD instructions of one GL product in the SASS (cuobjdump of
     ``gl_mul_probe_kernel``);
  3. the PCS slice end to end with the default BasefoldParams: commit, open
     and verify the (61, 2^19) witness stack and the (13, 2^16) fixed stack,
     each with one random ext4 point per height class and the true MLE value
     of every slice; a claim with one value changed must be rejected. The
     kernel launch counts are read over this phase alone and must be those of
     the phase's 25 trees: K1 once per tree, K2 as ``merkle_plan`` plans them;
  4. the GKR slice: ``fibonacci_vm(174760)`` (1,048,571 steps) on the port's
     native emulator core (built from its C++ source; no fallback to the
     Python interpreter), the opcode chips' witness (rows per chip checked
     against the program), then stages 3-5 of ``zkvm/scheme.prove`` on the
     card: records per chip, one tower per tower size, one batched main
     zerocheck per height class, every record, tower layer and sumcheck bank
     checked to lie on the card; the port's verifiers must accept, and reject
     a proof over one changed output limb of the add chip; the first rounds
     of its sumchecks must include phase 2's shapes; the digests of the
     same stages at ``fibonacci_vm(100)`` must equal the reference's,
     committed in ``ceno_tpu_torch/golden/gkr_fibonacci.json``. All of it
     runs the fused sumchecks and tower levels (the default); then, with
     ``CENO_TPU_TORCH_FUSED=0`` and ``CENO_TPU_TORCH_FUSED_TOWER=0``, the
     per-round sumchecks and per-level towers must give the same digests of
     the full-size proof and pass the golden check;
  5. the main path end to end, as a user calls it: ``fibonacci_vm(174760)``
     on the native core (no fallback), ``public_values_from_vm``, ``keygen``
     at bench.py's ``ZKVMConfig(shl_x_bits=10)`` and ``BasefoldParams()``
     (its stacked fixed matrix must have the content key that names the
     golden file, and its fixed codeword, leaves, levels and root must equal
     the file's), a first ``prove`` (its K5/K7 steps counted by words and
     powers: phase 2's ``DUPLEX_STEPS`` must be among them), a second one
     with spans on and every witness commit, record, tower layer and
     sumcheck bank checked to lie on the card, then ``verify`` (the
     kernels' launch counts are reset just
     before keygen and before the second prove, and read just after each:
     K1, K2, K6a, K6b and K5/K7);
     both proofs must be the same bytes, and a changed public value,
     class-main eval and opening row must each be rejected. Its golden
     gate (run in phase 9's untimed window): the proof of ``fibonacci_vm(100)`` at
     ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)`` and ``BasefoldParams()``
     must have the SHA-256 and length of the reference's
     (``ceno_tpu_torch/golden/e2e_fibonacci.json``) and verify;
  6. continuations: its golden gate (run in phase 9's untimed window),
     ``prove_shards`` (pipelined) of
     ``fibonacci_vm(12)`` at ``tests/test_shard.py``'s setup (40 steps a
     shard, 3 shards): each shard's proof must have the SHA-256 and length of
     the reference's (``ceno_tpu_torch/golden/shard_fibonacci.json``),
     ``verify_shards`` must accept it and reject a broken pc chain, a broken
     cycle chain, a tampered RW sum and a dropped shard, and ``verify`` an
     interior shard as a standalone proof. The phase: the 2^20 fibonacci as two
     shards on phase 5's key, vm and trace (``bench_shards.py``'s
     ``max_steps = (n + 1) // 2 + 8``): the AOT preflight's bounds must equal
     the trace's ``plan_boundaries``; ``prove_shards`` pipelined on the card
     (the next shard's witgen on a host thread; every commit, record, tower
     layer and sumcheck bank checked to lie on the card and to be made on the
     main thread; the launch counts reset just before and read just after,
     each kernel's at least one); ``verify_shards`` must accept, the
     cross-shard EC sum be the identity, and the same tampered proofs be
     rejected; then K6a against its plain version, bitwise and timed, on the
     first-round inputs of the shard-RAM 2^9 class main that prove made;
  7. precompiles and guest I/O: its golden gate (run in phase 9's untimed
     window), the proofs of four guests at ``ZKVMConfig(shl_x_bits=6, mem_words_log=7)`` and
     ``BasefoldParams()`` (``examples/precompile_torture.s``: keccak-f, SHA
     extend, uint256 mul, PUB_IO_COMMIT; ``examples/hashing.s`` with its hints
     written by ``CenoStdin``; ``tests/test_curves.py``'s secp guest, run by
     the Python interpreter as the native core has no curve calls;
     ``tests/test_messages.py``'s println guest, its messages read back with
     ``read_all_messages``): each must have the SHA-256 and length of the
     reference's (``ceno_tpu_torch/golden/precompile_guests.json``) and
     verify; the secp guest's prove must run phase 2's secp class main.
     The phase: the precompile path at full size, KECCAK_LOOP_SRC with
     1,024 permutations (N from a ``CenoStdin`` hints buffer) on the native
     core, its committed words against keccak-f applied 1,024 times on the
     host, keygen at bench.py's config and ``BasefoldParams()``, one prove
     with spans, the device audit and the launch counts (reset just before,
     read just after, each kernel's at least one), verify, and a changed
     main-zerocheck message of the keccak core's class and a changed public
     value rejected; the keccak loop's prove must run phase 2's keccak
     class mains; then K6a against its plain version,
     bitwise and timed, on the first-round inputs of the keccak core's 2^15
     class main that prove made;
  8. report: phase 3's span tree; the launch counts of phase 3 and of
     phase 5's keygen and timed prove, each equal to its trees' launch
     plans (K1 once a tree, K2 as ``merkle_plan`` plans it); phase 4's
     span tree and its ``{"gkr": {...}}`` line; phase 5's span tree and its
     proof size beside the reference's; a
     ``{"kernels": [...]}`` line (the largest shapes; launches over phase 5's
     timed prove, each kernel's at least one); phase 6's span tree and its
     launch counts; phase 7's span tree and its launch counts (the
     ``{"e2e": ...}``, ``{"shards": ...}`` and ``{"precompiles": ...}``
     lines wait for their golden gates: phase 9 prints them);
  9. aggregation: the main process aggregates phase 5's 2^20 proof with
     phase 5's key (``prove_aggregation`` with spans, the device audit and
     the launch counts, reset just before and read just after, each
     kernel's at least one; its sumchecks must run ``AGG_CLASS_MAINS``),
     verifies it key-less (``verify_aggregation``, which rebuilds the key
     from the proof's skeleton), then holds K6a against its plain version,
     bitwise and timed, on the first-round inputs of its 2^15 class main;
     nothing else runs on the host or the card while these are timed.
     Then, timed by no metric, worker processes (``agg_pool``: spawned,
     each its own CUDA context) run the golden gates of phases 5, 6 and 7,
     verify the proof read back from its bytes, reject it with a changed
     public value, and prove the entries of
     ``ceno_tpu_torch/golden/aggregation_fibonacci.json`` on the card,
     holding them against the reference's digests (SHA-256 and length of
     ``agg_proof_to_bytes``, the key's digest): the single
     ``prove_aggregation`` of ``fibonacci_vm(8)``, the sharded
     ``fibonacci_vm(12)`` (``prove_shard_aggregation``), the level-2
     ``prove_chipset_aggregation`` of that single aggregation (over its
     stored bytes, with its key rebuilt key-less, so that it need not wait
     for the single one), all at ``tests/test_aggregate.py``'s setup, and
     ``prove_aggregation`` of ``fibonacci_vm(100)`` at ``BasefoldParams()``;
     the matching key-less verifier must accept each (the level-2 one the
     reference's stored bytes, in a worker of its own beside the level-2
     prove, whose digests must equal them), and reject the single aggregation with a
     changed public value, a wrong geometry flag and a changed class-main
     eval. It prints phase 5's ``{"e2e": {...}}`` line (seconds per stage,
     proof size, peak memory, launches, the golden gate), phase 6's
     ``{"shards": {...}}`` line (plan, per-shard,
     pipelined and stitch-verify seconds, tokens and quark rounds per shard,
     peak device memory, the golden gate) and phase 7's ``{"precompiles":
     {...}}`` line (steps, rows per precompile chip, seconds per stage and
     witgen step, proof bytes, peak device memory, launches, the golden
     guests), the span tree, the ``{"aggregation": {...}}`` line
     (chips, rows, cells, seconds of the witness, the prove by stage, the
     key rebuild and the verification, proof bytes, peak device memory,
     launches, the golden results) and the ``{"kernel_shapes": ...}`` line
     with every shape of phase 2 and the real inputs of phases 6, 7 and 9;
     the card line and, last, ``{"ok": true, "device": {...}}``;
 10. the command line, the key cache and row sharding. First, with nothing
     beside it, phase 5's keygen again with ``CENO_TPU_TORCH_COMMIT_CACHE``
     naming a temporary directory that holds a copy of GOLDEN: it must hit
     that file (write nothing) and give phase 5's fresh fixed commitment
     (cols, codeword, leaves, levels, root); the fixed commit alone is timed
     fresh and from the cache (the ``{"key_cache": ...}`` line). Then, in
     phase 9's untimed window beside its workers: ``python -m
     ceno_tpu_torch`` in subprocesses (on the card, its default):
     ``prove examples/fibonacci.s --hints 174760 --profile test`` (the
     2^20-step trace) and ``verify`` of that file, which must accept it with
     the guest's exit code (wall seconds and bytes); then the setup of
     ``ceno_tpu_torch/golden/cli_fibonacci.json`` (``--hints 100``):
     ``prove``, ``verify``, ``aggregate`` and ``stats --active``, whose
     proof and aggregation files must have the reference's SHA-256 and
     length, verify the reference's exit code and cycles, and stats the
     reference's text (the ``{"cli": ...}`` line). Beside them, the
     row-sharded chip prove (``parallel/chip.prove_chip_sharded``): phase 4's
     ``fibonacci_vm(174760)`` witness of its largest opcode chip (addi, 2^19
     rows) proved by 4 spawned ranks that share the card over ``gloo``
     (``parallel/sharded.run_ranks``); every rank's proof must be the bytes
     of the single-device ``prove_chip`` on the card, which the verifier
     accepts, and each rank must launch K6a and K6b (the ``{"sharded_chip":
     ...}`` line; correctness only: four ranks on one card show no speed);
 11. Goldilocks (``run_gl``): the add chip of phase 5's trace (174,760 rows,
     a (26, 2^18) witness, its ``rd_idinv`` recomputed as the GL inverse)
     through the port's ``assign_opcode_chips``, proved over GoldilocksExt2
     with ``gl/zkvm.prove_chip_gl`` at ``GlParams()`` on the card, with spans,
     the device audit (every commit, record, tower layer and sumcheck bank on
     the card, made on the main thread) and K14's launch counts (reset just
     before, read just after, each at least one); ``verify_chip_gl`` on the
     host must accept it and reject the proof with a changed witness
     evaluation and with a changed opened row, and the proof of the add chip
     with its ``rd_iszero`` cell changed (tests/test_gl_pipeline.py's
     tamper). Nothing runs beside it. In phase 9's untimed window a worker
     runs its golden gate (``gl_golden_check``): the port's GL commit roots
     of seeded matrices, a seeded GL sumcheck's digest and the GlChipProof
     digest of ``fibonacci_vm(40)``'s add chip at the test's params must
     equal the reference's (``ceno_tpu_torch/golden/gl_pipeline.json``). It
     prints the span tree and the ``{"gl": {...}}`` line (seconds of the
     witness, the prove, the verify and the tampered prove, spans, launches,
     peak device memory, the golden gate).
 12. the Goldilocks zkVM scheme (``run_gl_scheme``): on phase 5's key, vm
     and 2^20-step trace, ``gl/scheme.keygen_gl``, then ``prove_gl`` of the
     trace as one standalone shard at ``GlParams()`` on the card (every
     active chip: a GL witgen, then per chip a K14a-c commit,
     records, towers, the masked main zerocheck and its opening), timed with
     nothing beside it, with spans (``gl/witgen``, ``gl/commit``, and per
     chip ``gl/chip/<name>`` over ``gl/records``, ``gl/towers``,
     ``gl/main``, ``gl/open``, ``gl/quark``), the device audit and K14's
     launch counts (reset just before, read just after, each at least one;
     they are the ``kernels`` line's K14 launches, phase 11's kept beside
     them). In phase 9's untimed window, worker jobs
     (``gl_scheme_jobs``): the host ``verify_gl`` of that proof, shipped
     as its interop dict, which must accept it and reject a changed
     ``wit_evals`` entry, a flipped public value and a changed opened row;
     and the golden gate: the port's ``prove_gl`` of tests/test_gl_scheme.py's
     setup and ``prove_shards_gl`` of tests/test_gl_continuation.py:138's
     two-shard setup, at the small params, on the card, whose digests must
     equal the reference's (``ceno_tpu_torch/golden/gl_scheme.json``), with
     ``verify_shards_gl`` accepting the two shards and rejecting a changed
     ``PV_RW_SUM_IN`` limb, a broken pc chain and a dropped shard. It prints
     the span tree and the ``{"gl_scheme": {...}}`` line (active chips and
     rows, seconds of ``keygen_gl``, the witgen, the prove by span and by
     chip, the grinds summed, the verify beside the workers, peak device
     memory, launches, the golden results).
 13. WHIR (``run_whir``), with nothing beside it: on phase 5's vm and
     2^20-step trace, ``keygen`` at ``BasefoldParams(pcs_kind="whir")``
     (bench.py's config; blowup 8, 29 queries, 16 PoW bits), timed, then one
     ``prove``, timed, whose jagged openings are WHIR's (``pcs/whir.py``:
     rounds on K6a/K6b, new oracles through the NTT encode and K1/K2), with
     spans (``whir/rounds``, ``whir/encode``, ``whir/tree``, ``whir/grind``,
     ``whir/queries``), the device audit (phase 5's, and WHIR's g, weights,
     oracles and trees, each made on the main thread) and the launch counts
     (reset just before, read just after; those inside the WHIR openings
     apart, each of K1, K2, K6a and K6b at least once; the rounds must run
     phase 2's first-round bank), then the host ``verify``, timed. In
     phase 9's untimed window one worker verifies the proof with a changed
     query leaf, OOD value or final function, each of which must be
     rejected (``whir_rejects_job``), and another runs its golden gate
     (``whir_golden_check``): tests/test_whir.py's seeded ``open_whir``
     case (the proof's digest and the transcript's end state), the proof of
     ``fibonacci_vm(8)`` at tests/test_whir.py::test_whir_zkvm_e2e's params
     and that of ``fibonacci_vm(100)`` at ``BasefoldParams(pcs_kind="whir")``
     must equal the reference's (``ceno_tpu_torch/golden/whir_fibonacci.json``)
     and verify. It prints the span tree and the ``{"whir": {...}}`` line
     (seconds of keygen, prove, verify and the golden gate, the prove's
     stages and WHIR spans, the openings' shapes and oracles, proof bytes,
     peak device memory, launches, the rejections, the golden results).

Any mismatch, rejected honest proof or exception exits nonzero before the
last line. Without a CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import faulthandler
import hashlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.distributed as dist

from ceno_tpu_torch import interop
from ceno_tpu_torch.emulator import keccak, native, programs
from ceno_tpu_torch.emulator.rv32im import assemble
from ceno_tpu_torch.emulator.state import CYCLE_START, Platform, VMState, make_program
from ceno_tpu_torch.fields import babybear as bb
from ceno_tpu_torch.fields import ext4
from ceno_tpu_torch.fields import gl_host
from ceno_tpu_torch.fields import goldilocks as gld
from ceno_tpu_torch.fields import goldilocks_ext2 as gx
from ceno_tpu_torch.fields import septic
from ceno_tpu_torch.gkr import chip as gkr_chip
from ceno_tpu_torch.gkr import eccquark
from ceno_tpu_torch.gkr import tower
from ceno_tpu_torch.gkr.chip import ChipError
from ceno_tpu_torch.gkr.tower import TowerError
from ceno_tpu_torch.gl import device as gdev
from ceno_tpu_torch.gl import eccquark as glq
from ceno_tpu_torch.gl import scheme as gls
from ceno_tpu_torch.gl import shard as glshard
from ceno_tpu_torch.gl import pcs as gpcs
from ceno_tpu_torch.gl import sumcheck as gsc
from ceno_tpu_torch.gl import zkvm as gz
from ceno_tpu_torch.gl.transcript import GlTranscript
from ceno_tpu_torch.hash import poseidon2_merkle as pm
from ceno_tpu_torch.hash.transcript import Transcript
from ceno_tpu_torch.host import CenoStdin, read_all_messages
from ceno_tpu_torch.mle import ops
from ceno_tpu_torch.parallel import chip as pchip
from ceno_tpu_torch.parallel import sharded as psharded
from ceno_tpu_torch.pcs import basefold as bf
from ceno_tpu_torch.pcs import commitcache
from ceno_tpu_torch.pcs import jagged as jg
from ceno_tpu_torch.pcs import whir
from ceno_tpu_torch.sumcheck import fused, terms
from ceno_tpu_torch.sumcheck import prover as sc_prover
from ceno_tpu_torch.sumcheck.host_impl import build_eq_host
from ceno_tpu_torch.sumcheck.verifier import SumcheckError
from ceno_tpu_torch.utils import cuda_build, spans
from ceno_tpu_torch.zkvm import aggregate, e2e, layout, scheme, serialize, shard, witgen
from ceno_tpu_torch.zkvm.chips.opcodes import TraceView, build_opcode_chips
from ceno_tpu_torch.zkvm.tables import ZKVMConfig

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, ".commit_cache", "commit-8cc386001f1b61172778f21844b7e769.npz")
SEED = 20

# (h, cols) classes of the 2^20-step fibonacci witness (ZKVMConfig(shl_x_bits=10))
WITNESS_CLASSES = [(2, 30), (16, 2), (32, 7), (256, 6), (4096, 1), (16384, 2),
                   (65536, 4), (262144, 62), (524288, 23)]
# fixed-column classes of the same proof's key
FIXED_CLASSES = [(16, 8), (32, 12), (16384, 8), (65536, 9)]

# H100 SXM peaks at the 700 W limit. HBM bytes/s: NVIDIA's H100 data sheet.
# 32-bit integer multiplies/s: the CUDA C++ Programming Guide's table of
# arithmetic instruction throughput gives compute capability 9.0 64 results
# per clock per SM for 32-bit integer multiply and multiply-add (against 128
# for float32 fma), times the data sheet's 132 SMs and 1.98 GHz boost clock.
PEAK_BYTES_PER_S = 3.35e12
PEAK_MULS_PER_S = 132 * 64 * 1.98e9
MULS_PER_PERM = 772 * 3  # Montgomery products per permutation x 3 multiplies

# (C, log2 M) main-path shapes of K1: the witness commit, the fixed commit and
# the first witness fold tree (4 rows for one point); K2 runs over their trees
K1_SHAPES = [(61, 22), (13, 19), (4, 21), (415, 18)]  # the last: the aggregation's commit
SMALL_TREES = range(1, 12)  # log2 of the leaf counts of the small K2 trees

# The main path's largest sumchecks, whose shapes phase 2 holds K6a and K6b
# at (phase 4 checks that the 2^20-step fibonacci's GKR stages run them):
# - the first round of tower level 21 of the 2^22 group (add and addi):
#   TOWER_SPECS product and LogUp specs, the fused tower's term table;
# - the first round of the 2^19 and 2^18 class mains: their base columns
#   (witness, fixed and structural), sel_eq columns (one a chip), live terms,
#   the most base and ext factors a term has and the degree.
TOWER_LOG_N = 21
TOWER_SPECS = (4, 2)  # (product, LogUp): add's and addi's two products and one LogUp each
CLASS_MAINS = [  # the 2^19 class (addi), and the 2^18 class (add, beq, jal) of the largest degree
    {"log_n": 19, "base": 23, "ext": 1, "terms": 83, "db": 2, "de": 1, "deg": 3},
    {"log_n": 18, "base": 62, "ext": 3, "terms": 215, "db": 3, "de": 1, "deg": 4},
]
# The sharded 2^20 fibonacci's sumchecks that the single-shard proof does not
# run (phase 6 checks that its sharded prove runs them): the first round of
# the 2^9 class main of a shard-RAM chip alone (288 tokens; its Poseidon2
# columns make it the one main of degree 8) and of the EC-sum quark over a
# tree of 2^10 rows (9 rounds), with the quark's own term table.
SHARD_CLASS_MAIN = {"what": "shard-RAM", "log_n": 9, "base": 315, "ext": 1, "terms": 3289,
                    "db": 7, "de": 1, "deg": 8}
QUARK_LOG_N = 9
# The precompile path's class mains (phase 7 checks that its proves run
# them): the first round of the keccak core chip's 2^15 class alone (1,024
# permutations, 24 rows each: 1,274 witness columns, 1,201 lookups) and of
# the 2^10 class of its ecall chip (1,210 terms) with bne (1,276 terms, 1,274
# with a nonzero scalar), both in phase 7b's keccak loop; and of the 2-row
# class of phase 7a's secp guest, where secp256k1_add's 14,196 terms sit
# beside the other curve chips' (lw, halt, secp256k1_add, _double,
# _decompress, _invert, global: 39,427 terms, 39,422 with a nonzero scalar).
# "terms" counts the live terms, which are what K6a runs.
KECCAK_CLASS_MAINS = [
    {"what": "keccak core", "chips": ("keccak_core",), "log_n": 15, "base": 1274, "ext": 1,
     "terms": 5376, "db": 2, "de": 1, "deg": 3},
    {"what": "keccak ecall", "chips": ("bne", "keccak_ecall"), "log_n": 10, "base": 386,
     "ext": 2, "terms": 1274, "db": 3, "de": 1, "deg": 4},
]
SECP_CLASS_MAIN = {"what": "secp guest", "chips": ("lw", "halt", "secp256k1_add",
                                                   "secp256k1_double", "secp256k1_decompress",
                                                   "secp256k1_invert", "global"),
                   "log_n": 1, "base": 3094, "ext": 7, "terms": 39422, "db": 2, "de": 1,
                   "deg": 3}
PRECOMPILE_CLASS_MAINS = KECCAK_CLASS_MAINS + [SECP_CLASS_MAIN]
# The aggregation's class mains (phase 9 checks that the aggregation of the
# 2^20 fibonacci proof runs them): the first round of its 2^15 class
# (pcs_merkle_rows, 319 columns with the Poseidon2 gadget, beside fs_scav)
# and of its 2^12 class (fs_duplex, the in-circuit transcript, beside
# jag_eq_rows), both of degree 8 with 7 base factors a term, and of its
# 2-row class of 16 chips, the one with the most terms.
AGG_CLASS_MAINS = [
    {"what": "aggregation", "chips": ("pcs_merkle_rows", "fs_scav"), "log_n": 15, "base": 321,
     "ext": 2, "terms": 3210, "db": 7, "de": 1, "deg": 8},
    {"what": "aggregation", "chips": ("jag_eq_rows", "fs_duplex"), "log_n": 12, "base": 331,
     "ext": 2, "terms": 3540, "db": 7, "de": 1, "deg": 8},
    {"what": "aggregation", "chips": ("tower_g*_ends", "fs_pv", "..."), "log_n": 1,
     "base": 1369, "ext": 16, "terms": 6299, "db": 2, "de": 1, "deg": 3},
]
# K5/K7's steps in the 2^20-step fibonacci prove, whose shapes phase 2 times
# it at (phase 5 checks that its first prove makes each): (what, words
# absorbed, powers). Each starts where the prove's do, after a sample: pos 0,
# sq_pos 4, nothing absorbed since (DUPLEX_FROM). A degree-3 round's message
# (16 words: 2 permutations), a degree-4 one's (20: 3), the fused tower's
# alpha with its powers (the sample before left four words: no
# permutation; 12 powers, the n_claims = 4 + 2 * 4 of the 2^4 group (lui,
# halt, program, range4), the most of the prove's tower groups) and a tower
# level's end absorbing that group's S_e = 24 evals (96 words: 12).
DUPLEX_STEPS = [("a degree-3 round's step", 16, 0), ("a degree-4 round's step", 20, 0),
                ("the tower's alpha and its 12 powers", 0, 12),
                ("a tower level's 24 evals (2^4 group)", 96, 0)]
DUPLEX_FROM = (0, 4, False)  # pos, sq_pos, absorbed
# phase 2's check from every state: words absorbed and powers, cycled over
# the states, beside a round's 16 words and 5 powers at each
DUPLEX_CHECKS = [(70, 70), (33, 33), (0, 32), (64, 31), (1, 1), (20, 0), (96, 12)]
MULS_PER_PRODUCT = 3  # 32-bit multiplies of one Montgomery product
EXT_PRODUCTS = 16     # base products of one ext4 product (the x^4 = 11 wrap adds none)


def opening_trees(n_vars: int, params) -> list:
    """log2 leaf counts of the fold trees one Basefold opening of 2^n_vars
    rows commits (pcs/basefold.open_batch): one a round while the folded
    codeword is longer than ``stop_size``, never in the last round."""
    top = n_vars + params.blowup_log
    return [top - 1 - r for r in range(n_vars - 1) if (1 << (top - 1 - r)) > params.stop_size]


# log2 of the leaf counts of phase 3's trees: the witness commit (2^19 rows,
# blowup 8) and its 13 fold trees, the fixed commit (2^16 rows) and its 10
# (folding stops at 2^9 leaves); the launch-plan tests read this list too
MAIN_PATH_TREES = [22, *opening_trees(19, bf.BasefoldParams()),
                   19, *opening_trees(16, bf.BasefoldParams())]
EDGE_SHAPE = (61, 16)  # (C, log2 M) of the edge-word inputs
DEVICE = "cuda"
T0 = time.time()


def log(msg: str) -> None:
    print(f"[{time.time() - T0:8.2f}s] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` runs after one warm-up."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, n: int = 200) -> float:
    """Device time of one ``fn()`` without the host's pacing: ``n`` calls
    captured in one CUDA graph, which is replayed between two events (after
    a warm-up call and a warm-up replay); the mean per call."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    g.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def wall_ms(fn) -> tuple:
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def bound_of(muls: int, nbytes: int) -> tuple:
    """Least time for ``muls`` 32-bit integer multiplies moving ``nbytes``:
    the larger of the bytes over the HBM rate and the multiplies over the
    multiply rate, in ms, and which of the two it is."""
    t_ops = muls / PEAK_MULS_PER_S
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def bound(perms: int, nbytes: int) -> tuple:
    """Least time for ``perms`` permutations moving ``nbytes``. It counts
    multiplies only, not the additions and reductions, which share the
    integer ALU pipe's own 64 per clock per SM."""
    return bound_of(perms * MULS_PER_PERM, nbytes)


def reset_launches() -> None:
    """Every kernel wrapper's launch count to 0."""
    for mod in (pm, terms, fused):
        mod.reset_launches()


def launches() -> dict:
    """Every kernel wrapper's launch count: K1, K2, K6a, K6b, K5/K7."""
    return {**pm.LAUNCHES, **terms.LAUNCHES, **fused.LAUNCHES}


def ptxas_by_kernel(log: str) -> dict:
    """ptxas's registers, stack frame and spills per kernel from an
    ``-Xptxas -v`` build log, keyed by the kernel's name (with its degree for
    K6a's template)."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"\d+([a-z_]+_kernel)(?:ILi(\d+)EE)?", m.group(1))
            cur = m.group(1) if k is None else k.group(1)
            if k is not None and k.group(2):
                cur += f"<{k.group(2)}>"
            out[cur] = {}
        elif cur and "spill stores" in line:
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                          r"spill loads", line)
            out[cur].update(stack_frame=int(m.group(1)), spill_stores=int(m.group(2)),
                            spill_loads=int(m.group(3)))
        elif cur and "registers" in line:
            out[cur]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return out


def max_abs_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item())


@contextlib.contextmanager
def phase(name: str):
    log(f"phase {name}: start")
    t = time.time()
    yield
    log(f"phase {name}: done in {time.time() - t:.2f}s")


def golden_check() -> None:
    with np.load(GOLDEN) as z:
        cw = z["cw"].astype(np.uint64)
        leaves = z["leaves"].astype(np.uint64)
        levels = [z[f"level{i}"].astype(np.uint64) for i in range(int(z["n_levels"]))]
    log(f"golden file: cw {cw.shape}, {len(levels)} levels")
    cur = pm.leaf_sponge(bb.to_device(cw, DEVICE))
    if not np.array_equal(bb.to_host(cur), leaves):
        fail("K1 leaves differ from the committed fixed-commit leaves")
    tree = pm.merkle_levels(cur)
    if len(tree) != len(levels):
        fail(f"merkle_levels gave {len(tree)} levels, the committed tree has {len(levels)}")
    for i, want in enumerate(levels):
        if not np.array_equal(bb.to_host(tree[i]), want):
            fail(f"K2 merkle_levels: level {i} differs from the committed level{i}")
        cur = pm.compress_level(cur)
        if not np.array_equal(bb.to_host(cur), want):
            fail(f"K2 compress_level: level {i} differs from the committed level{i}")
    log(f"golden: leaves, {len(levels)} levels (merkle_levels in {len(pm.merkle_plan(cw.shape[1]))}"
        f" launches, and compress_level level by level) and root "
        f"{bb.to_host(cur)[:, 0].tolist()} equal")


def plain_levels(leaves) -> list:
    cur, out = leaves, []
    while cur.shape[1] > 1:
        cur = pm.compress_level_plain(cur)
        out.append(cur)
    return out


def levels_err(got, want) -> int:
    if len(got) != len(want):
        fail(f"K2 gave {len(got)} levels, the plain version {len(want)}")
    return max((max_abs_err(a, b) for a, b in zip(got, want)), default=0)


def kernels_vs_plain(rng) -> tuple:
    """Each kernel against its plain version at every main-path shape, bitwise,
    with both times. Returns (the ``kernels`` entries at the largest shapes,
    one row per shape)."""
    rows, results = [], {}
    for c, log_m in K1_SHAPES:
        m = 1 << log_m
        cols = bb.to_device(rng.integers(0, bb.P, size=(c, m), dtype=np.uint64), DEVICE)
        got = pm.leaf_sponge(cols)
        ms = cuda_ms(lambda: pm.leaf_sponge(cols), reps=5)
        chunk = 1 << 20
        want, plain_ms = wall_ms(lambda: torch.cat(
            [pm.leaf_sponge_plain(cols[:, s:s + chunk]) for s in range(0, m, chunk)], 1))
        err = max_abs_err(got, want)
        b_ms, b_by = bound(-(-max(c, 1) // 8) * m, (c + 8) * 4 * m)
        rows.append(dict(name="leaf_sponge", shape=f"({c}, 2^{log_m})", max_abs_err=err,
                         ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by))
        results.setdefault("leaf_sponge", rows[-1])
        log(f"K1 ({c}, 2^{log_m}) full width: max_abs_err {err}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        if err:
            fail(f"K1 differs from its plain version at ({c}, 2^{log_m})")
        del cols, want
        levels = pm.merkle_levels(got)
        ms = cuda_ms(lambda: pm.merkle_levels(got), reps=5)
        want, plain_ms = wall_ms(lambda: plain_levels(got))
        err = levels_err(levels, want)
        b_ms, b_by = bound(m - 1, 8 * 4 * m + 8 * 4 * (m - 1))
        n_launch = len(pm.merkle_plan(m))
        rows.append(dict(name="compress_level", shape=f"all {log_m} levels of (8, 2^{log_m})",
                         launches_per_tree=n_launch, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by))
        results.setdefault("compress_level", rows[-1])
        log(f"K2 all {log_m} levels of (8, 2^{log_m}) in {n_launch} launches: max_abs_err {err}, "
            f"kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.3f} ms ({b_by})")
        if err:
            fail(f"K2 differs from its plain version on the 2^{log_m} tree")
        del levels, want
    for log_m in SMALL_TREES:
        leaves = bb.to_device(rng.integers(0, bb.P, size=(8, 1 << log_m), dtype=np.uint64), DEVICE)
        if levels_err(pm.merkle_levels(leaves), plain_levels(leaves)):
            fail(f"K2 differs from its plain version on the 2^{log_m} tree")
    log(f"K2 over every tree from 2^{SMALL_TREES[0]} to 2^{SMALL_TREES[-1]} leaves "
        f"({sum(len(pm.merkle_plan(1 << n)) for n in SMALL_TREES)} launches) equals the plain version")
    edge_words(EDGE_SHAPE)
    kernels = [
        dict(name=name, route="cuda", source="ceno_tpu_torch/csrc/poseidon2_merkle.cu",
             replaces=f"ceno_tpu/hash/poseidon2_pallas.py:{line}",
             **{k: v for k, v in results[name].items() if k not in ("name", "launches_per_tree")},
             library_ms=None)
        for name, line in (("leaf_sponge", 116), ("compress_level", 147))
    ]
    return kernels, rows


def edge_words(shape) -> None:
    """K1 on (C, M) words all 0, all p - 1 and alternating 0 / p - 1, and K2
    over the tree whose leaves are the first 8 rows of each, bitwise against
    the plain versions: the values where a reduction left out shows."""
    c, m = shape[0], 1 << shape[1]
    alternating = (torch.arange(c * m, device=DEVICE).reshape(c, m) % 2 * (bb.P - 1)).to(bb.DTYPE)
    for name, words in (("all 0", torch.zeros((c, m), dtype=bb.DTYPE, device=DEVICE)),
                        ("all p-1", torch.full((c, m), bb.P - 1, dtype=bb.DTYPE, device=DEVICE)),
                        ("alternating 0/p-1", alternating)):
        level = words[:8].contiguous()
        if max_abs_err(pm.leaf_sponge(words), pm.leaf_sponge_plain(words)):
            fail(f"K1 differs from its plain version on {name} words at ({c}, 2^{shape[1]})")
        if levels_err(pm.merkle_levels(level), plain_levels(level)):
            fail(f"K2 differs from its plain version on {name} words, (8, 2^{shape[1]}) tree")
        log(f"edge words {name}: K1 at ({c}, 2^{shape[1]}) and K2 over (8, 2^{shape[1]}) "
            "equal their plain versions")


# -- phase 2, continued: the Goldilocks commit kernels K14a, K14b, K14c ----------

GL_P = gld.P
GL_ENCODE_SHAPE = (26, 18, 3)  # (C, log2 N, blowup_log): phase 11's witness commit
GL_LEAF_SHAPES = [(26, 21), (2, 20)]  # its codeword's leaves; the first fold tree's
GL_TREE_LOG = 21               # the codeword's tree
GL_EDGE_SHAPE = (26, 12)       # (C, log2 M) of the edge-word inputs
GL_PRODUCTS_PER_PERM = 520     # 8 x 8 S-boxes x 4 + 22 x (4 + 8 diagonal)


def gl_imads_per_product() -> dict:
    """The IMAD instructions of one GL product: cuobjdump's SASS of
    ``gl_mul_probe_kernel`` (one product a thread, never launched), with the
    IMAD.MOV moves counted apart."""
    lib = cuda_build._target("gl_commit")[1]
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([tool, "-sass", "-fun", "gl_mul_probe_kernel", lib],
                         capture_output=True, text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed on {lib}: {out.stderr.strip()[:400]}")
    ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?(IMAD[.\w]*)", out.stdout)
    moves = sum(op.startswith("IMAD.MOV") for op in ops)
    if len(ops) - moves <= 0:
        fail(f"no IMAD in the SASS of gl_mul_probe_kernel:\n{out.stdout[:2000]}")
    return {"imad": len(ops) - moves, "imad_mov": moves,
            "kinds": sorted(set(op for op in ops if not op.startswith("IMAD.MOV")))}


def gl_random(rng, shape) -> torch.Tensor:
    return gld.to_device(rng.integers(0, GL_P, size=shape, dtype=np.uint64), DEVICE)


def gl_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest |got - want| over canonical words (0 when bitwise equal)."""
    if got.shape != want.shape:
        fail(f"K14: shape {tuple(got.shape)} against the plain version's {tuple(want.shape)}")
    if torch.equal(got, want):
        return 0
    a, b = gld.to_host(got), gld.to_host(want)
    return int(np.where(a > b, a - b, b - a).max())


def gl_levels_err(got, want) -> int:
    if len(got) != len(want):
        fail(f"K14c gave {len(got)} levels, the plain version {len(want)}")
    return max((gl_err(a, b) for a, b in zip(got, want)), default=0)


def gl_levels_plain_batched(trees: list) -> list:
    """``gdev.merkle_levels_plain`` of each (4, m) leaf tensor in ``trees``,
    one plain level compression per depth over every tree still that deep
    (the plain permutation's cost is its operation count, not its width)."""
    out = [[] for _ in trees]
    cur = list(trees)
    while any(c.shape[1] > 1 for c in cur):
        live = [i for i, c in enumerate(cur) if c.shape[1] > 1]
        parents = gdev.compress_level_plain(torch.cat([cur[i] for i in live], 1))
        for i, part in zip(live, parents.split([cur[i].shape[1] // 2 for i in live], 1)):
            cur[i] = part.contiguous()
            out[i].append(cur[i])
    return out


def gl_edge_words(c: int, m: int) -> list:
    """(name, (c, m) words on DEVICE): all 0, all p - 1, all 2^32 - 1, all
    2^32, alternating 0 / p - 1."""
    alternating = torch.arange(c * m, device=DEVICE).reshape(c, m) % 2 * gld.const(GL_P - 1)
    return [(name, gld.full((c, m), v, DEVICE)) for name, v in
            (("all 0", 0), ("all p-1", GL_P - 1), ("all 2^32-1", (1 << 32) - 1),
             ("all 2^32", 1 << 32))] + [("alternating 0/p-1", alternating)]


def gl_kernels_vs_plain(rng, ptxas: dict) -> tuple:
    """K14a, K14b and K14c against their plain versions, bitwise, at phase
    11's shapes, every tree from 2^1 to 2^11 leaves and the edge words, with
    both times and the bound (the multiplies of a GL product as the SASS
    shows them). Returns (the ``kernels`` entries, one row per shape)."""
    imads = gl_imads_per_product()
    log(f"K14: one GL product is {imads['imad']} IMAD instructions in the SASS "
        f"({imads['kinds']}; {imads['imad_mov']} IMAD.MOV not counted)")
    rows, first = [], {}

    def row(name, shape, err, ms, plain_ms, products, nbytes, launches_per_call, kernels):
        b_ms, b_by = bound_of(products * imads["imad"], nbytes)
        rows.append(dict(name=name, shape=shape, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, launches_per_call=launches_per_call,
                         gl_products=products, imad_per_product=imads["imad"],
                         ptxas={k: ptxas.get(k) for k in kernels}))
        first.setdefault(name, rows[-1])
        log(f"{name} {shape}: max_abs_err {err}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by}), {launches_per_call} launches")
        if err:
            fail(f"{name} differs from its plain version at {shape}")

    c, log_n, blowup = GL_ENCODE_SHAPE
    n, log_m = 1 << log_n, log_n + blowup
    m = 1 << log_m
    evals = gl_random(rng, (c, n))
    cw = gdev.encode(evals, blowup)
    ms = cuda_ms(lambda: gdev.encode(evals, blowup), reps=5)
    want, plain_ms = wall_ms(lambda: gdev.encode_plain(evals, blowup))
    row("gl_encode", f"({c}, 2^{log_n}) at blowup 2^{blowup}", gl_err(cw, want), ms, plain_ms,
        c * log_m * (m // 2), 8 * c * (n + m), gdev.encode_launches(log_n, log_m),
        ["gl_gather_kernel", "gl_mobius_kernel", "gl_spread_kernel", "gl_dit_kernel",
         "gl_twiddles_kernel"])
    del evals, want
    torch.cuda.empty_cache()
    leaves = None
    for c, log_m in GL_LEAF_SHAPES:
        m = 1 << log_m
        cols = cw if cw.shape == (c, m) else gl_random(rng, (c, m))
        got = gdev.leaf_sponge(cols)
        ms = cuda_ms(lambda: gdev.leaf_sponge(cols), reps=5)
        want, plain_ms = wall_ms(lambda: gdev.leaf_sponge_plain(cols))
        row("gl_leaf_sponge", f"({c}, 2^{log_m})", gl_err(got, want), ms, plain_ms,
            GL_PRODUCTS_PER_PERM * -(-c // 4) * m, 8 * (c + 4) * m, 1, ["gl_leaf_sponge_kernel"])
        if leaves is None:
            leaves = got
        del cols, want
    del cw
    torch.cuda.empty_cache()
    m = 1 << GL_TREE_LOG
    if leaves.shape != (4, m):
        fail(f"K14c's leaves are {tuple(leaves.shape)}, not (4, 2^{GL_TREE_LOG})")
    levels = gdev.merkle_levels(leaves)
    ms = cuda_ms(lambda: gdev.merkle_levels(leaves), reps=5)
    want, plain_ms = wall_ms(lambda: gdev.merkle_levels_plain(leaves))
    row("gl_merkle_levels", f"all {GL_TREE_LOG} levels of (4, 2^{GL_TREE_LOG})",
        gl_levels_err(levels, want), ms, plain_ms, GL_PRODUCTS_PER_PERM * (m - 1),
        8 * 4 * (2 * m - 1), gdev.merkle_launches(m),
        ["gl_merkle_level_kernel", "gl_merkle_top_kernel"])
    del leaves, levels, want
    smalls = [gl_random(rng, (4, 1 << log_t)) for log_t in SMALL_TREES]
    for log_t, small, want in zip(SMALL_TREES, smalls, gl_levels_plain_batched(smalls)):
        if gl_levels_err(gdev.merkle_levels(small), want):
            fail(f"K14c differs from its plain version on the 2^{log_t} tree")
    log(f"K14c over every tree from 2^{SMALL_TREES[0]} to 2^{SMALL_TREES[-1]} leaves equals "
        "the plain version")
    c, log_e = GL_EDGE_SHAPE
    edges = gl_edge_words(c, 1 << log_e)
    sponges = gdev.leaf_sponge_plain(torch.cat([w for _, w in edges], 1)).chunk(len(edges), 1)
    trees = gl_levels_plain_batched([w[:4].contiguous() for _, w in edges])
    for (name, words), sponge, tree in zip(edges, sponges, trees):
        if gl_err(gdev.encode(words, 3), gdev.encode_plain(words, 3)):
            fail(f"K14a differs from its plain version on {name} words at ({c}, 2^{log_e})")
        if gl_err(gdev.leaf_sponge(words), sponge.contiguous()):
            fail(f"K14b differs from its plain version on {name} words at ({c}, 2^{log_e})")
        if gl_levels_err(gdev.merkle_levels(words[:4].contiguous()), tree):
            fail(f"K14c differs from its plain version on {name} words, (4, 2^{log_e}) tree")
        log(f"edge words {name}: K14a, K14b at ({c}, 2^{log_e}) and K14c over (4, 2^{log_e}) "
            "equal their plain versions")
    kernels = [
        dict(name=name, route="cuda", source="ceno_tpu_torch/csrc/gl_commit.cu",
             replaces=f"ceno_tpu/gl/device.py:{line}",
             **{k: first[name][k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                            "bound_by")},
             library_ms=None)
        for name, line in (("gl_encode", 54), ("gl_leaf_sponge", 162), ("gl_merkle_levels", 162))
    ]
    return kernels, rows


# -- phase 2, continued: the sumcheck kernels K6a, K6b and K5/K7 ------------------

def random_banks(rng, n_base: int, n_ext: int, n: int) -> tuple:
    """Seeded (n_base + 1, n) base and (4, n_ext + 1, n) ext banks on DEVICE,
    each with its ones sentinel last."""
    base = bb.to_device(rng.integers(0, bb.P, size=(n_base + 1, n), dtype=np.uint64), DEVICE)
    base[n_base] = bb.MONTY_ONE
    ext = bb.to_device(rng.integers(0, bb.P, size=(4, n_ext + 1, n), dtype=np.uint64), DEVICE)
    ext[:, n_ext] = 0
    ext[0, n_ext] = bb.MONTY_ONE
    return base, ext


def main_path_sumchecks(rng) -> list:
    """(what, base bank, ext bank, bidx, eidx, scalars, deg) at the shapes of
    TOWER_* and CLASS_MAINS. The tower level has the fused tower's own
    tables (``tower._level_static``: its live terms) and scalars gathered
    from seeded alpha powers, as the card builds them; a class main has
    seeded tables of its shape (the terms' real indices come from the chips'
    constraints, which this phase does not build)."""
    out = []
    n_prod, n_logup = TOWER_SPECS
    bidx, eidx, _, alpha_idx, deg = tower._level_static(n_prod, n_logup)
    n_claims, s_e = n_prod + 2 * n_logup, 2 * n_prod + 4 * n_logup
    pows = bb.to_device(rng.integers(0, bb.P, size=(4, n_claims), dtype=np.uint64), DEVICE)
    base, ext = random_banks(rng, 0, s_e + 1, 1 << TOWER_LOG_N)
    dev_idx = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(DEVICE)  # noqa: E731
    out.append((f"tower level {TOWER_LOG_N} of the 2^{TOWER_LOG_N + 1} group", base, ext,
                dev_idx(bidx), dev_idx(eidx), pows[:, torch.from_numpy(alpha_idx).to(DEVICE)], deg))
    for cm in CLASS_MAINS + [SHARD_CLASS_MAIN] + PRECOMPILE_CLASS_MAINS + AGG_CLASS_MAINS:
        base, ext = random_banks(rng, cm["base"], cm["ext"], 1 << cm["log_n"])
        t = cm["terms"]
        what = " ".join(filter(None, (cm.get("what"), f"2^{cm['log_n']} class main")))
        out.append((f"{what}, first round", base, ext,
                    dev_idx(rng.integers(0, cm["base"] + 1, size=(t, cm["db"]))),
                    dev_idx(rng.integers(0, cm["ext"] + 1, size=(t, cm["de"]))),
                    bb.to_device(rng.integers(1, bb.P, size=(4, t), dtype=np.uint64), DEVICE),
                    cm["deg"]))
    bidx, eidx, scal, deg = quark_terms(rng)
    base, ext = random_banks(rng, 7 * eccquark.DEG, 3, 1 << QUARK_LOG_N)
    out.append((f"EC-sum quark over 2^{QUARK_LOG_N + 1} rows, first round", base, ext,
                dev_idx(bidx), dev_idx(eidx), bb.to_device(scal.T, DEVICE), deg))
    return out


def quark_terms(rng) -> tuple:
    """The EC-sum quark's live term table (``eccquark._build_terms`` over
    seeded alpha powers and final sum, packed by ``compile_terms``): (bidx,
    eidx, canonical scalars (T, 4), deg). Its export terms have no base
    factor and index the base bank's ones column."""
    alphas = rng.integers(1, bb.P, size=(7 * eccquark.DEG, 4), dtype=np.uint64)
    final = rng.integers(1, bb.P, size=(2, 7), dtype=np.uint64)
    terms_ = eccquark._build_terms(alphas, final)
    bidx, eidx, scal, deg = sc_prover.compile_terms(terms_, 7 * eccquark.DEG, 3)
    live = np.nonzero(scal.any(axis=1))[0]
    return bidx[live], eidx[live], scal[live], deg


def round_evals_bound(base, ext, bidx, eidx, scalars, deg: int) -> tuple:
    """K6a's least time on these inputs: each column that a live term
    (nonzero scalar) names read once, the ones sentinels not at all (the
    kernel drops a factor that names one), and the (deg + 1, 4) sums
    written; per live term, node and element of the half-cube, one product
    for each factor past the first (base 1, ext EXT_PRODUCTS, a base product
    into an ext one 4; the sentinel factors need none), and one ext product
    per live term and node for its scalar. ``base`` may be None (no base
    factors)."""
    cb = base.shape[0] - 1 if base is not None else 0
    ce, n = ext.shape[1] - 1, ext.shape[2]
    live = scalars.ne(0).any(dim=0).cpu().numpy()
    bidx, eidx = bidx.cpu().numpy()[live], eidx.cpu().numpy()[live]
    nb, ne = (bidx != cb).sum(axis=1), (eidx != ce).sum(axis=1)
    per_elem = (np.maximum(nb - 1, 0) + EXT_PRODUCTS * np.maximum(ne - 1, 0)
                + 4 * ((nb > 0) & (ne > 0)))
    products = (deg + 1) * (n // 2 * int(per_elem.sum()) + EXT_PRODUCTS * int(live.sum()))
    read = len(np.setdiff1d(bidx, [cb])) + 4 * len(np.setdiff1d(eidx, [ce]))
    return bound_of(products * MULS_PER_PRODUCT, 4 * (n * read + 4 * (deg + 1)))


def fold_bound(cb: int, ce1: int, n: int) -> tuple:
    """K6b's least time: read cb base and ce1 ext columns, write the
    (4, cb + ce1, n / 2) bank; 4 products a base column element, EXT_PRODUCTS
    an ext one."""
    half = n // 2
    nbytes = 4 * (cb * n + 4 * ce1 * n) + 16 * (cb + ce1) * half
    return bound_of(half * (4 * cb + EXT_PRODUCTS * ce1) * MULS_PER_PRODUCT, nbytes)


def k6a_row(what: str, base, ext, bidx, eidx, scalars, deg: int, ptxas: dict) -> dict:
    """K6a against its plain version, bitwise, on these inputs, with the
    times of both, the bound, the plan it chose and its kernel's ptxas
    line."""
    plan = terms.eval_plan(ext, bidx, eidx)
    got = terms.round_evals(base, ext, bidx, eidx, scalars, deg=deg)
    ms = cuda_ms(lambda: terms.round_evals(base, ext, bidx, eidx, scalars, deg=deg,
                                           check_indices=False), reps=5)
    want, plain_ms = wall_ms(lambda: terms.round_evals_plain(base, ext, bidx, eidx, scalars,
                                                             deg=deg))
    err = max_abs_err(got, want)
    b_ms, b_by = round_evals_bound(base, ext, bidx, eidx, scalars, deg)
    kernel = f"round_evals_kernel<{deg}>"
    base_shape = tuple(base.shape) if base is not None else None
    row = dict(name="round_evals", shape=f"{what}: base {base_shape}, ext "
               f"{tuple(ext.shape)}, T {bidx.shape[0]}, DB {bidx.shape[1]}, DE {eidx.shape[1]}, "
               f"deg {deg}", max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, plan=dataclasses.asdict(plan),
               ptxas={kernel: ptxas.get(kernel, "not built in this process")})
    log(f"K6a {row['shape']}: max_abs_err {err}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), {b_ms / ms:.1%} of it; {plan}; {row['ptxas']}")
    if err:
        fail(f"K6a differs from its plain version on the {what}")
    return row


def duplex_perms(n_in: int, pos: int, sq_pos: int, absorbed: bool) -> int:
    """Permutations of one K5/K7 step that absorbs ``n_in`` words from
    (pos, sq_pos, absorbed) and samples one ext challenge."""
    perms = 0
    for _ in range(n_in):
        perms += pos == 8
        pos = 1 if pos == 8 else pos + 1
        absorbed = True
    for _ in range(4):
        if absorbed or sq_pos == 8:
            perms, sq_pos, absorbed = perms + 1, 0, False
        sq_pos += 1
    return perms


def duplex_check_cases() -> list:
    """(pos, sq_pos, absorbed, words, powers) of the K5/K7 checks: every pos
    (0-8), sq_pos 0, 4 or 8, absorbed or not, each with a round's 16 words
    and 5 powers and with one of DUPLEX_CHECKS in turn; then each of
    DUPLEX_STEPS from DUPLEX_FROM, the shapes that are timed."""
    states = [(pos, sq_pos, absorbed) for pos in range(9) for sq_pos in (0, 4, 8)
              for absorbed in (False, True)]
    return [(*st, *case) for k, st in enumerate(states)
            for case in ((16, 5), DUPLEX_CHECKS[k % len(DUPLEX_CHECKS)])] + \
        [(*DUPLEX_FROM, n_in, n_pows) for _, n_in, n_pows in DUPLEX_STEPS]


def duplex_vs_plain(rng, ptxas) -> list:
    """K5/K7 against its plain version, bitwise, from every pos (0-8), sq_pos
    0, 4 or 8, absorbed or not: each absorbing a round's 16 words and
    sampling with 5 powers, and absorbing and sampling one of DUPLEX_CHECKS
    (up to 96 words, several permutations in one launch; up to 70 powers,
    past the warp's 32 lanes); and at each of DUPLEX_STEPS from DUPLEX_FROM.
    Then at each of DUPLEX_STEPS, timed without the host's pacing
    (:func:`graph_ms`), with the plain version's time and the bound. Returns
    one row per step."""
    def fresh(n, k):
        return [bb.to_device(rng.integers(0, bb.P, size=16, dtype=np.uint64), DEVICE),
                torch.zeros(4, dtype=bb.DTYPE, device=DEVICE),
                torch.zeros((4, k + 1), dtype=bb.DTYPE, device=DEVICE)], \
            bb.to_device(rng.integers(0, bb.P, size=n, dtype=np.uint64), DEVICE)
    errs = {}
    for pos, sq_pos, absorbed, n_in, n_pows in duplex_check_cases():
        got, words = fresh(n_in, n_pows)
        want = [t.clone() for t in got]
        absorb = words if n_in else None
        fused.duplex(got[0], absorb, got[1], got[2][:, :n_pows] if n_pows else None,
                     pos=pos, sq_pos=sq_pos, absorbed=absorbed)
        fused.duplex_plain(want[0], absorb, want[1], want[2][:, :n_pows] if n_pows else None,
                           pos, sq_pos, absorbed)
        err = errs[pos, sq_pos, absorbed, n_in, n_pows] = max(
            max_abs_err(a, b) for a, b in zip(got, want))
        if err:
            fail(f"K5/K7 differs from its plain version from pos {pos}, sq_pos {sq_pos}, "
                 f"absorbed {absorbed}, {n_in} words, {n_pows} powers")
    log(f"K5/K7 from every pos (0-8), sq_pos 0/4/8, absorbed or not, with 16 words and 5 "
        f"powers and with {DUPLEX_CHECKS} (words, powers) in turn, and at each of DUPLEX_STEPS, "
        f"equals its plain version")
    rows = []
    pos, sq_pos, absorbed = DUPLEX_FROM
    for what, n_in, n_pows in DUPLEX_STEPS:
        (st, out, pows), words = fresh(n_in, n_pows)
        absorb, pw = (words if n_in else None), (pows[:, :n_pows] if n_pows else None)
        ms = graph_ms(lambda: fused.duplex(st, absorb, out, pw, pos=pos, sq_pos=sq_pos,
                                           absorbed=absorbed))
        _, plain_ms = wall_ms(lambda: fused.duplex_plain(st, absorb, out, pw, pos, sq_pos,
                                                         absorbed))
        perms = duplex_perms(n_in, pos, sq_pos, absorbed)
        # the state in and out, the words, the challenge and the powers
        b_ms, b_by = bound(perms, 4 * (2 * 16 + n_in + 4 + 4 * n_pows))
        rows.append(dict(name="duplex", shape=f"{what}: absorb {n_in} words from pos {pos}, "
                         f"sample one ext ({perms} permutations), {n_pows} powers",
                         max_abs_err=errs[pos, sq_pos, absorbed, n_in, n_pows], ms=ms,
                         plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, ptxas=ptxas))
        log(f"K5/K7 {rows[-1]['shape']}: kernel {ms:.4f} ms (CUDA graph of 200 launches), "
            f"plain {plain_ms:.2f} ms, bound {b_ms:.7f} ms ({b_by}; latency binds), {ptxas}")
    return rows


def k6b_row(what: str, base, ext, r, ptxas) -> dict:
    """K6b against its plain version, bitwise, with the times of both and the
    bound: mixed mode (the base bank folded into the ext one) when ``base``
    is given, else ext mode."""
    n, ce1 = ext.shape[2], ext.shape[1]
    if base is not None:
        mode, fold, plain, args = "mixed", terms.fold_banks, terms.fold_banks_plain, (base, ext, r)
        cols = (base.shape[0] - 1, ce1)
    else:
        mode, fold, plain, args = "ext", terms.fold_ext_bank, terms.fold_ext_bank_plain, (ext, r)
        cols = (0, ce1)
    got = fold(*args)
    ms = cuda_ms(lambda: fold(*args), reps=5)
    want, plain_ms = wall_ms(lambda: plain(*args))
    err = max_abs_err(got, want)
    b_ms, b_by = fold_bound(*cols, n)
    row = dict(name="fold", shape=f"{what}, {mode} mode: {cols[0]} base and {cols[1]} ext "
               f"columns of 2^{n.bit_length() - 1}", max_abs_err=err, ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, ptxas=ptxas)
    log(f"K6b {row['shape']}: max_abs_err {err}, kernel {ms:.3f} ms, plain {plain_ms:.1f} ms, "
        f"bound {b_ms:.3f} ms ({b_by})")
    if err:
        fail(f"K6b ({mode} mode) differs from its plain version on the {what}")
    return row


def whir_round_rows(rng, ptxas: dict) -> list:
    """K6a and K6b (ext mode) against their plain versions, bitwise, at the
    first round of the 2^20 fibonacci's WHIR witness opening (phase 13
    checks that its prove runs it), as ``pcs/whir._rounds`` calls them: the
    seeded bank [g, w, ones] (4, 3, 2^WHIR_LOG_N), one term g*w, degree 2,
    no base bank; timed, with the bound."""
    _, ext = random_banks(rng, 0, 2, 1 << WHIR_LOG_N)
    what = f"WHIR's first round, the bank [g, w, ones] of 2^{WHIR_LOG_N}"
    eidx = torch.tensor([[0, 1]], dtype=torch.int32, device=DEVICE)
    bidx = torch.zeros((1, 0), dtype=torch.int32, device=DEVICE)
    rows = [k6a_row(what, None, ext, bidx, eidx, ext4.ones((1,), DEVICE), 2, ptxas)]
    r = bb.to_device(rng.integers(0, bb.P, size=4, dtype=np.uint64), DEVICE)
    rows.append(k6b_row(what, None, ext, r, ptxas.get("fold_kernel", "not built in this process")))
    return rows


def sumcheck_kernels_vs_plain(rng, ptxas: dict) -> tuple:
    """K6a, K6b (mixed and ext mode) and K5/K7 against their plain versions,
    bitwise, at the main path's largest shapes, with the times of both and
    the bound. Returns (the ``kernels`` entries, one row per shape)."""
    rows, results = [], {}
    regs = lambda k: ptxas.get(k, "not built in this process")  # noqa: E731
    for what, base, ext, bidx, eidx, scalars, deg in main_path_sumchecks(rng):
        rows.append(k6a_row(what, base, ext, bidx, eidx, scalars, deg, ptxas))
        results.setdefault("round_evals", rows[-1])
        r = bb.to_device(rng.integers(0, bb.P, size=4, dtype=np.uint64), DEVICE)
        rows.append(k6b_row(what, base, ext, r, regs("fold_kernel")))
        rows.append(k6b_row(what, None, ext, r, regs("fold_kernel")))
        if what.startswith("tower"):
            results.setdefault("fold", rows[-1])
        del base, ext
    rows += whir_round_rows(rng, ptxas)
    rows += duplex_vs_plain(rng, regs("duplex_kernel"))
    results["duplex"] = rows[-len(DUPLEX_STEPS)]
    lines = {"round_evals": "ceno_tpu/sumcheck/terms.py:108",
             "fold": "ceno_tpu/sumcheck/terms.py:138", "duplex": "ceno_tpu/sumcheck/fused.py:30"}
    kernels = [dict(name=name, route="cuda", source="ceno_tpu_torch/csrc/sumcheck.cu",
                    replaces=line, **{k: v for k, v in results[name].items()
                                      if k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by")}, library_ms=None)
               for name, line in lines.items()]
    return kernels, rows


def mle_values(arr: np.ndarray, z: np.ndarray) -> np.ndarray:
    """True values f_j(z) of every row of ``arr`` (C, h) canonical: (C, 4)."""
    f = torch.from_numpy(arr.astype(np.int64)).to(DEVICE)
    eq = bb.from_monty(ops.build_eq(bb.to_device(z, DEVICE))).long()  # (4, h)
    vals = torch.stack([(f * eq[i]).remainder(bb.P).sum(dim=1) % bb.P for i in range(4)], 1)
    return vals.cpu().numpy().astype(np.uint64)


def run_slice(name, classes, rng, params) -> None:
    layout = jg.plan_layout(classes)
    arrs = [(h, rng.integers(0, bb.P, size=(c, h), dtype=np.uint64)) for h, c in classes]
    mat = jg.stack_matrix(layout, arrs)
    log(f"{name}: stacked ({layout.n_mat_cols}, 2^{layout.n_r.bit_length() - 1}), "
        f"blowup {params.blowup}, {params.n_queries} queries, {params.pow_bits} PoW bits")
    t = time.time()
    committed = bf.commit(mat, params, device=DEVICE)
    log(f"{name}: commit {time.time() - t:.3f}s, codeword {tuple(committed.codeword.shape)}")
    claims = []
    for h, arr in arrs:
        z = rng.integers(0, bb.P, size=(h.bit_length() - 1, 4), dtype=np.uint64)
        for v in mle_values(arr, z):
            claims.append(jg.JaggedClaim(len(claims), z, v))
    t = time.time()
    proof = jg.open_jagged(committed, layout, claims, Transcript(b"chip-smoke"), params)
    log(f"{name}: open {time.time() - t:.3f}s ({len(claims)} claims, "
        f"{len(proof.opening.fold_roots)} fold trees, nonce {proof.opening.pow_nonce})")
    t = time.time()
    jg.verify_jagged(committed.root, layout, claims, proof, Transcript(b"chip-smoke"), params)
    log(f"{name}: verify accepted in {time.time() - t:.3f}s")
    i, bad = len(claims) // 2, list(claims)
    bad[i] = jg.JaggedClaim(claims[i].slice_idx, claims[i].z,
                            (claims[i].value + np.uint64(1)) % np.uint64(bb.P))
    try:
        jg.verify_jagged(committed.root, layout, bad, proof, Transcript(b"chip-smoke"), params)
    except (jg.JaggedError, SumcheckError, bf.PCSError) as e:
        log(f"{name}: tampered claim rejected ({type(e).__name__})")
    else:
        fail(f"{name}: a tampered claim was accepted")


# -- phase 4: the GKR slice ------------------------------------------------------

LABEL = b"ceno-tpu/zkvm/v8"  # the zkVM transcript label (ceno_tpu/zkvm/scheme.py:53)
GKR_ITERS = 174760           # bench.py's fibonacci_vm(174760): 1,048,571 steps
GOLDEN_ITERS = 100           # the size of the reference's committed digests
GKR_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gkr_fibonacci.json")


def sync() -> None:
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def fib_rows(n: int) -> dict:
    """Rows of each opcode chip in fibonacci_vm(n), counted from FIBONACCI:
    each of the n iterations runs beq, add, three addi (two mv and the
    decrement) and j (jal); outside the loop run one more beq, one mv, the
    ecall (halt) and four li of two words each, lui + addi where the value
    has upper bits (n >= 2048 for li a0, n) and else addi + an addi nop."""
    lui = int(n >= 2048)
    rows = dict.fromkeys(("add", "sub", "addi", "lui", "beq", "bne", "jal", "slli",
                          "lw", "sw", "halt"), 0)
    rows.update(add=n, addi=3 * n + 9 - lui, lui=lui, beq=n + 1, jal=n, halt=1)
    return rows


def public_values(vm) -> np.ndarray:
    """The public values as zkvm/e2e.py's public_values_from_vm sets them, for
    the slots the opcode chips read: of these chips only halt reads
    instances (end pc, end cycle, exit code). The slots of chips not ported
    yet (shard, heap, stack and info lengths, the public-io digest) stay 0."""
    pv = np.zeros(layout.N_PUBLIC_VALUES, np.uint64)
    pv[layout.PV_INIT_PC] = vm.entry
    pv[layout.PV_INIT_CYCLE] = CYCLE_START
    pv[layout.PV_END_PC] = vm.pc
    pv[layout.PV_END_CYCLE] = vm.cycle
    pv[layout.PV_EXIT_CODE_LO] = vm.exit_code & 0xFFFF
    pv[layout.PV_EXIT_CODE_HI] = (vm.exit_code >> 16) & 0xFFFF
    return pv


def gkr_transcript(pv: np.ndarray) -> tuple:
    """The transcript and the two RLC challenges, as zkvm/scheme.prove starts
    them. The reference absorbs the verifying key's digest before the public
    values, and the witness commitment's root and every chip's instance
    count before the challenges; the key (with the table chips) and the
    witness commit are not part of this slice, so neither is absorbed."""
    t = Transcript(LABEL)
    t.append(pv)
    return t, np.array([t.sample_ext(), t.sample_ext()], np.uint64)


def gkr_prove(assigned: list, pv: np.ndarray) -> dict:
    """Stages 3-5 of zkvm/scheme.prove over the opcode chips that have rows:
    records per chip in registry order, one tower per tower size N_t
    (ascending; chips in registry order), then one main zerocheck per height
    class (ascending). Returns the proofs, the groups, the chips' tower
    inputs and contexts, and each stage's seconds."""
    t, challenges = gkr_transcript(pv)
    active = [a for a in assigned if a.num_instances > 0]
    inputs, seconds = {}, {"records": {}, "towers": {}, "class_main": {}}
    for a in active:
        if a.compiled.n_fixed:
            fail(f"{a.name}: fixed columns come with the key, which this slice does not build")
        n = a.n_rows
        structural = (np.stack([gkr_chip.structural_table(s, n, pv) for s in a.compiled.structural])
                      if a.compiled.structural else np.zeros((0, n), np.uint64))
        t0 = time.time()
        with spans.span(f"records/{a.name}"):
            inputs[a.name] = gkr_chip.build_tower_inputs(
                a.compiled, a.wit, np.zeros((0, n), np.uint64), structural, pv,
                a.num_instances, challenges, device=DEVICE)
            sync()
        seconds["records"][a.name] = time.time() - t0
    groups, towers, ctxs = {}, {}, {}
    for a in active:
        groups.setdefault(inputs[a.name].n_tower, []).append(a.name)
    for n_t in sorted(groups):
        t0 = time.time()
        towers[n_t], gctxs = gkr_chip.prove_group_towers([inputs[nm] for nm in groups[n_t]], t)
        seconds["towers"][f"2^{n_t.bit_length() - 1}"] = time.time() - t0
        ctxs.update(zip(groups[n_t], gctxs))
    classes, mains, openings = {}, {}, {}
    for a in active:
        classes.setdefault(a.n_rows, []).append(a.name)
    for h in sorted(classes):
        t0 = time.time()
        with spans.span(f"class-main/2^{h.bit_length() - 1}"):
            mains[h], openings[h] = gkr_chip.prove_class_main(
                [ctxs[nm] for nm in classes[h]], pv, challenges, t)
        seconds["class_main"][f"2^{h.bit_length() - 1}"] = time.time() - t0
    return dict(challenges=challenges, inputs=inputs, groups=groups, towers=towers, ctxs=ctxs,
                classes=classes, mains=mains, openings=openings, transcript=t, seconds=seconds)


def gkr_verify(assigned: list, pv: np.ndarray, run: dict) -> tuple:
    """The port's verifiers over ``run``'s proofs on a fresh transcript, in
    the prover's order. Returns (transcript, openings per class); raises
    ChipError, TowerError or SumcheckError on a rejected proof."""
    t, challenges = gkr_transcript(pv)
    by_name = {a.name: a for a in assigned}
    vctxs = {}
    for n_t in sorted(run["groups"]):
        names = run["groups"][n_t]
        entries = [(by_name[nm].compiled, by_name[nm].num_instances,
                    by_name[nm].n_rows.bit_length() - 1) for nm in names]
        out = gkr_chip.verify_group_towers(entries, run["towers"][n_t], pv, challenges, t)
        vctxs.update(zip(names, (o[0] for o in out)))
    openings = {}
    for h in sorted(run["classes"]):
        openings[h] = gkr_chip.verify_class_main(
            [vctxs[nm] for nm in run["classes"][h]], run["mains"][h], pv, challenges, t)
    return t, openings


def gkr_digests(run: dict) -> dict:
    """SHA-256 digests of each group's TowerProof, each class's
    ClassMainProof and the final transcript state (``interop.digest`` of
    their plain forms)."""
    return {
        "towers": {f"2^{n_t.bit_length() - 1}": interop.digest(dataclasses.asdict(p))
                   for n_t, p in sorted(run["towers"].items())},
        "class_main": {f"2^{h.bit_length() - 1}": interop.digest(dataclasses.asdict(p))
                       for h, p in sorted(run["mains"].items())},
        "transcript": interop.digest(list(run["transcript"].export_state())),
    }


def on_main_thread(what: str) -> None:
    """Device work runs on the main thread only (the sharded prover's witgen
    thread is host numpy)."""
    if threading.current_thread() is not threading.main_thread():
        fail(f"{what} made on the thread {threading.current_thread().name}, not the main thread")


@contextlib.contextmanager
def device_audit():
    """Record the device of every tower layer and every sumcheck bank made
    inside the block (the tower's layer builders and the banks' constructor,
    wrapped for its length); each must be made on the main thread."""
    seen = {"layers": [], "banks": []}
    originals = (tower.product_layers, tower.logup_layers, terms.make_banks)

    def wrap(fn, key, tensors):
        def inner(*args, **kwargs):
            on_main_thread(key)
            out = fn(*args, **kwargs)
            seen[key] += [x.device.type for x in tensors(out)]
            return out
        return inner

    tower.product_layers = wrap(originals[0], "layers", lambda out: out)
    tower.logup_layers = wrap(originals[1], "layers", lambda out: out[0] + out[1])
    terms.make_banks = wrap(originals[2], "banks", lambda out: out)
    try:
        yield seen
    finally:
        tower.product_layers, tower.logup_layers, terms.make_banks = originals


def check_devices(run: dict, seen: dict) -> dict:
    """Every record, tower layer and sumcheck bank of ``run`` lies on DEVICE's
    kind; returns how many of each were checked."""
    want = torch.device(DEVICE).type
    records = [x.device.type for ti in run["inputs"].values()
               for x in ti.prods + [m for pq in ti.lps for m in pq]]
    counts = {"records": len(records), "layers": len(seen["layers"]), "banks": len(seen["banks"])}
    for what, devices in (("records", records), ("layers", seen["layers"]), ("banks", seen["banks"])):
        if not devices or set(devices) != {want}:
            fail(f"GKR {what} on {sorted(set(devices))}, not on {want}")
    return counts


def tamper_add(assigned: list) -> list:
    """``assigned`` with one output limb of the add chip changed (rd_lo of
    its first row): a cell its constraints and its write record bind."""
    out = []
    for a in assigned:
        if a.name == "add":
            wit = a.wit.copy()
            i = a.cb.wit_names.index("rd_lo")
            wit[i, 0] = (wit[i, 0] + np.uint64(1)) % np.uint64(bb.P)
            a = dataclasses.replace(a, wit=wit)
        out.append(a)
    return out


def emulate_and_assign(n: int) -> tuple:
    """fibonacci_vm(n) on the native core (never the Python interpreter),
    checked, then the opcode chips' witness, checked row by row against
    :func:`fib_rows`. Returns (vm, assigned, seconds)."""
    seconds = {}
    t0 = time.time()
    vm = programs.fibonacci_vm(n)
    view = native.run_trace_native(vm)
    seconds["emulate"] = time.time() - t0
    want = fib_rows(n)
    if view.n != sum(want.values()) or not vm.halted:
        fail(f"fibonacci_vm({n}) ran {view.n} steps (halted {vm.halted}), "
             f"FIBONACCI gives {sum(want.values())}")
    if vm.regs[10] != programs.fib_expected(n):
        fail(f"fibonacci_vm({n}): a0 = {vm.regs[10]}, fib_expected gives {programs.fib_expected(n)}")
    t0 = time.time()
    assigned = witgen.assign_opcode_chips(view, build_opcode_chips())
    seconds["witgen"] = time.time() - t0
    rows = {a.name: a.num_instances for a in assigned}
    if rows != want:
        fail(f"fibonacci_vm({n}): rows per chip {rows}, FIBONACCI gives {want}")
    return vm, assigned, seconds


def run_gkr(n: int) -> dict:
    """Phase 4 at fibonacci_vm(n): emulate, assign, prove (records, grouped
    towers, class mains), verify, then prove and verify again with one add
    output limb changed, which must be rejected. Returns the ``gkr`` line."""
    vm, assigned, seconds = emulate_and_assign(n)
    log(f"GKR: fibonacci_vm({n}) ran {sum(a.num_instances for a in assigned)} steps in "
        f"{seconds['emulate']:.2f}s on the native core, witness in {seconds['witgen']:.2f}s")
    pv = public_values(vm)
    t0 = time.time()
    spans.enable()
    with device_audit() as seen, sumcheck_calls() as calls:
        run = gkr_prove(assigned, pv)
        sync()
    seconds["prove"] = time.time() - t0
    span_report = spans.report(min_seconds=0.001)
    spans.disable()
    checked = check_devices(run, seen)
    log(f"GKR: proved in {seconds['prove']:.2f}s; on {DEVICE}: {checked}")
    t0 = time.time()
    vt, vopen = gkr_verify(assigned, pv, run)
    seconds["verify"] = time.time() - t0
    if not np.array_equal(vt.export_state()[0], run["transcript"].export_state()[0]):
        fail("GKR: the verifier's transcript ended elsewhere than the prover's")
    for h, ops_ in run["openings"].items():
        if any(not np.array_equal(a.point, b.point) for a, b in zip(ops_, vopen[h])):
            fail(f"GKR: class 2^{h.bit_length() - 1} opens at another point than it proved")
    log(f"GKR: verified in {seconds['verify']:.2f}s")
    t0 = time.time()
    bad = tamper_add(assigned)
    try:
        gkr_verify(bad, pv, gkr_prove(bad, pv))
    except (ChipError, TowerError, SumcheckError) as e:
        log(f"GKR: a changed add output limb rejected ({type(e).__name__}: {e})")
    else:
        fail("GKR: a proof over a changed add output limb was accepted")
    seconds["tamper_prove_verify"] = time.time() - t0
    chips = {a.name: {"rows": a.num_instances, "height": a.n_rows} for a in assigned if a.num_instances}
    groups = {}
    for n_t, names in sorted(run["groups"].items()):
        levels = n_t.bit_length() - 2
        groups[f"2^{n_t.bit_length() - 1}"] = {"chips": names, "levels": levels,
                                                "rounds": levels * (levels + 1) // 2}
    classes = {f"2^{h.bit_length() - 1}": {"chips": names, "rounds": h.bit_length() - 1}
               for h, names in sorted(run["classes"].items())}
    return {"program": f"fibonacci_vm({n})", "steps": sum(a.num_instances for a in assigned),
            "device": DEVICE, "seconds": seconds, "stage_seconds": run["seconds"],
            "chips": chips, "tower_groups": groups, "classes": classes,
            "checked_on_device": checked, "sumcheck_shapes": first_rounds(calls),
            "digests": gkr_digests(run), "span_report": span_report}


@contextlib.contextmanager
def sumcheck_calls(keep: dict | None = None):
    """Record the first round of every sumcheck made inside the block (the
    K6a calls with a base bank): its banks' shapes, term table shapes,
    degree and scalars. ``keep`` maps names to first-round shapes as
    :func:`main_shape` gives them; the first call of each shape replaces
    its entry with that call's inputs (base bank, ext bank, bidx, eidx,
    scalars, deg)."""
    calls, original = [], terms.round_evals
    want = dict(keep or {})

    def inner(base_bank, ext_bank, bidx, eidx, scalars, **kwargs):
        if base_bank is not None:
            calls.append((tuple(base_bank.shape), tuple(ext_bank.shape), tuple(bidx.shape),
                          tuple(eidx.shape), kwargs["deg"], scalars))
            for name, w in want.items():
                if keep[name] is w and (w["base"], w["ext"], w["terms"], w["db"], w["de"],
                                        w["deg"]) == (list(base_bank.shape),
                                                      list(ext_bank.shape), *bidx.shape,
                                                      eidx.shape[1], kwargs["deg"]):
                    keep[name] = (base_bank, ext_bank, bidx, eidx, scalars, kwargs["deg"])
        return original(base_bank, ext_bank, bidx, eidx, scalars, **kwargs)
    terms.round_evals = inner
    try:
        yield calls
    finally:
        terms.round_evals = original


@contextlib.contextmanager
def duplex_calls():
    """Count the K5/K7 steps made inside the block by their (words absorbed,
    powers): a dict the block fills."""
    counts, original = {}, fused.duplex

    def inner(state, absorb, out, pows=None, **kwargs):
        key = (0 if absorb is None else absorb.shape[0], 0 if pows is None else pows.shape[1])
        counts[key] = counts.get(key, 0) + 1
        return original(state, absorb, out, pows, **kwargs)
    fused.duplex = inner
    try:
        yield counts
    finally:
        fused.duplex = original


def check_duplex_steps(counts: dict) -> None:
    """Each of phase 2's K5/K7 steps (DUPLEX_STEPS) is among the steps the
    prove made (:func:`duplex_calls`)."""
    for what, n_in, n_pows in DUPLEX_STEPS:
        if not counts.get((n_in, n_pows)):
            fail(f"phase 2's K5/K7 step {what} ({n_in} words, {n_pows} powers) is not among "
                 f"the prove's: {sorted(counts)}")
    log(f"phase 2's {len(DUPLEX_STEPS)} K5/K7 steps are among the prove's "
        f"{sum(counts.values())} steps ({len(counts)} kinds; the most words {max(counts)[0]}, "
        f"the most powers {max(k[1] for k in counts)})")


def first_rounds(calls) -> list:
    """The distinct first-round shapes of :func:`sumcheck_calls`, with the
    count of live terms (nonzero scalars), as JSON."""
    out = []
    for base, ext, b, e, deg, scalars in calls:
        sig = {"base": list(base), "ext": list(ext), "terms": b[0], "db": b[1], "de": e[1],
               "deg": deg, "live": int(scalars.ne(0).any(dim=0).sum())}
        if sig not in out:
            out.append(sig)
    return out


def main_shape(cm: dict) -> dict:
    """A class main's first round (CLASS_MAINS' form) as :func:`first_rounds`
    gives it: its banks with their sentinel columns, every term live."""
    n = 1 << cm["log_n"]
    return {"base": [cm["base"] + 1, n], "ext": [4, cm["ext"] + 1, n], "terms": cm["terms"],
            "db": cm["db"], "de": cm["de"], "deg": cm["deg"], "live": cm["terms"]}


def shard_shapes() -> list:
    """Phase 2's sumcheck shapes of the sharded proof only (SHARD_CLASS_MAIN,
    the quark), as :func:`first_rounds` gives them."""
    t = len(eccquark._term_schedule()[0])  # 455, every one live
    return [main_shape(SHARD_CLASS_MAIN),
            {"base": [7 * eccquark.DEG + 1, 1 << QUARK_LOG_N], "ext": [4, 4, 1 << QUARK_LOG_N],
             "terms": t, "db": 2, "de": 1, "deg": 3, "live": t}]


def check_shapes_ran(want: list, shapes: list, what: str) -> None:
    """Each of phase 2's sumcheck shapes ``want`` is among the first rounds
    ``shapes`` that ``what`` ran."""
    for w in want:
        if w not in shapes:
            fail(f"phase 2's sumcheck shape {w} is not among the first rounds of the {what}: "
                 f"{shapes}")
    log(f"phase 2's {len(want)} sumcheck shapes are among the {len(shapes)} distinct first "
        f"rounds of the {what}")


def check_main_path_shapes(shapes: list) -> None:
    """Phase 2's sumcheck shapes (TOWER_*, CLASS_MAINS) are among the first
    rounds the GKR stages ran."""
    n_prod, n_logup = TOWER_SPECS
    n, s_e = 1 << TOWER_LOG_N, 2 * n_prod + 4 * n_logup
    want = [{"base": [1, n], "ext": [4, s_e + 2, n],
             "terms": tower._level_static(n_prod, n_logup)[0].shape[0], "db": 0, "de": 3,
             "deg": 3, "live": n_prod + 3 * n_logup}]
    check_shapes_ran(want + [main_shape(cm) for cm in CLASS_MAINS], shapes, "GKR stages")


SWITCHES = ("CENO_TPU_TORCH_FUSED", "CENO_TPU_TORCH_FUSED_TOWER")


@contextlib.contextmanager
def per_round_paths():
    """The per-round sumchecks and the per-level towers (both switches "0")
    for the block's length."""
    saved = {k: os.environ.get(k) for k in SWITCHES}
    os.environ.update(dict.fromkeys(SWITCHES, "0"))
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def gkr_per_round_check(n: int, fused_digests: dict) -> dict:
    """Phase 4 once more on the per-round paths: the proof of fibonacci_vm(n)
    must have the fused run's digests, and the golden check must pass.
    Returns its seconds."""
    with per_round_paths():
        vm, assigned, _ = emulate_and_assign(n)
        t0 = time.time()
        got = gkr_digests(gkr_prove(assigned, public_values(vm)))
        sync()
        seconds = {"prove": time.time() - t0}
        t0 = time.time()
        gkr_golden_check()
        seconds["golden_check"] = time.time() - t0
    if got != fused_digests:
        fail(f"GKR at fibonacci_vm({n}): the per-round paths' digests {got} differ from the "
             f"fused paths' {fused_digests}")
    log(f"GKR: the per-round sumchecks and per-level towers give the fused paths' digests at "
        f"fibonacci_vm({n}) (prove {seconds['prove']:.2f}s) and the golden ones")
    return seconds


def gkr_golden_check(n: int = GOLDEN_ITERS) -> dict:
    """The port's digests at fibonacci_vm(n) against the reference's,
    committed in GKR_GOLDEN."""
    with open(GKR_GOLDEN) as f:
        want = json.load(f)
    vm, assigned, _ = emulate_and_assign(n)
    got = gkr_digests(gkr_prove(assigned, public_values(vm)))
    if want["program"] != f"fibonacci_vm({n})" or got != want["digests"]:
        fail(f"GKR digests at fibonacci_vm({n}) differ from {os.path.relpath(GKR_GOLDEN, ROOT)}: "
             f"{got} against {want}")
    log(f"GKR: fibonacci_vm({n}) digests equal the reference's ({len(got['towers'])} towers, "
        f"{len(got['class_main'])} class mains, transcript)")
    return got


# -- phase 5: keygen -> prove -> verify, end to end --------------------------------

E2E_ITERS = GKR_ITERS                     # bench.py's program: fibonacci_vm(174760)
E2E_CFG = {"shl_x_bits": 10}              # bench.py's ZKVMConfig
FIXED_KEY = "8cc386001f1b61172778f21844b7e769"  # the content key GOLDEN is named by
# the setup of the reference's committed proof digests (tools/torch_e2e_golden.py)
E2E_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "e2e_fibonacci.json")
E2E_GOLDEN_ITERS = 100
E2E_GOLDEN_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
# the reference's proof size at bench.py's workload: BENCH_r05.json's proof_kib,
# len(proof_to_bytes) / 1024 (bench.py:154-155), from an older run
REFERENCE_PROOF_KIB = 816.4
PROTOCOL_ERRORS = (scheme.ZKVMError, ChipError, TowerError, SumcheckError, bf.PCSError,
                   jg.JaggedError)


def content_key(mat: np.ndarray, blowup_log: int) -> str:
    """The content key of a fixed matrix, the name of its cached commitment
    (``pcs/commitcache._key``, the reference's ceno_tpu/pcs/commitcache.py:34)."""
    return commitcache._key(mat, bf.BasefoldParams(blowup_log=blowup_log))


def fixed_commit_check(pk) -> None:
    """The key's fixed commitment, made by the port from its own tables, must
    be the golden one: the matrix's content key names GOLDEN, and the
    codeword (the NTT encode), the leaves, every level and the root equal
    the file's."""
    (committed,) = pk.fixed_committed.values()
    got = interop.committed_to_numpy(committed)
    key = content_key(got["cols"], pk.params.blowup_log)
    if key != FIXED_KEY:
        fail(f"the key's stacked fixed matrix has content key {key}, not {FIXED_KEY}")
    with np.load(GOLDEN) as z:
        if not np.array_equal(got["codeword"], z["cw"].astype(np.uint64)):
            fail("the key's fixed codeword differs from the golden cw")
        if not np.array_equal(got["leaves"], z["leaves"].astype(np.uint64)):
            fail("the key's fixed leaves differ from the golden leaves")
        n_levels = int(z["n_levels"])
        if len(got["levels"]) != n_levels:
            fail(f"the key's fixed tree has {len(got['levels'])} levels, the golden {n_levels}")
        for i, lv in enumerate(got["levels"]):
            if not np.array_equal(lv, z[f"level{i}"].astype(np.uint64)):
                fail(f"the key's fixed tree: level {i} differs from the golden level{i}")
    log(f"e2e: the key's fixed matrix {got['cols'].shape} has content key {key}; its codeword "
        f"{got['codeword'].shape}, leaves, {n_levels} levels and root "
        f"{committed.root.tolist()} equal the golden commitment")


def prove_trees(pk, proof) -> list:
    """log2 leaf counts of every Merkle tree one prove builds: the witness
    commit, then the fold trees of the witness and the fixed openings."""
    (n_w,) = proof.witness_roots
    (n_f,) = pk.fixed_committed
    b = pk.params.blowup_log
    n_w, n_f = n_w.bit_length() - 1, n_f.bit_length() - 1
    return [n_w + b, *opening_trees(n_w, pk.params), *opening_trees(n_f, pk.params)]


@contextlib.contextmanager
def prove_audit():
    """:func:`device_audit` over a whole prove, with the witness commits
    (``basefold.commit``: evals and codeword) and the records
    (``build_tower_inputs``) recorded as well, each on the main thread."""
    originals = (bf.commit, gkr_chip.build_tower_inputs)

    def commit(*args, **kwargs):
        on_main_thread("commits")
        out = originals[0](*args, **kwargs)
        seen["commits"] += [out.cols.device.type, out.codeword.device.type]
        return out

    def tower_inputs(*args, **kwargs):
        on_main_thread("records")
        out = originals[1](*args, **kwargs)
        seen["records"] += [x.device.type for x in out.prods + [m for pq in out.lps for m in pq]]
        return out

    with device_audit() as seen:
        seen.update(commits=[], records=[])
        bf.commit, gkr_chip.build_tower_inputs = commit, tower_inputs
        try:
            yield seen
        finally:
            bf.commit, gkr_chip.build_tower_inputs = originals


def on_device(seen: dict) -> dict:
    """Every entry of ``seen`` lies on DEVICE's kind; returns the counts."""
    want = torch.device(DEVICE).type
    for what, devices in seen.items():
        if not devices or set(devices) != {want}:
            fail(f"prove: {what} on {sorted(set(devices))}, not on {want}")
    return {what: len(devices) for what, devices in seen.items()}


def bump(a: np.ndarray, index) -> None:
    a[index] = (int(a[index]) + 1) % bb.P


def tampered(proof) -> list:
    """(what, proof) pairs, each changed in one place the verifier must
    reject: a public value (the exit code), one witness eval of the largest
    class's main zerocheck, one codeword entry of the witness opening's
    first query."""
    out = []
    bad = copy.deepcopy(proof)
    bump(bad.public_values, layout.PV_EXIT_CODE_LO)
    out.append(("public value", bad))
    bad = copy.deepcopy(proof)
    bump(bad.class_main[max(bad.class_main)].wit_evals[0], (0, 0))
    out.append(("class-main eval", bad))
    bad = copy.deepcopy(proof)
    (opening,) = bad.witness_openings.values()
    bump(opening.opening.queries[0].base_rows, (0, 0))
    out.append(("opening row", bad))
    return out


def stage_seconds(tree: dict) -> dict:
    """The prove's top-level spans summed by stage."""
    stages = {"witgen": "witgen", "commit": "commit/", "records": "records/",
              "towers": "towers/", "class_main": "class-main/", "openings": "open/"}
    return {stage: sum(node["total"] for name, node in tree.items() if name.startswith(prefix))
            for stage, prefix in stages.items()}


def run_e2e(n: int, cfg, params, key_check=None) -> tuple:
    """The main path at fibonacci_vm(n): the native emulator (no fallback),
    the public values, keygen (then ``key_check(pk)``), a first prove (its
    K5/K7 steps counted: the line's ``duplex_steps``, [words, powers,
    count]), a second prove with spans and the device audit on, then
    verify; both proofs must be the same bytes, and each tampered proof
    must be rejected.
    The launch counts are reset just before keygen and before the second
    prove, and read just after each. Returns (the ``e2e`` line, the timed
    prove's span report, {"keygen" | "prove": (launches, planned trees)},
    (the key, the halted vm, the trace, the proof) for the continuations
    and aggregation phases)."""
    seconds = {}
    t0 = time.time()
    vm = programs.fibonacci_vm(n)
    trace = native.run_trace_native(vm)
    seconds["emulate"] = time.time() - t0
    if (trace.n != sum(fib_rows(n).values()) or not vm.halted
            or vm.regs[10] != programs.fib_expected(n)):
        fail(f"fibonacci_vm({n}) ran {trace.n} steps (halted {vm.halted}), a0 = {vm.regs[10]}")
    pv = e2e.public_values_from_vm(vm, cfg)
    reset_launches()
    t0 = time.time()
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    sync()
    seconds["keygen"] = time.time() - t0
    (fixed,) = pk.fixed_committed.values()
    counted = {"keygen": (launches(), [fixed.n_vars + params.blowup_log])}
    log(f"e2e: fibonacci_vm({n}), {trace.n} steps emulated in {seconds['emulate']:.2f}s; "
        f"keygen ({len(pk.metas)} chips) in {seconds['keygen']:.2f}s")
    if key_check:
        key_check(pk)
    t0 = time.time()
    with duplex_calls() as steps:
        first = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        sync()
    seconds["prove_first"] = time.time() - t0
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with prove_audit() as seen:
        reset_launches()
        t0 = time.time()
        proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        sync()
        seconds["prove"] = time.time() - t0
        counted["prove"] = (launches(), prove_trees(pk, proof))
    tree, span_report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device(seen)
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    log(f"e2e: proved in {seconds['prove_first']:.2f}s, then {seconds['prove']:.2f}s; "
        f"on {DEVICE}: {checked}")
    data = serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params)
    if serialize.proof_to_bytes(first, pv, pk.cfg, pk.params) != data:
        fail("e2e: two proves of the same trace gave different proofs")
    t0 = time.time()
    if scheme.verify(pk.vk, proof) is not True:
        fail("e2e: the verifier did not accept the honest proof")
    seconds["verify"] = time.time() - t0
    log(f"e2e: verified in {seconds['verify']:.2f}s; proof {len(data)} bytes")
    for what, bad in tampered(proof):
        try:
            scheme.verify(pk.vk, bad)
        except PROTOCOL_ERRORS as e:
            log(f"e2e: a changed {what} rejected ({type(e).__name__}: {str(e)[:80]})")
        else:
            fail(f"e2e: a proof with a changed {what} was accepted")
    seconds["witgen"] = tree["witgen"]["total"]
    active = [(m, k, scheme.chip_height(m, k)) for m, k in zip(pk.metas, proof.num_instances) if k]
    groups, classes = {}, {}
    for m, _, h in active:
        rho = gkr_chip.interleave_geometry(m.compiled)[0]
        groups.setdefault(f"2^{(h << rho).bit_length() - 1}", []).append(m.name)
        classes.setdefault(f"2^{h.bit_length() - 1}", []).append(m.name)
    line = {"program": f"fibonacci_vm({n})", "steps": trace.n, "device": DEVICE,
            "cfg": dataclasses.asdict(pk.cfg), "params": dataclasses.asdict(pk.params),
            "seconds": seconds, "stage_seconds": stage_seconds(tree),
            "spans": {name: node["total"] for name, node in tree.items()},
            "witgen_spans": {name: node["total"]
                             for name, node in tree["witgen"]["children"].items()},
            "proof_bytes": len(data), "proof_kib": len(data) / 1024,
            "reference_proof_kib": REFERENCE_PROOF_KIB, "max_memory_allocated": peak,
            "launches": {path: c[0] for path, c in counted.items()}, "chips": len(pk.metas),
            "active_chips": {m.name: {"rows": k, "height": h} for m, k, h in active},
            "tower_groups": groups, "classes": classes, "checked_on_device": checked,
            "duplex_steps": [[n_in, n_pows, c] for (n_in, n_pows), c in sorted(steps.items())]}
    if sorted(groups) != sorted(f"2^{n_t.bit_length() - 1}" for n_t in proof.tower_groups):
        fail(f"e2e: tower groups {sorted(groups)} against the proof's {sorted(proof.tower_groups)}")
    return line, span_report, counted, (pk, vm, trace, proof)


def e2e_golden_check() -> dict:
    """The port's proof of the reference's committed setup: its bytes' SHA-256
    and length, and the key's digest, must equal E2E_GOLDEN's; the port's
    verifier must accept it."""
    with open(E2E_GOLDEN) as f:
        want = json.load(f)
    setup = {"program": f"fibonacci_vm({E2E_GOLDEN_ITERS})", "cfg": E2E_GOLDEN_CFG,
             "params": dataclasses.asdict(bf.BasefoldParams())}
    if {k: want[k] for k in setup} != setup:
        fail(f"{os.path.relpath(E2E_GOLDEN, ROOT)} names {want}, chip_smoke proves {setup}")
    cfg, params = ZKVMConfig(**E2E_GOLDEN_CFG), bf.BasefoldParams()
    vm = programs.fibonacci_vm(E2E_GOLDEN_ITERS)
    trace = native.run_trace_native(vm)
    pv = e2e.public_values_from_vm(vm, cfg)
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
    data = serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params)
    got = {"proof_sha256": hashlib.sha256(data).hexdigest(), "proof_bytes": len(data),
           "vk_digest_sha256": hashlib.sha256(pk.vk.digest_elems().tobytes()).hexdigest()}
    if got != {k: want[k] for k in got}:
        fail(f"the proof of {setup['program']} differs from the reference's: {got} against {want}")
    if scheme.verify(pk.vk, proof) is not True:
        fail(f"the proof of {setup['program']} was not accepted")
    log(f"e2e: the proof of {setup['program']} at BasefoldParams() equals the reference's "
        f"({len(data)} bytes, sha256 {got['proof_sha256'][:16]}...) and verifies")
    return got


# -- phase 6: continuations: the 2^20 fibonacci as chained shards -----------------

# the setup of the reference's committed sharded proof digests
# (tools/torch_shard_golden.py; tests/test_shard.py's setup)
SHARD_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "shard_fibonacci.json")
SHARD_GOLDEN_ITERS = 12
SHARD_GOLDEN_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
SHARD_GOLDEN_PARAMS = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}
SHARD_GOLDEN_STEPS = 40
SHARD_ERRORS = PROTOCOL_ERRORS + (shard.ShardChainError, eccquark.EccError)
SHARD_CHIPS = ("shard_ram_in", "shard_ram_out", "ec_tree_in", "ec_tree_out")


def max_steps_per_shard(n_steps: int) -> int:
    """bench_shards.py's shard size: two shards of the trace."""
    return (n_steps + 1) // 2 + 8


def sharded_tampered(sproof) -> list:
    """(what, sharded proof) pairs, each changed in one place the stitching
    verifier must reject: a broken pc chain and a broken cycle chain (shard
    1's initial pc or cycle, which the chain check meets before shard 1's
    proof), a tampered RW sum (shard 0's exported EC sum) and a dropped last
    shard."""
    out = []
    for what, slot in (("pc chain", layout.PV_INIT_PC), ("cycle chain", layout.PV_INIT_CYCLE)):
        bad = copy.deepcopy(sproof)
        bump(bad.proofs[1].public_values, slot)
        out.append((what, bad))
    bad = copy.deepcopy(sproof)
    bump(bad.proofs[0].public_values, layout.PV_RW_SUM_OUT)
    out.append(("rw sum", bad))
    bad = copy.deepcopy(sproof)
    bad.proofs = bad.proofs[:-1]
    bad.n_shards -= 1
    out.append(("dropped shard", bad))
    return out


def check_shard_rejections(vk, sproof, what: str) -> dict:
    """Each of :func:`sharded_tampered` must be rejected by ``verify_shards``,
    and shard 1 alone by the standalone ``verify``; returns the errors."""
    errors = {}
    for kind, bad in sharded_tampered(sproof):
        try:
            shard.verify_shards(vk, bad)
        except SHARD_ERRORS as e:
            errors[kind] = f"{type(e).__name__}: {str(e)[:80]}"
        else:
            fail(f"{what}: a sharded proof with a changed {kind} was accepted")
    try:
        scheme.verify(vk, sproof.proofs[1])
    except scheme.ZKVMError as e:
        errors["standalone shard 1"] = f"ZKVMError: {str(e)[:80]}"
    else:
        fail(f"{what}: shard 1 was accepted as a standalone proof")
    for kind, err in errors.items():
        log(f"{what}: {kind} rejected ({err})")
    return errors


def shard_digests(sproof, cfg, params) -> dict:
    """The shard count and each shard's proof bytes' SHA-256 and length."""
    blobs = interop.sharded_proof_to_bytes(sproof, cfg, params)
    return {"n_shards": len(blobs),
            "shards": [{"proof_sha256": hashlib.sha256(b).hexdigest(), "proof_bytes": len(b)}
                       for b in blobs]}


def shard_golden_check() -> dict:
    """The port's sharded proof of the reference's committed setup, pipelined
    on DEVICE under the device audit: each shard's bytes' SHA-256 and length
    must equal SHARD_GOLDEN's; ``verify_shards`` must accept it and reject
    each tampered proof. Returns the digests, the rejections' errors and the
    audit's counts."""
    with open(SHARD_GOLDEN) as f:
        want = json.load(f)
    setup = {"program": f"fibonacci_vm({SHARD_GOLDEN_ITERS})", "cfg": SHARD_GOLDEN_CFG,
             "params": SHARD_GOLDEN_PARAMS, "max_steps_per_shard": SHARD_GOLDEN_STEPS}
    if {k: want[k] for k in setup} != setup:
        fail(f"{os.path.relpath(SHARD_GOLDEN, ROOT)} names {want}, chip_smoke proves {setup}")
    vm = programs.fibonacci_vm(SHARD_GOLDEN_ITERS)
    trace = native.run_trace_native(vm)
    pk = scheme.keygen(vm.program, ZKVMConfig(**SHARD_GOLDEN_CFG),
                       bf.BasefoldParams(**SHARD_GOLDEN_PARAMS), device=DEVICE)
    with prove_audit() as seen:
        sproof = shard.prove_shards(pk, vm, trace, SHARD_GOLDEN_STEPS, device=DEVICE)
    checked = on_device(seen)
    got = shard_digests(sproof, pk.cfg, pk.params)
    if got != {k: want[k] for k in got}:
        fail(f"the sharded proof of {setup['program']} differs from the reference's: "
             f"{got} against {want}")
    if shard.verify_shards(pk.vk, sproof) is not True:
        fail(f"the sharded proof of {setup['program']} was not accepted")
    log(f"shards: the {got['n_shards']} shard proofs of {setup['program']} equal the "
        f"reference's ({[s['proof_bytes'] for s in got['shards']]} bytes) and verify_shards "
        "accepts them")
    got["rejected"] = check_shard_rejections(pk.vk, sproof, "shards (golden)")
    got["checked_on_device"] = checked
    return got


def ec_sum_of(sproof) -> tuple:
    """The sum of every shard's imported and exported EC sums (public values)."""
    acc = (np.zeros(7, np.uint64), np.zeros(7, np.uint64))
    for proof in sproof.proofs:
        pv = np.asarray(proof.public_values, np.uint64)
        for base in (layout.PV_RW_SUM_IN, layout.PV_RW_SUM_OUT):
            acc = septic.point_add(acc, (pv[base:base + 7], pv[base + 7:base + 14]))
    return acc


def real_k6a_rows(kept: dict, ptxas: dict) -> list:
    """:func:`k6a_row` on the inputs :func:`sumcheck_calls` kept: a prove's
    real banks and term tables, whose column locality seeded tables lack."""
    rows = []
    for what, inputs in kept.items():
        if isinstance(inputs, dict):
            fail(f"K6a: no first round of the {what} ({inputs}) was recorded")
        base, ext, bidx, eidx, scalars, deg = inputs
        rows.append(k6a_row(f"{what}, first round, the prove's own inputs", base, ext,
                            bidx.to(torch.int32).contiguous(), eidx.to(torch.int32).contiguous(),
                            scalars, deg, ptxas))
    return rows


def run_continuations(pk, vm, trace, n: int, keep: dict | None = None) -> tuple:
    """The 2^20 fibonacci as chained shards, on phase 5's key, vm (halted) and
    trace: the AOT preflight's plan against the traced plan, then
    ``prove_shards`` pipelined on DEVICE with spans, the device audit and the
    launch counts (reset just before, read just after), then
    ``verify_shards``; the cross-shard EC sum must be the identity, and the
    tampered proofs must be rejected. Returns (the ``shards`` line, the span
    report, the launches)."""
    seconds = {}
    max_steps = max_steps_per_shard(trace.n)
    t0 = time.time()
    traced = shard.plan_boundaries(trace, pk.opcode_chips, None, max_steps)
    seconds["plan_boundaries"] = time.time() - t0
    t0 = time.time()
    bounds, _, steps, state = native.run_preflight(
        programs.fibonacci_vm(n), shard._cost_by_kind(pk.opcode_chips), None, max_steps)
    seconds["preflight"] = time.time() - t0
    if bounds != traced or steps != trace.n or not state["halted"]:
        fail(f"shards: the AOT preflight plans {bounds} over {steps} steps, the trace {traced}")
    log(f"shards: the AOT preflight plans {bounds} in {seconds['preflight']:.2f}s, as the "
        f"trace's plan_boundaries does in {seconds['plan_boundaries']:.2f}s")
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with prove_audit() as seen, sumcheck_calls(keep) as calls:
        reset_launches()
        t0 = time.time()
        sproof = shard.prove_shards(pk, vm, trace, max_steps, device=DEVICE)
        sync()
        seconds["prove_shards"] = time.time() - t0
        counted = launches()
    tree, span_report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device(seen)
    shapes = first_rounds(calls)
    del calls
    check_shapes_ran(shard_shapes(), shapes, "sharded prove (shard-RAM class main, EC-sum quark)")
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    if sproof.n_shards != len(bounds) - 1:
        fail(f"shards: {sproof.n_shards} shard proofs for the plan {bounds}")
    seconds["plan"] = tree["plan-shards"]["total"]
    seconds["shards"] = [tree[f"shard/{s}"]["total"] for s in range(sproof.n_shards)]
    seconds["witgen"] = [tree["witgen"]["total"], tree["witgen"]["count"]]
    log(f"shards: {sproof.n_shards} shards proved in {seconds['prove_shards']:.2f}s (plan "
        f"{seconds['plan']:.2f}s, shard proves {[round(s, 2) for s in seconds['shards']]}); on "
        f"{DEVICE}: {checked}")
    t0 = time.time()
    if shard.verify_shards(pk.vk, sproof) is not True:
        fail("shards: verify_shards did not accept the honest sharded proof")
    seconds["verify_shards"] = time.time() - t0
    if not septic.is_infinity(*ec_sum_of(sproof)):
        fail("shards: the cross-shard EC sum is not the identity")
    log(f"shards: verify_shards accepts in {seconds['verify_shards']:.2f}s; the cross-shard EC "
        "sum is the identity")
    rejected = check_shard_rejections(pk.vk, sproof, "shards (2^20)")
    idx = {m.name: ci for ci, m in enumerate(pk.metas)}
    per_shard = []
    for proof in sproof.proofs:
        pv = np.asarray(proof.public_values, np.uint64)
        per_shard.append({
            "tokens": {c: int(proof.num_instances[idx[c]]) for c in SHARD_CHIPS},
            "quark_rounds": {name: int(p.n_vars) for name, p in proof.ec_proofs.items()},
            "active_chips": sum(1 for k in proof.num_instances if k),
            "init_pc": int(pv[layout.PV_INIT_PC]), "end_pc": int(pv[layout.PV_END_PC]),
            "proof_bytes": len(serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params))})
    line = {"program": f"fibonacci_vm({n})", "steps": trace.n, "device": DEVICE,
            "max_steps_per_shard": max_steps, "bounds": bounds, "n_shards": sproof.n_shards,
            "plan_route": "aot preflight (bounds) + trace (plan_shards)",
            "seconds": seconds, "per_shard": per_shard, "max_memory_allocated": peak,
            "launches": counted, "spans": {name: node["total"] for name, node in tree.items()},
            "checked_on_device": checked, "rejected": rejected,
            "sumcheck_first_rounds": len(shapes)}
    return line, span_report, counted


# -- phase 7: precompiles and guest I/O ------------------------------------------

ROM = Platform.rom_start
# the setup of the reference's committed precompile proof digests
# (tools/torch_precompile_golden.py): the config of the reference's precompile
# tests, each guest at their params ("fast") and at BasefoldParams() ("default")
PRECOMPILE_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "precompile_guests.json")
PRECOMPILE_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
FAST_PARAMS = {"blowup_log": 1, "n_queries": 4, "stop_size": 32}
PRECOMPILE_GUESTS = ("precompile_torture", "hashing", "secp", "println")
# the hints of examples/hashing.s: it reads word 0 of the buffer as n (here
# the header's data offset, 12) and seeds the keccak state from words 1..n
HASHING_HINT = [0xDEAD, 0xBEEF, 0x1234, 0x5678, 0x9ABC, 0xDEF0, 7, 8, 9]
# tests/test_messages.py's println guest: "hi!" and "ceno" to the info-out region
PRINTLN_SRC = f"""
    li t1, {Platform.info_start}
    li t2, 3
    sw t2, 0(t1)
    li t2, {int.from_bytes(b"hi!" + bytes(1), "little")}
    sw t2, 4(t1)
    li t2, 4
    sw t2, 8(t1)
    li t2, {int.from_bytes(b"ceno", "little")}
    sw t2, 12(t1)
    li a0, 0
    li t0, 0
    ecall
"""
PRINTLN_MESSAGES = [b"hi!", b"ceno"]
# secp256k1's generator (tests/test_curves.py's G1)
SECP_G = (55066263022277343669578718895168534326250603453777594175500187360389116729240,
          32670510020758816978083085130507043184471273380659243275938904335757337482424)
SECP_SCALAR = 0xDEADBEEF12345

# The precompile path at full size: N KECCAK_PERMUTE calls on one 50-word
# state. The guest reads N, the first item of a CenoStdin hints buffer, zeroes
# the state, permutes it N times, commits its first 8 words and halts; every
# syscall it makes is in the native core.
KECCAK_LOOP_SRC = """
    li s0, {hints}
    lw t1, 0(s0)
    add t1, t1, s0
    lw s2, 0(t1)
    li s1, {heap}
    li t1, 0
    mv t2, s1
    li t3, 50
zero:
    sw zero, 0(t2)
    addi t2, t2, 4
    addi t1, t1, 1
    blt t1, t3, zero
    li t0, {keccak}
    mv a0, s1
    beq s2, zero, done
permute:
    ecall
    addi s2, s2, -1
    bne s2, zero, permute
done:
    li t0, {commit}
    mv a0, s1
    ecall
    li t0, 0
    li a0, 0
    ecall
"""
KECCAK_PERMS = 1024
PRECOMPILE_CHIPS = ("keccak_ecall", "keccak_core", "pubio_commit", "sha_extend", "uint256_mul",
                    "secp256k1_add", "secp256k1_double", "secp256k1_decompress",
                    "secp256k1_invert")


def _store_words(value: int, base_reg: str, off: int) -> str:
    """Assembly that stores ``value``'s 8 little-endian words at off(base_reg)."""
    return "\n".join(f"    li t5, {(value >> (32 * i)) & 0xFFFFFFFF}\n"
                     f"    sw t5, {off + 4 * i}({base_reg})" for i in range(8))


def secp_guest_src() -> str:
    """tests/test_curves.py's SECP_GUEST: double G, add G, invert a scalar,
    decompress x(G) (the curve calls, which the native core does not run)."""
    heap, (gx, gy) = Platform.heap_start, SECP_G
    return f"""
    li t1, {heap}
{_store_words(gx, "t1", 0)}
{_store_words(gy, "t1", 32)}
{_store_words(gx, "t1", 64)}
{_store_words(gy, "t1", 96)}
{_store_words(SECP_SCALAR, "t1", 128)}
{_store_words(gx, "t1", 160)}
    li t0, {Platform.ECALL_SECP256K1_DOUBLE}
    mv a0, t1
    ecall
    li t0, {Platform.ECALL_SECP256K1_ADD}
    addi a1, t1, 64
    ecall
    li t0, {Platform.ECALL_SECP256K1_SCALAR_INVERT}
    addi a0, t1, 128
    ecall
    li t0, {Platform.ECALL_SECP256K1_DECOMPRESS}
    addi a0, t1, 160
    li a1, {gy & 1}
    ecall
    lw a0, 0(t1)
    li t0, 0
    ecall
"""


def precompile_guest(name: str) -> tuple:
    """(assembly source, hint words, runs on the native core) of one golden
    guest of PRECOMPILE_GUESTS."""
    heap = Platform.heap_start
    if name == "precompile_torture":  # as tests/test_precompile_torture.py formats it
        with open(os.path.join(ROOT, "examples", "precompile_torture.s")) as f:
            src = f.read().format(heap=heap, w_base=heap + 512, x_base=heap + 1024,
                                  keccak=Platform.ECALL_KECCAK,
                                  sha_extend=Platform.ECALL_SHA_EXTEND,
                                  uint256=Platform.ECALL_UINT256_MUL,
                                  commit=Platform.ECALL_COMMIT)
        return src, [], True
    if name == "hashing":
        with open(os.path.join(ROOT, "examples", "hashing.s")) as f:
            src = f.read().format(hints=Platform.hints_start, heap=heap,
                                  keccak=Platform.ECALL_KECCAK, commit=Platform.ECALL_COMMIT)
        return src, CenoStdin().write(HASHING_HINT).to_words(), True
    if name == "secp":
        return secp_guest_src(), [], False
    if name == "println":
        return PRINTLN_SRC, [], True
    raise ValueError(f"no precompile guest {name!r}")


def guest_vm(src: str, hints: list) -> VMState:
    """The guest's VM at ROM with ``hints`` at the hints window."""
    vm = VMState(make_program(assemble(src, ROM), ROM), ROM)
    for i, w in enumerate(hints):
        vm.init_memory(Platform.hints_start + 4 * i, w)
    return vm


def program_digest(vm) -> str:
    """SHA-256 of a guest's program words and initial memory (its hints)."""
    h = hashlib.sha256()
    for items in (vm.program, vm.mem_init):
        h.update(np.array(sorted(items.items()), np.uint64).tobytes())
    return h.hexdigest()


def pubio_words(pv: np.ndarray) -> list:
    """The committed digest's 8 words from the public values' u16 limbs."""
    base = layout.PV_PUBIO_DIGEST
    return [int(pv[base + 2 * i]) | int(pv[base + 2 * i + 1]) << 16 for i in range(8)]


def keccak_digest(state_words: list, perms: int) -> list:
    """The first 8 words of keccak-f applied ``perms`` times on the host."""
    lanes = keccak.words_to_lanes(list(state_words) + [0] * (50 - len(state_words)))
    for _ in range(perms):
        lanes = keccak.keccakf(lanes)
    return keccak.lanes_to_words(lanes)[:8]


def proof_digests(data: bytes, pk) -> dict:
    return {"proof_sha256": hashlib.sha256(data).hexdigest(), "proof_bytes": len(data),
            "vk_digest_sha256": hashlib.sha256(pk.vk.digest_elems().tobytes()).hexdigest()}


def prove_guest(name: str, params) -> tuple:
    """keygen -> prove of one golden guest at PRECOMPILE_CFG on DEVICE: the
    native core where it runs the guest (never a fallback), else the Python
    interpreter's records. Returns (vm, pk, proof, proof bytes, the prove's
    first sumcheck rounds)."""
    src, hints, native_core = precompile_guest(name)
    vm = guest_vm(src, hints)
    trace = native.run_trace_native(vm) if native_core else TraceView.from_records(vm.run())
    if not vm.halted:
        fail(f"precompiles: the {name} guest did not halt")
    cfg = ZKVMConfig(**PRECOMPILE_CFG)
    pv = e2e.public_values_from_vm(vm, cfg)
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    with sumcheck_calls() as calls:
        proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        shapes = first_rounds(calls)
    return vm, pk, proof, serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params), shapes


def guest_output_check(name: str, vm, pv: np.ndarray) -> None:
    """What the I/O guests give back: the hashing guest's committed digest
    is keccak-f of its hinted state; the println guest's messages read back."""
    if name == "hashing":
        _, hints, _ = precompile_guest(name)
        want = keccak_digest(hints[1:hints[0] + 1], 1)
        if pubio_words(pv) != want or vm.pubio_digest != want:
            fail(f"precompiles: the hashing guest committed {vm.pubio_digest}, keccak-f gives "
                 f"{want}")
    elif name == "println":
        got = read_all_messages(vm)
        if got != PRINTLN_MESSAGES or int(pv[layout.PV_INFO_WORDS]) != 4:
            fail(f"precompiles: the println guest's messages read back as {got}")


def precompile_golden_check() -> dict:
    """Phase 7a: the port's proof of each guest of PRECOMPILE_GUESTS at
    BasefoldParams() must have the SHA-256 and length of the reference's
    (PRECOMPILE_GOLDEN), and verify; the I/O guests' outputs must read back.
    Returns the digests, seconds and the secp guest's first sumcheck rounds."""
    with open(PRECOMPILE_GOLDEN) as f:
        want = json.load(f)
    params = bf.BasefoldParams()
    setup = {"cfg": PRECOMPILE_CFG, "params": {"fast": dataclasses.asdict(
        bf.BasefoldParams(**FAST_PARAMS)), "default": dataclasses.asdict(params)}}
    if {k: want[k] for k in setup} != setup or tuple(want["guests"]) != PRECOMPILE_GUESTS:
        fail(f"{os.path.relpath(PRECOMPILE_GOLDEN, ROOT)} names {want}, chip_smoke proves {setup}")
    out = {}
    for name in PRECOMPILE_GUESTS:
        t0 = time.time()
        vm, pk, proof, data, shapes = prove_guest(name, params)
        ref = want["guests"][name]
        got = {"program_sha256": program_digest(vm), **proof_digests(data, pk)}
        if got != {"program_sha256": ref["program_sha256"], **ref["default"]}:
            fail(f"precompiles: the proof of the {name} guest differs from the reference's: "
                 f"{got} against {ref}")
        if scheme.verify(pk.vk, proof) is not True:
            fail(f"precompiles: the proof of the {name} guest was not accepted")
        guest_output_check(name, vm, proof.public_values)
        out[name] = {**got, "seconds": time.time() - t0,
                     "active_chips": sum(1 for k in proof.num_instances if k)}
        if name == "secp":
            out[name]["sumcheck_shapes"] = shapes
        log(f"precompiles: the {name} guest's proof at BasefoldParams() equals the reference's "
            f"({len(data)} bytes, sha256 {got['proof_sha256'][:16]}...) and verifies "
            f"({out[name]['seconds']:.2f}s)")
    return out


def keccak_loop_vm(n: int) -> VMState:
    """KECCAK_LOOP_SRC with N = ``n`` written by CenoStdin into the hints."""
    src = KECCAK_LOOP_SRC.format(hints=Platform.hints_start, heap=Platform.heap_start,
                                 keccak=Platform.ECALL_KECCAK, commit=Platform.ECALL_COMMIT)
    return guest_vm(src, CenoStdin().write(n).to_words())


def precompile_tampered(proof, h_core: int) -> list:
    """(what, proof) pairs the verifier must reject: one main-zerocheck
    message of the keccak core's class, and a public value (a word of the
    committed digest)."""
    out = []
    bad = copy.deepcopy(proof)
    bump(bad.class_main[h_core].main_msgs, (0, 0, 0))
    out.append(("keccak_core class-main message", bad))
    bad = copy.deepcopy(proof)
    bump(bad.public_values, layout.PV_PUBIO_DIGEST)
    out.append(("public value (pubio digest)", bad))
    return out


def run_keccak_loop(n: int, cfg, params, keep: dict | None = None) -> tuple:
    """Phase 7b: the keccak guest of ``n`` permutations as a user proves it:
    the native core (no fallback), the committed words against keccak-f on
    the host, keygen, one prove with spans, the device audit and the launch
    counts (reset just before, read just after), verify, then the tampered
    proofs. Returns (the ``precompiles`` line, the span report, the
    launches, the first sumcheck rounds)."""
    seconds = {}
    vm = keccak_loop_vm(n)
    t0 = time.time()
    trace = native.run_trace_native(vm)
    seconds["emulate"] = time.time() - t0
    want = keccak_digest([], n)
    if not vm.halted or vm.exit_code != 0 or vm.pubio_digest != want:
        fail(f"keccak loop({n}): halted {vm.halted}, exit {vm.exit_code}, committed "
             f"{vm.pubio_digest}; keccak-f {n} times gives {want}")
    pv = e2e.public_values_from_vm(vm, cfg)
    if pubio_words(pv) != want:
        fail(f"keccak loop({n}): the public values carry {pubio_words(pv)}, not {want}")
    t0 = time.time()
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    sync()
    seconds["keygen"] = time.time() - t0
    log(f"precompiles: keccak loop({n}), {trace.n} steps emulated in {seconds['emulate']:.2f}s, "
        f"its {n} digests equal keccak-f on the host; keygen in {seconds['keygen']:.2f}s")
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with prove_audit() as seen, sumcheck_calls(keep) as calls:
        reset_launches()
        t0 = time.time()
        proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        sync()
        seconds["prove"] = time.time() - t0
        counted = launches()
        shapes = first_rounds(calls)
    tree, span_report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device(seen)
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    data = serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params)
    log(f"precompiles: proved in {seconds['prove']:.2f}s, {len(data)} bytes; on {DEVICE}: "
        f"{checked}; launches {counted}")
    t0 = time.time()
    if scheme.verify(pk.vk, proof) is not True:
        fail("precompiles: the verifier did not accept the keccak loop's proof")
    seconds["verify"] = time.time() - t0
    heights = {m.name: (k, scheme.chip_height(m, k))
               for m, k in zip(pk.metas, proof.num_instances) if k}
    rejected = {}
    for what, bad in precompile_tampered(proof, heights["keccak_core"][1]):
        try:
            scheme.verify(pk.vk, bad)
        except PROTOCOL_ERRORS as e:
            rejected[what] = f"{type(e).__name__}: {str(e)[:80]}"
            log(f"precompiles: a changed {what} rejected ({rejected[what]})")
        else:
            fail(f"precompiles: a keccak loop proof with a changed {what} was accepted")
    classes = {}
    for name, (_, h) in heights.items():
        classes.setdefault(f"2^{h.bit_length() - 1}", []).append(name)
    line = {"program": f"keccak loop({n})", "permutations": n, "steps": trace.n, "device": DEVICE,
            "cfg": dataclasses.asdict(pk.cfg), "params": dataclasses.asdict(pk.params),
            "seconds": seconds, "stage_seconds": stage_seconds(tree),
            "spans": {name: node["total"] for name, node in tree.items()},
            "witgen_spans": {name: node["total"]
                             for name, node in tree["witgen"]["children"].items()},
            "rows": {name: {"rows": k, "height": h} for name, (k, h) in heights.items()
                     if name in PRECOMPILE_CHIPS},
            "active_chips": len(heights), "classes": classes,
            "proof_bytes": len(data), "max_memory_allocated": peak, "launches": counted,
            "checked_on_device": checked, "rejected": rejected,
            "sumcheck_first_rounds": len(shapes)}
    return line, span_report, counted, shapes


# -- phase 9: aggregation -----------------------------------------------------------

AGG_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "aggregation_fibonacci.json")
# the stored proofs of its single and level-2 entries (tools/torch_agg_golden.py)
AGG_GOLDEN_PROOF = os.path.join(ROOT, "ceno_tpu_torch", "golden", "aggregation_{}.bin")
AGG_GOLDEN_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
# the untimed jobs: 4 golden entries, 5 golden gates, 2 aggregation checks,
# phase 12's 3 jobs and phase 13's rejections
AGG_WORKERS = 6
AGG_ERRORS = PROTOCOL_ERRORS + (aggregate.AggError, eccquark.EccError,
                                serialize.ProofFormatError)


def agg_digests(key, aproof, params) -> dict:
    """An aggregation proof's bytes' SHA-256 and length, its key's chip count
    and the SHA-256 of the key's ``digest_elems`` (as the golden file has them)."""
    data = serialize.agg_proof_to_bytes(aproof, params)
    return {"proof_sha256": hashlib.sha256(data).hexdigest(), "proof_bytes": len(data),
            "chips": len(key.chips),
            "key_sha256": hashlib.sha256(
                np.asarray(key.digest_elems(), np.uint64).tobytes()).hexdigest()}


def agg_tampered(aproof) -> list:
    """(what, proof) pairs the key-less verifier must reject: a public value
    (the last shard's exit code in the aggregation statement), a wrong
    geometry flag (the last shard claimed not last), one witness eval of the
    largest class main."""
    out = []
    bad = copy.deepcopy(aproof)
    bump(bad.public_values, len(bad.public_values) - layout.N_PUBLIC_VALUES
         + layout.PV_EXIT_CODE_LO)
    out.append(("public value", bad))
    geo = list(aproof.geometry)
    geo[-1] = dataclasses.replace(geo[-1], is_last=False)
    out.append(("geometry flag", dataclasses.replace(aproof, geometry=geo)))
    bad = copy.deepcopy(aproof)
    bump(bad.class_main[max(bad.class_main)].wit_evals[0], (0, 0))
    out.append(("class-main eval", bad))
    return out


def check_agg_rejections(verify, bads: list, what: str) -> dict:
    """Each (what, proof) of ``bads`` must make ``verify`` raise one of
    AGG_ERRORS; returns {what: the error's type}."""
    rejected = {}
    for w, bad in bads:
        try:
            verify(bad)
        except AGG_ERRORS as e:
            log(f"{what}: a changed {w} rejected ({type(e).__name__}: {str(e)[:80]})")
            rejected[w] = type(e).__name__
        else:
            fail(f"{what}: an aggregation proof with a changed {w} was accepted")
    return rejected


def agg_golden_entry(name: str, want: dict) -> dict:
    """One entry of AGG_GOLDEN proved by the port on DEVICE: the shard proof
    (or proofs) of its setup, then its aggregation (``prove_aggregation`` or
    ``prove_shard_aggregation``), whose digests must equal the entry's; the
    matching key-less verifier must accept it, and the single aggregation's
    tampered proofs must be rejected. The level-2 entry is
    :func:`agg_level2_entry` and :func:`agg_level2_verify`."""
    t0 = time.time()
    cfg, params = ZKVMConfig(**want["cfg"]), bf.BasefoldParams(**want["params"])
    vm = programs.fibonacci_vm(int(re.search(r"\d+", want["program"]).group()))
    trace = native.run_trace_native(vm)
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    if name == "sharded":
        sproof = shard.prove_shards(pk, vm, trace, want["max_steps_per_shard"], device=DEVICE)
        key, aproof, n = aggregate.prove_shard_aggregation(pk.vk, sproof, params=params,
                                                           device=DEVICE)
        got = {"n_shards": n}

        def verify(p):
            return aggregate.verify_shard_aggregation(p, n, pk.vk, params=params)
    else:
        proof = scheme.prove(pk, vm, trace, e2e.public_values_from_vm(vm, cfg), device=DEVICE)
        key, aproof = aggregate.prove_aggregation(pk.vk, proof, params=params, device=DEVICE)
        got = {}

        def verify(p):
            return aggregate.verify_aggregation(p, pk.vk, params=params)
    sync()
    got.update(agg_digests(key, aproof, params))
    got["prove_s"] = time.time() - t0
    agg_golden_compare(name, want, got)
    t0 = time.time()
    if verify(aproof) is not True:
        fail(f"aggregation ({name}): the key-less verifier did not accept the honest proof")
    got["verify_s"] = time.time() - t0
    log(f"aggregation ({name}): {want['entry']} of {want['program']} equals the reference's "
        f"({got['proof_bytes']} bytes, {got['chips']} chips) in {got['prove_s']:.2f}s; "
        f"verified key-less in {got['verify_s']:.2f}s")
    if name == "single":
        got["rejected"] = check_agg_rejections(verify, agg_tampered(aproof),
                                               f"aggregation ({name})")
    return got


def agg_golden_compare(name: str, want: dict, got: dict) -> None:
    if {k: got[k] for k in want if k in got} != {k: want[k] for k in got if k in want}:
        fail(f"aggregation ({name}): the port's {want['entry']} of {want['program']} differs "
             f"from the reference's: {got} against {want}")


def stored_agg_proof(name: str, want: dict) -> tuple:
    """AGG_GOLDEN's stored bytes of entry ``name`` (the reference's: their
    SHA-256 and length are the entry's ``want``), parsed: (proof, params)."""
    with open(AGG_GOLDEN_PROOF.format(name), "rb") as f:
        data = f.read()
    if (hashlib.sha256(data).hexdigest(), len(data)) != (want["proof_sha256"],
                                                         want["proof_bytes"]):
        fail(f"aggregation: {os.path.relpath(AGG_GOLDEN_PROOF.format(name), ROOT)} is not the "
             f"proof that {os.path.relpath(AGG_GOLDEN, ROOT)} names")
    return serialize.agg_proof_from_bytes(data)


def level2_inner(want: dict) -> tuple:
    """The level-2 entry's inner proof, the stored ``single`` aggregation
    (``want``, which the ``single`` gate holds the port's own to), and its
    key, rebuilt key-less (``expected_agg_key``) from the shard key of its
    setup on DEVICE: their digests must be the entry's. Returns (the key,
    the proof, the params)."""
    cfg, params = ZKVMConfig(**want["cfg"]), bf.BasefoldParams(**want["params"])
    vm = programs.fibonacci_vm(int(re.search(r"\d+", want["program"]).group()))
    vk = scheme.keygen(vm.program, cfg, params, device=DEVICE).vk
    inner, _ = stored_agg_proof("single", want)
    pv = np.asarray(inner.public_values, np.uint64)[len(vk.digest_elems()):]
    key = aggregate.expected_agg_key(vk, inner.geometry, [pv], params)
    agg_golden_compare("single", want, agg_digests(key, inner, params))
    return key, inner, params


def agg_level2_entry(want: dict, inner_want: dict) -> dict:
    """AGG_GOLDEN's level-2 entry proved by the port on DEVICE:
    ``prove_chipset_aggregation`` over :func:`level2_inner`, whose digests
    must equal the entry's (the reference's, whose bytes
    :func:`agg_level2_verify` verifies beside it)."""
    t0 = time.time()
    inner_key, inner, params = level2_inner(inner_want)
    key, aproof = aggregate.prove_chipset_aggregation(inner_key, [inner], params=params,
                                                      device=DEVICE)
    sync()
    got = agg_digests(key, aproof, params)
    got["prove_s"] = time.time() - t0
    agg_golden_compare("level2", want, got)
    log(f"aggregation (level2): {want['entry']} of {want['program']} equals the reference's "
        f"({got['proof_bytes']} bytes, {got['chips']} chips) in {got['prove_s']:.2f}s")
    return got


def agg_level2_verify(want: dict, inner_want: dict) -> dict:
    """The key-less ``verify_chipset_aggregation`` of the stored level-2
    proof (the reference's bytes, which :func:`agg_level2_entry`'s digests
    must equal) against :func:`level2_inner`'s key, which must accept it."""
    inner_key, inner, params = level2_inner(inner_want)
    outer, _ = stored_agg_proof("level2", want)
    t0 = time.time()
    if aggregate.verify_chipset_aggregation(outer, inner_key, [inner.public_values],
                                            params=params) is not True:
        fail("aggregation (level2): the key-less verifier did not accept the honest proof")
    got = {"verify_s": time.time() - t0}
    log(f"aggregation (level2): the reference's proof verified key-less in "
        f"{got['verify_s']:.2f}s")
    return got


def agg_golden_check(pool) -> dict:
    """:func:`agg_golden_entry` for each entry of AGG_GOLDEN, the level-2
    one as :func:`agg_level2_entry` and :func:`agg_level2_verify`, each in
    a worker of ``pool`` (:func:`agg_pool`), longest first; returns {name:
    the worker's pending result}, which :func:`agg_results` waits for."""
    with open(AGG_GOLDEN) as f:
        want = json.load(f)
    inner = want[want["level2"]["inner"]]
    pending = {"level2": pool.apply_async(_agg_job, (agg_level2_entry, want["level2"], inner))}
    for name in ("sharded", "default", "single"):
        pending[name] = pool.apply_async(_agg_job, (agg_golden_entry, name, want[name]))
    pending["level2 verify"] = pool.apply_async(_agg_job,
                                                (agg_level2_verify, want["level2"], inner))
    return pending


def agg_pool(n: int):
    """``n`` worker processes (spawned; each its own CUDA context, torch on one
    thread) for phase 9's untimed work: the golden entries and gates and the
    checks of the 2^20 aggregation. The caller terminates it."""
    import multiprocessing

    return multiprocessing.get_context("spawn").Pool(n, initializer=_agg_worker_init,
                                                     initargs=(T0, DEVICE))


def _agg_worker_init(t0: float, device: str) -> None:
    global T0, DEVICE
    T0, DEVICE = t0, device
    torch.set_num_threads(1)


def _agg_job(fn, *args):
    """``fn(*args)`` in a worker: a failure comes back as an exception (a
    SystemExit would end the worker and leave its result pending)."""
    try:
        return fn(*args)
    except SystemExit as e:
        raise RuntimeError(str(e)) from None


def golden_gates(pool) -> dict:
    """Phases 7, 6, 11, 13 and 5's golden gates (:func:`precompile_golden_check`,
    :func:`shard_golden_check`, :func:`gl_golden_check`,
    :func:`whir_golden_check`, :func:`e2e_golden_check`), each in a worker of
    ``pool``: pending (result, seconds) for :func:`agg_results`."""
    return {what: pool.apply_async(_agg_job, (_timed, fn))
            for what, fn in (("precompiles golden", precompile_golden_check),
                             ("shards golden", shard_golden_check),
                             ("gl golden", gl_golden_check),
                             ("whir golden", whir_golden_check),
                             ("e2e golden", e2e_golden_check))}


def _timed(fn) -> tuple:
    t0 = time.time()
    out = fn()
    return out, time.time() - t0


def agg_results(pending: dict) -> dict:
    """{name: result} of :func:`agg_golden_check`, :func:`golden_gates` or
    :func:`agg_verifications`:
    each worker's result, waited for (a worker's failure fails the run)."""
    out = {}
    for name, r in pending.items():
        try:
            out[name] = r.get()
        except RuntimeError as e:
            fail(f"{name}: {e}")
    return out


def agg_verify_job(what: str, vk, data: bytes) -> dict:
    """One key-less verification of the aggregation proof ``data``
    (``agg_proof_to_bytes``) against ``vk``, with spans on: ``honest``
    verifies the proof; ``parsed`` also checks that the parsed proof writes
    back to the same bytes; ``public value`` changes the last shard's exit
    code in the statement, which must be rejected. Returns its seconds (and
    those of the key rebuild and of ``verify_chipset``) or the error."""
    aproof, params = serialize.agg_proof_from_bytes(data)
    if what == "parsed" and serialize.agg_proof_to_bytes(aproof, params) != data:
        fail("aggregation: the parsed proof does not write back to the same bytes")
    if what == "public value":
        return check_agg_rejections(lambda p: aggregate.verify_aggregation(p, vk, params=params),
                                    agg_tampered(aproof)[:1], "aggregation")
    spans.enable()
    t0 = time.time()
    if aggregate.verify_aggregation(aproof, vk, params=params) is not True:
        fail(f"aggregation: the key-less verifier did not accept the {what} proof")
    out = {"seconds": time.time() - t0}
    tree = spans.tree()
    spans.disable()
    out["key_rebuild"] = tree["agg/key-rebuild"]["total"]
    out["verify_chipset"] = tree["agg/verify-chipset"]["total"]
    log(f"aggregation: the {what} proof verified key-less in {out['seconds']:.2f}s (key "
        f"rebuild {out['key_rebuild']:.2f}s)")
    return out


def agg_verifications(pool, vk, data: bytes) -> dict:
    """:func:`agg_verify_job` for the parsed and the tampered proof, each in
    a worker of ``pool`` (pending results for :func:`agg_results`)."""
    return {what: pool.apply_async(_agg_job, (agg_verify_job, what, vk, data))
            for what in ("parsed", "public value")}


def agg_shapes(aproof) -> dict:
    """The aggregation proof's class-main heights and tower-group sizes, as
    log2."""
    return {"classes": [h.bit_length() - 1 for h in sorted(aproof.class_main)],
            "tower_groups": [n.bit_length() - 1 for n in sorted(aproof.tower_groups)]}


def run_aggregation(pk, proof, n: int, keep: dict | None = None) -> tuple:
    """Aggregate phase 5's proof of fibonacci_vm(n) with its key, as a user's
    ``aggregate`` command does: ``prove_aggregation`` on DEVICE with spans,
    the device audit and the launch counts (reset just before, read just
    after); then the key-less ``verify_aggregation`` of the proof, timed
    (:func:`agg_verify_job`). Returns (the ``aggregation`` line, the span
    report, the launches, the first rounds of its sumchecks, the proof's
    bytes)."""
    seconds = {}
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with prove_audit() as seen, sumcheck_calls(keep) as calls:
        reset_launches()
        t0 = time.time()
        key, aproof = aggregate.prove_aggregation(pk.vk, proof, device=DEVICE)
        sync()
        seconds["prove_aggregation"] = time.time() - t0
        counted = launches()
    tree, report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device(seen)
    shapes = first_rounds(calls)
    del calls
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    seconds["witness"] = tree["agg/witness"]["total"]
    seconds["prove"] = seconds["prove_aggregation"] - seconds["witness"]
    stages = {"commit": "agg/commit/", "records": "agg/records", "towers": "agg/towers",
              "class_main": "agg/class-main/", "opening": "agg/open/"}
    seconds["prove_stages"] = {st: sum(node["total"] for nm, node in tree.items()
                                       if nm.startswith(prefix))
                               for st, prefix in stages.items()}
    rows = {name: int(k) for (name, _, _, _), k in zip(key.chips, aproof.num_instances)}
    log(f"aggregation: {len(key.chips)} chips, {sum(rows.values())} rows; proved in "
        f"{seconds['prove_aggregation']:.2f}s (witness {seconds['witness']:.2f}s); on {DEVICE}: "
        f"{checked}")
    data = serialize.agg_proof_to_bytes(aproof, pk.params)
    line = {"program": f"fibonacci_vm({n})", "device": DEVICE,
            "params": dataclasses.asdict(pk.params), "chips": len(key.chips),
            "rows": sum(rows.values()), "rows_per_chip": rows,
            "padded_rows": sum(max(2, 1 << max(0, (k - 1).bit_length())) for k in rows.values()),
            "cells": sum(c.n_wit * max(2, 1 << max(0, (k - 1).bit_length()))
                         for (_, c, _, _), k in zip(key.chips, aproof.num_instances)),
            "seconds": seconds, "proof_bytes": len(data), "max_memory_allocated": peak,
            "launches": counted, "checked_on_device": checked,
            "shapes": agg_shapes(aproof), "sumcheck_first_rounds": len(shapes),
            "spans": {name: node["total"] for name, node in tree.items()}}
    del key, aproof
    honest = agg_verify_job("honest", pk.vk, data)
    seconds["verify_aggregation"] = honest["seconds"]
    seconds["key_rebuild"] = honest["key_rebuild"]
    seconds["verify_chipset"] = honest["verify_chipset"]
    return line, report, counted, shapes, data


# ---------------------------------------------------------------------------
# Phase 10: the command line, the key cache, the row-sharded chip prove
# ---------------------------------------------------------------------------

CLI_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "cli_fibonacci.json")
CLI_GUEST = "examples/fibonacci.s"
CLI_ITERS = 174760  # --hints of the CLI's 2^20-step prove: 1,048,572 steps
CLI_TIMEOUT = 300   # seconds a CLI command may take
SHARDED_CHIP = "addi"  # fibonacci_vm(174760)'s largest opcode chip: 2^19 rows
SHARDED_RANKS = 4
SHARDED_CHALLENGES = np.array([[5, 7, 11, 13], [17, 19, 23, 29]], np.uint64)
SHARDED_LABEL = b"chip-dryrun"
SHARDED_TIMEOUT = 120  # seconds each collective may wait
SHARDED_DEADLINE = 300  # seconds the ranks may take in all, their start included


def cli_run(what: str, *args: str) -> tuple:
    """``python -m ceno_tpu_torch <args>`` from the repo root, on the card:
    (its standard output, wall seconds). Fails on a nonzero exit."""
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "ceno_tpu_torch", *args], cwd=ROOT,
                       capture_output=True, text=True, timeout=CLI_TIMEOUT)
    dt = time.time() - t0
    if r.returncode != 0:
        fail(f"cli {what}: exit {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-4000:]}")
    log(f"cli: {what}: {r.stdout.strip().splitlines()[-1]} ({dt:.2f}s wall)")
    return r.stdout, dt


def file_sha256(path: str) -> dict:
    with open(path, "rb") as f:
        data = f.read()
    return {"sha256": hashlib.sha256(data).hexdigest(), "bytes": len(data)}


def cli_large(tmp: str) -> dict:
    """``prove`` of CLI_GUEST with ``--hints CLI_ITERS --profile test`` (the
    2^20-step trace at phase 5's widths), then ``verify`` of that file, which
    must accept it with the guest's exit code."""
    path = os.path.join(tmp, "fib_2^20.bin")
    _, prove_s = cli_run("prove 2^20", "prove", CLI_GUEST, "--hints", str(CLI_ITERS),
                         "--profile", "test", "-o", path)
    out, verify_s = cli_run("verify 2^20", "verify", CLI_GUEST, path, "--profile", "test")
    want = f"exit_code={programs.fib_expected(CLI_ITERS)}"
    if not out.startswith("verify: OK") or want not in out:
        fail(f"cli verify 2^20: {out.strip()!r}, expected OK and {want}")
    return {"prove_wall_s": prove_s, "verify_wall_s": verify_s,
            "proof_bytes": os.path.getsize(path)}


def cli_golden_run(tmp: str, want: dict) -> dict:
    """The golden setup of ``tools/torch_cli_golden.py``: ``prove``, then
    ``verify`` and ``aggregate`` of its file; the proof's and the
    aggregation's SHA-256 and length, and verify's exit code and cycles, must
    be the reference's."""
    proof, agg = os.path.join(tmp, "fib_golden.bin"), os.path.join(tmp, "agg_golden.bin")
    seconds = {}
    _, seconds["prove"] = cli_run("prove (golden)", "prove", want["guest"], "--hints",
                                  want["hints"], "--profile", want["profile"], "-o", proof)
    if file_sha256(proof) != want["prove"]:
        fail(f"cli prove: {file_sha256(proof)}, the reference's {want['prove']}")
    out, seconds["verify"] = cli_run("verify (golden)", "verify", want["guest"], proof,
                                     "--profile", want["profile"])
    if not out.startswith("verify: OK") or not out.strip().endswith(want["verify"]):
        fail(f"cli verify: {out.strip()!r}, the reference's ends {want['verify']!r}")
    _, seconds["aggregate"] = cli_run("aggregate (golden)", "aggregate", want["guest"], proof,
                                      "--profile", want["profile"], "-o", agg)
    if file_sha256(agg) != want["aggregate"]:
        fail(f"cli aggregate: {file_sha256(agg)}, the reference's {want['aggregate']}")
    return {"wall_s": seconds, "prove": want["prove"], "aggregate": want["aggregate"]}


def cli_stats(want: dict) -> dict:
    """``stats <guest> --hints .. --active`` must print the reference's text."""
    out, dt = cli_run("stats (golden)", "stats", want["guest"], "--hints", want["hints"],
                      "--active")
    if out != want["stats"]:
        fail(f"cli stats: the table differs from the reference's:\n{out}")
    return {"wall_s": dt, "lines": len(out.splitlines())}


def key_cache_check(pk, first_keygen_s: float) -> dict:
    """Phase 5's keygen again (``first_keygen_s`` is phase 5's, the first in
    the process), once without the cache and once with
    CENO_TPU_TORCH_COMMIT_CACHE naming a temporary directory that holds a
    copy of GOLDEN: it must hit that file (write nothing) and give phase 5's
    fixed commitment (cols, codeword, leaves, levels, root). Then the fixed
    matrix's commit alone, from the cache and fresh. Returns the
    ``key_cache`` line."""
    (fresh,) = pk.fixed_committed.values()
    n_pre = len(pk.metas) - len(pk.tables)
    (mat,) = scheme.fixed_matrices(pk.tables, n_pre, pk.params)[1].values()
    out = {"keygen_first_s": first_keygen_s}
    t0 = time.time()
    scheme.keygen(pk.program_words, pk.cfg, pk.params, pk.data_image, device=DEVICE)
    sync()
    out["keygen_fresh_s"] = time.time() - t0
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copy2(GOLDEN, tmp)
        before = {f: os.stat(os.path.join(tmp, f)).st_mtime_ns for f in os.listdir(tmp)}
        os.environ[commitcache.ENV] = tmp
        try:
            t0 = time.time()
            key = scheme.keygen(pk.program_words, pk.cfg, pk.params, pk.data_image,
                                device=DEVICE)
            sync()
            out["keygen_hit_s"] = time.time() - t0
        finally:
            del os.environ[commitcache.ENV]
        t0 = time.time()
        commitcache.commit_cached(mat, pk.params, cache_dir=tmp, device=DEVICE)
        sync()
        out["commit_hit_s"] = time.time() - t0
        after = {f: os.stat(os.path.join(tmp, f)).st_mtime_ns for f in os.listdir(tmp)}
    if after != before:
        fail(f"key cache: keygen wrote to the cache: {sorted(after)} against {sorted(before)}")
    t0 = time.time()
    bf.commit(mat, pk.params, device=DEVICE)
    sync()
    out["commit_fresh_s"] = time.time() - t0
    (hit,) = key.fixed_committed.values()
    got, want = interop.committed_to_numpy(hit), interop.committed_to_numpy(fresh)
    for k in ("cols", "codeword", "leaves"):
        if not np.array_equal(got[k], want[k]):
            fail(f"key cache: the loaded {k} differs from phase 5's fresh commit")
    if len(got["levels"]) != len(want["levels"]) or any(
            not np.array_equal(a, b) for a, b in zip(got["levels"], want["levels"])):
        fail("key cache: the loaded tree's levels differ from phase 5's fresh commit")
    if not np.array_equal(hit.root, fresh.root) or hit.codeword.device.type != \
            torch.device(DEVICE).type:
        fail("key cache: the loaded root differs, or the commitment is not on the device")
    out["levels"] = len(got["levels"])
    log(f"key cache: keygen hit the golden file (nothing written) in {out['keygen_hit_s']:.2f}s "
        f"(without the cache {out['keygen_fresh_s']:.2f}s; phase 5's, the first, "
        f"{first_keygen_s:.2f}s); root, {out['levels']} levels and "
        f"codeword equal phase 5's; the fixed commit {out['commit_fresh_s']:.3f}s fresh, "
        f"{out['commit_hit_s']:.3f}s from the cache")
    return out


def sharded_chip_inputs(path: str) -> tuple:
    """fibonacci_vm(GKR_ITERS)'s SHARDED_CHIP witness (emulated and assigned
    as in phase 4), written to ``path`` for the ranks; returns (compiled,
    wit, fixed, structural, pv, num_instances)."""
    vm, assigned, _ = emulate_and_assign(GKR_ITERS)
    (a,) = [a for a in assigned if a.name == SHARDED_CHIP]
    pv = public_values(vm)
    np.savez(path, name=a.name, wit=a.wit, pv=pv, num_instances=a.num_instances)
    return (a.compiled, a.wit, *chip_side_columns(a.compiled, a.wit.shape[1], pv), pv,
            a.num_instances)


def chip_side_columns(compiled, n: int, pv: np.ndarray) -> tuple:
    """(fixed, structural) canonical columns of an opcode chip of ``n`` rows,
    as ``scheme.prove`` gives them."""
    if compiled.n_fixed:
        fail(f"{compiled.name}: an opcode chip with fixed columns")
    structural = (np.stack([gkr_chip.structural_table(s, n, pv) for s in compiled.structural])
                  if compiled.structural else np.zeros((0, n), np.uint64))
    return np.zeros((0, n), np.uint64), structural


def sharded_chip_job(rank: int, path: str, device: str) -> dict:
    """One rank of the row-sharded chip prove: the chip's witness from
    ``path`` (:func:`sharded_chip_inputs`), ``prove_chip_sharded`` on
    ``device`` after a barrier, the launch counts reset just before and read
    just after. Returns the proof, the opening, the seconds and launches."""
    with np.load(path) as z:
        name, wit, pv, k = str(z["name"]), z["wit"], z["pv"], int(z["num_instances"])
    compiled = next(c.compiled for c in build_opcode_chips() if c.name == name)
    fixed, structural = chip_side_columns(compiled, wit.shape[1], pv)
    mesh = psharded.make_mesh(device=device)
    dist.barrier()
    reset_launches()
    t0 = time.time()
    proof, opening = pchip.prove_chip_sharded(mesh, compiled, wit, fixed, structural, pv, k,
                                              SHARDED_CHALLENGES, Transcript(SHARDED_LABEL))
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    return {"proof": proof, "opening": opening, "seconds": time.time() - t0,
            "launches": launches()}


def chip_proof_bytes(proof, opening) -> bytes:
    """A chip's proof as the serializer writes it, then its opening's point
    and evals."""
    buf = io.BytesIO()
    serialize._encode(buf, proof, 0)
    for a in (opening.point, opening.wit_evals, opening.fixed_evals):
        buf.write(np.ascontiguousarray(a, np.uint64).tobytes())
    return buf.getvalue()


def sharded_chip_check(tmp: str) -> dict:
    """SHARDED_RANKS spawned ranks, sharing the card over ``gloo``, prove the
    chip with ``prove_chip_sharded``; every rank's bytes must equal the
    single-device ``prove_chip``'s on the card, which the verifier accepts,
    and each rank must have launched K6a and K6b. Returns the
    ``sharded_chip`` line."""
    path = os.path.join(tmp, "sharded_chip.npz")
    compiled, wit, fixed, structural, pv, k = sharded_chip_inputs(path)
    t0 = time.time()
    proof, opening = gkr_chip.prove_chip(compiled, wit, fixed, structural, pv, k,
                                         SHARDED_CHALLENGES, Transcript(SHARDED_LABEL),
                                         device=DEVICE)
    sync()
    single_s = time.time() - t0
    want = chip_proof_bytes(proof, opening)
    gkr_chip.verify_chip(compiled, proof, pv, SHARDED_CHALLENGES, Transcript(SHARDED_LABEL))
    t0 = time.time()
    ranks = psharded.run_ranks(sharded_chip_job, (path, DEVICE), world_size=SHARDED_RANKS,
                               timeout=SHARDED_TIMEOUT, deadline=SHARDED_DEADLINE)
    ranks_s = time.time() - t0
    for r, res in enumerate(ranks):
        if chip_proof_bytes(res["proof"], res["opening"]) != want:
            fail(f"sharded chip: rank {r}'s proof differs from the single-device prove_chip's")
        if torch.device(DEVICE).type == "cuda" and (res["launches"]["round_evals"] <= 0
                                                    or res["launches"]["fold"] <= 0):
            fail(f"sharded chip: rank {r} launched {res['launches']}, not K6a and K6b")
    line = {"chip": SHARDED_CHIP, "rows": int(k), "height": int(wit.shape[1]),
            "ranks": SHARDED_RANKS, "backend": "gloo", "device": DEVICE,
            "proof_bytes": len(want), "single_device_prove_s": single_s,
            "rank_prove_s": [res["seconds"] for res in ranks], "ranks_wall_s": ranks_s,
            "rank_launches": [res["launches"] for res in ranks]}
    log(f"sharded chip: {SHARDED_CHIP} ({k} rows of {wit.shape[1]}) on {SHARDED_RANKS} gloo ranks: "
        f"every rank's {len(want)} bytes equal the single-device proof ({single_s:.2f}s); rank "
        f"proves {[round(s, 2) for s in line['rank_prove_s']]} s, {ranks_s:.2f}s with the start")
    return line


def run_phase10_untimed(tmp: str) -> tuple:
    """Phase 10's CLI commands (two threads of subprocesses: the 2^20 prove
    and verify, then stats; the golden prove, verify and aggregate) beside
    the row-sharded chip prove, all in the untimed window. Returns the
    ``cli`` and ``sharded_chip`` lines."""
    with open(CLI_GOLDEN) as f:
        want = json.load(f)
    with ThreadPoolExecutor(2) as ex:
        large = ex.submit(lambda: (cli_large(tmp), cli_stats(want)))
        golden = ex.submit(cli_golden_run, tmp, want)
        sharded_line = sharded_chip_check(tmp)
        large_line, stats_line = large.result()
        cli_line = {"guest": CLI_GUEST, "large": {"hints": CLI_ITERS, **large_line},
                    "golden": {**golden.result(), "stats": stats_line}}
    return cli_line, sharded_line


# -- phase 11: Goldilocks: the single-chip GL prover on the card ----------------------

GL_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gl_pipeline.json")
GL_GOLDEN_ITERS = 40   # tests/test_gl_pipeline.py's fibonacci_vm(40) and its params
GL_GOLDEN_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
GL_GOLDEN_PARAMS = {"blowup_log": 1, "n_queries": 4, "pow_bits": 4, "stop_size": 16}
# seeded commit matrices, (name, seed, C, log2 N, blowup_log): the shapes of
# tests/test_gl_device.py's encode, tests/test_gl_pipeline.py's two PCS
# round trips, and the add chip's width at the default blowup
GL_GOLDEN_COMMITS = [("test_gl_device encode", 3, 5, 5, 2),
                     ("test_gl_pipeline roundtrip", 7, 3, 7, 1),
                     ("test_gl_pipeline multi-level", 7, 5, 9, 2),
                     ("add chip width", 11, 26, 12, 3)]
GL_GOLDEN_SUMCHECK = (13, 8)  # (seed, n_vars) of the golden sumcheck
GL_ERRORS = (gz.GlZkvmError, gsc.GlSumcheckError, gpcs.GlPCSError)


def gl_golden_commit_inputs() -> list:
    """(name, (C, N) canonical numpy, blowup_log) of GL_GOLDEN_COMMITS."""
    return [(name, np.random.default_rng(seed).integers(0, GL_P, size=(c, 1 << log_n),
                                                        dtype=np.uint64), blowup)
            for name, seed, c, log_n, blowup in GL_GOLDEN_COMMITS]


def gl_golden_sumcheck_inputs() -> tuple:
    """(base cols, ext cols, terms, n_vars) of the golden sumcheck: three base
    and two ext columns, terms of degree 0 to 5 (the degree-0 term
    contributes nothing, as in the reference)."""
    seed, n_vars = GL_GOLDEN_SUMCHECK
    rng = np.random.default_rng(seed)
    n = 1 << n_vars
    base = [rng.integers(0, GL_P, size=n, dtype=np.uint64) for _ in range(3)]
    ext = [rng.integers(0, GL_P, size=(n, 2), dtype=np.uint64) for _ in range(2)]
    shapes = [((0, 1), (0,)), ((), (1,)), ((2,), ()), ((), ()), ((0, 1, 2), (0, 1)), ((1,), (1,))]
    terms = [(rng.integers(0, GL_P, size=2, dtype=np.uint64), b, e) for b, e in shapes]
    return base, ext, terms, n_vars


def gl_add_witness(assigned: list, device) -> tuple:
    """(the add chip's AssignedChip, its GL witness on ``device``): the
    BabyBear witgen's columns with the is-zero gadget's ``rd_idinv``
    recomputed as the GL inverse of ``rd_id`` (tests/test_gl_pipeline.py:178)."""
    add = next(a for a in assigned if a.name == "add")
    wn = add.cb.wit_names
    wit = gld.to_device(np.asarray(add.wit, np.uint64), device)
    wit[wn.index("rd_idinv")] = gld.inv(wit[wn.index("rd_id")])
    return add, wit


def gl_golden_values(device) -> dict:
    """The port's GL commit roots, sumcheck digest and chip-proof digest at
    the golden inputs, on ``device``."""
    roots = {name: gpcs.commit(cols, gpcs.GlParams(blowup_log=b), device=device).root.tolist()
             for name, cols, b in gl_golden_commit_inputs()}
    base, ext, terms, n_vars = gl_golden_sumcheck_inputs()
    out = gsc.prove(base, ext, terms, n_vars, GlTranscript(b"gl-golden-sc"), device=device)
    vm = programs.fibonacci_vm(GL_GOLDEN_ITERS)
    assigned = witgen.assign_opcode_chips(native.run_trace_native(vm), build_opcode_chips())
    add, wit = gl_add_witness(assigned, device)
    pv = e2e.public_values_from_vm(vm, ZKVMConfig(**GL_GOLDEN_CFG))
    params = gpcs.GlParams(**GL_GOLDEN_PARAMS)
    proof = gz.prove_chip_gl(add.compiled, wit, pv, add.num_instances, params, device=device)
    gz.verify_chip_gl(add.compiled, proof, pv, params)
    return {"commit_roots": roots,
            "sumcheck": interop.digest(interop.gl_sumcheck_output_to_dict(out)),
            "chip": {"rows": add.num_instances, "n_vars": proof.n_vars,
                     "digest": interop.gl_chip_proof_digest(proof)}}


def gl_golden_check() -> dict:
    """:func:`gl_golden_values` on DEVICE against the reference's, committed
    in ``ceno_tpu_torch/golden/gl_pipeline.json``."""
    with open(GL_GOLDEN) as f:
        want = json.load(f)
    got = gl_golden_values(DEVICE)
    for key in ("commit_roots", "sumcheck", "chip"):
        if got[key] != want[key]:
            fail(f"GL golden: {key} {got[key]} differs from the reference's {want[key]}")
    log(f"GL golden: {len(got['commit_roots'])} commit roots, the sumcheck digest and the "
        f"chip proof of fibonacci_vm({GL_GOLDEN_ITERS})'s add chip equal the reference's")
    return {"commit_roots": len(got["commit_roots"]), "sumcheck": got["sumcheck"][:16],
            "chip_digest": got["chip"]["digest"][:16]}


@contextlib.contextmanager
def gl_device_audit():
    """Record the device of every commit (evals and codeword), record, tower
    layer and sumcheck bank that ``gz.prove_chip_gl`` makes inside the block,
    each made on the main thread."""
    seen = {"commits": [], "records": [], "layers": [], "banks": []}
    originals = (gpcs.commit, gz.build_records_gl, gz._prod_layers, gz._logup_layers, gsc._bank)

    def wrap(fn, key, tensors):
        def inner(*args, **kwargs):
            on_main_thread(f"GL {key}")
            out = fn(*args, **kwargs)
            seen[key] += [x.device.type for x in tensors(out)]
            return out
        return inner

    gpcs.commit = wrap(originals[0], "commits", lambda c: [c.cols, c.codeword])
    gz.build_records_gl = wrap(originals[1], "records",
                               lambda out: out[0] + [m for pq in out[1] for m in pq])
    gz._prod_layers = wrap(originals[2], "layers", lambda out: out)
    gz._logup_layers = wrap(originals[3], "layers", lambda out: out[0] + out[1])
    gsc._bank = wrap(originals[4], "banks", lambda out: [out])
    try:
        yield seen
    finally:
        (gpcs.commit, gz.build_records_gl, gz._prod_layers, gz._logup_layers,
         gsc._bank) = originals


def gl_tampered(proof) -> list:
    """(what, proof) pairs, each with one opening value changed: a claimed
    witness evaluation at the point, and an opened codeword row."""
    bad_eval = copy.deepcopy(proof)
    bad_eval.wit_evals[0, 0] = (int(bad_eval.wit_evals[0, 0]) + 1) % GL_P
    bad_row = copy.deepcopy(proof)
    q = bad_row.opening.queries[0]
    q.base_col_vals[0, 0] = (int(q.base_col_vals[0, 0]) + 1) % GL_P
    return [("witness evaluation", bad_eval), ("opened row", bad_row)]


def gl_rejects(compiled, bad, pv, params, what: str) -> str:
    try:
        gz.verify_chip_gl(compiled, bad, pv, params)
    except GL_ERRORS as e:
        log(f"GL: a proof with a changed {what} rejected ({type(e).__name__}: {str(e)[:80]})")
        return type(e).__name__
    fail(f"GL: a proof with a changed {what} was accepted")


def run_gl(trace, pv) -> tuple:
    """Phase 11: the add chip of phase 5's trace (through the port's
    ``assign_opcode_chips``) proved over Goldilocks with ``prove_chip_gl`` at
    ``GlParams()`` on DEVICE, with spans, the device audit and K14's launch
    counts (reset just before, read just after, each at least one), then
    ``verify_chip_gl`` on the host, which must accept it and reject a proof
    of the add chip with its ``rd_iszero`` cell changed (the reference test's
    tamper) and the proof with a changed witness evaluation and opened row.
    Returns (the ``gl`` line, the span report, K14's launches over the
    prove, which the caller checks)."""
    seconds = {}
    t0 = time.time()
    assigned = witgen.assign_opcode_chips(trace, build_opcode_chips())
    add, wit = gl_add_witness(assigned, DEVICE)
    sync()
    seconds["witness"] = time.time() - t0
    k, n = add.num_instances, wit.shape[1]
    log(f"GL: add chip, {k} instances, witness {tuple(wit.shape)} on {wit.device} "
        f"in {seconds['witness']:.2f}s")
    params = gpcs.GlParams()
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with gl_device_audit() as seen:
        gdev.reset_launches()
        t0 = time.time()
        proof = gz.prove_chip_gl(add.compiled, wit, pv, k, params)
        sync()
        seconds["prove"] = time.time() - t0
        counted = dict(gdev.LAUNCHES)
    tree, report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device(seen)
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    log(f"GL: proved in {seconds['prove']:.2f}s; launches {counted}; on {DEVICE}: {checked}")
    t0 = time.time()
    gz.verify_chip_gl(add.compiled, proof, pv, params)
    seconds["verify"] = time.time() - t0
    log(f"GL: verified on the host in {seconds['verify']:.2f}s")
    rejected = {what: gl_rejects(add.compiled, bad, pv, params, what)
                for what, bad in gl_tampered(proof)}
    bad_wit = wit.clone()
    zc = add.cb.wit_names.index("rd_iszero")
    bad_wit[zc, 1] = gld.add(bad_wit[zc, 1], torch.ones_like(bad_wit[zc, 1]))
    t0 = time.time()
    bad = gz.prove_chip_gl(add.compiled, bad_wit, pv, k, params)
    sync()
    seconds["prove_tampered"] = time.time() - t0
    rejected["rd_iszero cell"] = gl_rejects(add.compiled, bad, pv, params, "rd_iszero cell")
    line = {"chip": "add", "rows": k, "witness": list(wit.shape), "device": DEVICE,
            "params": dataclasses.asdict(params), "seconds": seconds,
            "spans": {name: node["total"] for name, node in tree.items()},
            "launches": counted, "checked_on_device": checked, "max_memory_allocated": peak,
            "proof_digest": interop.gl_chip_proof_digest(proof)[:16],
            "tower": {"prod": int(proof.tower.prod_out.shape[0]),
                      "logup": int(proof.tower.logup_out.shape[0]),
                      "levels": len(proof.tower.round_msgs)},
            "fold_trees": len(proof.opening.fold_roots), "rejected": rejected}
    return line, report, counted


# -- phase 12: the Goldilocks zkVM scheme and its continuations ----------------------

GL_SCHEME_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "gl_scheme.json")
GL_SCHEME_GOLDEN_ITERS = 8  # tests/test_gl_scheme.py's and test_gl_continuation.py's fibonacci_vm(8)
GL_SCHEME_GOLDEN_CFG = {"shl_x_bits": 6, "mem_words_log": 7}
# tests/test_gl_continuation.py:154's params, for both golden setups
GL_SCHEME_GOLDEN_PARAMS = {"blowup_log": 1, "n_queries": 4, "pow_bits": 0, "stop_size": 32}


def gl_golden_shard_steps(n_steps: int) -> int:
    """tests/test_gl_continuation.py's ``max_steps_per_shard`` for a trace of
    ``n_steps`` steps: two shards."""
    return n_steps // 2 + 4


GL_SCHEME_ERRORS = GL_ERRORS + (gls.GlSchemeError, glq.GlEccError)


def gl_scheme_setup(n: int, cfg: dict, device, params=None) -> tuple:
    """(the BabyBear key, the halted vm, its native trace, the public values)
    of fibonacci_vm(n) at ZKVMConfig(**cfg); the key at ``params``
    (``BasefoldParams()``; the GL scheme uses its chips, not its commitment)
    on ``device``."""
    cfg = ZKVMConfig(**cfg)
    vm = programs.fibonacci_vm(n)
    trace = native.run_trace_native(vm)
    pk = scheme.keygen(vm.program, cfg, params or bf.BasefoldParams(), device=device)
    return pk, vm, trace, e2e.public_values_from_vm(vm, cfg)


def span_totals(tree: dict, names) -> dict:
    """{name: (seconds, calls)} of the spans named ``names``, each summed over
    the span tree ``tree`` ({name: node}) at every depth."""
    out = dict.fromkeys(names, (0.0, 0))

    def walk(children):
        for name, node in children.items():
            if name in out:
                out[name] = (out[name][0] + node["total"], out[name][1] + node["count"])
            walk(node["children"])

    walk(tree)
    return out


def gl_span_seconds(tree: dict) -> tuple:
    """(seconds by span summed over the chips, {chip: {span: seconds}}, the
    grind seconds summed) of prove_gl's span tree."""
    by_span = {name: tree[name]["total"] for name in ("gl/witgen", "gl/commit") if name in tree}
    by_chip = {}
    grind = 0.0
    for name, node in tree.items():
        if not name.startswith("gl/chip/"):
            continue
        chip = {"total": node["total"]}
        for child, c in node["children"].items():
            chip[child] = c["total"]
            by_span[child] = by_span.get(child, 0.0) + c["total"]
        chip["grind"] = span_totals(node["children"], ("grind",))["grind"][0]
        grind += chip["grind"]
        by_chip[name[len("gl/chip/"):]] = chip
    return by_span, by_chip, grind


def run_gl_scheme(pk, vm, trace, pv, params=None) -> tuple:
    """Phase 12, timed with nothing beside it: ``keygen_gl`` of the BabyBear
    key ``pk``, then ``prove_gl`` of the trace as one standalone shard at ``params``
    (``GlParams()``) on DEVICE, with spans, the device audit (every commit,
    record, tower layer and sumcheck bank on the card, made on the main
    thread) and K14's launch counts (reset just before, read just after).
    Returns (the ``gl_scheme`` line, the span report, K14's launches over the
    prove, which the caller checks, and (the GL key, the proof's interop dict,
    the params' dict) for the untimed verification)."""
    params = params or gpcs.GlParams()
    seconds = {}
    t0 = time.time()
    vk = gls.keygen_gl(pk)
    seconds["keygen_gl"] = time.time() - t0
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with gl_device_audit() as seen:
        gdev.reset_launches()
        t0 = time.time()
        proof = gls.prove_gl(pk, vm, trace, pv, params, device=DEVICE, vk=vk)
        sync()
        seconds["prove"] = time.time() - t0
        counted = dict(gdev.LAUNCHES)
    tree, report = spans.tree(), spans.report(min_seconds=0.05)
    spans.disable()
    checked = on_device(seen)
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    by_span, by_chip, grind = gl_span_seconds(tree)
    seconds["witgen"] = by_span.get("gl/witgen", 0.0)
    active = {vk.metas[ci].name: {"rows": k, "height": 1 << len(proof.pieces[ci].main_msgs),
                                  "tower_rounds": sum(len(m) for m in proof.pieces[ci].tower.round_msgs)}
              for ci, k in enumerate(proof.num_instances) if k}
    log(f"GL scheme: keygen_gl {seconds['keygen_gl']:.2f}s; prove_gl of {trace.n} steps, "
        f"{len(active)} active chips, in {seconds['prove']:.2f}s (grinds {grind:.2f}s); "
        f"launches {counted}; on {DEVICE}: {checked}")
    line = {"steps": trace.n, "device": DEVICE, "params": dataclasses.asdict(params),
            "seconds": seconds, "span_seconds": by_span, "grind_seconds": grind,
            "chips": by_chip, "active_chips": active,
            "tower_rounds": sum(c["tower_rounds"] for c in active.values()),
            "launches": counted, "checked_on_device": checked, "max_memory_allocated": peak,
            "proof_digest": interop.gl_zkvm_proof_digest(proof)}
    return line, report, counted, (vk, interop.gl_zkvm_proof_to_dict(proof),
                                   dataclasses.asdict(params))


def gl_scheme_tampered(proof) -> list:
    """(what, proof) pairs of tests/test_gl_scheme.py's two tampers (a
    changed ``wit_evals`` entry of the first chip, a flipped public value)
    and a changed opened row of the first chip's opening."""
    ci = next(iter(proof.pieces))
    bad_eval = copy.deepcopy(proof)
    ev = bad_eval.pieces[ci].wit_evals
    ev[0, 0] = (int(ev[0, 0]) + 1) % GL_P
    bad_pv = copy.deepcopy(proof)
    bad_pv.public_values[0] ^= np.uint64(1)
    bad_row = copy.deepcopy(proof)
    q = bad_row.pieces[ci].opening.queries[0]
    q.base_col_vals[0, 0] = (int(q.base_col_vals[0, 0]) + 1) % GL_P
    return [("witness evaluation", bad_eval), ("public value", bad_pv), ("opened row", bad_row)]


def gl_scheme_rejects(verify, bads: list, what: str) -> dict:
    """Each (what, proof) of ``bads`` must be rejected by ``verify`` with a
    protocol error; returns {what: error name}."""
    out = {}
    for name, bad in bads:
        try:
            verify(bad)
        except GL_SCHEME_ERRORS as e:
            log(f"{what}: a changed {name} rejected ({type(e).__name__}: {str(e)[:80]})")
            out[name] = type(e).__name__
        else:
            fail(f"{what}: a proof with a changed {name} was accepted")
    return out


def gl_scheme_verify_job(vk, data: dict, params: dict) -> dict:
    """In a worker: ``verify_gl`` on the host of the proof that phase 12
    proved (its interop dict), timed, then the three tampered copies, each
    of which must be rejected."""
    proof = interop.gl_zkvm_proof_from_dict(data)
    params = gpcs.GlParams(**params)
    t0 = time.time()
    if gls.verify_gl(vk, proof, params) is not True:
        fail("GL scheme: verify_gl did not accept the honest proof")
    out = {"seconds": time.time() - t0}
    log(f"GL scheme: phase 12's proof verified on the host in {out['seconds']:.2f}s")
    out["rejected"] = gl_scheme_rejects(lambda p: gls.verify_gl(vk, p, params),
                                        gl_scheme_tampered(proof), "GL scheme")
    return out


def gl_scheme_golden_standalone(want: dict | None = None) -> dict:
    """The port's ``prove_gl`` of tests/test_gl_scheme.py's setup at the small
    params on DEVICE: its digest, instance counts, public values and GL key
    must equal the reference's (GL_SCHEME_GOLDEN's ``standalone``), and
    ``verify_gl`` must accept it."""
    if want is None:
        with open(GL_SCHEME_GOLDEN) as f:
            want = json.load(f)["standalone"]
    pk, vm, trace, pv = gl_scheme_setup(GL_SCHEME_GOLDEN_ITERS, GL_SCHEME_GOLDEN_CFG, DEVICE)
    params = gpcs.GlParams(**GL_SCHEME_GOLDEN_PARAMS)
    vk = gls.keygen_gl(pk)
    if interop.gl_vk_summary(vk) != want["vk"]:
        fail("GL scheme golden: the GL key differs from the reference's")
    proof = gls.prove_gl(pk, vm, trace, pv, params, device=DEVICE, vk=vk)
    got = {"steps": trace.n, "digest": interop.gl_zkvm_proof_digest(proof),
           "num_instances": [int(k) for k in proof.num_instances],
           "public_values": [int(v) for v in proof.public_values]}
    for key, value in got.items():
        if value != want[key]:
            fail(f"GL scheme golden: standalone {key} {value} differs from the reference's "
                 f"{want[key]}")
    gls.verify_gl(vk, proof, params)
    log(f"GL scheme golden: the standalone proof of fibonacci_vm({GL_SCHEME_GOLDEN_ITERS}) "
        f"({sum(1 for k in proof.num_instances if k)} active chips) equals the reference's")
    return {"digest": got["digest"][:16], "active_chips": sum(1 for k in proof.num_instances if k)}


def gl_shard_tampered(sproof) -> list:
    """(what, sharded proof) of the chain tampers: a changed ``PV_RW_SUM_IN``
    limb of the first shard carrying tokens in (tests/test_gl_continuation.py's
    tamper), a broken pc chain, and the last shard dropped."""
    victim = next(i for i, p in enumerate(sproof.proofs)
                  if np.asarray(p.public_values)[layout.PV_RW_SUM_IN:layout.PV_RW_SUM_IN + 5].any())
    bad_sum = copy.deepcopy(sproof)
    pv = bad_sum.proofs[victim].public_values
    pv[layout.PV_RW_SUM_IN] = (int(pv[layout.PV_RW_SUM_IN]) + 1) % GL_P
    bad_pc = copy.deepcopy(sproof)
    pv = bad_pc.proofs[1].public_values
    pv[layout.PV_INIT_PC] = (int(pv[layout.PV_INIT_PC]) + 4) % GL_P
    dropped = glshard.GlShardedProof(copy.deepcopy(sproof.proofs[:-1]))
    return [("rw-sum limb", bad_sum), ("pc chain", bad_pc), ("dropped shard", dropped)]


def gl_scheme_golden_shards(want: dict | None = None) -> dict:
    """The port's ``prove_shards_gl`` of tests/test_gl_continuation.py:138's
    two-shard setup on DEVICE: each shard's digest, instance counts and public
    values must equal the reference's (GL_SCHEME_GOLDEN's ``two_shards``);
    ``verify_shards_gl`` must accept the proof and reject
    :func:`gl_shard_tampered`'s three."""
    if want is None:
        with open(GL_SCHEME_GOLDEN) as f:
            want = json.load(f)["two_shards"]
    pk, vm, trace, _ = gl_scheme_setup(GL_SCHEME_GOLDEN_ITERS, GL_SCHEME_GOLDEN_CFG, DEVICE)
    params = gpcs.GlParams(**GL_SCHEME_GOLDEN_PARAMS)
    steps = gl_golden_shard_steps(trace.n)
    if steps != want["max_steps_per_shard"]:
        fail(f"GL scheme golden: {steps} steps a shard, the reference's {want['max_steps_per_shard']}")
    sproof = glshard.prove_shards_gl(pk, vm, trace, steps, params=params, device=DEVICE)
    got = [{"digest": interop.gl_zkvm_proof_digest(p),
            "num_instances": [int(k) for k in p.num_instances],
            "public_values": [int(v) for v in p.public_values]} for p in sproof.proofs]
    if got != want["shards"]:
        fail(f"GL scheme golden: the two-shard proof differs from the reference's: "
             f"{[g['digest'][:16] for g in got]} against "
             f"{[w['digest'][:16] for w in want['shards']]}")
    vk = gls.keygen_gl(pk)
    if glshard.verify_shards_gl(vk, sproof, params=params) is not True:
        fail("GL scheme golden: verify_shards_gl did not accept the two-shard proof")
    rejected = gl_scheme_rejects(lambda p: glshard.verify_shards_gl(vk, p, params=params),
                                 gl_shard_tampered(sproof), "GL shards")
    log(f"GL scheme golden: the {len(got)} shards of fibonacci_vm({GL_SCHEME_GOLDEN_ITERS}) equal "
        f"the reference's")
    return {"digests": [g["digest"][:16] for g in got], "rejected": rejected}


def gl_scheme_jobs(pool, vk, data: dict, params: dict) -> dict:
    """Phase 12's untimed work, each in a worker of ``pool`` (pending results
    for :func:`agg_results`): the two golden proofs, then the host
    verification of phase 12's proof with its tampers."""
    return {"gl scheme golden shards": pool.apply_async(_agg_job, (_timed, gl_scheme_golden_shards)),
            "gl scheme verify": pool.apply_async(_agg_job, (gl_scheme_verify_job, vk, data, params)),
            "gl scheme golden standalone":
                pool.apply_async(_agg_job, (_timed, gl_scheme_golden_standalone))}


def gl_scheme_collect(line: dict, checks: dict) -> None:
    """Takes :func:`gl_scheme_jobs`' results out of ``checks`` (from
    :func:`agg_results`) into phase 12's ``line``: the verify and its
    seconds, and each golden proof's result and seconds."""
    line["verify"] = checks.pop("gl scheme verify")
    line["seconds"]["verify"] = line["verify"].pop("seconds")
    line["golden"] = {}
    for part in ("standalone", "shards"):
        line["golden"][part], line["seconds"][f"golden_{part}"] = \
            checks.pop(f"gl scheme golden {part}")


# -- phase 13: WHIR, the jagged PCS's third inner opening ---------------------------

WHIR_PARAMS = {"pcs_kind": "whir"}  # BasefoldParams()'s blowup 8, 29 queries and 16 PoW bits
WHIR_LOG_N = 19  # log2 rows of the 2^20 fibonacci's witness stack: WHIR's first round
WHIR_GOLDEN = os.path.join(ROOT, "ceno_tpu_torch", "golden", "whir_fibonacci.json")
# tests/test_whir.py's seeded open_whir case: the first draw of its RNG
WHIR_OPEN_CASE = {"seed": 11, "n_vars": 12, "cols": 5, "blowup_log": 2, "label": "whir-test",
                  "params": {"k": 3, "stop_vars": 5, "security_bits": 8, "pow_bits": 0}}
# the golden proofs: tests/test_whir.py::test_whir_zkvm_e2e's setup, and one
# at BasefoldParams(pcs_kind="whir")'s defaults (16-bit grinds, 29-query sets)
WHIR_GOLDEN_PROOFS = {
    "test_params": {"iters": 8, "cfg": {"shl_x_bits": 6, "mem_words_log": 7},
                    "params": {"blowup_log": 1, "n_queries": 4, "stop_size": 32,
                               "pcs_kind": "whir"}},
    "defaults": {"iters": 100, "cfg": {"shl_x_bits": 6, "mem_words_log": 7},
                 "params": WHIR_PARAMS},
}
WHIR_ERRORS = PROTOCOL_ERRORS + (whir.WhirError,)
WHIR_SPANS = ("whir/rounds", "whir/encode", "whir/tree", "whir/grind", "whir/queries")


def whir_setup(setup: dict) -> dict:
    """A golden proof's setup as the golden file names it: the params in full."""
    return {"iters": setup["iters"], "cfg": setup["cfg"],
            "params": dataclasses.asdict(bf.BasefoldParams(**setup["params"]))}


def whir_open_inputs() -> tuple:
    """WHIR_OPEN_CASE's inputs, canonical: the columns (C, 2^n), the point
    (n, 4) and each column's value there (C, 4)."""
    c = WHIR_OPEN_CASE
    rng = np.random.default_rng(c["seed"])
    cols = rng.integers(0, bb.P, size=(c["cols"], 1 << c["n_vars"])).astype(np.uint64)
    z = rng.integers(0, bb.P, size=(c["n_vars"], 4)).astype(np.uint64)
    eq = build_eq_host(z)  # (2^n, 4)
    p = np.uint64(bb.P)
    values = np.stack([(eq * col[:, None] % p).sum(axis=0) % p for col in cols])
    return cols, z, values


def transcript_state(tr) -> dict:
    """A transcript's ``export_state()`` as plain JSON data."""
    state, pos, sq_pos, absorbed = tr.export_state()
    return {"state": [int(v) for v in state], "pos": int(pos), "sq_pos": int(sq_pos),
            "absorbed": bool(absorbed)}


def whir_golden_check() -> dict:
    """The port's WHIR outputs on DEVICE against the reference's
    (WHIR_GOLDEN): WHIR_OPEN_CASE's proof digest (``interop.digest`` of its
    plain form) and the transcript's end state, then the proof of each of
    WHIR_GOLDEN_PROOFS (SHA-256 and length of ``proof_to_bytes``, the key's
    digest); the port's verifiers must accept each."""
    with open(WHIR_GOLDEN) as f:
        want = json.load(f)
    c = WHIR_OPEN_CASE
    if want["open_whir"]["setup"] != c:
        fail(f"{os.path.relpath(WHIR_GOLDEN, ROOT)} names {want['open_whir']['setup']}, "
             f"chip_smoke opens {c}")
    cols, z, values = whir_open_inputs()
    committed = bf.commit(cols, bf.BasefoldParams(blowup_log=c["blowup_log"]), device=DEVICE)
    tr = Transcript(c["label"].encode())
    proof = whir.open_whir(committed, z, values, tr, c["blowup_log"],
                           whir.WhirParams(**c["params"]))
    got = {"proof_digest": interop.digest(interop.whir_proof_to_dict(proof)),
           "transcript": transcript_state(tr)}
    if got != {k: want["open_whir"][k] for k in got}:
        fail(f"WHIR golden: the seeded open_whir differs from the reference's: "
             f"{got['proof_digest'][:16]} against {want['open_whir']['proof_digest'][:16]}")
    whir.verify_whir(committed.root, c["n_vars"], c["cols"], z, values, proof,
                     Transcript(c["label"].encode()), c["blowup_log"],
                     whir.WhirParams(**c["params"]))
    out = {"open_whir": got["proof_digest"][:16], "iterations": len(proof.iters)}
    for name, setup in WHIR_GOLDEN_PROOFS.items():
        if want[name]["setup"] != whir_setup(setup):
            fail(f"{os.path.relpath(WHIR_GOLDEN, ROOT)} names {want[name]['setup']} for {name}, "
                 f"chip_smoke proves {whir_setup(setup)}")
        cfg, params = ZKVMConfig(**setup["cfg"]), bf.BasefoldParams(**setup["params"])
        vm = programs.fibonacci_vm(setup["iters"])
        trace = native.run_trace_native(vm)
        pv = e2e.public_values_from_vm(vm, cfg)
        pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
        proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        got = proof_digests(serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params), pk)
        if got != {k: want[name][k] for k in got}:
            fail(f"WHIR golden: the {name} proof of fibonacci_vm({setup['iters']}) differs from "
                 f"the reference's: {got} against {want[name]}")
        if scheme.verify(pk.vk, proof) is not True:
            fail(f"WHIR golden: the {name} proof was not accepted")
        out[name] = {"proof_bytes": got["proof_bytes"], "sha256": got["proof_sha256"][:16]}
    log(f"WHIR golden: the seeded open_whir and the proofs of {sorted(WHIR_GOLDEN_PROOFS)} equal "
        f"the reference's and verify")
    return out


@contextlib.contextmanager
def whir_audit():
    """Over the WHIR openings made inside the block, record: the device of g
    and of the weights w at every round's start and of every new oracle's
    codeword, leaves and levels (each made on the main thread); the length
    of every round's bank; each opening's shape and each new oracle's; and
    the kernels' launches
    made inside the openings, summed. Yields (seen, info)."""
    seen = {"whir g": [], "whir w": [], "whir oracles": [], "whir trees": []}
    info = {"bank_lengths": [], "oracle_shapes": [], "openings": [],
            "launches": dict.fromkeys(launches(), 0)}
    originals = (whir._rounds, whir._new_oracle, whir.open_whir)

    def rounds(g, w, k, transcript):
        on_main_thread("WHIR rounds")
        seen["whir g"].append(g.device.type)
        seen["whir w"].append(w.device.type)
        info["bank_lengths"].append(g.shape[1])
        return originals[0](g, w, k, transcript)

    def new_oracle(g, blowup_log):
        on_main_thread("WHIR oracles")
        cw, tree = originals[1](g, blowup_log)
        seen["whir oracles"].append(cw.device.type)
        info["oracle_shapes"].append(list(cw.shape))
        seen["whir trees"] += [x.device.type for x in (tree.leaves, *tree.levels)]
        return cw, tree

    def open_whir(committed, *args, **kwargs):
        before = launches()
        proof = originals[2](committed, *args, **kwargs)
        info["launches"] = {k: v + launches()[k] - before[k] for k, v in info["launches"].items()}
        info["openings"].append({
            "n_vars": committed.n_vars, "cols": committed.cols.shape[0],
            "iterations": len(proof.iters),
            "queries": [len(it.queries.indices) for it in proof.iters]
            + [len(proof.final_queries.indices)],
            "final_vars": proof.final_g.shape[0].bit_length() - 1})
        return proof

    whir._rounds, whir._new_oracle, whir.open_whir = rounds, new_oracle, open_whir
    try:
        yield seen, info
    finally:
        whir._rounds, whir._new_oracle, whir.open_whir = originals


def whir_tampered(proof) -> list:
    """(what, proof) pairs, each one word changed in the first WHIR opening
    with an iteration (the witness's, then the fixed one's): a leaf of its
    first query set, its first OOD value, and its final function."""
    openings = [op.opening for op in (*proof.witness_openings.values(),
                                      *proof.fixed_openings.values())]
    idx = next((i for i, op in enumerate(openings) if op.iters), None)
    if idx is None:
        fail("WHIR: no opening of the proof has an iteration to tamper with")
    out = []
    for what, arr_of, index in (("query leaf", lambda op: op.iters[0].queries.leaves, (0, 0, 0)),
                                ("OOD value", lambda op: op.iters[0].y_ood, 0),
                                ("final function", lambda op: op.final_g, (0, 0))):
        bad = copy.deepcopy(proof)
        bad_openings = [op.opening for op in (*bad.witness_openings.values(),
                                              *bad.fixed_openings.values())]
        bump(arr_of(bad_openings[idx]), index)
        out.append((what, bad))
    return out


def run_whir(vm, trace, pv, n: int, cfg, params) -> tuple:
    """Phase 13, with nothing beside it: keygen at ``params`` (WHIR, timed;
    launches reset just before and read just after), one prove of the trace
    with spans, the device audit (commits, records, tower layers, banks and
    WHIR's g, w, oracles and trees on the card, each made on the main
    thread) and the launches (reset just before, read just after; those
    inside the WHIR openings counted apart), then the host verify, timed.
    Returns (the ``whir`` line, the span report, the length of every WHIR
    round's bank, (the key, the proof's bytes)); the caller checks the
    launches."""
    seconds = {}
    reset_launches()
    t0 = time.time()
    pk = scheme.keygen(vm.program, cfg, params, device=DEVICE)
    sync()
    seconds["keygen"] = time.time() - t0
    counted = {"keygen": launches()}
    if torch.device(DEVICE).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    spans.enable()
    with prove_audit() as seen, whir_audit() as (wseen, info):
        reset_launches()
        t0 = time.time()
        proof = scheme.prove(pk, vm, trace, pv, device=DEVICE)
        sync()
        seconds["prove"] = time.time() - t0
        counted["prove"] = launches()
    tree, report = spans.tree(), spans.report(min_seconds=0.01)
    spans.disable()
    checked = on_device({**seen, **wseen})
    peak = torch.cuda.max_memory_allocated() if torch.device(DEVICE).type == "cuda" else None
    counted["whir_openings"] = info["launches"]
    data = serialize.proof_to_bytes(proof, pv, pk.cfg, pk.params)
    t0 = time.time()
    if scheme.verify(pk.vk, proof) is not True:
        fail("WHIR: the verifier did not accept the honest proof")
    seconds["verify"] = time.time() - t0
    whir_spans = {name: {"seconds": s, "calls": c}
                  for name, (s, c) in span_totals(tree, WHIR_SPANS).items()}
    log(f"WHIR: keygen {seconds['keygen']:.2f}s; prove of fibonacci_vm({n}) ({trace.n} steps) "
        f"{seconds['prove']:.2f}s (grinds {whir_spans['whir/grind']['seconds']:.2f}s); verify "
        f"{seconds['verify']:.2f}s; proof {len(data)} bytes; launches in the WHIR openings "
        f"{info['launches']}; on {DEVICE}: {checked}")
    line = {"program": f"fibonacci_vm({n})", "steps": trace.n, "device": DEVICE,
            "cfg": dataclasses.asdict(pk.cfg), "params": dataclasses.asdict(pk.params),
            "seconds": seconds, "stage_seconds": stage_seconds(tree), "whir_spans": whir_spans,
            "openings": info["openings"], "oracle_shapes": info["oracle_shapes"],
            "proof_bytes": len(data),
            "max_memory_allocated": peak, "launches": counted, "checked_on_device": checked}
    return line, report, info["bank_lengths"], (pk, data)


def whir_rejects_job(vk, data: bytes) -> dict:
    """In a worker: phase 13's proof (``proof_to_bytes``) read back and
    :func:`whir_tampered`'s three changed copies verified against ``vk``,
    each of which must be rejected; returns {what: error name}."""
    proof = serialize.proof_from_bytes(data)[0]
    rejected = {}
    for what, bad in whir_tampered(proof):
        try:
            scheme.verify(vk, bad)
        except WHIR_ERRORS as e:
            log(f"WHIR: a changed {what} rejected ({type(e).__name__}: {str(e)[:80]})")
            rejected[what] = type(e).__name__
        else:
            fail(f"WHIR: a proof with a changed {what} was accepted")
    return rejected


def main() -> int:
    pools = []
    try:
        return _main(pools)
    finally:
        for pool in pools:
            pool.terminate()
            pool.join()


def _main(pools: list) -> int:
    """The phases; each worker pool it starts goes into ``pools``, which
    :func:`main` terminates."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    with phase("0 setup"):
        card = card_line()
        log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
        faulthandler.dump_traceback_later(600, exit=True)
        t = time.time()
        cuda_build.build_all()
        log(f"kernels built in {time.time() - t:.2f}s")
        ptxas = {}
        for name, out in cuda_build.build_logs.items():
            for kernel, info in ptxas_by_kernel(out).items():
                log(f"  {name}: {kernel}: {info}")
                ptxas[kernel] = info
    with phase("1 golden Merkle check"):
        golden_check()
    with phase("2 kernels against plain versions"):
        kernels, shape_rows = kernels_vs_plain(np.random.default_rng(SEED))
        torch.cuda.empty_cache()
        sc_kernels, sc_rows = sumcheck_kernels_vs_plain(np.random.default_rng(SEED + 2), ptxas)
        kernels += sc_kernels
        shape_rows += sc_rows
        torch.cuda.empty_cache()
        gl_kernels, gl_rows = gl_kernels_vs_plain(np.random.default_rng(SEED + 3), ptxas)
        kernels += gl_kernels
        shape_rows += gl_rows
    torch.cuda.empty_cache()

    with phase("3 PCS slice end to end"):
        rng = np.random.default_rng(SEED + 1)
        spans.enable()
        reset_launches()
        for name, classes in (("witness", WITNESS_CLASSES), ("fixed", FIXED_CLASSES)):
            with spans.span(name):
                run_slice(name, classes, rng, bf.BasefoldParams())
        torch.cuda.synchronize()
        pcs_launches = launches()
        pcs_report = spans.report(min_seconds=0.001)
        spans.disable()
    torch.cuda.empty_cache()

    with phase("4 GKR slice"):
        torch.cuda.reset_peak_memory_stats()
        gkr = run_gkr(GKR_ITERS)
        gkr["max_memory_allocated"] = torch.cuda.max_memory_allocated()
        check_main_path_shapes(gkr["sumcheck_shapes"])
        t = time.time()
        gkr["golden_digests"] = gkr_golden_check()
        gkr["seconds"]["golden_check"] = time.time() - t
        gkr["seconds"]["per_round"] = gkr_per_round_check(GKR_ITERS, gkr["digests"])
        gkr_report = gkr.pop("span_report")
    torch.cuda.empty_cache()

    with phase("5 e2e"):
        e2e_line, e2e_report, e2e_counted, (pk, vm, trace, proof) = run_e2e(
            E2E_ITERS, ZKVMConfig(**E2E_CFG), bf.BasefoldParams(), key_check=fixed_commit_check)
        check_duplex_steps({(a, b): c for a, b, c in e2e_line["duplex_steps"]})
    torch.cuda.empty_cache()

    with phase("6 continuations"):
        kept = {"shard-RAM 2^9 class main": main_shape(SHARD_CLASS_MAIN)}
        shard_line, shard_report, shard_counted = run_continuations(pk, vm, trace, E2E_ITERS,
                                                                    kept)
        shape_rows += real_k6a_rows(kept, ptxas)
        del kept
    torch.cuda.empty_cache()

    with phase("7 precompiles"):
        # bench.py's ZKVMConfig and BasefoldParams(), as phase 5
        kept = {"keccak core 2^15 class main": main_shape(KECCAK_CLASS_MAINS[0])}
        pre_line, pre_report, pre_counted, pre_shapes = run_keccak_loop(
            KECCAK_PERMS, ZKVMConfig(**E2E_CFG), bf.BasefoldParams(), kept)
        check_shapes_ran([main_shape(cm) for cm in KECCAK_CLASS_MAINS], pre_shapes,
                         "keccak loop's prove")
        shape_rows += real_k6a_rows(kept, ptxas)
        del kept

    with phase("8 report"):
        print(pcs_report, flush=True)
        for path, (counted, trees) in (("PCS slice (phase 3)", (pcs_launches, MAIN_PATH_TREES)),
                                       ("e2e keygen (phase 5)", e2e_counted["keygen"]),
                                       ("e2e prove (phase 5)", e2e_counted["prove"])):
            expected = {"leaf_sponge": len(trees),
                        "compress_level": sum(len(pm.merkle_plan(1 << n)) for n in trees)}
            log(f"launches over the {path}: {counted}; its {len(trees)} trees' launch plans "
                f"give {expected}")
            if {k: counted[k] for k in expected} != expected:
                fail(f"launches over the {path}: {counted}, the launch plans give {expected}")
        for k in kernels:
            if k["name"] in gdev.LAUNCHES:
                continue  # phase 11's prove counts them
            k["launches"] = e2e_counted["prove"][0][k["name"]]
            if k["launches"] <= 0:
                fail(f"kernel {k['name']} was not launched on the main path")
        print(gkr_report, flush=True)
        print(json.dumps({"gkr": gkr}), flush=True)
        print(e2e_report, flush=True)
        log(f"e2e: proof of {e2e_line['program']}: {e2e_line['proof_kib']:.1f} KiB; the "
            f"reference's, BENCH_r05.json: {REFERENCE_PROOF_KIB} KiB (an older run)")
        print(shard_report, flush=True)
        log(f"shards: launches over the sharded prove: {shard_counted}")
        for name, c in shard_counted.items():
            if c <= 0:
                fail(f"shards: kernel {name} was not launched in the sharded prove")
        print(pre_report, flush=True)
        log(f"precompiles: launches over the keccak loop's prove: {pre_counted}")
        for name, c in pre_counted.items():
            if c <= 0:
                fail(f"precompiles: kernel {name} was not launched in the keccak loop's prove")
    torch.cuda.empty_cache()

    with phase("9 aggregation"):
        kept = {f"aggregation's 2^{AGG_CLASS_MAINS[0]['log_n']} class main":
                main_shape(AGG_CLASS_MAINS[0])}
        agg_line, agg_report, agg_counted, agg_rounds, agg_data = run_aggregation(
            pk, proof, E2E_ITERS, kept)
        check_shapes_ran([main_shape(cm) for cm in AGG_CLASS_MAINS], agg_rounds,
                         "aggregation's prove")
        shape_rows += real_k6a_rows(kept, ptxas)
        del kept, proof
        torch.cuda.empty_cache()

    with phase("10 key cache"):
        cache_line = key_cache_check(pk, e2e_line["seconds"]["keygen"])
    torch.cuda.empty_cache()

    with phase("11 Goldilocks"):
        gl_line, gl_report, gl_counted = run_gl(
            trace, e2e.public_values_from_vm(vm, ZKVMConfig(**E2E_CFG)))
        for k in kernels:
            if k["name"] in gl_counted:
                k["launches"] = gl_counted[k["name"]]
                if k["launches"] <= 0:
                    fail(f"GL: kernel {k['name']} was not launched in prove_chip_gl")
    torch.cuda.empty_cache()

    with phase("12 Goldilocks scheme"):
        gs_line, gs_report, gs_counted, gs_verify_args = run_gl_scheme(
            pk, vm, trace, e2e.public_values_from_vm(vm, ZKVMConfig(**E2E_CFG)))
        gs_line["program"] = f"fibonacci_vm({E2E_ITERS})"
        for k in kernels:
            if k["name"] in gs_counted:
                k["launches_prove_chip_gl"] = k["launches"]
                k["launches"] = gs_counted[k["name"]]
                if k["launches"] <= 0:
                    fail(f"GL scheme: kernel {k['name']} was not launched in prove_gl")
    torch.cuda.empty_cache()

    with phase("13 WHIR"):
        cfg = ZKVMConfig(**E2E_CFG)
        whir_line, whir_report, whir_lengths, (whir_pk, whir_data) = run_whir(
            vm, trace, e2e.public_values_from_vm(vm, cfg), E2E_ITERS, cfg,
            bf.BasefoldParams(**WHIR_PARAMS))
        if 1 << WHIR_LOG_N not in whir_lengths:
            fail(f"WHIR: phase 2's first-round bank of 2^{WHIR_LOG_N} is not among the WHIR "
                 f"rounds' banks {sorted(set(whir_lengths))}")
        for name in ("leaf_sponge", "compress_level", "round_evals", "fold"):
            for path in ("prove", "whir_openings"):
                if whir_line["launches"][path][name] <= 0:
                    fail(f"WHIR: kernel {name} was not launched in the {path}")
        log(f"WHIR: launches over the prove {whir_line['launches']['prove']}, inside its WHIR "
            f"openings {whir_line['launches']['whir_openings']}")
        del vm, trace
    torch.cuda.empty_cache()

    with phase("9-13 untimed: golden gates, CLI, row-sharded chip, GL verify"), \
            tempfile.TemporaryDirectory() as tmp:
        # nothing is timed from here on: the golden entries and gates and the
        # checks of the parsed and the tampered proof run in workers beside
        # each other, longest first; beside them phase 10's CLI commands in
        # subprocesses and its row-sharded ranks
        pool = agg_pool(AGG_WORKERS)
        pools.append(pool)
        t = time.time()
        pending = agg_golden_check(pool)
        pending.update(gl_scheme_jobs(pool, *gs_verify_args))
        pending.update(golden_gates(pool))
        pending.update(agg_verifications(pool, pk.vk, agg_data))
        pending["whir rejects"] = pool.apply_async(_agg_job,
                                                   (whir_rejects_job, whir_pk.vk, whir_data))
        cli_line, sharded_line = run_phase10_untimed(tmp)
        checks = agg_results(pending)
        e2e_line["golden"], e2e_line["seconds"]["golden_check"] = checks.pop("e2e golden")
        shard_line["golden"], shard_line["seconds"]["golden_check"] = \
            checks.pop("shards golden")
        gl_line["golden"], gl_line["seconds"]["golden_check"] = checks.pop("gl golden")
        whir_line["golden"], whir_line["seconds"]["golden_check"] = checks.pop("whir golden")
        whir_line["rejected"] = checks.pop("whir rejects")
        del whir_pk, whir_data
        gl_scheme_collect(gs_line, checks)
        del gs_verify_args
        golden, golden_s = checks.pop("precompiles golden")
        golden["seconds"] = golden_s
        check_shapes_ran([main_shape(SECP_CLASS_MAIN)], golden["secp"].pop("sumcheck_shapes"),
                         "secp guest's prove")
        pre_line["golden"] = golden
        agg_line["rejected"] = checks.pop("public value")
        checks.pop("parsed")  # verified, or the run failed; its seconds are not kept
        agg_line["golden"] = checks
        agg_line["golden"]["seconds"] = time.time() - t
        del pk, agg_data
        print(json.dumps({"e2e": e2e_line}), flush=True)
        print(json.dumps({"shards": shard_line}), flush=True)
        print(json.dumps({"precompiles": pre_line}), flush=True)
        print(agg_report, flush=True)
        log(f"aggregation: launches over the aggregation's prove: {agg_counted}")
        for name, c in agg_counted.items():
            if c <= 0:
                fail(f"aggregation: kernel {name} was not launched in the aggregation's prove")
        print(json.dumps({"aggregation": agg_line}), flush=True)
        print(json.dumps({"key_cache": cache_line}), flush=True)
        print(json.dumps({"cli": cli_line}), flush=True)
        print(json.dumps({"sharded_chip": sharded_line}), flush=True)
        print(gl_report, flush=True)
        print(json.dumps({"gl": gl_line}), flush=True)
        print(gs_report, flush=True)
        print(json.dumps({"gl_scheme": gs_line}), flush=True)
        print(whir_report, flush=True)
        print(json.dumps({"whir": whir_line}), flush=True)
        print(json.dumps({"kernel_shapes": shape_rows}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
