"""CLI: run / prove / verify guest programs (cargo-ceno mirror, SURVEY.md §2.7).

    python -m ceno_tpu_torch run       guest.s [--hints 1,2,3] [--max-steps N]
    python -m ceno_tpu_torch prove     guest.s [--hints ...] [-o proof.bin] [--profile test|prod]
    python -m ceno_tpu_torch verify    guest.s proof.bin
    python -m ceno_tpu_torch aggregate guest.s proof.bin [-o agg.bin]
    python -m ceno_tpu_torch stats     [guest.s] [--hints ...] [--active]

Guests are mini-assembler sources (ceno_tpu_torch/emulator/rv32im.py syntax);
hints are comma-separated u32 words placed in the private-input region.

Counterpart of ``ceno_tpu/__main__.py``: the same subcommands, arguments,
profiles, printed lines, exit codes and file formats, so each package reads
the other's proof files. The device work (keygen's fixed commit, the prove,
the aggregation's prove) runs on the CUDA card; :func:`main` takes a
``device`` for callers that name another (the tests pass ``"cpu"``). The
reference's ``CENO_TPU_HOST_N`` settings have no counterpart: the port has
no host/device size crossover.
"""

from __future__ import annotations

import argparse
import sys
import time


def _assemble(path: str):
    """The guest's program words, from its source with the platform's
    addresses filled in."""
    from .emulator.rv32im import assemble
    from .emulator.state import Platform, make_program

    rom = Platform.rom_start
    src = open(path).read().format(
        heap=Platform.heap_start, hints=Platform.hints_start
    )
    return make_program(assemble(src, rom), rom)


def _build_vm(path: str, hints: str, hints_file: str | None = None):
    from .emulator.state import Platform, VMState

    vm = VMState(_assemble(path), Platform.rom_start)
    words = []
    if hints_file:
        with open(hints_file, "rb") as f:
            raw = f.read()
        words = [
            int.from_bytes(raw[i : i + 4], "little") for i in range(0, len(raw), 4)
        ]
    elif hints:
        words = [int(x, 0) for x in hints.split(",")]
    for i, word in enumerate(words):
        vm.init_memory(Platform.hints_start + 4 * i, word)
    return vm


def _profiles(name: str):
    from .pcs.basefold import BasefoldParams
    from .zkvm.tables import ZKVMConfig

    if name == "test":
        return ZKVMConfig(shl_x_bits=10), BasefoldParams(
            blowup_log=1, n_queries=6, stop_size=32
        )
    return ZKVMConfig(), BasefoldParams()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="ceno_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("stats", help="per-circuit constraint/witness report")
    ps.add_argument("guest", nargs="?", default=None,
                    help="optional guest .s: adds instance counts per chip")
    ps.add_argument("--hints", default="")
    ps.add_argument("--active", action="store_true",
                    help="only show chips with instances")
    for name in ("run", "prove", "verify"):
        p = sub.add_parser(name)
        p.add_argument("guest")
        if name == "verify":
            p.add_argument("proof")
            p.add_argument("--profile", choices=("test", "prod"), default="prod")
            p.add_argument(
                "--public-io", default=None,
                help="comma-separated u32 words the guest must have "
                "committed (PUB_IO_COMMIT digest check)",
            )
        else:
            p.add_argument("--hints", default="")
            p.add_argument(
                "--hints-file", default=None,
                help="binary hints buffer (host.CenoStdin.to_bytes layout)",
            )
            p.add_argument("--max-steps", type=int, default=1 << 24)
        if name == "prove":
            p.add_argument("-o", "--out", default="proof.bin")
            p.add_argument("--profile", choices=("test", "prod"), default="prod")
    pa = sub.add_parser(
        "aggregate",
        help="re-prove a shard proof's verification in-circuit (recursion)",
    )
    pa.add_argument("guest")
    pa.add_argument("proof")
    pa.add_argument("-o", "--out", default="agg.bin")
    pa.add_argument("--profile", choices=("test", "prod"), default="prod")
    return ap


def main(argv=None, *, device=None) -> int:
    """Run one command; returns its exit code. ``device`` is where keygen,
    the prove and the aggregation's prove run (the card unless named)."""
    args = _parser().parse_args(argv)
    if args.cmd == "aggregate":
        return _aggregate(args, device)
    if args.cmd == "stats":
        return _stats(args)
    if args.cmd == "run":
        vm = _build_vm(args.guest, args.hints, args.hints_file)
        records = vm.run(args.max_steps)
        print(f"halted={vm.halted} exit_code={vm.exit_code} steps={len(records)}")
        return 0 if vm.halted else 1
    if args.cmd == "prove":
        return _prove(args, device)
    return _verify(args, device)


def _aggregate(args, device) -> int:
    from .zkvm.aggregate import prove_aggregation, verify_aggregation
    from .zkvm.scheme import keygen
    from .zkvm.serialize import agg_proof_to_bytes, proof_from_bytes

    cfg, params = _profiles(args.profile)
    with open(args.proof, "rb") as f:
        proof, pv, em_cfg, em_params = proof_from_bytes(f.read())
    if em_params != params or em_cfg != cfg:
        print("aggregate: FAIL — proof/profile parameter mismatch")
        return 1
    pk = keygen(_assemble(args.guest), cfg, params, device=device)
    t0 = time.time()
    key, aproof = prove_aggregation(pk.vk, proof, params=params, device=device)
    dt = time.time() - t0
    t0 = time.time()
    # key-less verification: the expected key is reconstructed from
    # (vk, params, the proof's public geometry) — the trust anchor
    if not verify_aggregation(aproof, pk.vk, params=params):
        print("aggregate: FAIL — the aggregation proof did not verify")
        return 1
    data = agg_proof_to_bytes(aproof, params)
    with open(args.out, "wb") as f:
        f.write(data)
    print(
        f"aggregated in {dt:.1f}s, verified in {time.time() - t0:.1f}s "
        f"-> {args.out} ({len(data)} bytes)"
    )
    return 0


def _stats(args) -> int:
    from .utils.stats import format_table, report
    from .zkvm.chips import build_all_chips
    from .zkvm.chips.dyn_ram import build_dyn_ram_chips
    from .zkvm.chips.shard_ram import build_shard_chips
    from .zkvm.tables import ZKVMConfig, build_tables

    cfg = ZKVMConfig(shl_x_bits=6)
    opcode_chips = build_all_chips()
    shard_chips = build_shard_chips()
    dyn_chips = build_dyn_ram_chips(cfg)
    assigned = None
    if args.guest:
        from .zkvm.e2e import public_values_from_vm
        from .zkvm.witgen import generate_witness

        vm = _build_vm(args.guest, args.hints)
        records = vm.run()
        tables = build_tables(vm.program, cfg)
        pv = public_values_from_vm(vm, cfg)
        assigned = generate_witness(
            records, opcode_chips, tables, vm, pv, cfg,
            shard_chips=shard_chips, dyn_chips=dyn_chips,
        )
        print(f"guest: {len(records)} steps, exit {vm.exit_code}")
    else:
        tables = build_tables({0x02000000: 0x73}, cfg)
    print(format_table(
        report(opcode_chips, shard_chips, dyn_chips, tables, assigned),
        only_active=args.active,
    ))
    return 0


def _prove(args, device) -> int:
    from .zkvm.e2e import run_e2e
    from .zkvm.serialize import proof_to_bytes

    cfg, params = _profiles(args.profile)
    vm = _build_vm(args.guest, args.hints, args.hints_file)
    t0 = time.time()
    res = run_e2e(vm, cfg, params, args.max_steps, device=device)
    data = proof_to_bytes(res.proof, res.public_values, cfg, params)
    with open(args.out, "wb") as f:
        f.write(data)
    print(
        f"proved {res.n_steps} steps in {time.time() - t0:.1f}s -> "
        f"{args.out} ({len(data)} bytes)"
    )
    return 0


def _verify(args, device) -> int:
    """Re-derive the vk from the guest (keygen is deterministic) and verify.

    cfg/params are PINNED verifier-side (--profile): proof bytes are
    untrusted, so the embedded copies are only cross-checked, never used
    (an attacker must not get to choose n_queries / blowup — ADVICE.md)."""
    from .zkvm.scheme import keygen, verify
    from .zkvm.serialize import proof_from_bytes

    cfg, params = _profiles(args.profile)
    with open(args.proof, "rb") as f:
        proof, pv, em_cfg, em_params = proof_from_bytes(f.read())
    if em_params != params or em_cfg != cfg:
        print(
            f"verify: FAIL — proof was produced under different parameters "
            f"than the pinned --profile {args.profile} "
            f"(embedded {em_params}, pinned {params})"
        )
        return 1
    pk = keygen(_assemble(args.guest), cfg, params, device=device)
    t0 = time.time()
    ok = verify(pk.vk, proof)
    pv = proof.public_values
    if ok and args.public_io is not None:
        from .emulator.keccak import public_io_digest_words
        from .zkvm.layout import PV_PUBIO_DIGEST

        words = [int(x, 0) for x in args.public_io.split(",")] if args.public_io else []
        expect = public_io_digest_words(words)
        got = [
            int(pv[PV_PUBIO_DIGEST + 2 * i])
            | (int(pv[PV_PUBIO_DIGEST + 2 * i + 1]) << 16)
            for i in range(8)
        ]
        if got != expect:
            print("verify: FAIL — public-io digest mismatch")
            return 1
    exit_code = int(pv[4]) | (int(pv[5]) << 16)
    print(
        f"verify: {'OK' if ok else 'FAIL'} ({time.time() - t0:.1f}s) "
        f"exit_code={exit_code} cycles={int(pv[3]) - int(pv[2])}"
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
