"""Guest debug-output (println) channel.

Mirror of the reference's host message reader
(ceno_emul/src/host_utils.rs:11-45 + ceno_rt INFO_OUT_ADDR): guests write
length-prefixed byte messages to the info-out region with plain stores —
one u32 byte-length word, then ceil(len/4) little-endian data words — and
the host reads them back after execution. The region is covered by the
dynamic info RAM chips, so a proved trace binds exactly what was printed.

Copy of ``ceno_tpu/host/messages.py``, with the same relative imports:
:func:`run` emulates through the port's ``emulator/native.run_trace``, which
falls back to the Python interpreter where the native core does not build.
"""

from __future__ import annotations


def read_all_messages(vm) -> list[bytes]:
    """All length-prefixed messages from the guest's info-out region."""
    base = vm.platform.info_start >> 2
    end = vm.platform.info_end >> 2
    out = []
    w = base
    while w < end:
        byte_len = vm.mem.get(w, 0)
        if byte_len == 0:
            break
        n_words = (byte_len + 3) // 4
        data = bytearray()
        for i in range(n_words):
            data += int(vm.mem.get(w + 1 + i, 0)).to_bytes(4, "little")
        out.append(bytes(data[:byte_len]))
        w += 1 + n_words
    return out


def run(vm, max_steps: int = 1 << 24) -> list[bytes]:
    """ceno_host::run mirror: execute the guest, return its messages."""
    from ..emulator import native

    native.run_trace(vm, max_steps)
    return read_all_messages(vm)
