"""A CPU rehearsal of ``chip_smoke.py``'s continuations phase (phase 6).

``shard_golden_check`` on CPU tensors: the port's ``prove_shards``, with its
pipeline (each shard's witgen on a host thread), of ``fibonacci_vm(12)`` at
``tests/test_shard.py``'s setup, under the device audit (every commit,
record, tower layer and sumcheck bank made on the main thread). Each shard's
proof must have the SHA-256 and length that the reference's has
(``ceno_tpu_torch/golden/shard_fibonacci.json``); ``tests/test_torch_shard.py``
holds the sequential path against the reference's bytes and the same file,
so the pipelined proofs equal the sequential ones. ``verify_shards`` must
accept the proof and reject each tampered one.
"""

import json

import pytest
import torch

import chip_smoke

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def golden():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(chip_smoke, "DEVICE", "cpu")
        return chip_smoke.shard_golden_check()


def test_pipelined_proofs_equal_the_golden_digests(golden):
    with open(chip_smoke.SHARD_GOLDEN) as f:
        want = json.load(f)
    assert {k: golden[k] for k in ("n_shards", "shards")} == \
        {k: want[k] for k in ("n_shards", "shards")}
    assert golden["n_shards"] == 3


def test_tampered_sharded_proofs_rejected(golden):
    errors = golden["rejected"]
    assert list(errors) == ["pc chain", "cycle chain", "rw sum", "dropped shard",
                            "standalone shard 1"]
    # the chain check meets a broken chain before the shard's own proof
    assert errors["pc chain"].startswith("ShardChainError: shard 1: pc chain broken")
    assert errors["cycle chain"].startswith("ShardChainError: shard 1: cycle chain broken")
    assert errors["dropped shard"] == "ZKVMError: final shard must halt exactly once (got 0)"
    assert errors["standalone shard 1"] == "ZKVMError: standalone proof must be shard 0"


def test_device_work_audited_on_the_main_thread(golden):
    checked = golden["checked_on_device"]
    assert set(checked) == {"layers", "banks", "commits", "records"}
    assert checked["commits"] == 2 * golden["n_shards"] and min(checked.values()) > 0


def test_device_work_off_the_main_thread_fails():
    import threading

    out = []
    th = threading.Thread(target=lambda: out.append(_fails(lambda: chip_smoke.on_main_thread("x"))))
    th.start()
    th.join()
    assert out == [True]
    chip_smoke.on_main_thread("x")


def _fails(fn) -> bool:
    try:
        fn()
    except SystemExit as e:
        return "not the main thread" in str(e)
    return False


def test_spans_from_threads_lose_no_update():
    """The witgen thread and the main thread open spans in one tree: with
    more threads than cores and a short switch interval, every span is
    counted, each thread's nesting stays its own."""
    import sys
    import threading

    from ceno_tpu_torch.utils import spans

    n_threads, n_spans = 8, 500
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    spans.enable()
    try:
        def work():
            for _ in range(n_spans):
                with spans.span("witgen"):
                    with spans.span("tables"):
                        pass

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
        tree = spans.tree()
    finally:
        spans.disable()
        sys.setswitchinterval(old)
    assert list(tree) == ["witgen"]
    assert tree["witgen"]["count"] == n_threads * n_spans
    assert list(tree["witgen"]["children"]) == ["tables"]
    assert tree["witgen"]["children"]["tables"]["count"] == n_threads * n_spans
