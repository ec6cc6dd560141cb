"""zkVM layout constants: public-value slots, lookup tags, timestamp model.

Mirror of the reference's PublicValues (scheme.rs:92-104) and the 4-subcycle
timestamp model (tracer.rs:306). Public values are instance slots shared by
every chip's constraint system. Round 2 adds the continuation slots:
shard_id plus the two per-shard EC sums of the cross-shard RAM multiset hash
(affine septic points, 14 base elements each — the reference's
``shard_rw_sum`` split into import/export trees; (0,..,0) = infinity).

Copy of ``ceno_tpu/zkvm/layout.py``: the port keeps its own, with the same
relative imports.
"""

# public value indices
PV_INIT_PC = 0
PV_END_PC = 1
PV_INIT_CYCLE = 2
PV_END_CYCLE = 3
PV_EXIT_CODE_LO = 4
PV_EXIT_CODE_HI = 5
PV_SHARD_ID = 6
PV_RW_SUM_IN = 7     # 14 slots: x[0..7), y[0..7) of the import-tree sum
PV_RW_SUM_OUT = 21   # 14 slots: export-tree sum
PV_HEAP_WORDS = 35   # dynamic heap length (dyn_heap init/final instance count)
PV_STACK_WORDS = 36  # dynamic stack length (words below stack_top)
PV_PUBIO_DIGEST = 37  # 16 slots: u16 limbs (lo, hi per word) of the 8-word
# PUB_IO_COMMIT Keccak-256 digest (e2e.rs:71-85, precompiles/pubio_commit.rs)
PV_INFO_WORDS = 53   # dynamic info-out (guest println) region length
N_PUBLIC_VALUES = 54

TS_MAX_BITS = 28  # cur_ts - prev_ts - 1 decomposes into u16 + u12
