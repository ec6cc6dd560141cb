"""Port parity of the whole proof of ``tests/test_curves.py``'s secp guest
(secp256k1 double, add, scalar invert and decompress): the curve calls are
not in the native core, so both packages' ``run_e2e`` run the Python
interpreter. The port's ``proof_to_bytes`` equals the reference's and the
``fast`` entry of ``ceno_tpu_torch/golden/precompile_guests.json``, each
verifier accepts the other's proof, and the port's prove runs the 2-row
class main of ``chip_smoke.PRECOMPILE_CLASS_MAINS`` (its four curve chips,
lw, halt and global). About two minutes on one CPU thread."""

import torch

from test_curves import SECP_GUEST
from test_torch_precompile_e2e import proof_parity

import chip_smoke

torch.set_num_threads(1)


def test_secp_guest_is_the_reference_tests():
    assert chip_smoke.secp_guest_src() == SECP_GUEST


def test_secp_proof_bytes_equal_golden_and_cross_verified():
    """... and the prove runs the secp class main phase 2 holds K6a at."""
    _, port, shapes = proof_parity("secp")
    active = {m.name for m, k in zip(port.pk.metas, port.proof.num_instances) if k}
    assert {"secp256k1_add", "secp256k1_double", "secp256k1_decompress",
            "secp256k1_invert"} <= active
    assert chip_smoke.main_shape(chip_smoke.SECP_CLASS_MAIN) in shapes
