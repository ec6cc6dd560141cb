"""ceno-tpu-torch: the PyTorch/CUDA port of ``ceno_tpu``.

Module paths and public names mirror ``ceno_tpu/`` so that each module's
counterpart is found by its path. Device tensors hold BabyBear elements in
Montgomery form as ``torch.int32`` (every value is below p < 2^31), and
Goldilocks elements (``gl/``) as canonical uint64 bit patterns in
``torch.int64``; host-side protocol code (transcript, verifiers) works on
canonical numpy ``uint64`` as the reference does. Entry points run on the CUDA card unless the caller passes
``device="cpu"``; the hand-written Hopper kernels live in ``csrc/``.

The package imports neither ``jax`` nor ``ceno_tpu``.
"""

__version__ = "0.1.0"

DEFAULT_DEVICE = "cuda"
