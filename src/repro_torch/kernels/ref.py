"""Oracles for every kernel: the plain PyTorch versions, under the names
of ``src/repro/kernels/ref.py``.  Each is defined beside its kernel; the
tests compare both against the JAX package and ``chip_smoke.py`` holds each
CUDA kernel against its oracle on the card."""

from repro_torch.kernels.combine import (  # noqa: F401
    combine_weighted_torch as combine_weighted_ref)
from repro_torch.kernels.decode_attention import (  # noqa: F401
    flash_decode_torch as flash_decode_ref,
    paged_flash_decode_torch as paged_flash_decode_ref)
from repro_torch.kernels.grouped_gemm import (  # noqa: F401
    grouped_gemm_torch as grouped_gemm_ref)
