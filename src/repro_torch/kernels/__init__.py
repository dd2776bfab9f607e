"""Hopper kernels of the port and their plain PyTorch versions.

* :mod:`~repro_torch.kernels.grouped_gemm` + :mod:`.group_shrink` — the
  expert server's grouped GEMM with group-shrink (paper §4.1);
* :mod:`~repro_torch.kernels.decode_attention` — dense and paged
  flash-decode;
* :mod:`~repro_torch.kernels.combine` — the top-k combine epilogue;
* :mod:`~repro_torch.kernels.autograd` — the grouped GEMM's and the
  combine's gradients (backward kernels in ``csrc/grouped_gemm_bwd.cu``)
  and stacked views of parameters;
* :mod:`~repro_torch.kernels.ops` — dispatch by device (and by grad mode);
* :mod:`~repro_torch.kernels.build` — nvcc build + ctypes load, at first
  use only.
"""
