"""Hopper kernels of the port and their plain PyTorch versions.

* :mod:`~repro_torch.kernels.grouped_gemm` + :mod:`.group_shrink` — the
  expert server's grouped GEMM with group-shrink (paper §4.1);
* :mod:`~repro_torch.kernels.decode_attention` — dense flash-decode;
* :mod:`~repro_torch.kernels.combine` — the top-k combine epilogue;
* :mod:`~repro_torch.kernels.ops` — dispatch by device;
* :mod:`~repro_torch.kernels.build` — nvcc build + ctypes load, at first
  use only.
"""
