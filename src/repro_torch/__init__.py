"""PyTorch/CUDA port of the EaaS serving system (``src/repro`` is the JAX
reference).

The package mirrors the reference layout — ``configs``, ``kernels``,
``models``, ``core``, ``serving``, ``training``, ``launch`` — with the same
module and function names,
so each function has an obvious counterpart.  It imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of ``repro``.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version instead.  The CUDA kernels (``csrc/*.cu``) are compiled with
``nvcc`` at first use, never at import.
"""
