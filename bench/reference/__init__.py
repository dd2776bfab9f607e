"""Plain PyTorch references of the benchmark's configurations: float32,
no kernels, no cache, no batching.  They import nothing of the program."""
