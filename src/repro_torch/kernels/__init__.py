"""Hand-written CUDA kernels of the port and their plain PyTorch versions
(counterpart of ``repro.kernels``).  Importing this package builds nothing;
a kernel is compiled at its first launch."""
