"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each
beside its plain PyTorch version.  A wrapper runs the plain version for
CPU tensors and launches its kernel for CUDA tensors, counting launches
in its ``launches`` attribute."""
