"""Hand-written CUDA kernels for Hopper (sources in ``../csrc``), each
beside its plain PyTorch version.  A wrapper runs the plain version for
CPU tensors and launches its kernel for CUDA tensors, counting launches
in its ``launches`` attribute.

Each kernel follows the ``<name>.py`` (wrapper, plain version, launch
count) / ``../csrc/<name>.cu`` (the kernel) convention; ``ops.py`` is the
public entry point, the reference's layout adapters over the port's
kernels."""
