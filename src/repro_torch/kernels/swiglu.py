"""Fused SwiGLU MLP: ``bf16(bf16(silu(x @ w1) * (x @ w3)) @ w2)``.

CUDA kernel: ``csrc/swiglu.cu``, which replaces the TPU kernel
``repro/kernels/swiglu.py:40`` (``swiglu``): a gate-up launch writes the
bf16 hidden h to a [T, ff] workspace, a down launch multiplies it by w2;
both on the shared wgmma body fed by TMA (``csrc/gemm_wgmma.cuh``), fp32
sums, the down product with a deterministic split-K where its output
tiles are few (no float atomics: a second launch repeats the first bit
for bit).  The wrapper plans the products (``_gemm.swiglu_plans``),
allocates h and the workspace, launches the pair and counts it as one
launch.

Plain version: :func:`swiglu_plain`, the Pallas kernel's function with
its casts, not the jnp oracle's: both products and the gate in fp32, h
rounded to the input dtype, the down projection summed in fp32 and
rounded.  (``repro.kernels.ref.swiglu_ref`` rounds ``x @ w1`` and
``x @ w3`` to bf16 first, and so differs by design.)  The model's own
``mlp_block`` stays unfused, as the reference's.
"""
from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, _gemm, _paged

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("swiglu", "swiglu",
                       [_P] * 7 + [ctypes.c_longlong] + [_I] * 5 + [_P])


def swiglu_hidden(x: torch.Tensor, w1: torch.Tensor,
                  w3: torch.Tensor) -> torch.Tensor:
    """h = silu(x @ w1) * (x @ w3), products and gate in fp32, rounded to
    x's dtype: x [T, d]; w1, w3 [d, ff] -> [T, ff]."""
    xf = x.float()
    return (F.silu(xf @ w1.float()) * (xf @ w3.float())).to(x.dtype)


def swiglu_plain(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
                 w2: torch.Tensor) -> torch.Tensor:
    """x [T, d]; w1, w3 [d, ff]; w2 [ff, d] -> [T, d] in x's dtype."""
    return (swiglu_hidden(x, w1, w3).float() @ w2.float()).to(x.dtype)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    """x [T, d]; w1, w3 [d, ff]; w2 [ff, d] -> [T, d].  CPU tensors take
    the plain version (bf16 or fp32); CUDA tensors launch the kernel (bf16,
    contiguous, d and ff multiples of 16; any T)."""
    if x.dim() != 2 or w1.dim() != 2:
        raise ValueError(f"swiglu: x must be [T, d] and w1 [d, ff], got "
                         f"{tuple(x.shape)}, {tuple(w1.shape)}")
    t, d = x.shape
    ff = w1.shape[1]
    _gemm.check("swiglu", x, {"w1": (w1, (d, ff)), "w3": (w3, (d, ff)),
                              "w2": (w2, (ff, d))})
    if x.device.type == "cpu":
        return swiglu_plain(x, w1, w3, w2)
    y = _launch(x, w1, w3, w2, _gemm.swiglu_plans(t, d, ff)[1])
    _paged.count_launch(swiglu)
    return y


def _launch(x, w1, w3, w2, down: _gemm.Plan) -> torch.Tensor:
    """The kernel on checked CUDA inputs, with the down product's plan
    ``down`` (``_gemm.swiglu_plans``'s; launch/gemm_sweep.py passes other
    split counts); counts nothing."""
    t, d = x.shape
    ff = w1.shape[1]
    h = torch.empty((t, ff), dtype=x.dtype, device=x.device)
    y = torch.empty((t, d), dtype=x.dtype, device=x.device)
    ws = torch.empty(_gemm.workspace_bytes(down), dtype=torch.uint8,
                     device=x.device)
    rc = _kernel()(x.data_ptr(), w1.data_ptr(), w3.data_ptr(), w2.data_ptr(),
                   h.data_ptr(), y.data_ptr(), ws.data_ptr(), ws.numel(), t,
                   d, ff, down.bn, down.q, _paged.stream_ptr(x))
    if rc:
        raise RuntimeError(f"swiglu launch failed: CUDA error {rc}")
    return y


swiglu.launches = 0
