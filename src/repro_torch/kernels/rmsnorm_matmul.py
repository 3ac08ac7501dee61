"""RMSNorm fused into the projection after it:
``bf16(bf16(bf16(x * rsqrt(mean(x^2) + eps)) * w_norm) @ w_proj)``.

CUDA kernel: ``csrc/rmsnorm_matmul.cu``, which replaces the TPU kernel
``repro/kernels/rmsnorm_matmul.py:31`` (``rmsnorm_matmul``): a stats
launch takes each row's 1/rms once, then the shared wgmma body
(``csrc/gemm_wgmma.cuh``) streams w_proj, x and w_norm by TMA while its
normalisers turn each x tile into hn in shared memory, with fp32 sums
and a deterministic split-K where the output tiles are few.  The wrapper
plans the product (``_gemm.plan``) and allocates the workspace.

Plain version: :func:`rmsnorm_matmul_plain`, the Pallas kernel's
function with its casts: the statistics in fp32, the normalised x rounded
to the input dtype, the product with w_norm in the input dtype (two
roundings), the projection summed in fp32 and rounded.  The model's
block entries and LM head stay unfused, as the reference's.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build, _gemm, _paged
from repro_torch.models.common import rmsnorm

_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _kernel():
    return _build.load("rmsnorm_matmul", "rmsnorm_matmul",
                       [_P] * 5 + [ctypes.c_longlong] + [_I] * 3
                       + [ctypes.c_float] + [_I] * 2 + [_P])


def rmsnorm_matmul_plain(x: torch.Tensor, w_norm: torch.Tensor,
                         w_proj: torch.Tensor, *,
                         eps: float = 1e-5) -> torch.Tensor:
    """x [T, d]; w_norm [d]; w_proj [d, F] -> [T, F] in x's dtype."""
    hn = rmsnorm(x, w_norm, eps)
    return (hn.float() @ w_proj.float()).to(x.dtype)


def rmsnorm_matmul(x: torch.Tensor, w_norm: torch.Tensor,
                   w_proj: torch.Tensor, *, eps: float = 1e-5) -> torch.Tensor:
    """x [T, d]; w_norm [d]; w_proj [d, F] -> [T, F].  CPU tensors take
    the plain version (bf16 or fp32); CUDA tensors launch the kernel (bf16,
    contiguous, d and F multiples of 16; any T)."""
    if x.dim() != 2 or w_proj.dim() != 2:
        raise ValueError(f"rmsnorm_matmul: x must be [T, d] and w_proj "
                         f"[d, F], got {tuple(x.shape)}, "
                         f"{tuple(w_proj.shape)}")
    t, d = x.shape
    f = w_proj.shape[1]
    _gemm.check("rmsnorm_matmul", x, {"w_norm": (w_norm, (d,)),
                                      "w_proj": (w_proj, (d, f))})
    if x.device.type == "cpu":
        return rmsnorm_matmul_plain(x, w_norm, w_proj, eps=eps)
    y = _launch(x, w_norm, w_proj, eps, _gemm.plan(t, d, f))
    _paged.count_launch(rmsnorm_matmul)
    return y


def _launch(x, w_norm, w_proj, eps: float, pl: _gemm.Plan) -> torch.Tensor:
    """The kernel on checked CUDA inputs, with the plan ``pl``
    (``_gemm.plan``'s; launch/gemm_sweep.py passes other split counts);
    counts nothing."""
    t, d = x.shape
    f = w_proj.shape[1]
    y = torch.empty((t, f), dtype=x.dtype, device=x.device)
    ws = torch.empty(_gemm.workspace_bytes(pl, inv_rows=t),
                     dtype=torch.uint8, device=x.device)
    rc = _kernel()(x.data_ptr(), w_norm.data_ptr(), w_proj.data_ptr(),
                   y.data_ptr(), ws.data_ptr(), ws.numel(), t, d, f, eps,
                   pl.bn, pl.q, _paged.stream_ptr(x))
    if rc:
        raise RuntimeError(f"rmsnorm_matmul launch failed: CUDA error {rc}")
    return y


rmsnorm_matmul.launches = 0
