"""Input checks shared by the two fused matrix-product kernels (``swiglu``,
``rmsnorm_matmul``; see ``csrc/gemm_bf16.cuh`` for their common tile
product), and the limit a kernel's output is held to against its plain
version on the same bf16 values."""
from __future__ import annotations

import torch

# |kernel - plain| <= GEMM_REL * |plain| + GEMM_SUM * (|lhs| @ |rhs|)
# + GEMM_ABS, elementwise, for y = lhs @ rhs rounded to bf16 (lhs the
# rounded h of SwiGLU or hn of RMSNorm, rhs the weights):
# - GEMM_REL: one bf16 step of the output, where the two fp32 sums fall on
#   either side of a rounding boundary;
# - GEMM_SUM: the fp32 sums themselves, taken in another order (and with
#   an lhs element now and then one bf16 step apart, where its own fp32
#   sums straddle a boundary).  A product's output is a signed sum that
#   cancels, so its own size is no scale for that noise near zero; the sum
#   of the terms' sizes is.  Reordering a 5632-term sum in tiles of 64 or
#   512 reaches ~0.2 of this limit; dropping one 64-wide tile exceeds it
#   many times over (tests/test_torch_ops.py);
# - GEMM_ABS: a floor for outputs that are exactly zero.
GEMM_REL = 2.0 ** -7
GEMM_SUM = 2.0 ** -12
GEMM_ABS = 1e-5


def gemm_limit(plain: torch.Tensor, lhs: torch.Tensor,
               rhs: torch.Tensor) -> torch.Tensor:
    """The elementwise limit on |kernel - plain| for ``plain`` =
    bf16(lhs @ rhs), in fp32 (see the constants above)."""
    mag = lhs.float().abs() @ rhs.float().abs()
    return GEMM_REL * plain.float().abs() + GEMM_SUM * mag + GEMM_ABS


def gemm_excess(out: torch.Tensor, plain: torch.Tensor, lhs: torch.Tensor,
                rhs: torch.Tensor) -> tuple:
    """(max |out - plain|, max of |out - plain| / limit): the output is
    within the limit when the second is at most 1."""
    diff = (out.float() - plain.float()).abs()
    return (float(diff.max()),
            float((diff / gemm_limit(plain, lhs, rhs)).max()))


def check(name: str, x: torch.Tensor, weights: dict) -> None:
    """Validate a fused-product call: x [T, d]; ``weights`` maps each
    weight's name to (tensor, the shape it must have); one dtype and one
    device for all.  The plain version (CPU) takes bf16 or fp32; the CUDA
    kernel bf16, contiguous and 16-byte aligned, widths multiples of 16.
    Raises ValueError/TypeError."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be [T, d], got {tuple(x.shape)}")
    for wname, (w, shape) in weights.items():
        if tuple(w.shape) != tuple(shape):
            raise ValueError(f"{name}: {wname} must be {tuple(shape)}, got "
                             f"{tuple(w.shape)}")
        if w.dtype != x.dtype:
            raise TypeError(f"{name}: {wname} is {w.dtype}, x {x.dtype}")
    tensors = [x] + [w for w, _ in weights.values()]
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{name}: all inputs must be on one device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    if x.device.type == "cpu":
        if x.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"{name}: the plain version takes bf16 or fp32, "
                            f"got {x.dtype}")
        return
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{name}: the CUDA kernel takes bf16, got {x.dtype}")
    widths = {x.shape[1]} | {n for _, s in weights.values() for n in s}
    if any(n % 16 for n in widths):
        raise ValueError(f"{name}: the CUDA kernel needs widths that are "
                         f"multiples of 16, got {sorted(widths)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: the CUDA kernel needs 16-byte aligned "
                         "inputs")
