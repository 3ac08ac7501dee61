"""What the two fused matrix-product kernels (``swiglu``,
``rmsnorm_matmul``) share on the Python side: the plan of their common
wgmma body (``csrc/gemm_wgmma.cuh``: token and column tiles, split-K
slices, workspace), their input checks, and the limit a kernel's output
is held to against its plain version on the same bf16 values."""
from __future__ import annotations

import dataclasses
import functools

import torch

# The body's tiling (csrc/gemm_wgmma.cuh): a block owns bm output columns,
# 128 or 64 (a consumer warpgroup for each 64: wgmma's M), and up to
# BN_MAX tokens (wgmma's N; an accumulator a thread for every two tokens,
# so 128 keeps SwiGLU's two products at 128 registers); a pipeline stage
# is BK of the sum.
BK = 64
BN_MAX = 128
# Split-K: cut K in MAX_SPLITS slices where the output tiles are fewer than
# the H100's SMS, while each slice keeps MIN_STEPS stages (the ring fills
# once a block) and splits * bn stays within k / 12: the fp32 partials
# (written, then read back by the tile's last block) cost more than their
# bytes, since the last block sums them after the stream.  The rule
# follows launch/gemm_sweep.py's split counts at the main shapes on the
# H100.  SwiGLU's down product takes 64-column tiles (fixed in
# csrc/swiglu.cu): more tiles, fewer partials, faster there than 128 at
# four of the five main shapes (PERF.md).
SMS = 132
MAX_SPLITS = 2
MIN_STEPS = 4


@dataclasses.dataclass(frozen=True)
class Plan:
    """One product's tiling: out [t, n] = act [t, k] @ W [k, n] for ``nb``
    weights.  K is cut into ``splits`` slices of ``q`` steps of BK (the
    last may be shorter); grid (token tiles of bn, column tiles of bm,
    splits)."""
    t: int
    k: int
    n: int
    nb: int
    bn: int
    bm: int
    q: int

    @property
    def nk(self) -> int:
        return -(-self.k // BK)

    @property
    def splits(self) -> int:
        return -(-self.nk // self.q)

    @property
    def tiles(self) -> int:
        return -(-self.t // self.bn) * -(-self.n // self.bm)

    def slices(self) -> list:
        """[(first, end)) k-steps of each slice, in slice order."""
        return [(s * self.q, min((s + 1) * self.q, self.nk))
                for s in range(self.splits)]

    def partial_floats(self) -> int:
        """The fp32 partials of the split (0 without one): a block's
        accumulators, bm x bn for each weight."""
        if self.splits == 1:
            return 0
        return self.tiles * self.splits * self.nb * self.bm * self.bn


@functools.lru_cache(maxsize=1024)
def plan(t: int, k: int, n: int, nb: int = 1, bm: int = 128) -> Plan:
    """The body's plan for ``t`` tokens, a sum of ``k`` and ``n`` output
    columns in tiles of ``bm`` (128 or 64) with ``nb`` weights: the token
    tile is the power of two from 8 to BN_MAX that holds t (a chunk of
    more takes several), and K is split as the constants above say.
    SwiGLU's gate-up (``nb`` 2) takes no split: its arrival counts would
    need zeroing by a launch ahead of it, and with one (a zeroing kernel
    it depends on) the call measured slower on the H100 than unsplit.  A
    function of the shapes alone."""
    bn = 8
    while bn < min(t, BN_MAX):
        bn *= 2
    nk = -(-k // BK)
    if nb == 2:
        return Plan(t, k, n, nb, bn, bm, nk)
    tiles = -(-max(t, 1) // bn) * -(-n // bm)
    fill = max(1, SMS // tiles)
    traffic = max(1, k // (12 * bn))
    steps = max(1, nk // MIN_STEPS)
    splits = min(MAX_SPLITS, fill, traffic, steps)
    return Plan(t, k, n, nb, bn, bm, -(-nk // splits))


def swiglu_plans(t: int, d: int, ff: int) -> tuple:
    """(gate-up, down) plans of a SwiGLU call: one token tile for both,
    the split (if any) in the down product's sum over ff, over 64-column
    tiles."""
    return plan(t, d, ff, 2), plan(t, ff, d, 1, bm=64)


def _up256(n: int) -> int:
    return -(-n // 256) * 256


def workspace_bytes(p: Plan, inv_rows: int = 0) -> int:
    """Bytes of the body's workspace for the product ``p``, the one a call
    may split (csrc/gemm_wgmma.cuh Workspace): an int32 arrival count a
    tile, then ``inv_rows`` fp32 1/rms values, then the partials; each part
    256-byte aligned."""
    return (_up256(4 * p.tiles) + _up256(4 * inv_rows)
            + _up256(4 * p.partial_floats()))


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
