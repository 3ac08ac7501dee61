"""Input checks, launch geometry and the limit against their plain
versions shared by the attention kernels (``span_attention``,
``decode_attention``), paged and contiguous; see
``csrc/span_attention_tiled.cuh``, ``csrc/span_attention_quant_tiled.cuh``,
``csrc/decode_attention_split.cuh`` and
``csrc/decode_attention_quant_split.cuh`` for the kernels' bodies.

Two cache layouts: paged, [n_blocks, bs, Kv, hd] leaves read through
[B, nb] int32 block tables; and contiguous rows, [R, S, Kv, hd] leaves
indexed by an int32 row per token or per decode row (``block_tables``
None below).  int8 scales drop the last axis."""
from __future__ import annotations

import contextlib
import threading

import torch

from repro_torch.models.attention import decode_quant_pv

# A kernel (bf16 in, fp32 inside, bf16 out) against its plain version run
# in fp32 on the same values: |kernel - plain| <= KERNEL_REL * |plain| +
# KERNEL_ABS, one bf16 step of the output (2^-7 relative; rounding moves it
# by half that) plus fp32 summation-order noise.  Dropping one of n
# visible slots moves an output by ~|v|/n, ~1e-3 at n = 1000: several
# steps of a typical output.  chip_smoke.py holds every attention kernel to
# it; tests/test_torch_rolling_tiles.py shows that the tiled rolling body
# needs its probabilities as bf16 hi + lo to stay inside it.
KERNEL_REL = 2.0 ** -7
KERNEL_ABS = 1e-5

# The int8 decode kernels (csrc/decode_attention_quant.cu: rows 2b, 2bc,
# 2br and 2bcr) normalise the softmax over the whole context, then quantize
# x = p * vs / scale to p8 = round(x) (scale = max |p * vs| / 127 + 1e-8 per
# (row, head)).  The kernel sums the denominator S = sum of e_s =
# exp(score_s - max) in another order than the plain version (per chunk of
# DECODE_SPLIT slots lane-strided partial sums, then a butterfly; the
# chunks in order), so an x that lies on a rounding half-integer can give a
# p8 one step apart, and an output element then moves by ps * |v8[s, d]|,
# more than the limit above where |plain| is small.  QUANT_FLIP_TERM's
# bound on that:
# - both sums are of the same fp32 e_s (same scores, same expf), each
#   within gamma(n - 1) * S of the exact sum in any order (n visible slots,
#   gamma(k) = k u / (1 - k u), u = 2^-24: the fp32 unit roundoff), so the
#   two differ by a relative eps <= 2 gamma(n - 1);
# - a relative change eps of S moves every p * vs by -eps, the scale's
#   max |p * vs| / 127 part with them, but not its 1e-8: x moves by
#   |x| * eps * 1e-8 / scale;
# - each version rounds 7 times on the way to x (e / S, * vs, / scale; in
#   the scale e / S, * vs, / 127, + 1e-8): 14 u of |x| more between them.
# So slot s's two p8 agree unless the plain version's x lies within
# delta_s = |x_s| * (2 gamma(n - 1) * 1e-8 / scale + 14 u) of a half-integer,
# and the term adds, for each output element, ps * sum |v8[s, d]| over those
# slots: one p8 step at each.  A ps one bf16 step apart (the scale itself on
# a rounding boundary) moves the output by 2^-8 relative, inside
# KERNEL_REL.  The span kernels quantize per tile under a running max: the
# term is not theirs.
FP32_UNIT = 2.0 ** -24
QUANT_X_ROUNDINGS = 7


def quant_decode_x(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                   vs: torch.Tensor, positions: torch.Tensor, *,
                   rolling_window: int = 0):
    """The int8 decode plain version's x = p * vs / scale [B, Kv, g, S], the
    half-integer distance each slot's p8 is safe within (delta, the same
    shape; 0 where no slot is visible) and the bf16 scale ps [B, Kv, g].
    Caches in rows: k8 [B, S, Kv, hd], ks/vs [B, S, Kv] (a paged cache's
    gathered view)."""
    pv, valid = decode_quant_pv(q.float(), k8, ks, vs, positions,
                                rolling_window=rolling_window)
    amax = pv.abs().amax(-1)
    scale = amax / torch.full_like(amax, 127.0) + 1e-8   # as quantize_kv
    x = pv / scale[..., None]
    k = (valid.sum(-1).double() - 1).clamp(min=0)[:, None, None, None]
    gamma = k * FP32_UNIT / (1 - k * FP32_UNIT)
    delta = x.double().abs() * (2 * gamma * 1e-8 / scale[..., None].double()
                                + 2 * QUANT_X_ROUNDINGS * FP32_UNIT)
    delta = torch.where(valid[:, None, None, :], delta,
                        torch.zeros_like(delta))
    return x, delta, scale.bfloat16().float()


def quant_flip_term(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                    v8: torch.Tensor, vs: torch.Tensor,
                    positions: torch.Tensor, *,
                    rolling_window: int = 0) -> torch.Tensor:
    """The int8 decode limit's extra term [B, H * hd] (see the comment
    above): ps * sum of |v8[s, d]| over each (row, head)'s slots s whose x
    lies within delta_s of a half-integer.  Arguments as
    :func:`quant_decode_x`, v8 [B, S, Kv, hd]."""
    b, h, hd = q.shape
    x, delta, ps = quant_decode_x(q, k8, ks, vs, positions,
                                  rolling_window=rolling_window)
    ax = x.double().abs()
    near = ((ax - torch.floor(ax) - 0.5).abs() <= delta).float()
    # integers below 2^24: exact in fp32
    steps = torch.einsum("bgqs,bsgd->bgqd", near, v8.float().abs())
    return (steps * ps[..., None]).reshape(b, h * hd)


# The tiled bodies (csrc/span_attention_tiled.cuh: the bf16 span kernels,
# full-cache and rolling; csrc/span_attention_quant_tiled.cuh: the int8
# ones; csrc/flash_attention.cu): blocks of QUERY_ROWS query rows, tq =
# QUERY_ROWS // g tokens (or positions) x g heads of one kv head; where g
# does not divide QUERY_ROWS the rows from tq * g on are idle
# (tiled::Group)
QUERY_ROWS = 64
TILED_MAX_GROUP = 16                # g = H / Kv in 1..16
TILED_WIDTHS = (16, 32, 64, 128)    # hd of the span bodies, bf16 and int8
# hd of the flash body (csrc/flash_attention.cu) and the bf16 split decode
# body (csrc/decode_attention_split.cuh): TILED_WIDTHS and 256
# (recurrentgemma-9b), where both keep Q in shared memory
WIDE_WIDTHS = TILED_WIDTHS + (256,)


def check_tiled(q: torch.Tensor, kv_heads: int, tensors,
                widths=TILED_WIDTHS) -> None:
    """The tiled bodies' shapes, for a CUDA call (q [..., H, hd]): g = H /
    Kv an integer in 1..TILED_MAX_GROUP, hd in ``widths`` (the span
    bodies' TILED_WIDTHS, or the flash body's WIDE_WIDTHS), 16-byte
    aligned data (cp.async).  Raises ValueError; the caller never falls
    back to the plain version."""
    h, hd = q.shape[-2], q.shape[-1]
    if kv_heads < 1 or h % kv_heads \
            or not 1 <= h // kv_heads <= TILED_MAX_GROUP \
            or hd not in widths:
        raise ValueError(f"the tiled kernels take g = H / Kv in "
                         f"1..{TILED_MAX_GROUP} and hd in {widths}, "
                         f"got H = {h}, Kv = {kv_heads}, hd = {hd}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the tiled kernels need 16-byte aligned inputs")


# The split decode bodies of the bf16 and int8 decode kernels
# (csrc/decode_attention_split.cuh, csrc/decode_attention_quant_split.cuh):
# chunks of DECODE_SPLIT slots from slot 0 (the C entries refuse another
# value), g = H / Kv up to 16 (the rows of one mma tile), hd in
# WIDE_WIDTHS (bf16) or TILED_WIDTHS (int8)
DECODE_SPLIT = 512
DECODE_MAX_GROUP = 16


def check_decode_split(q: torch.Tensor, kv_heads: int, tensors,
                       widths=TILED_WIDTHS) -> None:
    """The split decode bodies' shapes, for a CUDA call: 1 <= g <=
    DECODE_MAX_GROUP, hd in ``widths`` (the int8 body's TILED_WIDTHS, or
    the bf16 body's WIDE_WIDTHS), 16-byte aligned data (cp.async, 16-byte
    loads).  Raises ValueError; the caller never falls back to the plain
    version."""
    h, hd = q.shape[1], q.shape[2]
    if not 1 <= h // kv_heads <= DECODE_MAX_GROUP or hd not in widths:
        raise ValueError(f"the split decode kernel takes g = H / Kv in "
                         f"1..{DECODE_MAX_GROUP} and hd in {widths}, "
                         f"got g = {h // kv_heads}, hd = {hd}")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the split decode kernel needs 16-byte aligned "
                         "inputs")


def decode_workspace(b: int, h: int, kv: int, hd: int, width: int) -> int:
    """fp32 entries of the split decode body's partial states for B = b
    rows over ``width`` slots: (max, sum, o[hd]) for each (row, query head,
    chunk)."""
    return b * h * -(-width // DECODE_SPLIT) * (hd + 2)


def quant_decode_workspace(b: int, h: int, kv: int, hd: int,
                           width: int) -> int:
    """fp32 entries of the int8 split decode body's workspace
    (csrc/decode_attention_quant_split.cuh) for B = b rows over ``width``
    slots: for each (row, query head, chunk of DECODE_SPLIT slots) the
    chunk's scores (then p * vs, then p8) and its max, sum and max |p *
    vs|; for each (row, kv head, chunk) its slots' V scales; for each (row,
    query head) hd int32 sums of p8 . v8; for each (row, kv head) a count
    of the chunks done."""
    n_split = -(-width // DECODE_SPLIT)
    return (b * h * n_split * (DECODE_SPLIT + 3)
            + b * kv * n_split * DECODE_SPLIT + b * h * hd + b * kv)


def quant_decode_p8(workspace: torch.Tensor, b: int, h: int, kv: int,
                    width: int) -> torch.Tensor:
    """The quantized probabilities p8 that a CUDA call of the int8 decode
    kernels leaves in its workspace, as [B, H, n_split * DECODE_SPLIT]
    floats: entry [b, head, s] is slot s's (valid for s below the row's
    visible count).  The workspace's first region is [B, Kv, n_split, g,
    DECODE_SPLIT]."""
    n_split = -(-width // DECODE_SPLIT)
    g = h // kv
    p = workspace[:b * h * n_split * DECODE_SPLIT]
    return p.view(b, kv, n_split, g, DECODE_SPLIT).permute(0, 1, 3, 2, 4) \
        .reshape(b, h, n_split * DECODE_SPLIT)


def plan_ints(t: int, rows: int, g: int) -> int:
    """int32 entries of the tiled body's planning workspace for T = t
    tokens over ``rows`` cache (or table) rows (tiled::plan_ints)."""
    tq = QUERY_ROWS // g
    max_tiles = -(-t // tq) + min(rows, t)
    return 1 + 3 * max_tiles + 2 * t + 3 * rows


def _check_shapes(q: torch.Tensor, cache_shape, block_tables,
                  index_vectors) -> None:
    layout = ("[R, S, Kv, hd]" if block_tables is None
              else "[n_blocks, bs, Kv, hd]")
    if q.dim() != 3 or len(cache_shape) != 4:
        raise ValueError(f"q must be [N, H, hd] and the caches {layout}; "
                         f"got {tuple(q.shape)} and {tuple(cache_shape)}")
    n, h, hd = q.shape
    kv = cache_shape[2]
    if cache_shape[3] != hd or h % kv:
        raise ValueError(f"q heads/width {h}x{hd} do not fit cache kv "
                         f"heads/width {kv}x{cache_shape[3]}")
    if block_tables is not None and block_tables.dim() != 2:
        raise ValueError(f"block_tables must be [B, nb], got "
                         f"{tuple(block_tables.shape)}")
    for name, v in index_vectors.items():
        if v.shape != (n,):
            raise ValueError(f"{name} must be [{n}], got {tuple(v.shape)}")
    tables = {} if block_tables is None else {"block_tables": block_tables}
    for name, v in (*tables.items(), *index_vectors.items()):
        if v.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {v.dtype}")


def _check_devices(q: torch.Tensor, tensors) -> None:
    if len({t.device for t in tensors}) != 1:
        raise ValueError("all inputs must be on one device, got "
                         f"{sorted(str(t.device) for t in tensors)}")
    dev = q.device.type
    if dev == "cpu":
        if q.dtype not in (torch.bfloat16, torch.float32):
            raise TypeError(f"the plain version takes bf16 or fp32, got "
                            f"{q.dtype}")
        return
    if dev != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dtype != torch.bfloat16:
        raise TypeError(f"the CUDA kernel takes bf16, got {q.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the CUDA kernel needs contiguous inputs")


def check(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
          block_tables, index_vectors) -> None:
    """Validate an attention call: q [N, H, hd]; caches [n_blocks, bs, Kv,
    hd] with tables [B, nb] int32, or rows [R, S, Kv, hd] with
    ``block_tables`` None; each index vector [N] int32; everything on one
    device.  Raises ValueError/TypeError."""
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k_cache.shape)} "
                         f"vs {tuple(v_cache.shape)}")
    _check_shapes(q, k_cache.shape, block_tables, index_vectors)
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k_cache.dtype}, "
                        f"{v_cache.dtype}")
    _check_devices(q, [q, k_cache, v_cache, *_tables(block_tables),
                       *index_vectors.values()])


def check_quant(q: torch.Tensor, k8: torch.Tensor, ks: torch.Tensor,
                v8: torch.Tensor, vs: torch.Tensor,
                block_tables, index_vectors) -> None:
    """Validate an int8 attention call: q [N, H, hd] (bf16; fp32 too on
    the CPU); k8/v8 [n_blocks, bs, Kv, hd] (or rows [R, S, Kv, hd]) int8;
    ks/vs the same without hd, bf16; tables and index vectors as in
    :func:`check`.  The CUDA kernels read K 16 bytes at a time, so there
    hd must be a multiple of 16 and the int8 caches 16-byte aligned."""
    if v8.shape != k8.shape:
        raise ValueError(f"k/v cache shapes differ: {tuple(k8.shape)} "
                         f"vs {tuple(v8.shape)}")
    _check_shapes(q, k8.shape, block_tables, index_vectors)
    for name, c, dt in (("k8", k8, torch.int8), ("v8", v8, torch.int8),
                        ("ks", ks, torch.bfloat16), ("vs", vs, torch.bfloat16)):
        if c.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {c.dtype}")
    for name, c in (("ks", ks), ("vs", vs)):
        if c.shape != k8.shape[:3]:
            raise ValueError(f"{name} must be {tuple(k8.shape[:3])}, got "
                             f"{tuple(c.shape)}")
    tensors = [q, k8, ks, v8, vs, *_tables(block_tables),
               *index_vectors.values()]
    _check_devices(q, tensors)
    if q.device.type == "cuda":
        if q.shape[2] % 16:
            raise ValueError(f"the CUDA kernel needs hd % 16 == 0, got "
                             f"{q.shape[2]}")
        if k8.data_ptr() % 16 or v8.data_ptr() % 16:
            raise ValueError("the CUDA kernel needs 16-byte aligned int8 "
                             "caches")


def _tables(block_tables) -> list:
    return [] if block_tables is None else [block_tables]


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


_count_lock = threading.Lock()
_recording = threading.local()


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``; the pipeline's stage threads
    launch concurrently, and ``+=`` on an attribute is not atomic.  Inside
    :func:`record_launches` on this thread the launch is recorded instead:
    a CUDA graph's capture enqueues no kernel."""
    record = getattr(_recording, "record", None)
    if record is not None:
        record[wrapper] = record.get(wrapper, 0) + 1
        return
    with _count_lock:
        wrapper.launches += 1


@contextlib.contextmanager
def record_launches():
    """Record, and do not count, the launches this thread makes inside
    the block: yields ``{wrapper: launches}``, which :func:`add_launches`
    counts at each replay of the graph captured there.  Other threads
    count as usual."""
    prev = getattr(_recording, "record", None)
    _recording.record = record = {}
    try:
        yield record
    finally:
        _recording.record = prev


def add_launches(record) -> None:
    """Count a recorded set of launches (a graph replay's)."""
    with _count_lock:
        for wrapper, n in record.items():
            wrapper.launches += n
