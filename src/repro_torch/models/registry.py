"""Model assembly: ``build_model(cfg)`` for every family of the
reference: the dense and MoE decoders (full attention or a sliding
window), the hybrid (recurrentgemma: RG-LRU and local attention), ssm
(xLSTM) and vlm (cross-attention to image patches) families, and the
audio encoder-decoder family (whisper).

Model = embed -> Stack -> final norm -> lm head.  Parameters are nested
dicts of tensors in the reference's layout (``embed``, ``lnf``, ``head``,
``stacks/blocks/l0/{attn,ffn}/...`` with a leading ``[groups]`` axis; an
MoE layer's ``ffn`` is ``{ln, moe: {router, w1, w3, w2}}``, with
``shared_w1/w3/w2`` beside them for a shared expert; whisper has
``stacks/encoder/{attn,ffn}``, ``stacks/decoder/{self,cross,ffn}`` and
``enc_lnf``; the hybrid family adds ``stacks/tail``, the trailing
layers, and the ssm family's ``stacks/blocks/mlstm`` leaves are stacked
twice, [groups, 7, ...]), so :mod:`repro_torch.bridge` maps the
reference's pytree onto them leaf for leaf.  The engine drives the dense
and MoE models through the ``make_ctx``, ``embed_tokens`` and
``lm_head`` hooks and :func:`run_stack`; it does not serve the audio,
hybrid, ssm and vlm families (nor does the reference's), which run
through ``prefill`` and ``decode`` (and :meth:`Model.init_cache`).
:class:`ModelOptions` selects the int8 KV cache (``kv_quant``; dense and
MoE: the hybrid, ssm and vlm families keep a bf16 cache, as in the
reference), the prefill attention's kv tile and the fused shared expert;
the reference's other options are not ported and raise when set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, init_tensor, rmsnorm, \
    rope_tables, sinusoid_positions
from repro_torch.models.hybrid import hybrid_stack, hybrid_tail_stack
from repro_torch.models.stacked import Ctx, Stack, run_stack, stack_specs, \
    tree_map
from repro_torch.models.transformer import dense_layer_stack, vlm_stack
from repro_torch.models.whisper import decoder_stack, encoder_stack
from repro_torch.models.xlstm import xlstm_stack

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """The reference's ``repro.models.ModelOptions``.  Ported: ``kv_block``
    (prefill attention's kv tile), ``kv_quant`` (int8 KV cache, one bf16
    scale per K/V vector) and ``fuse_shared_expert`` (a shared expert's
    product inside the MoE FFN's sum, :func:`repro_torch.models.moe.
    moe_local`).  The others keep their defaults or raise."""
    kv_block: int = 512
    triangular: bool = False
    fuse_shared_expert: bool = False
    seq_shard: bool = False
    kv_quant: bool = False
    remat: bool = True
    logits_fp32: bool = True


_UNPORTED_OPTIONS = ("triangular", "seq_shard", "remat", "logits_fp32")


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    options: ModelOptions
    specs: PyTree                      # ParamSpec tree (stacked)
    stacks: Dict[str, Stack]
    prefill: Callable                  # (params, batch) -> (logits [B,V], cache)
    decode: Callable                   # (params, cache, batch) -> (logits [B,V], cache)
    make_ctx: Callable
    embed_tokens: Callable
    lm_head: Callable
    enc_len: int = 0                   # audio: encoder frames of the cache
    # audio: (params, frames [B, Se, d]) -> the encoder's output [B, Se, d]
    encode: Optional[Callable] = None

    def init(self, seed: int = 0, device=None) -> PyTree:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (``cuda`` unless given; see :func:`repro_torch.
        resolve_device`), drawn on the device.  The reference's init
        schemes; its numbers differ, so parity tests use
        :func:`repro_torch.bridge.params_from_jax`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return tree_map(lambda s: init_tensor(s.shape, s.init, gen,
                                              fan_in=s.fan_in, device=device,
                                              dtype=s.dtype),
                        self.specs)

    @property
    def layers_per_group(self) -> int:
        return len(self.stacks["blocks"].specs)

    def _cache(self, lead, dtype, quant: Optional[bool], make) -> PyTree:
        """``{"l<i>": {leaf: make(shape, dtype)}}`` for each layer of a
        group."""
        leaves = self._kv_leaves(lead, dtype, quant)
        return {f"l{i}": {kk: make(shape, dt)
                          for kk, (shape, dt) in leaves.items()}
                for i in range(self.layers_per_group)}

    def _kv_leaves(self, lead, dtype, quant: Optional[bool]):
        """Cache leaf shapes and dtypes over the leading dims ``lead``."""
        quant = self.options.kv_quant if quant is None else quant
        cfg = self.cfg
        vec = lead + (cfg.num_kv_heads, cfg.resolved_head_dim)
        if quant:
            return {"k": (vec, torch.int8), "v": (vec, torch.int8),
                    "ks": (vec[:-1], torch.bfloat16),
                    "vs": (vec[:-1], torch.bfloat16)}
        return {"k": (vec, dtype), "v": (vec, dtype)}

    def paged_cache(self, n_groups: int, n_blocks: int, block_size: int,
                    device=None, dtype=torch.bfloat16,
                    quant: Optional[bool] = None) -> PyTree:
        """Zeroed block-major KV cache of ``n_groups`` layer groups:
        ``{"l0": {"k", "v"}, ...}`` leaves [groups, n_blocks, bs, Kv, hd]
        (one ``l<i>`` per layer of a group), on
        ``device`` (``cuda`` unless given).  It takes the parameters'
        dtype: bf16 as in the reference, or fp32 for parity runs on the
        CPU.  With ``quant`` (default: the model's ``kv_quant``) the
        leaves are int8 and ``{"ks", "vs"}`` bf16 [groups, n_blocks, bs,
        Kv] hold their scales."""
        device = resolve_device(device)
        return self._cache((n_groups, n_blocks, block_size), dtype, quant,
                           lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                         device=device))

    def row_cache(self, n_groups: int, rows: int, seq: int, device=None,
                  dtype=torch.bfloat16, quant: Optional[bool] = None) -> PyTree:
        """Zeroed contiguous KV cache of ``n_groups`` layer groups (the
        contiguous layout's rows; the reference's ``init_cache(rows,
        max_seq_len)``): leaves [groups, rows, S, Kv, hd] (scales [groups,
        rows, S, Kv]), S = ``seq``, or W for a windowed model, whose rows
        are rolling (slot = position % W) whatever ``seq``.  Device, dtype
        and ``quant`` as :meth:`paged_cache`."""
        device = resolve_device(device)
        slots = self.cfg.window or seq
        return self._cache((n_groups, rows, slots), dtype, quant,
                           lambda shape, dt: torch.zeros(shape, dtype=dt,
                                                         device=device))

    def init_cache(self, batch: int, cache_len: int, device=None,
                   dtype=torch.bfloat16, fill=None) -> PyTree:
        """Zeroed decode cache (the reference's ``init_cache(batch,
        cache_len)``) on ``device`` (``cuda`` unless given), its K/V and
        conv leaves in ``dtype`` (the recurrent states are fp32).  Audio:
        ``{"decoder": {"self": {k, v}, "cross": {k, v}}}`` with self leaves
        [L, B, cache_len, Kv, hd] and cross leaves [L, B, enc_len, Kv, hd];
        ``fill``, a prefill cache, is copied into its leading slots, so
        decoding goes on past the prompt.  Hybrid, ssm and vlm: one tree
        per stack of its ``cache_spec`` with a leading [groups] axis
        (attention rows [groups, B, cache_len or W, Kv, hd], contiguous;
        a rolling row is exactly W slots); ``fill``, a prefill cache or a
        list of them, is copied into the leading slots of consecutive
        batch rows, the first at row 0, so prompts of other lengths,
        prefilled apart, decode as one batch."""
        device = resolve_device(device)
        if self.cfg.family in _SPEC_FAMILIES:
            return _spec_cache(self.stacks, batch, cache_len, dtype, device,
                               torch.zeros, fill)
        if self.cfg.family != "audio":
            raise ValueError("init_cache builds the audio, hybrid, ssm and "
                             "vlm families' caches; dense and moe models "
                             "use paged_cache or row_cache")
        cache = {"decoder": _audio_cache(
            self.cfg, batch, cache_len, self.enc_len,
            lambda shape: torch.zeros(shape, dtype=dtype, device=device))}
        if fill is not None:
            for part in ("self", "cross"):
                for kk in "kv":
                    src = fill["decoder"][part][kk]
                    cache["decoder"][part][kk][
                        tuple(slice(0, n) for n in src.shape)] = src
        return cache

    def prefill_cache(self, n_groups: int, batch: int, seq: int, device,
                      dtype=torch.bfloat16) -> PyTree:
        """Uninitialized per-prompt cache that prefill mode fills:
        ``{"l0": {...}, ...}`` leaves [groups, B, S, Kv, hd] (scales
        [groups, B, S, Kv]), int8 with the model's ``kv_quant``.  A
        windowed model's cache is rolling: W slots whatever S."""
        slots = self.cfg.window or seq
        return self._cache((n_groups, batch, slots), dtype, None,
                           lambda shape, dt: torch.empty(shape, dtype=dt,
                                                         device=device))


# the families whose caches follow their stacks' ``cache_spec``
_SPEC_FAMILIES = ("hybrid", "ssm", "vlm")


def _spec_cache(stacks: Dict[str, Stack], batch: int, cache_len: int,
                dtype, device, make, fill=None) -> PyTree:
    """Each stack's cache, leaves ``make(shape, dtype=, device=)`` of
    [groups] + its ``cache_spec`` leaf; ``fill``'s caches (one or a list)
    copied into consecutive batch rows (see :meth:`Model.init_cache`)."""
    cache, axes = {}, {}
    for name, st in stacks.items():
        spec = st.cache_spec(batch, cache_len, dtype)
        cache[name] = tree_map(lambda c: make((st.n,) + c.shape,
                                              dtype=c.dtype, device=device),
                               spec)
        axes[name] = tree_map(lambda c: c.batch_axis + 1, spec)
    row = 0
    for part in ([] if fill is None else
                 fill if isinstance(fill, (list, tuple)) else [fill]):
        leaves = []

        def walk(dst, src, ax):
            if isinstance(dst, dict):
                for kk in dst:
                    walk(dst[kk], src[kk], ax[kk])
            else:
                leaves.append((dst, src, ax))

        walk(cache, part, axes)
        rows = {src.shape[ax] for _, src, ax in leaves}
        if len(rows) != 1 or row + min(rows) > batch:
            raise ValueError(f"a fill cache of {sorted(rows)} batch rows "
                             f"does not fit rows {row}.. of {batch}")
        n = rows.pop()
        for dst, src, ax in leaves:
            idx = [slice(0, m) for m in src.shape]
            idx[ax] = slice(row, row + n)
            dst[tuple(idx)] = src
        row += n
    return cache


def _audio_cache(cfg: ArchConfig, batch: int, seq: int, enc_len: int,
                 make) -> PyTree:
    """The whisper decoder's cache tree, leaves from ``make(shape)``."""
    lead = (cfg.num_layers, batch)
    tail = (cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"self": {kk: make(lead + (seq,) + tail) for kk in "kv"},
            "cross": {kk: make(lead + (enc_len,) + tail) for kk in "kv"}}


def _sinusoid_at(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """The sinusoidal embedding [B, d_model] of decode ``positions`` [B]:
    computed in fp32, then rounded to bf16, as the reference's decode does
    (its prefill rounds :func:`sinusoid_positions`' float64 table)."""
    half = d_model // 2
    f32 = dict(dtype=torch.float32, device=positions.device)
    # tensor operands: the reference divides (PyTorch would multiply by a
    # Python divisor's reciprocal)
    log = torch.log(torch.tensor(10000.0, **f32))
    inv = torch.exp(-log / torch.tensor(float(max(half - 1, 1)), **f32)
                    * torch.arange(half, **f32))
    ang = positions.float()[:, None] * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(torch.bfloat16)


def build_model(cfg: ArchConfig, options: ModelOptions = ModelOptions(),
                enc_len: int = 0) -> Model:
    """The model of ``cfg``.  ``enc_len`` (audio only; default 1500, the
    reference's) is the encoder length :meth:`Model.init_cache` sizes the
    cross cache for."""
    if cfg.family not in ("dense", "moe", "audio") + _SPEC_FAMILIES:
        raise ValueError(f"unknown family {cfg.family}")
    for name in _UNPORTED_OPTIONS:
        if getattr(options, name) != getattr(ModelOptions, name):
            raise NotImplementedError(
                f"ModelOptions.{name} is not ported yet (ROADMAP.md queue 1)")
    audio = cfg.family == "audio"
    if audio and options.kv_quant:
        raise NotImplementedError("the int8 KV cache (kv_quant) of the "
                                  "audio family is not ported")
    if audio:
        stacks = {"encoder": encoder_stack(cfg),
                  "decoder": decoder_stack(cfg)}
    elif cfg.family == "moe":
        if cfg.moe is None:
            raise ValueError(f"{cfg.name}: family 'moe' needs a MoEConfig")
        per = cfg.moe.every
        stacks = {"blocks": dense_layer_stack(cfg, cfg.num_layers // per,
                                              moe_every=per)}
    elif cfg.family == "hybrid":
        stacks = {"blocks": hybrid_stack(cfg)}
        if cfg.tail_pattern:
            stacks["tail"] = hybrid_tail_stack(cfg)
    elif cfg.family == "ssm":
        stacks = {"blocks": xlstm_stack(cfg)}
    elif cfg.family == "vlm":
        stacks = {"blocks": vlm_stack(cfg)}
    else:
        stacks = {"blocks": dense_layer_stack(cfg, cfg.num_layers)}
    spec_family = cfg.family in _SPEC_FAMILIES
    # the int8 cache is the dense and moe families' (the reference's
    # build_model, repro/models/registry.py:152)
    kv_quant = options.kv_quant and cfg.family in ("dense", "moe")
    uses_rope = cfg.family not in ("ssm", "audio")
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((v, d), "small"),
        "lnf": ParamSpec((d,), "ones"),
        "head": ParamSpec((d, v)),
        "stacks": {name: stack_specs(st) for name, st in stacks.items()},
    }
    if audio:
        specs["enc_lnf"] = ParamSpec((d,), "ones")
    hd = cfg.resolved_head_dim

    def make_ctx(mode: str, positions: torch.Tensor,
                 seq_idx: Optional[torch.Tensor] = None,
                 span_starts: Optional[torch.Tensor] = None,
                 n_valid: Optional[int] = None,
                 seq_lens: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None,
                 enc_out: Optional[torch.Tensor] = None,
                 patches: Optional[torch.Tensor] = None) -> Ctx:
        cos = sin = None
        # whisper's positions are sinusoids; xLSTM has none
        if uses_rope:
            cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        return Ctx(mode=mode, positions=positions, rope_cos=cos,
                   rope_sin=sin, seq_idx=seq_idx, span_starts=span_starts,
                   n_valid=n_valid, seq_lens=seq_lens,
                   block_tables=block_tables, rows=rows, patches=patches,
                   enc_out=enc_out, kv_block=options.kv_block,
                   kv_quant=kv_quant,
                   fuse_shared_expert=options.fuse_shared_expert)

    def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def lm_head(params, x: torch.Tensor) -> torch.Tensor:
        return (rmsnorm(x, params["lnf"], cfg.norm_eps) @ params["head"]).float()

    def run_encoder(params, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, Se, d] -> the encoder's normed output [B, Se, d]."""
        s = frames.shape[1]
        x = frames + sinusoid_positions(s, d).to(frames.device)[None]
        ctx = Ctx(mode="train", positions=torch.arange(
            s, dtype=torch.int32, device=frames.device),
            kv_block=options.kv_block)
        x = run_stack(stacks["encoder"], params["stacks"]["encoder"], x, ctx)
        return rmsnorm(x, params["enc_lnf"], cfg.norm_eps)

    def prefill_audio(params, batch):
        frames, tokens = batch["frames"], batch["tokens"]
        b, s = tokens.shape
        enc_out = run_encoder(params, frames)
        x = embed_tokens(params, tokens) \
            + sinusoid_positions(s, d).to(tokens.device)[None]
        ctx = make_ctx("prefill", torch.arange(s, dtype=torch.int32,
                                               device=x.device),
                       enc_out=enc_out)
        cache = _audio_cache(cfg, b, s, frames.shape[1], lambda shape:
                             torch.empty(shape, dtype=x.dtype,
                                         device=x.device))
        x = run_stack(stacks["decoder"], params["stacks"]["decoder"], x, ctx,
                      cache)
        return lm_head(params, x[:, -1]), {"decoder": cache}

    def prefill_spec(params, batch):
        tokens = batch["tokens"]
        b, s = tokens.shape
        patches = batch.get("patches")
        if cfg.family == "vlm" and patches is None:
            raise ValueError("the vlm family's prefill needs patches "
                             "[B, P, d]")
        x = embed_tokens(params, tokens)
        ctx = make_ctx("prefill", torch.arange(s, dtype=torch.int32,
                                               device=x.device),
                       patches=patches)
        cache = _spec_cache(stacks, b, s, x.dtype, x.device, torch.empty)
        for name, st in stacks.items():      # blocks, then tail
            x = run_stack(st, params["stacks"][name], x, ctx, cache[name])
        return lm_head(params, x[:, -1]), cache

    def prefill(params, batch):
        """batch: ``tokens`` [B, S].  Returns the logits of each row's
        last token [B, V] and ``{"blocks": cache}``, the prompt's K/V
        (int8 with scales under ``kv_quant``) as leaves [groups, B, S or
        W, ...].  Audio: batch also holds ``frames`` [B, Se, d], and the
        cache is ``{"decoder": {"self": {k, v}, "cross": {k, v}}}``, self
        leaves [L, B, S, Kv, hd] and cross leaves [L, B, Se, Kv, hd].
        Hybrid, ssm and vlm (an unpadded batch; vlm: batch also holds
        ``patches`` [B, P, d]): the cache is :meth:`Model.init_cache`'s
        tree at cache_len S, holding the state after the prompt."""
        if audio:
            return prefill_audio(params, batch)
        if spec_family:
            return prefill_spec(params, batch)
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = embed_tokens(params, tokens)
        ctx = make_ctx("prefill", torch.arange(s, dtype=torch.int32,
                                               device=x.device))
        cache = model.prefill_cache(stacks["blocks"].n, b, s, x.device,
                                    x.dtype)
        x = run_stack(stacks["blocks"], params["stacks"]["blocks"], x, ctx,
                      cache)
        return lm_head(params, x[:, -1]), {"blocks": cache}

    def decode(params, cache, batch):
        """batch: ``token`` [B], ``positions`` [B] int32 and
        ``block_tables`` [B, nb] int32, with ``cache`` as :meth:`Model.
        paged_cache`, or None, with ``cache`` the batch's B rows as
        :meth:`Model.row_cache` makes them; all layers, updated in
        place.  Audio, hybrid, ssm and vlm: no ``block_tables``; ``cache``
        as :meth:`Model.init_cache` (or prefill) makes it, row b of each
        attention layer's rows written at ``positions[b]`` (``% W``
        rolling)."""
        if audio:
            positions = batch["positions"]
            x = embed_tokens(params, batch["token"]) \
                + _sinusoid_at(positions, d)
            x = run_stack(stacks["decoder"], params["stacks"]["decoder"], x,
                          make_ctx("decode", positions), cache["decoder"])
            return lm_head(params, x), cache
        if spec_family:
            x = embed_tokens(params, batch["token"])
            ctx = make_ctx("decode", batch["positions"])
            for name, st in stacks.items():
                x = run_stack(st, params["stacks"][name], x, ctx,
                              cache[name])
            return lm_head(params, x), cache
        x = embed_tokens(params, batch["token"])
        ctx = make_ctx("decode", batch["positions"],
                       block_tables=batch["block_tables"])
        x = run_stack(stacks["blocks"], params["stacks"]["blocks"], x, ctx,
                      cache)
        return lm_head(params, x), cache

    model = Model(cfg=cfg, options=options, specs=specs, stacks=stacks,
                  prefill=prefill, decode=decode, make_ctx=make_ctx,
                  embed_tokens=embed_tokens, lm_head=lm_head,
                  enc_len=(enc_len or 1500) if audio else 0,
                  encode=run_encoder if audio else None)
    return model
