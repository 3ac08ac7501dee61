"""Model assembly: ``build_model(cfg)`` for the dense and MoE decoder
families (full attention or a sliding window).

Model = embed -> Stack -> final norm -> lm head.  Parameters are nested
dicts of tensors in the reference's layout (``embed``, ``lnf``, ``head``,
``stacks/blocks/l0/{attn,ffn}/...`` with a leading ``[groups]`` axis; an
MoE layer's ``ffn`` is ``{ln, moe: {router, w1, w3, w2}}``), so
:mod:`repro_torch.bridge` maps the reference's pytree onto them leaf for
leaf.  The engine drives the model through the ``make_ctx``,
``embed_tokens`` and ``lm_head`` hooks and :func:`run_stack`.
:class:`ModelOptions` selects the int8 KV cache (``kv_quant``) and the
prefill attention's kv tile; the reference's other options are not
ported and raise when set.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models.common import ParamSpec, init_tensor, rmsnorm, \
    rope_tables
from repro_torch.models.stacked import Ctx, Stack, run_stack, stack_specs, \
    tree_map
from repro_torch.models.transformer import dense_layer_stack

PyTree = Any


@dataclasses.dataclass(frozen=True)
class ModelOptions:
    """The reference's ``repro.models.ModelOptions``.  Ported: ``kv_block``
    (prefill attention's kv tile) and ``kv_quant`` (int8 KV cache, one bf16
    scale per K/V vector).  The others keep their defaults or raise."""
    kv_block: int = 512
    triangular: bool = False
    fuse_shared_expert: bool = False
    seq_shard: bool = False
    kv_quant: bool = False
    remat: bool = True
    logits_fp32: bool = True


_UNPORTED_OPTIONS = ("triangular", "fuse_shared_expert", "seq_shard",
                     "remat", "logits_fp32")


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

    def init(self, seed: int = 0, device=None) -> PyTree:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (``cuda`` unless given; see :func:`repro_torch.
        resolve_device`), drawn on the device.  The reference's init
        schemes; its numbers differ, so parity tests use
        :func:`repro_torch.bridge.params_from_jax`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return tree_map(lambda s: init_tensor(s.shape, s.init, gen,
                                              fan_in=s.fan_in, device=device),
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


def build_model(cfg: ArchConfig,
                options: ModelOptions = ModelOptions()) -> Model:
    if cfg.family not in ("dense", "moe"):
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1)")
    for name in _UNPORTED_OPTIONS:
        if getattr(options, name) != getattr(ModelOptions, name):
            raise NotImplementedError(
                f"ModelOptions.{name} is not ported yet (ROADMAP.md queue 1)")
    if cfg.family == "moe":
        if cfg.moe is None:
            raise ValueError(f"{cfg.name}: family 'moe' needs a MoEConfig")
        per = cfg.moe.every
        stacks = {"blocks": dense_layer_stack(cfg, cfg.num_layers // per,
                                              moe_every=per)}
    else:
        stacks = {"blocks": dense_layer_stack(cfg, cfg.num_layers)}
    d, v = cfg.d_model, cfg.vocab_size
    specs = {
        "embed": ParamSpec((v, d), "small"),
        "lnf": ParamSpec((d,), "ones"),
        "head": ParamSpec((d, v)),
        "stacks": {name: stack_specs(st) for name, st in stacks.items()},
    }
    hd = cfg.resolved_head_dim

    def make_ctx(mode: str, positions: torch.Tensor,
                 seq_idx: Optional[torch.Tensor] = None,
                 span_starts: Optional[torch.Tensor] = None,
                 n_valid: Optional[int] = None,
                 seq_lens: Optional[torch.Tensor] = None,
                 block_tables: Optional[torch.Tensor] = None,
                 rows: Optional[torch.Tensor] = None) -> Ctx:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        return Ctx(mode=mode, positions=positions, rope_cos=cos,
                   rope_sin=sin, seq_idx=seq_idx, span_starts=span_starts,
                   n_valid=n_valid, seq_lens=seq_lens,
                   block_tables=block_tables, rows=rows,
                   kv_block=options.kv_block, kv_quant=options.kv_quant)

    def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def lm_head(params, x: torch.Tensor) -> torch.Tensor:
        return (rmsnorm(x, params["lnf"], cfg.norm_eps) @ params["head"]).float()

    def prefill(params, batch):
        """batch: ``tokens`` [B, S].  Returns the logits of each row's
        last token [B, V] and ``{"blocks": cache}``, the prompt's K/V
        (int8 with scales under ``kv_quant``) as leaves [groups, B, S or
        W, ...]."""
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
        place."""
        x = embed_tokens(params, batch["token"])
        ctx = make_ctx("decode", batch["positions"],
                       block_tables=batch["block_tables"])
        x = run_stack(stacks["blocks"], params["stacks"]["blocks"], x, ctx,
                      cache)
        return lm_head(params, x), cache

    model = Model(cfg=cfg, options=options, specs=specs, stacks=stacks,
                  prefill=prefill, decode=decode, make_ctx=make_ctx,
                  embed_tokens=embed_tokens, lm_head=lm_head)
    return model
