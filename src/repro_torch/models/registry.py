"""Model assembly: ``build_model(cfg)`` for the dense decoder family.

Model = embed -> Stack -> final norm -> lm head.  Parameters are nested
dicts of tensors in the reference's layout (``embed``, ``lnf``, ``head``,
``stacks/blocks/l0/{attn,ffn}/...`` with a leading ``[groups]`` axis), so
:mod:`repro_torch.bridge` maps the reference's pytree onto them leaf for
leaf.  The engine drives the model through the ``make_ctx``,
``embed_tokens`` and ``lm_head`` hooks and :func:`run_stack`.
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


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    specs: PyTree                      # ParamSpec tree (stacked)
    stacks: Dict[str, Stack]
    decode: Callable                   # (params, cache, batch) -> (logits [B,V], cache)
    make_ctx: Callable
    embed_tokens: Callable
    lm_head: Callable

    def init(self, seed: int = 0, device=None) -> PyTree:
        """Random parameters from a seeded ``torch.Generator`` on
        ``device`` (``cuda`` unless given; see :func:`repro_torch.
        resolve_device`).  The reference's init schemes; its numbers
        differ, so parity tests use :func:`repro_torch.bridge.
        params_from_jax`."""
        device = resolve_device(device)
        gen = torch.Generator(device=device).manual_seed(seed)
        return tree_map(lambda s: init_tensor(s.shape, s.init, gen,
                                              fan_in=s.fan_in, device=device),
                        self.specs)

    def paged_cache(self, n_groups: int, n_blocks: int, block_size: int,
                    device=None, dtype=torch.bfloat16) -> PyTree:
        """Zeroed block-major KV cache of ``n_groups`` layer groups:
        ``{"l0": {"k", "v"}}`` leaves [groups, n_blocks, bs, Kv, hd], on
        ``device`` (``cuda`` unless given).  It takes the parameters'
        dtype: bf16 as in the reference, or fp32 for parity runs on the
        CPU."""
        device = resolve_device(device)
        cfg = self.cfg
        shape = (n_groups, n_blocks, block_size, cfg.num_kv_heads,
                 cfg.resolved_head_dim)
        return {"l0": {kk: torch.zeros(shape, dtype=dtype, device=device)
                       for kk in ("k", "v")}}

    def prefill(self, params, batch):
        raise NotImplementedError(
            "monolithic prefill is the next slice of the port "
            "(ROADMAP.md queue 2: flash_attention); use a span policy")


def build_model(cfg: ArchConfig) -> Model:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP.md queue 1)")
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
                 block_tables: Optional[torch.Tensor] = None) -> Ctx:
        cos, sin = rope_tables(positions, hd, cfg.rope_theta)
        return Ctx(mode=mode, positions=positions, rope_cos=cos,
                   rope_sin=sin, seq_idx=seq_idx, block_tables=block_tables)

    def embed_tokens(params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens.long()]

    def lm_head(params, x: torch.Tensor) -> torch.Tensor:
        return (rmsnorm(x, params["lnf"], cfg.norm_eps) @ params["head"]).float()

    def decode(params, cache, batch):
        """batch: ``token`` [B], ``positions`` [B] int32 and
        ``block_tables`` [B, nb] int32; ``cache`` as :meth:`Model.
        paged_cache` for all layers, updated in place."""
        x = embed_tokens(params, batch["token"])
        ctx = make_ctx("decode", batch["positions"],
                       block_tables=batch["block_tables"])
        x = run_stack(stacks["blocks"], params["stacks"]["blocks"], x, ctx,
                      cache)
        return lm_head(params, x), cache

    return Model(cfg=cfg, specs=specs, stacks=stacks, decode=decode,
                 make_ctx=make_ctx, embed_tokens=embed_tokens,
                 lm_head=lm_head)
