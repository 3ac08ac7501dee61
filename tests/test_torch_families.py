"""The three families the engine does not serve, through the port's model
API against the reference on the CPU, with the reference's weights
(``params_from_jax``) and the same numpy-seeded inputs:

* recurrentgemma-9b (hybrid: RG-LRU blocks and local attention; smoke: 8
  layers, hd 16, g 4, W 32), xlstm-1.3b (ssm: sLSTM and mLSTM; smoke: 8
  layers, hd 32) and llama-3.2-vision-90b (vlm: cross-attention to 6400
  image patches; smoke: 10 layers, patches of width 64);
* each config module is the reference's but for its import line (and the
  vlm's one-card depth), and ``get_config`` gives equal fields, full and
  ``-smoke``; the bridge keeps every leaf's bits (the RG-LRU's fp32 gate
  leaves, xLSTM's doubly stacked mLSTM leaves, the vlm's cross group);
* each new block alone in fp32, prefill and decode: ``rglru_block``,
  ``mlstm_block`` (over several chunks), ``slstm_block`` and
  ``cross_attn_block`` over patches;
* each smoke model's prefill logits and 4 greedy decode steps, fp32 and
  bf16; the port's own prefill then decode against its prefill of the
  longer prompt, with rows of other lengths prefilled apart and decoded
  as one batch (``Model.init_cache(fill=[...])``);
* the flash (window band) and rolling decode plain versions at hd 256,
  g 16 against the reference's jnp oracles, and the CUDA shape checks:
  the flash and bf16 decode bodies take hd 256, the span bodies refuse it;
* both engines refuse the three families.

Every vlm comparison opens the cross-attention gates (1.0): they init to
zero, and a zero gate hides the patches from the logits.

Tolerances: blocks, logits fp32 1e-4 (the same operations summed in other
orders, the RG-LRU scan by doubling where the reference's is
associative_scan's tree; observed <= 1e-5), bf16 0.1 (both packages round
to bf16 after each operation, XLA fuses some; as tests/test_torch_whisper.
py); kernels' plain versions fp32 1e-5, bf16 2e-2.  Greedy tokens must
agree wherever the reference's top-2 logit gap exceeds twice the
tolerance."""
import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import list_archs as ref_list_archs
from repro.models import ShardCtx
from repro.models import attention as A
from repro.models import build_model as ref_build_model
from repro.models import hybrid as ref_hybrid
from repro.models import stacked as ref_stacked
from repro.models import transformer as ref_transformer
from repro.models import xlstm as ref_xlstm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, list_archs
from repro_torch.core import engine
from repro_torch.kernels import _paged
from repro_torch.kernels import decode_attention as kda
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import hybrid, transformer, xlstm
from repro_torch.models.registry import build_model
from repro_torch.models.stacked import Ctx, tree_map

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULES = {"recurrentgemma-9b": "recurrentgemma_9b",
           "xlstm-1.3b": "xlstm_1_3b",
           "llama-3.2-vision-90b": "llama_3_2_vision_90b"}
ARCHS = list(MODULES)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
B, S, N_STEPS = 2, 40, 4           # S over the hybrid smoke's W = 32


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


def _bits(t):
    return t.view(torch.int16).numpy()


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------

def _source(pkg, module):
    with open(os.path.join(SRC, pkg, "configs", module + ".py")) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("arch", ARCHS)
def test_config_module_is_the_references_but_its_import(arch):
    """Line for line the reference's module with ``repro.configs.base``
    read as ``repro_torch.configs.base``; the vlm adds only its one-card
    depth, ``ONE_CARD_LAYERS`` (whole groups of 5), after a comment.
    ``get_config`` gives the reference's fields, full and ``-smoke``, and
    the registry lists the reference's architectures in its order."""
    ref = _source("repro", MODULES[arch])
    port = _source("repro_torch", MODULES[arch])
    assert port[:len(ref)] == [
        line.replace("from repro.configs.base import",
                     "from repro_torch.configs.base import") for line in ref]
    code = [line for line in port[len(ref):]
            if line and not line.startswith("#")]
    cfg = get_config(arch)
    if cfg.family == "vlm":
        assert code == ["ONE_CARD_LAYERS = 25"]
        assert 25 % (cfg.cross_attn_every + 1) == 0
    else:
        assert code == []
    for name in (arch, arch + "-smoke"):
        assert dataclasses.asdict(get_config(name)) == \
            dataclasses.asdict(ref_get_config(name))
    assert list_archs() == ref_list_archs()


@functools.lru_cache(maxsize=None)
def _models(arch):
    """Both packages' smoke models, the reference's weights (the vlm's
    gates opened) and their bridge onto the port."""
    name = arch + "-smoke"
    ref_model = ref_build_model(ref_get_config(name), ShardCtx.single())
    ref_params = ref_model.init(jax.random.key(0))
    if ref_model.cfg.family == "vlm":
        cross = ref_params["stacks"]["blocks"]["cross"]["attn"]
        cross["gate"] = jnp.full_like(cross["gate"], 1.0)
    model = build_model(get_config(name))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_model, ref_params, model, params


def _cast(arch, dtype):
    """Both packages' weights in ``dtype`` (fp32 leaves stay fp32)."""
    ref_model, ref_params, model, params = _models(arch)
    jdt, tdt = DTYPES[dtype]
    return (ref_model,
            jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16
                         else a, ref_params),
            model,
            tree_map(lambda t: t.to(tdt) if t.dtype == torch.bfloat16
                     else t, params))


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_is_bit_exact(arch):
    """Every leaf keeps its shape, dtype and bits (the RG-LRU's fp32
    ``lam``/``wa``/``ba``/``wi``/``bi``, the sLSTM's fp32 biases, the
    vlm's fp32 gate), and the tree is the port's own spec tree, which
    ``Model.init`` fills."""
    _, ref_params, model, params = _models(arch)
    leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    n_f32 = 0
    for path, leaf in leaves:
        t = params
        for k in path:
            t = t[k.key]
        leaf = np.asarray(leaf)
        assert tuple(t.shape) == leaf.shape
        if leaf.dtype == np.float32:
            n_f32 += 1
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(t), leaf.view(np.int16))
    # fp32 leaves: 5 per RG-LRU layer kind (2 in the superblock, 2 in the
    # tail: per stack, one leaf per layer key); 4 sLSTM biases; the gate
    assert n_f32 == {"hybrid": 20, "ssm": 4, "vlm": 1}[model.cfg.family]
    shapes = lambda tree, f: tree_map(f, tree)
    assert shapes(params, lambda t: (tuple(t.shape), t.dtype)) == \
        shapes(model.specs, lambda s: (s.shape, s.dtype))
    own = model.init(seed=1, device="cpu")
    assert shapes(own, lambda t: (tuple(t.shape), t.dtype)) == \
        shapes(model.specs, lambda s: (s.shape, s.dtype))


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _ref_ctx(mode, positions, **kw):
    return ref_stacked.Ctx(mode=mode, shard=ShardCtx.single(),
                           positions=jnp.asarray(positions), **kw)


def _port_ctx(mode, positions, **kw):
    return Ctx(mode=mode, positions=torch.tensor(np.asarray(positions,
                                                            np.int32)), **kw)


@pytest.mark.parametrize("block,s", [("rglru", 40), ("mlstm", 160),
                                     ("mlstm", 131), ("slstm", 12),
                                     ("cross", 6)])
def test_block_matches_reference(block, s):
    """One block of each new kind in fp32: prefill over S tokens (its
    cache too), then one decode step over that cache.  The port's mLSTM
    runs 160 tokens as chunks of 128 and 32, the reference's as 5 of 32
    (CHUNK halved until it divides S); 131 tokens as 128 and 3 against the
    reference's 131 of one token: the carried state crosses chunk edges
    that differ."""
    arch = {"rglru": "recurrentgemma-9b", "mlstm": "xlstm-1.3b",
            "slstm": "xlstm-1.3b", "cross": "llama-3.2-vision-90b"}[block]
    ref_model, ref_params, model, params = _cast(arch, "float32")
    cfg, rcfg = model.cfg, ref_model.cfg
    rng = np.random.default_rng(7)
    x = rng.standard_normal((B, s, cfg.d_model)).astype(np.float32)
    xd = rng.standard_normal((B, cfg.d_model)).astype(np.float32)
    first = lambda tree: tree_map(lambda a: a[0], tree)
    blocks = params["stacks"]["blocks"]
    rblocks = ref_params["stacks"]["blocks"]
    kw, rkw = {}, {}
    if block == "rglru":
        p, rp = blocks["l0"]["mix"], rblocks["l0"]["mix"]
        fn, rfn = hybrid.rglru_block, ref_hybrid.rglru_block
    elif block == "mlstm":
        p = tree_map(lambda a: a[0], blocks["mlstm"])
        rp = jax.tree.map(lambda a: a[0], rblocks["mlstm"])
        fn, rfn = xlstm.mlstm_block, ref_xlstm.mlstm_block
    elif block == "slstm":
        p, rp = blocks["slstm"], rblocks["slstm"]
        fn, rfn = xlstm.slstm_block, ref_xlstm.slstm_block
    else:
        p, rp = blocks["cross"]["attn"], rblocks["cross"]["attn"]
        fn, rfn = transformer.cross_attn_block, ref_transformer.cross_attn_block
        patches = (rng.standard_normal((B, transformer.cfg_n_patches(cfg),
                                        cfg.d_model)) * 0.5).astype(np.float32)
        kw = {"patches": torch.tensor(patches)}
        rkw = {"patches": jnp.asarray(patches)}
    p, rp = first(p), jax.tree.map(lambda a: a[0], rp)
    want, want_cache = rfn(rp, jnp.asarray(x), _ref_ctx("prefill",
                                                        np.arange(s), **rkw),
                           None, rcfg)
    cache = jax.tree.map(lambda a: torch.empty(a.shape), want_cache)
    got = fn(p, torch.tensor(x), _port_ctx("prefill", np.arange(s), **kw),
             cache, cfg)
    _close(got, want, LOGIT_TOL["float32"])
    jax.tree.map(lambda w, c: _close(c, w, LOGIT_TOL["float32"]),
                 want_cache, cache)
    pos = np.full((B,), s, np.int32)
    want, want_cache = rfn(rp, jnp.asarray(xd), _ref_ctx("decode", pos),
                           want_cache, rcfg)
    got = fn(p, torch.tensor(xd), _port_ctx("decode", pos), cache, cfg)
    _close(got, want, LOGIT_TOL["float32"])
    jax.tree.map(lambda w, c: _close(c, w, LOGIT_TOL["float32"]),
                 want_cache, cache)


def test_linear_scan_is_the_recurrence():
    """The doubling scan equals h_t = a_t h_{t-1} + b_t step by step, at
    lengths on both sides of powers of two."""
    rng = np.random.default_rng(3)
    for s in (1, 2, 7, 8, 9, 33):
        a = torch.tensor(rng.uniform(0.5, 1.0, (2, s, 5)), dtype=torch.float64)
        b = torch.tensor(rng.standard_normal((2, s, 5)))
        h, want = torch.zeros(2, 5, dtype=torch.float64), []
        for t in range(s):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        torch.testing.assert_close(hybrid.linear_scan(a, b),
                                   torch.stack(want, 1))


# ---------------------------------------------------------------------------
# Models
# ---------------------------------------------------------------------------

def _inputs(cfg, lengths, seed=0):
    """Prompts of ``lengths`` and, for a vlm, patches [len, P, d]."""
    rng = np.random.default_rng(seed)
    toks = [rng.integers(2, cfg.vocab_size, n).astype(np.int32)
            for n in lengths]
    patches = None
    if cfg.family == "vlm":
        patches = rng.standard_normal(
            (len(lengths), transformer.cfg_n_patches(cfg), cfg.d_model)
        ).astype(np.float32)
    return toks, patches


def _pad_into(dst, src):
    """The reference's decode-buffer padding (tests/test_arch_smoke.py)."""
    if dst.shape == src.shape:
        return src
    return dst.at[tuple(slice(0, d) for d in src.shape)].set(src)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_prefill_then_decode_matches_reference(arch, dtype):
    """Prefill B 2 prompts of 40 tokens (over the hybrid's W = 32), the
    caches padded into a 48-slot decode buffer, then 4 greedy decode
    steps (both packages fed the reference's token).  Observed max |diff|
    fp32 <= 1e-5."""
    ref_model, ref_params, model, params = _cast(arch, dtype)
    jdt, tdt = DTYPES[dtype]
    toks, patches = _inputs(model.cfg, (S, S))
    toks = np.stack(toks)
    batch, tbatch = {"tokens": jnp.asarray(toks)}, {
        "tokens": torch.tensor(toks)}
    if patches is not None:
        batch["patches"] = jnp.asarray(patches, jdt)
        tbatch["patches"] = torch.tensor(patches).to(tdt)
    rl, rc = jax.jit(ref_model.prefill)(ref_params, batch)
    tl, tc = model.prefill(params, tbatch)
    length = S + N_STEPS + 4
    dcache = jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16
                          else a, ref_model.init_cache(B, length))
    dcache = jax.tree.map(_pad_into, dcache, rc)
    tcache = model.init_cache(B, length, device="cpu", dtype=tdt, fill=tc)
    decode = jax.jit(ref_model.decode)
    tol = LOGIT_TOL[dtype]
    for i in range(N_STEPS + 1):
        want, got = np.asarray(rl, np.float32), tl.float().numpy()
        assert got.shape == (B, model.cfg.vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()
        if i == N_STEPS:
            break
        tok = want.argmax(-1).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        rl, dcache = decode(ref_params, dcache, {
            "token": jnp.asarray(tok), "positions": jnp.asarray(pos)})
        tl, tcache = model.decode(params, tcache, {
            "token": torch.tensor(tok), "positions": torch.tensor(pos)})


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_equals_longer_prefill(arch):
    """The port's own cache check (tests/test_arch_smoke.py:80 for the
    reference): rows of 37 and 12 tokens prefilled apart, their caches
    gathered into one batch (``init_cache(fill=[...])``) and one decode
    step of each row's next token give the logits of prefilling the 38-
    and 13-token prompts, in fp32.  The fills must fit the batch."""
    _, _, model, params = _cast(arch, "float32")
    toks, patches = _inputs(model.cfg, (38, 13), seed=5)
    fills, want = [], []
    for i, t in enumerate(toks):
        extra = {} if patches is None else {
            "patches": torch.tensor(patches[i:i + 1])}
        fills.append(model.prefill(params, {"tokens": torch.tensor(
            t[None, :-1]), **extra})[1])
        want.append(model.prefill(params, {"tokens": torch.tensor(t[None]),
                                           **extra})[0])
    cache = model.init_cache(2, 40, device="cpu", dtype=torch.float32,
                             fill=fills)
    got, _ = model.decode(params, cache, {
        "token": torch.tensor([t[-1] for t in toks]),
        "positions": torch.tensor([len(t) - 1 for t in toks],
                                  dtype=torch.int32)})
    torch.testing.assert_close(got, torch.cat(want), rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="rows"):
        model.init_cache(1, 40, device="cpu", fill=fills)


def test_patches_reach_the_logits():
    """With the gates open other patches give other prefill logits; with
    the init's zero gates they give the same (why the comparisons open
    them)."""
    _, _, model, params = _cast("llama-3.2-vision-90b", "float32")
    toks, patches = _inputs(model.cfg, (9,))
    other = np.random.default_rng(9).standard_normal(patches.shape)
    for gate, moves in ((1.0, True), (0.0, False)):
        p = tree_map(lambda t: t.clone(), params)
        p["stacks"]["blocks"]["cross"]["attn"]["gate"].fill_(gate)
        a, b = (model.prefill(p, {"tokens": torch.tensor(toks[0][None]),
                                  "patches": torch.tensor(x).float()})[0]
                for x in (patches, other))
        assert bool((a - b).abs().max() > 1e-3) == moves
    with pytest.raises(ValueError, match="patches"):
        model.prefill(params, {"tokens": torch.tensor(toks[0][None])})


@pytest.mark.parametrize("arch", ARCHS)
def test_engines_refuse_the_family(arch):
    """Neither engine serves these families (nor does the reference's);
    the message points to the model API."""
    model = build_model(get_config(arch + "-smoke"))
    params = model.init(0, device="cpu")
    for cls in (engine.SiPipeEngine, engine.NaivePPEngine):
        with pytest.raises(NotImplementedError,
                           match=f"{model.cfg.family}.*model API"):
            cls(model, params, engine.EngineConfig())


# ---------------------------------------------------------------------------
# Head width 256
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hd256_plain_versions_match_the_oracles(dtype):
    """recurrentgemma's attention shape (g 16, hd 256) at a small window:
    the flash plain version's window band against the reference's
    ``local_attention`` (its prefill), and the contiguous rolling decode's
    against ``decode_attention(rolling_window=)`` (its decode) over rolling
    rows, wrapped and not."""
    h, kv, hd, w, s = 16, 1, 256, 32, 80
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(256)
    q, k, v = (rng.standard_normal((2, s, n, hd)).astype(np.float32)
               for n in (h, kv, kv))
    t = lambda a: torch.tensor(a).to(tdt)
    got = kfa.flash_attention(t(q), t(k), t(v),
                              torch.arange(s, dtype=torch.int32), window=w,
                              kv_block=w)
    want = A.local_attention(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                             window=w, q_block=w)
    _close(got, want.reshape(2, s, h * hd), TOL[dtype])
    qd = rng.standard_normal((3, h, hd)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, w, kv, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.array([5, 31, 70], np.int32)
    got = kda.contiguous_decode_attention_rolling(
        t(qd), t(kc), t(vc), torch.arange(3, dtype=torch.int32),
        torch.tensor(pos), window=w)
    want = A.decode_attention(*(jnp.asarray(a, jdt) for a in (qd, kc, vc)),
                              jnp.asarray(pos), rolling_window=w)
    _close(got, want.reshape(3, h * hd), TOL[dtype])


def test_hd256_shape_checks():
    """The CUDA calls' shape checks (no fallback): the flash body
    (``HEAD_DIMS``) and the bf16 split decode body take hd 256; the span
    bodies and the int8 decode body keep hd 16-128 and refuse it."""
    q4 = torch.zeros((2, 5, 16, 256), dtype=torch.bfloat16)
    q3 = torch.zeros((5, 16, 256), dtype=torch.bfloat16)
    assert 256 in kfa.HEAD_DIMS and 256 not in _paged.TILED_WIDTHS
    _paged.check_tiled(q4, 1, [q4], widths=kfa.HEAD_DIMS)
    _paged.check_decode_split(q3, 1, [q3], widths=_paged.WIDE_WIDTHS)
    with pytest.raises(ValueError, match="hd in"):
        _paged.check_tiled(q3, 1, [q3])
    with pytest.raises(ValueError, match="hd in"):
        _paged.check_decode_split(q3, 1, [q3])
    for bad in (96, 512):
        q = torch.zeros((5, 16, bad), dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="hd in"):
            _paged.check_tiled(q, 1, [q], widths=kfa.HEAD_DIMS)
        with pytest.raises(ValueError, match="hd in"):
            _paged.check_decode_split(q, 1, [q], widths=_paged.WIDE_WIDTHS)
