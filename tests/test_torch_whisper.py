"""The port's whisper family (audio encoder-decoder) and the non-causal
form of its flash kernel against the reference, on the same numpy inputs
and the same weights (``params_from_jax``).

Every comparison runs on weights whose decoder cross-attention gates are
nonzero (1.0, so tanh(gate) ~ 0.76): the reference initialises them to
zero, and with a zero gate the decoder's logits do not depend on the
frames at all, so a broken encoder or non-causal kernel would pass.

Tolerances, by dtype:
  kernels  fp32 1e-5, bf16 2e-2, as in tests/test_torch_kernels.py
           (observed 6.6e-7 and 7.8e-3).
  blocks and logits  fp32 1e-4 (the same operations, summed in other
           orders; observed <= 1.4e-6), bf16 0.1 (both packages round to
           bf16 after each operation, XLA fuses some of them; observed
           <= 0.031).
Greedy tokens must agree wherever the reference's top-2 logit gap
exceeds twice the tolerance."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.kernels.ops import flash_attention_bshd
from repro.models import ShardCtx
from repro.models import attention as A
from repro.models import build_model as ref_build_model
from repro.models import common as ref_common
from repro.models import registry as ref_registry
from repro.models import stacked as ref_stacked
from repro.models import transformer as ref_transformer
from repro.models import whisper as ref_whisper
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as kfa
from repro_torch.models import common, registry, transformer, whisper
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import Ctx, tree_map

ARCH = "whisper-small-smoke"
ENC = 150                       # encoder frames: not a multiple of 64
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _close(port, ref, tol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol,
                               atol=tol)


# ---------------------------------------------------------------------------
# The non-causal flash kernel's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", [16, 64])
@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv", [(ENC, ENC), (4, ENC)],
                         ids=["self", "cross"])
def test_noncausal_plain_matches_oracle_and_pallas(dtype, hd, g, sq, skv):
    """Sq = Skv (the encoder) and Sq != Skv (the cross-attention), over
    150 keys: no tile multiple of the kernel's 64 or of the oracle's."""
    b, kv = 2, 2
    rng = np.random.default_rng(1000 * hd + 100 * g + sq)
    case = {"q": rng.standard_normal((b, sq, kv * g, hd), np.float32),
            "k": rng.standard_normal((b, skv, kv, hd), np.float32),
            "v": rng.standard_normal((b, skv, kv, hd), np.float32)}
    jdt, tdt = DTYPES[dtype]
    j = {n: jnp.asarray(a, jdt) for n, a in case.items()}
    t = {n: torch.tensor(a).to(tdt) for n, a in case.items()}
    out = kfa.flash_attention(t["q"], t["k"], t["v"], causal=False)
    assert out.shape == (b, sq, kv * g * hd) and out.dtype == tdt
    _close(out, A.chunked_attention(j["q"], j["k"], j["v"], causal=False),
           TOL[dtype])
    _close(out, A.cross_attention(j["q"], j["k"], j["v"]), TOL[dtype])
    _close(out, flash_attention_bshd(j["q"], j["k"], j["v"], causal=False),
           TOL[dtype])


def test_noncausal_kv_tile_changes_only_fp32_sums():
    """The plain version's kv tile (over 1500 keys 512 halves down to 4;
    300 and 1500 divide it) changes only the order of fp32 sums."""
    rng = np.random.default_rng(5)
    q, k, v = (torch.tensor(rng.standard_normal((1, n, 2, 16), np.float32))
               for n in (3, 1500, 1500))
    ref = A.chunked_attention(*map(jnp.asarray, (q.numpy(), k.numpy(),
                                                 v.numpy())), causal=False)
    for tile in (512, 300, 1500):
        out = kfa.flash_attention_noncausal(q, k, v, kv_block=tile)
        _close(out, ref, 1e-5)


def _flash_args():
    rng = np.random.default_rng(13)
    return [torch.tensor(rng.standard_normal((2, n, h, 16), np.float32))
            .to(torch.bfloat16) for n, h in ((3, 4), (9, 2), (9, 2))]


def test_noncausal_wrapper_routes_refuses_and_counts_no_cpu_launch():
    q, k, v = _flash_args()
    before = (kfa.flash_attention.launches,
              kfa.flash_attention_noncausal.launches)
    out = kfa.flash_attention(q, k, v, causal=False)
    assert torch.equal(out, kfa.flash_attention_noncausal(q, k, v))
    assert torch.equal(out, kfa.flash_attention_plain(q, k, v, causal=False))
    # positions mean nothing without the causal mask: they are not read
    assert torch.equal(out, kfa.flash_attention(
        q, k, v, torch.tensor([7, 0, 2], dtype=torch.int32), causal=False))
    # the causal form differs, and needs its positions
    causal = kfa.flash_attention(q, k[:, :3], v[:, :3],
                                 torch.arange(3, dtype=torch.int32))
    assert not torch.equal(causal, kfa.flash_attention(
        q, k[:, :3], v[:, :3], causal=False))
    with pytest.raises(ValueError, match="q_positions"):
        kfa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="window"):
        kfa.flash_attention(q, k, v, causal=False, window=4)
    with pytest.raises(ValueError):
        kfa.flash_attention(q, k[:, :0], v[:, :0], causal=False)
    assert (kfa.flash_attention.launches,
            kfa.flash_attention_noncausal.launches) == before


# ---------------------------------------------------------------------------
# Sinusoid tables
# ---------------------------------------------------------------------------

def _bits(t):
    return t.view(torch.int16).numpy()


def _ref_bits(a):
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("length,d", [(1500, 768), (ENC, 64)])
def test_sinusoid_tables_match_reference(length, d):
    """The prefill table (numpy float64, then bf16) equals the reference's
    bit for bit.  The decode embedding is the same fp32 formula, rounded to
    bf16; XLA's and PyTorch's fp32 ``exp``, ``sin`` and ``cos`` are not
    correctly rounded and differ by an ulp on some inputs (on ~10% of
    ``exp`` values), so a few elements round to the neighbouring bf16
    value: within one bf16 step (2^-8 below 1), in under 0.1% of the
    elements (observed: 258 of 1,152,000 at d 768, the first at position
    57).  The two tables round differently, so neither is the other."""
    np.testing.assert_array_equal(
        _bits(common.sinusoid_positions(length, d)),
        _ref_bits(ref_common.sinusoid_positions(length, d)))
    pos = np.arange(length, dtype=np.int32)
    got = registry._sinusoid_at(torch.tensor(pos), d)
    want = ref_registry._sinusoid_at(jnp.asarray(pos), d)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    diff = np.abs(got.float().numpy() - np.asarray(want, np.float32))
    assert diff.max() <= 2.0 ** -8
    assert (diff > 0).mean() < 1e-3
    table = common.sinusoid_positions(length, d)
    assert not torch.equal(got, table)
    assert not np.array_equal(np.asarray(want, np.float32),
                              np.asarray(ref_common.sinusoid_positions(
                                  length, d), np.float32))


# ---------------------------------------------------------------------------
# Models and weights
# ---------------------------------------------------------------------------

def _ref_params(seed=0, enc_len=ENC, gate=1.0):
    ref_model = ref_build_model(ref_get_config(ARCH), ShardCtx.single(),
                                enc_len=enc_len)
    p = ref_model.init(jax.random.key(seed))
    cross = p["stacks"]["decoder"]["cross"]
    cross["gate"] = jnp.full_like(cross["gate"], gate)
    return ref_model, p


@pytest.fixture(scope="module")
def models():
    ref_model, ref_params = _ref_params()
    model = build_model(get_config(ARCH), enc_len=ENC)
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_model, ref_params, model, params


def _cast(models, dtype):
    """Both packages' weights in ``dtype`` (the fp32 gates stay fp32)."""
    ref_model, ref_params, model, params = models
    jdt, tdt = DTYPES[dtype]
    return (ref_model,
            jax.tree.map(lambda a: a.astype(jdt) if a.dtype == jnp.bfloat16
                         else a, ref_params),
            model,
            tree_map(lambda t: t.to(tdt) if t.dtype == torch.bfloat16
                     else t, params))


def _inputs(cfg, b=2, s=4, seed=0, enc=ENC):
    """Frames at the stub frontend's scale (0.02) and prompt tokens."""
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((b, enc, cfg.d_model)) * 0.02).astype(
        np.float32)
    return frames, rng.integers(2, cfg.vocab_size, (b, s)).astype(np.int32)


def test_config_copy_matches_reference():
    for arch in ("whisper-small", ARCH):
        assert get_config(arch).__dict__ == ref_get_config(arch).__dict__


def test_params_from_jax_audio_tree_is_bit_exact(models):
    """Every leaf of the audio tree (encoder, decoder self/cross/ffn with
    the fp32 gate and ``ln_kv``, ``enc_lnf``) keeps its shape, dtype and
    bits, and the tree is the port's own spec tree."""
    _, ref_params, model, params = models
    leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    # embed, lnf, head, enc_lnf; encoder attn + ffn; decoder self, cross
    # (+ gate, ln_kv), ffn
    assert len(leaves) == 4 + (5 + 3) + 5 + 7 + 3
    for path, leaf in leaves:
        t = params
        for k in path:
            t = t[k.key]
        leaf = np.asarray(leaf)
        assert tuple(t.shape) == leaf.shape
        if leaf.dtype == np.float32:
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), leaf)
        else:
            assert t.dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(t), leaf.view(np.int16))
    assert float(params["stacks"]["decoder"]["cross"]["gate"][0, 0]) == 1.0
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), params) == \
        tree_map(lambda s: (s.shape, s.dtype), model.specs)
    own = model.init(seed=1, device="cpu")
    assert tree_map(lambda t: (tuple(t.shape), t.dtype), own) == \
        tree_map(lambda s: (s.shape, s.dtype), model.specs)
    assert bool((own["stacks"]["decoder"]["cross"]["gate"] == 0).all())


def _group(tree, i=0):
    return tree_map(lambda a: a[i], tree)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blocks_match_reference(models, dtype):
    """gelu_mlp, the encoder (sinusoids, two non-causal blocks, the final
    norm), and cross_attn_block in prefill (its cache too) and decode
    mode, each against the reference's on the same inputs.  Observed max
    |diff|: fp32 1.4e-6, bf16 0.031."""
    ref_model, ref_params, model, params = _cast(models, dtype)
    jdt, tdt = DTYPES[dtype]
    cfg, rcfg = model.cfg, ref_model.cfg
    tol = LOGIT_TOL[dtype]
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, cfg.d_model)).astype(np.float32)
    frames, _ = _inputs(cfg)
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    dec, rdec = params["stacks"]["decoder"], ref_params["stacks"]["decoder"]

    got = whisper.gelu_mlp(_group(dec["ffn"]), tx, cfg)
    _close(got, ref_whisper.gelu_mlp(_group(rdec["ffn"]), jx, rcfg), tol)

    # the encoder, as prefill runs it (its output is the cross memory)
    ref_enc = jax.jit(lambda p, f: _ref_encoder(ref_model, p, f))(
        ref_params, jnp.asarray(frames, jdt))
    enc = model.encode(params, torch.tensor(frames).to(tdt))
    _close(enc, ref_enc, tol)

    # cross-attention: prefill reads the memory and fills the cache
    ref_ctx = ref_stacked.Ctx(mode="prefill", shard=ShardCtx.single(),
                              positions=jnp.arange(4), enc_out=ref_enc)
    want, want_cache = ref_transformer.cross_attn_block(
        _group(rdec["cross"]), jx, ref_ctx, None, rcfg)
    cache = {kk: torch.empty((2, ENC, cfg.num_kv_heads,
                              cfg.resolved_head_dim), dtype=tdt)
             for kk in "kv"}
    ctx = Ctx(mode="prefill", positions=torch.arange(4, dtype=torch.int32),
              enc_out=torch.tensor(np.asarray(ref_enc, np.float32)).to(tdt))
    _close(transformer.cross_attn_block(_group(dec["cross"]), tx, ctx, cache,
                                        cfg), want, tol)
    for kk in "kv":
        _close(cache[kk], want_cache[kk], tol)
    # decode: one token per row over the cached memory (the reference's)
    xd = x[:, 0]
    ref_ctx = ref_stacked.Ctx(mode="decode", shard=ShardCtx.single(),
                              positions=jnp.array([4, 4]))
    want, _ = ref_transformer.cross_attn_block(
        _group(rdec["cross"]), jnp.asarray(xd, jdt), ref_ctx, want_cache,
        rcfg)
    cache = {kk: torch.tensor(np.asarray(want_cache[kk], np.float32)).to(tdt)
             for kk in "kv"}
    ctx = Ctx(mode="decode", positions=torch.tensor([4, 4],
                                                    dtype=torch.int32))
    _close(transformer.cross_attn_block(_group(dec["cross"]),
                                        torch.tensor(xd).to(tdt), ctx, cache,
                                        cfg), want, tol)


def _ref_encoder(ref_model, params, frames):
    """The reference's ``run_encoder`` (a closure inside its
    ``build_model``), rebuilt from its parts."""
    cfg = ref_model.cfg
    s = frames.shape[1]
    x = frames + ref_common.sinusoid_positions(s, cfg.d_model)[None]
    ctx = ref_stacked.Ctx(mode="train", shard=ShardCtx.single(),
                          positions=jnp.arange(s))
    x, _ = ref_stacked.run_stack(ref_model.stacks["encoder"],
                                 params["stacks"]["encoder"], x, ctx,
                                 remat=False)
    return ref_common.rmsnorm(x, params["enc_lnf"], cfg.norm_eps)


def _pad_into(dst, src):
    """The reference's decode-buffer padding (tests/test_arch_smoke.py)."""
    sl = tuple(slice(0, d) for d in src.shape)
    return dst.at[sl].set(src)


def _run_both(ref_model, ref_params, model, params, dtype, frames, toks,
              n_steps, cache_len):
    """Prefill, pad the cache into a ``cache_len`` decode buffer, then
    ``n_steps`` greedy decode steps (each package feeds the reference's
    token, so the two see the same inputs).  Returns each step's logits
    from both packages."""
    jdt, tdt = DTYPES[dtype]
    b, s = toks.shape
    rl, rc = jax.jit(ref_model.prefill)(
        ref_params, {"frames": jnp.asarray(frames, jdt),
                     "tokens": jnp.asarray(toks)})
    tl, tc = model.prefill(params, {"frames": torch.tensor(frames).to(tdt),
                                    "tokens": torch.tensor(toks)})
    dcache = jax.tree.map(lambda a: a.astype(jdt),
                          ref_model.init_cache(b, cache_len))
    dcache = jax.tree.map(_pad_into, dcache, rc)
    tcache = model.init_cache(b, cache_len, device="cpu", dtype=tdt,
                              fill=tc)
    ref_steps, port_steps = [np.asarray(rl, np.float32)], [tl.numpy()]
    decode = jax.jit(ref_model.decode)
    for i in range(n_steps):
        tok = ref_steps[-1].argmax(-1).astype(np.int32)
        pos = np.full((b,), s + i, np.int32)
        rl, dcache = decode(ref_params, dcache,
                            {"token": jnp.asarray(tok),
                             "positions": jnp.asarray(pos)})
        tl, tcache = model.decode(params, tcache,
                                  {"token": torch.tensor(tok),
                                   "positions": torch.tensor(pos)})
        ref_steps.append(np.asarray(rl, np.float32))
        port_steps.append(tl.float().numpy())
    return ref_steps, port_steps


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_whisper_smoke_prefill_then_decode_matches_reference(models, dtype):
    """whisper-small-smoke end to end: prefill (encoder over 150 frames,
    decoder over a 4-token prompt), the cache padded into a 12-slot decode
    buffer, then 6 greedy decode steps.  Observed max |diff|: fp32 1.2e-6,
    bf16 0.031."""
    ref_model, ref_params, model, params = _cast(models, dtype)
    frames, toks = _inputs(model.cfg)
    ref_steps, port_steps = _run_both(ref_model, ref_params, model, params,
                                      dtype, frames, toks, 6, 12)
    tol = LOGIT_TOL[dtype]
    for want, got in zip(ref_steps, port_steps):
        assert got.shape == (2, model.cfg.vocab_size)
        assert np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=tol, atol=tol)
        top2 = np.sort(want, -1)[:, -2:]
        clear = top2[:, 1] - top2[:, 0] > 2 * tol
        assert (got.argmax(-1) == want.argmax(-1))[clear].all()


def test_frames_reach_the_logits_in_both_packages():
    """With the gates nonzero, other frames give other logits, at prefill
    and at a decode step (the cross cache), in both packages; with the
    reference's zero-initialised gates they give the same logits: why
    every comparison here opens the gates."""
    cfg = get_config(ARCH)
    frames, toks = _inputs(cfg)
    other, _ = _inputs(cfg, seed=1)
    for gate, moves in ((1.0, True), (0.0, False)):
        ref_model, ref_params = _ref_params(gate=gate)
        model = build_model(cfg, enc_len=ENC)
        params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                                 device="cpu")
        both = _cast((ref_model, ref_params, model, params), "float32")
        runs = [_run_both(*both, "float32", f, toks, 1, 8)
                for f in (frames, other)]
        for pkg in (0, 1):                    # reference, port
            for step in (0, 1):               # prefill, decode
                a, b = runs[0][pkg][step], runs[1][pkg][step]
                assert (np.abs(a - b).max() > 1e-3) == moves, (gate, pkg,
                                                               step)


def test_full_enc_len_cache_and_refusals():
    """``enc_len`` defaults to the reference's 1500; the int8 cache, an
    unknown family and a dense init_cache raise; the engine refuses the
    audio family, as the reference's cannot serve it."""
    from repro_torch.core.engine import EngineConfig, SiPipeEngine
    cfg = get_config(ARCH)
    model = build_model(cfg)
    assert model.enc_len == 1500
    cache = model.init_cache(2, 8, device="cpu")
    assert cache["decoder"]["cross"]["k"].shape == (
        cfg.num_layers, 2, 1500, cfg.num_kv_heads, cfg.resolved_head_dim)
    assert cache["decoder"]["self"]["v"].shape[2] == 8
    with pytest.raises(NotImplementedError, match="kv_quant"):
        build_model(cfg, ModelOptions(kv_quant=True))
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.__class__(**{**cfg.__dict__, "family": "video"}))
    with pytest.raises(ValueError, match="audio"):
        build_model(get_config("stablelm-1.6b-smoke")).init_cache(1, 8,
                                                                  device="cpu")
    params = model.init(0, device="cpu")
    with pytest.raises(NotImplementedError, match="audio"):
        SiPipeEngine(model, params, EngineConfig(max_seq_len=64))
