"""The four architectures the reference's engine serves beside stablelm,
mixtral and whisper: codeqwen1.5-7b, glm4-9b, minicpm-2b and
llama4-maverick-400b-a17b (a dense and an MoE layer per group, 128
experts top-1 with a shared expert), held against the reference on the
CPU with the reference's weights (``params_from_jax``):

* each config module is the reference's but for its import line (and
  llama4's one-card depth), and ``get_config`` gives equal fields, full
  and ``-smoke``;
* glm4-9b-smoke (GQA g 2, Kv 2) and codeqwen1.5-7b-smoke (RoPE theta 1e6)
  through NaivePPEngine, fp32, monolithic and chunked: equal streams and
  scheduling traces (minicpm-2b-smoke is stablelm-1.6b-smoke after
  ``reduced()``, held by tests/test_torch_engine.py);
* llama4-maverick-400b-a17b-smoke: prefill logits with the shared expert
  as a separate branch and fused into the MoE sum (``fuse_shared_expert``)
  within 1e-4 in fp32 and 0.1 in bf16, the two forms bit-equal in bf16,
  the bridge's shared-expert leaves bit for bit, and the engine's streams
  and traces in fp32 (monolithic, chunked, the int8 cache);
* the same model recast to H 10 over Kv 2 (g 5, as the full config's 40
  over 8, which ``reduced()`` does not reach): equal streams and traces.

Chunk steps of llama4: top-1 routing at the smoke config's capacity
(factor 2.0: half the packed tokens an expert) drops tokens, bucket padding
last, and a dropped padding row's K/V differ from the valid token it
repeats.  The reference scatters every packed token's K/V, so its cache
slot then holds whichever write XLA lets win; the port writes only the
valid tokens (ROADMAP section 3c item 1, pinned for mixtral by
tests/test_torch_moe.py::test_padding_dropped_by_capacity_is_the_one_
difference).  So the chunked comparisons run the port once more with the
padding written as the reference writes it (last write wins, as on the
CPU in both): traces and streams must then be equal, and the traces of the
port's own run too (the schedule does not read token values).

In bf16 a top-1 router whose two best logits lie closer than the two
packages' rounding difference can send a token to another expert, which
moves that batch row's logits by far more than the tolerance; the bf16
prefill test records each token's route in both packages, holds the rows
routed alike to the tolerance, and checks that every other row parted at
such a near-tie.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as ref_moe
import repro_torch.models.moe as port_moe
import repro_torch.models.transformer as port_transformer
from repro.configs import get_config as ref_get_config
from repro.core import engine as ref_engine
from repro.core.sampling_params import SamplingParams as RefSamplingParams
from repro.models import ModelOptions as RefModelOptions
from repro.models import ShardCtx
from repro.models import build_model as ref_build_model
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config, list_archs
from repro_torch.core import engine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.registry import ModelOptions, build_model
from repro_torch.models.stacked import tree_map
from test_torch_engine import _prompts, _run

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MODULES = {"codeqwen1.5-7b": "codeqwen1_5_7b", "glm4-9b": "glm4_9b",
           "minicpm-2b": "minicpm_2b",
           "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b"}
LLAMA4 = "llama4-maverick-400b-a17b-smoke"
LOGIT_TOL = {"float32": 1e-4, "bfloat16": 0.1}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
LENS, N_NEW = (13, 9), 4


def _source(pkg, module):
    with open(os.path.join(SRC, pkg, "configs", module + ".py")) as f:
        return f.read().splitlines()


@pytest.mark.parametrize("arch", list(MODULES))
def test_config_module_is_the_references_but_its_import(arch):
    """Line for line the reference's module with ``repro.configs.base``
    read as ``repro_torch.configs.base``; llama4 adds only its one-card
    depth, ``ONE_CARD_LAYERS``, after a comment."""
    ref = _source("repro", MODULES[arch])
    port = _source("repro_torch", MODULES[arch])
    assert port[:len(ref)] == [
        line.replace("from repro.configs.base import",
                     "from repro_torch.configs.base import") for line in ref]
    extra = port[len(ref):]
    if arch.startswith("llama4"):
        code = [line for line in extra if line and not line.startswith("#")]
        assert code == ["ONE_CARD_LAYERS = 4"]
    else:
        assert extra == []
    assert arch in list_archs()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list(MODULES))
def test_get_config_gives_the_references_fields(arch, smoke):
    name = arch + ("-smoke" if smoke else "")
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(ref_get_config(name))


def _models(arch, seed=0, **recast):
    """Both packages' models of ``arch`` (recast by ``recast``) with the
    reference's weights from ``seed``, in fp32."""
    ref_cfg = dataclasses.replace(ref_get_config(arch), **recast)
    cfg = dataclasses.replace(get_config(arch), **recast)
    ref_model = ref_build_model(ref_cfg)
    ref_params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              ref_model.init(jax.random.key(seed)))
    params = params_from_jax(jax.tree.map(np.asarray, ref_params),
                             device="cpu")
    return ref_model, ref_params, build_model(cfg), params


def _engines_agree(models, policy, monkeypatch=None):
    """NaivePPEngine of both packages on the same prompts, in fp32: equal
    greedy streams and equal traces (members, spans, sampling points,
    block tables and CoW copies, iteration for iteration).  With
    ``monkeypatch`` (an MoE model's chunk steps, see the module's
    docstring) the port's own run gives the reference's traces, and a
    second run that writes the bucket padding's K/V as the reference does
    gives its streams too."""
    ref_model, ref_params, model, params = models
    prompts = _prompts(LENS, seed=5)
    kw = dict(n_new=N_NEW, policy=policy)
    ref = _run(ref_engine, "NaivePPEngine", RefSamplingParams, ref_model,
               ref_params, prompts, **kw)
    port = _run(engine, "NaivePPEngine", SamplingParams, model, params,
                prompts, **kw)
    assert [len(s) for _, s in port[0]] == [N_NEW] * len(prompts)
    assert port[1] == ref[1]
    assert port[2]["kv_blocks_free"] == port[2]["kv_blocks_total"]
    if monkeypatch is not None:
        block = port_transformer.self_attn_block

        def padding_written(p, x, ctx, cache, cfg, **kwargs):
            if ctx.mode == "chunk":
                ctx = dataclasses.replace(ctx, n_valid=None)
            return block(p, x, ctx, cache, cfg, **kwargs)

        monkeypatch.setattr(port_transformer, "self_attn_block",
                            padding_written)
        port = _run(engine, "NaivePPEngine", SamplingParams, model, params,
                    prompts, **kw)
        assert port[1] == ref[1]
    assert port[0] == ref[0]


@pytest.mark.parametrize("policy", ["monolithic", "chunked"])
@pytest.mark.parametrize("arch", ["glm4-9b-smoke", "codeqwen1.5-7b-smoke"])
def test_dense_engine_matches_reference(arch, policy):
    _engines_agree(_models(arch), policy)


# ---------------------------------------------------------------------------
# llama4-maverick: the shared expert
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def llama4():
    return _models(LLAMA4)


def test_bridge_carries_the_shared_expert(llama4):
    """``shared_w1`` / ``shared_w3`` [groups, d, ff] and ``shared_w2``
    [groups, ff, d] of each group's MoE layer, bit for bit, in the port's
    layout (its own init's shapes)."""
    ref_model, ref_params, model, params = llama4
    leaves = jax.tree_util.tree_flatten_with_path(ref_params)[0]
    shared = [(p, a) for p, a in leaves if "shared" in jax.tree_util.keystr(p)]
    assert len(shared) == 3
    for path, leaf in shared:
        t = params
        for k in path:
            t = t[k.key]
        np.testing.assert_array_equal(t.numpy(), np.asarray(leaf))
    ffn = params["stacks"]["blocks"]["l1"]["ffn"]
    assert tuple(ffn["shared_w1"].shape) == (2, 64, 128)
    assert tuple(ffn["shared_w3"].shape) == (2, 64, 128)
    assert tuple(ffn["shared_w2"].shape) == (2, 128, 64)
    assert "shared_w1" not in params["stacks"]["blocks"]["l0"]["ffn"]
    own = model.init(1, device="cpu")
    assert tree_map(lambda x: tuple(x.shape), own) == \
        tree_map(lambda x: tuple(x.shape), params)


def _routes(monkeypatch):
    """Record the router logits [T, E] of every MoE call of both packages
    (the reference's through a callback from inside its jit)."""
    seen = {"ref": [], "port": []}
    ref_local, port_local = ref_moe._moe_local, port_moe.moe_local

    def ref_hook(x2d, params, moe, **kw):
        jax.debug.callback(lambda a: seen["ref"].append(np.asarray(a)),
                           (x2d @ params["router"]).astype(jnp.float32))
        return ref_local(x2d, params, moe, **kw)

    def port_hook(x2d, params, moe, shared=None):
        seen["port"].append((x2d @ params["router"]).float().numpy())
        return port_local(x2d, params, moe, shared)

    monkeypatch.setattr(ref_moe, "_moe_local", ref_hook)
    monkeypatch.setattr(port_moe, "moe_local", port_hook)
    return seen


@pytest.mark.parametrize("fuse", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_llama4_prefill_logits_match_reference(llama4, dtype, fuse,
                                               monkeypatch):
    """Prefill of a [3, 21] batch through both packages, the shared expert
    as a separate branch or fused: in fp32 every token takes the same
    expert and the logits agree within 1e-4; in bf16 the rows whose tokens
    all take the same experts agree within 0.1, and each other row parted
    at a router near-tie (a top-2 gap within twice the packages' largest
    router logit difference)."""
    _, ref_params, _, params = llama4
    jdt, tdt = DTYPES[dtype]
    ref_model = ref_build_model(ref_get_config(LLAMA4), ShardCtx.single(),
                                RefModelOptions(fuse_shared_expert=fuse))
    model = build_model(get_config(LLAMA4),
                        ModelOptions(fuse_shared_expert=fuse))
    toks = np.random.default_rng(7).integers(2, 256, (3, 21)).astype(np.int32)
    seen = _routes(monkeypatch)
    want, _ = jax.jit(ref_model.prefill)(
        jax.tree.map(lambda a: a.astype(jdt), ref_params),
        {"tokens": jnp.asarray(toks)})
    jax.effects_barrier()
    got, _ = model.prefill(tree_map(lambda t: t.to(tdt), params),
                           {"tokens": torch.tensor(toks)})
    want, got = np.asarray(want, np.float32), got.float().numpy()
    assert len(seen["ref"]) == len(seen["port"]) == 2      # two MoE layers
    alike = np.ones(3, bool)
    for r, p in zip(seen["ref"], seen["port"]):
        same = (r.argmax(-1) == p.argmax(-1)).reshape(3, 21)
        alike &= same.all(1)
        top2 = np.sort(r, -1)[:, -2:]
        gap = (top2[:, 1] - top2[:, 0]).reshape(3, 21)
        # a near-tie: each of the two logits moved by at most the call's
        # largest difference between the packages
        assert (gap[~same] <= 2 * np.abs(r - p).max()).all()
    if dtype == "float32":
        assert alike.all()
    assert alike.any()
    np.testing.assert_allclose(got[alike], want[alike],
                               atol=LOGIT_TOL[dtype], rtol=0)


def test_llama4_fused_shared_expert_is_bit_equal_in_bf16(llama4):
    """The fused form adds the shared expert's bf16 product to the routed
    sum in bf16, as the separate branch adds it to the routed output: the
    same operations on the same values, so prefill logits and a decode
    step's are bit-equal (the card run asserts the same of its streams)."""
    _, _, model, params = llama4
    fused = build_model(get_config(LLAMA4),
                        ModelOptions(fuse_shared_expert=True))
    p = tree_map(lambda t: t.bfloat16(), params)
    toks = torch.tensor(np.random.default_rng(8).integers(2, 256, (2, 11)))
    (a, ca), (b, cb) = (m.prefill(p, {"tokens": toks})
                        for m in (model, fused))
    assert torch.equal(a, b)
    tables = torch.tensor([[0, 1], [2, 3]], dtype=torch.int32)
    caches = []
    for m, c in ((model, ca), (fused, cb)):
        cache = m.paged_cache(2, 5, 8, device="cpu")
        for layer in cache:
            for kk in "kv":
                src = c["blocks"][layer][kk]             # [G, B, 11, ...]
                for row in range(2):
                    for s in range(11):
                        cache[layer][kk][:, int(tables[row, s // 8]),
                                         s % 8] = src[:, row, s]
        batch = {"token": toks[:, -1], "block_tables": tables,
                 "positions": torch.tensor([11, 11], dtype=torch.int32)}
        caches.append(m.decode(p, cache, batch)[0])
    assert torch.equal(*caches)


@pytest.mark.parametrize("policy,kv_quant", [("monolithic", False),
                                             ("chunked", False),
                                             ("chunked", True)])
def test_llama4_engine_matches_reference(llama4, policy, kv_quant,
                                        monkeypatch):
    ref_model, ref_params, model, params = llama4
    if kv_quant:
        ref_model = ref_build_model(ref_get_config(LLAMA4), ShardCtx.single(),
                                    RefModelOptions(kv_quant=True))
        model = build_model(get_config(LLAMA4), ModelOptions(kv_quant=True))
    _engines_agree((ref_model, ref_params, model, params), policy,
                   monkeypatch if policy == "chunked" else None)


@pytest.mark.parametrize("policy", ["monolithic", "chunked"])
def test_llama4_at_head_group_5_matches_reference(policy, monkeypatch):
    """H 10 over Kv 2: g 5, as llama4's 40 heads over 8 (the tiled CUDA
    bodies' 64-row blocks then hold 12 tokens x 5 heads and 4 idle
    rows)."""
    models = _models(LLAMA4, seed=2, num_heads=10, num_kv_heads=2)
    assert models[2].cfg.num_heads // models[2].cfg.num_kv_heads == 5
    _engines_agree(models, policy,
                   monkeypatch if policy == "chunked" else None)
