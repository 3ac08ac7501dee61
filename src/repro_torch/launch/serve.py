"""Serving entry point: the port's SiPipe engine end to end on a dense or
MoE model with a ShareGPT-shaped workload (offline batch: enqueue
everything, then a blocking ``run()``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b

``--arch stablelm-1.6b`` serves the full-size configuration (random
weights from ``--seed``); ``stablelm-1.6b-smoke`` the reduced one.
``--arch mixtral-8x7b-smoke`` serves the reduced MoE model with its
sliding window (W = 32, rolling KV cache); ``mixtral-8x7b`` at its 32
published layers needs ~93 GB of bf16 weights, more than one 80 GB card
holds (``chip_smoke.py`` serves it cut to 16 layers).  The engine runs on
the card unless ``--device cpu`` is given.  Without
``--chunk-tokens`` the default policy prefills whole prompts
(monolithic); ``--chunk-tokens 256`` selects chunked prefill.
``--kv-layout contiguous`` serves over one cache row per sequence instead
of the paged cache (``auto``, the default, takes the paged one unless a
window is not a multiple of ``--block-size``).
"""
from __future__ import annotations

import argparse
import json

from repro_torch import resolve_device
from repro_torch.configs import get_config
from repro_torch.core.engine import EngineConfig, NaivePPEngine, SiPipeEngine
from repro_torch.core.sampling_params import SamplingParams
from repro_torch.models.registry import build_model
from repro_torch.runtime.data import ShareGPTLike

POLICY_CHOICES = ["auto", "monolithic", "chunked", "disaggregated", "adaptive"]
KV_LAYOUT_CHOICES = ["auto", "paged", "contiguous"]


def run(arch: str, *, engine: str = "sipipe", pp: int = 2, requests: int = 8,
        max_batch: int = 4, max_new_tokens: int = 16, max_seq_len: int = 256,
        chunk_tokens: int = 0, policy: str = "auto", kv_layout: str = "auto",
        block_size: int = 16, kv_blocks: int = 0, seed: int = 0, device=None,
        verbose: bool = True) -> dict:
    """Offline batch mode: enqueue every prompt, blocking run()."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(seed, device=dev)
    ecfg = EngineConfig(pp_degree=pp, max_batch=max_batch,
                        max_seq_len=max_seq_len,
                        prefill_chunk_tokens=chunk_tokens or None,
                        scheduling_policy=policy, kv_layout=kv_layout,
                        kv_block_size=block_size,
                        kv_blocks=kv_blocks or None, seed=seed)
    eng = (SiPipeEngine if engine == "sipipe" else NaivePPEngine)(
        model, params, ecfg)
    wl = ShareGPTLike(cfg.vocab_size, n_requests=requests, seed=seed,
                      prompt_len_median=12, max_prompt=max_seq_len // 4,
                      output_len_median=max_new_tokens,
                      max_output=max_new_tokens)
    sp_base = SamplingParams(temperature=0.8, top_k=40, top_p=0.95,
                             frequency_penalty=0.2, presence_penalty=0.1)
    for prompt, budget in wl.requests():
        eng.add_request(prompt, SamplingParams(
            **{**sp_base.__dict__,
               "max_new_tokens": min(budget, max_new_tokens)}))
    done = eng.run()
    m = eng.metrics()
    m["engine"] = engine
    m["finished"] = len(done)
    m["device"] = str(dev)
    if verbose:
        print(json.dumps({k: v for k, v in m.items()
                          if k not in ("stages", "requests")},
                         indent=1, default=float))
        for i, st in enumerate(m["stages"]):
            print(f"  stage{i}: busy={st['busy_s']:.2f}s "
                  f"prep={st['prep_s']:.2f}s bubble={st['bubble_frac']:.2f}")
    return m


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b",
                    help="architecture id; a '-smoke' suffix selects the "
                         "reduced configuration")
    ap.add_argument("--engine", default="sipipe", choices=["sipipe", "naive"])
    ap.add_argument("--pp", type=int, default=2)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--chunk-tokens", type=int, default=0,
                    help="per-iteration token budget for span scheduling "
                         "policies (0 = monolithic prefill)")
    ap.add_argument("--policy", default="auto", choices=POLICY_CHOICES,
                    help="scheduling policy; 'auto' maps a token budget to "
                         "chunked")
    ap.add_argument("--kv-layout", default="auto", choices=KV_LAYOUT_CHOICES,
                    help="KV cache layout: paged block tables or one "
                         "contiguous row per sequence ('auto': paged "
                         "unless a window is not a block multiple)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="KV slots per physical block")
    ap.add_argument("--kv-blocks", type=int, default=0,
                    help="total physical blocks (0 = the slot budget "
                         "contiguous rows would reserve)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the plain "
                         "PyTorch path)")
    args = ap.parse_args()
    run(args.arch, engine=args.engine, pp=args.pp, requests=args.requests,
        max_batch=args.max_batch, max_new_tokens=args.max_new_tokens,
        chunk_tokens=args.chunk_tokens, policy=args.policy,
        kv_layout=args.kv_layout, block_size=args.block_size, kv_blocks=args.kv_blocks,
        seed=args.seed, device=args.device)


if __name__ == "__main__":
    main()
