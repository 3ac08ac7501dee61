"""Synthetic serving workload (a copy of the reference's ``ShareGPTLike``).

Prompt and output lengths follow the ShareGPT workload used in the paper
(§7.1): log-normal, deterministic by seed.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class ShareGPTLike:
    """Synthetic serving workload with ShareGPT-shaped length statistics."""

    vocab_size: int
    n_requests: int = 64
    seed: int = 0
    prompt_len_median: int = 160
    prompt_len_sigma: float = 0.9
    output_len_median: int = 128
    output_len_sigma: float = 0.7
    max_prompt: int = 2048
    max_output: int = 1024

    def requests(self) -> List[Tuple[List[int], int]]:
        """[(prompt_ids, max_new_tokens)] deterministic by seed."""
        rng = np.random.default_rng(self.seed)
        out = []
        for _ in range(self.n_requests):
            pl = int(np.clip(rng.lognormal(np.log(self.prompt_len_median),
                                           self.prompt_len_sigma), 4, self.max_prompt))
            ol = int(np.clip(rng.lognormal(np.log(self.output_len_median),
                                           self.output_len_sigma), 4, self.max_output))
            prompt = rng.integers(2, self.vocab_size, size=pl).tolist()
            out.append((prompt, ol))
        return out

    def arrivals(self, rate_rps: float) -> List[Tuple[float, List[int], int]]:
        """Poisson arrival process over :meth:`requests`: exponential
        inter-arrival gaps at ``rate_rps`` requests/second, deterministic
        by seed.  Returns ``[(t_arrival_s, prompt_ids, max_new_tokens)]``
        sorted by arrival time — the online serving replay format
        (``serve.py --online``)."""
        if rate_rps <= 0:
            raise ValueError(f"arrival rate must be positive, got {rate_rps}")
        rng = np.random.default_rng((self.seed, 0xA881))
        t = 0.0
        out = []
        for prompt, budget in self.requests():
            t += float(rng.exponential(1.0 / rate_rps))
            out.append((t, prompt, budget))
        return out
