"""Per-request sampling parameters (vLLM-compatible subset)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    min_p: float = 0.0        # 0.0 = disabled
    frequency_penalty: float = 0.0
    presence_penalty: float = 0.0
    repetition_penalty: float = 1.0   # 1.0 = disabled (multiplicative)
    max_new_tokens: int = 64
    eos_token_id: int = -1    # -1 = never stop on EOS
    greedy: bool = False
    # parallel sampling: n completions from one prompt prefill.  n-1
    # children are CoW-forked off the parent's KV when its first token
    # lands (docs/memory.md "Prefix caching & CoW forks"); paged KV only.
    n: int = 1
    # request priority (docs/http.md): higher values are served first.
    # Threaded through Sequence into the scheduler — admission orders the
    # waiting queue priority-then-FIFO, and the paged preemption victim
    # choice is lowest-priority-then-latest-arrival, so under block
    # pressure low-priority requests are evicted before high-priority
    # ones.  0 is the neutral default; negative values mark best-effort
    # background work (e.g. offline batch traffic).
    priority: int = 0
    # workload tier (docs/hybrid.md): "online" requests are foreground
    # latency-SLO traffic; "offline" requests (evals, synthetic data,
    # backfills) queue separately, are admitted only into measured
    # pipeline slack, and are ALWAYS the first preemption victims — an
    # offline sequence ranks below every online priority, including
    # negative ones.  Priority still orders requests WITHIN a tier.
    tier: str = "online"

    def __post_init__(self):
        if self.tier not in ("online", "offline"):
            raise ValueError(
                f"tier must be 'online' or 'offline', got {self.tier!r}")

    def needs_penalties(self) -> bool:
        return (
            self.frequency_penalty != 0.0
            or self.presence_penalty != 0.0
            or self.repetition_penalty != 1.0
        )
