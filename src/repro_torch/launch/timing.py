"""Device time of a call on the card, for the launch scripts that sweep
kernels (``decode_split_sweep``, ``decode_quant_passes``, ``gemm_sweep``):
the stream sleeps first, so the events time the calls back to back on the
card, as ``chip_smoke.py``'s ``_device_ms`` does."""
from __future__ import annotations

import torch

SLEEP_CYCLES = 50_000_000


def device_ms(fn, reps: int) -> float:
    """Mean device ms of ``fn()`` over ``reps`` calls back to back behind
    a sleep, after one call to warm up."""
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps
