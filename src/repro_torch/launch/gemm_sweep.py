"""Device time of the fused-product kernels (``swiglu``,
``rmsnorm_matmul``) at other split counts than their plans',
to choose the plan's rules (``kernels/_gemm.py``) on the card.

    PYTHONPATH=src python -m repro_torch.launch.gemm_sweep [--seed N]

Launches the kernels through their wrappers' private ``_launch`` with
each alternative plan (swiglu: 1-8 slices of the down product's sum;
rmsnorm_matmul: 1-8 slices) on random bf16 inputs from ``--seed``, holds
every output within ``_gemm.gemm_limit`` of the plain version, and prints
each variant's device time at chip_smoke.py's main shapes, twice in turn
(``launch/timing.py``), the plan's own marked.  Needs one CUDA card and
``nvcc``.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess

import numpy as np
import torch

from repro_torch.kernels import _gemm
from repro_torch.kernels import rmsnorm_matmul as krm
from repro_torch.kernels import swiglu as ksw
from repro_torch.launch.timing import device_ms
from repro_torch.models.common import rmsnorm

REPS = 20
SPLITS = (1, 2, 3, 4, 6, 8)
SWIGLU = [(4, 2048, 5632), (16, 2048, 5632), (64, 2048, 5632),
          (256, 2048, 5632), (80, 4096, 14336)]
RMSNORM = [(4, 2048, 100352), (4, 4096, 32000), (16, 2048, 5632),
           (64, 2048, 5632), (256, 2048, 5632)]


def _splits(p):
    """p at each split count of SPLITS that its k-steps allow."""
    out = []
    for s in SPLITS:
        alt = dataclasses.replace(p, q=-(-p.nk // s))
        if alt.splits == s:
            out.append(alt)
    return out


def _run(label, call, plain, lhs, rhs, plans, chosen):
    """Each plan's output held to the limit, then timed twice in turn."""
    for p in plans:
        _, ratio = _gemm.gemm_excess(call(p), plain, lhs, rhs)
        if not ratio <= 1:
            raise AssertionError(f"{label} {p}: outside the limit ({ratio})")
    times = {p: [] for p in plans}
    for order in (plans, plans[::-1]):
        for p in order:
            times[p].append(device_ms(lambda: call(p), REPS))
    for p in plans:
        mark = "  (plan)" if p == chosen else ""
        print(f"{label} splits {p.splits} (q {p.q}): "
              + " / ".join(f"{ms:.4f}" for ms in times[p]) + f" ms{mark}",
              flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_sweep: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}", flush=True)
    gen = np.random.default_rng(args.seed)
    dev = torch.device("cuda")

    def rand(*shape, scale=1.0):
        return (torch.tensor(gen.standard_normal(shape, np.float32),
                             device=dev) * scale).to(torch.bfloat16)

    for t, d, ff in SWIGLU:
        x = rand(t, d)
        w1, w3 = rand(d, ff, scale=d ** -0.5), rand(d, ff, scale=d ** -0.5)
        w2 = rand(ff, d, scale=ff ** -0.5)
        _, down = _gemm.swiglu_plans(t, d, ff)
        _run(f"swiglu T={t} d={d} ff={ff}",
             lambda p: ksw._launch(x, w1, w3, w2, p),
             ksw.swiglu_plain(x, w1, w3, w2), ksw.swiglu_hidden(x, w1, w3),
             w2, _splits(down), down)
        del x, w1, w3, w2
    for t, d, f in RMSNORM:
        x, wn = rand(t, d), 1.0 + rand(d, scale=0.1)
        wp = rand(d, f, scale=d ** -0.5)
        p = _gemm.plan(t, d, f)
        _run(f"rmsnorm_matmul T={t} d={d} F={f}",
             lambda q: krm._launch(x, wn, wp, 1e-5, q),
             krm.rmsnorm_matmul_plain(x, wn, wp), rmsnorm(x, wn), wp,
             _splits(p), p)
        del x, wn, wp


if __name__ == "__main__":
    main()
