"""Device time of the bf16 decode kernels at other split sizes and ring
depths, to choose the split body's constants on the card.

    PYTHONPATH=src python -m repro_torch.launch.decode_split_sweep

``csrc/decode_attention_split.cuh`` cuts a row's visible slots into chunks
of ``DECODE_SPLIT_SLOTS`` (the port's ``_paged.DECODE_SPLIT``) and stages
64-slot tiles into a ring ``DECODE_SPLIT_STAGES`` deep.  This builds
``csrc/decode_attention.cu`` once per (split, depth) with ``-D`` into
``build/kernels/sweep/``, calls its C entries directly (the port's wrappers
take only the built value) on random bf16 caches from ``--seed``, and
prints each case's device time per variant, twice in turn (the stream
sleeps first, so the events time the calls back to back on the card, as
``chip_smoke.py``'s ``_device_ms``).  Cases: the paged rolling decode at
``chip_smoke.py``'s W = 4096 case and at mixtral-8x7b's profiled decode
step (B 4), stablelm-1.6b's paged decode (B 8, contexts up to 640),
glm4-9b's widths (Kv 2: g 16), and whisper-small's cross decode over
contiguous rows of 1500 slots.  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.launch.timing import device_ms

VARIANTS = [(128, 3), (256, 2), (256, 3), (512, 2), (512, 3)]
REPS = 50
BS = 16

# name, layout, (H, Kv, hd), window, positions (None: draw 8 in 100-640)
CASES = [
    ("mixtral rolling, W 4096, B 8", "paged", (32, 8, 128), 4096,
     [99, 700, 2047, 4095, 4096, 4600, 7000, 8999]),
    ("mixtral decode step, B 4", "paged", (32, 8, 128), 4096,
     [4700, 300, 4500, 100]),
    ("stablelm, B 8", "paged", (32, 32, 64), 0, None),
    ("glm4-9b widths, B 4", "paged", (32, 2, 128), 0, [639, 400, 611, 200]),
    ("whisper cross, B 4 x 1500", "rows", (12, 12, 64), 0,
     [1499, 1499, 1499, 1499]),
]


def _libs() -> dict:
    """Every variant's library, one nvcc each, all at once."""
    outs, procs = {}, []
    for split, stages in VARIANTS:
        out = _build.BUILD_DIR / "sweep" / f"libdecode_{split}_{stages}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        outs[(split, stages)] = out
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS,
             f"-DDECODE_SPLIT_SLOTS={split}",
             f"-DDECODE_SPLIT_STAGES={stages}", "-o", str(out),
             str(_build.CSRC / "decode_attention.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for v, out in outs.items():
        lib = libs[v] = ctypes.CDLL(str(out))
        lib.paged_decode_attention.argtypes = [p] * 7 + [i] * 9 + [
            ctypes.c_float, p]
        lib.contiguous_decode_attention.argtypes = [p] * 7 + [i] * 8 + [
            ctypes.c_float, p]
        lib.paged_decode_attention.restype = i
        lib.contiguous_decode_attention.restype = i
    return libs


def _case(gen, layout, shape, window, positions, dev):
    """bf16 q and caches (paged: shuffled pages and tables; rows: one row a
    batch row) and the C call's arguments but the workspace and split."""
    h, kv, hd = shape
    pos = np.asarray(positions, np.int64)
    n = np.minimum(pos + 1, window) if window else pos + 1
    b = len(pos)
    rand = lambda *s: torch.tensor(gen.standard_normal(s, np.float32),
                                   device=dev).bfloat16()
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    q = rand(b, h, hd)
    if layout == "rows":
        s = int(n.max())
        k, v = rand(b, s, kv, hd), rand(b, s, kv, hd)
        index, width = i32(np.arange(b)), s
        dims = [b, h, kv, hd, b, s]
    else:
        nb = int(-(-n.max() // BS))
        perm = gen.permutation(b * nb)
        tables = perm.reshape(b, nb)
        k, v = rand(b * nb, BS, kv, hd), rand(b * nb, BS, kv, hd)
        index = i32(tables)
        width = min(nb * BS, window) if window else nb * BS
        dims = [b, h, kv, hd, BS, nb, b * nb]
    tensors = [q, k, v, index, i32(pos)]
    return tensors, dims, width, (b, h, kv, hd)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_split_sweep: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.monotonic()
    libs = _libs()
    print(f"sweep: built {len(libs)} variants in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    gen = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for name, layout, shape, window, positions in CASES:
        if positions is None:
            positions = gen.integers(100, 641, 8) - 1
        tensors, dims, width, (b, h, kv, hd) = _case(
            gen, layout, shape, window, positions, dev)
        out = torch.empty((b, h * hd), dtype=torch.bfloat16, device=dev)
        ptrs = [t.data_ptr() for t in tensors]

        def caller(split, stages):
            ws = torch.empty(b * h * -(-width // split) * (hd + 2),
                             dtype=torch.float32, device=dev)
            lib = libs[(split, stages)]
            entry = (lib.paged_decode_attention if layout == "paged"
                     else lib.contiguous_decode_attention)
            return lambda: entry(*ptrs, ws.data_ptr(), out.data_ptr(), *dims,
                                 split, window, hd ** -0.5, stream)

        ref = None
        for rep in range(2):
            for split, stages in VARIANTS:
                call = caller(split, stages)
                if call():
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                if ref is None:
                    ref = out.clone()
                # each variant sums in its own order: within a few bf16
                # steps of the first
                gap = float((out.float() - ref.float()).abs().max())
                ms = device_ms(call, REPS)
                results.append(dict(case=name, split=split, stages=stages,
                                    rep=rep, ms=ms, max_diff=gap))
                print(f"sweep {name}: split {split} stages {stages} rep "
                      f"{rep}: {ms:.4f} ms (max |diff| {gap:.2e}) on {card}",
                      flush=True)
    print(card)
    print(json.dumps({"card": card, "sweep": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
