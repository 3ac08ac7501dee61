"""Device time of the int8 decode kernels (PERF.md rows 2b, 2bc, 2br,
2bcr), whole and pass by pass, with and without programmatic dependent
launch.

    PYTHONPATH=src python -m repro_torch.launch.decode_quant_passes [--seed N]

``csrc/decode_attention_quant_split.cuh`` computes a call in four launches
(scores, sums, pv, av), passes 2-4 started as programmatic dependents of
the pass before when ``QSPLIT_PDL`` is 1 (the built value).  This builds
``csrc/decode_attention_quant.cu`` with ``-DQSPLIT_PDL=1`` and ``=0`` into
``build/kernels/sweep/``, calls its C entries directly on the same random
int8 caches from ``--seed``, and prints for each case and variant, twice
in turn: the call's device time (the stream sleeps first, so CUDA events
time ``REPS`` calls back to back on the card, as ``chip_smoke.py``'s
``_device_ms``) and each pass's mean device time from ``torch.profiler``'s
kernel records (with dependent launch a pass's record includes its wait
for the pass before, so only the variant without it splits the time).
Both variants must give the same bits.  Cases: ``chip_smoke.py``'s rolling
case (mixtral-8x7b widths H 32, Kv 8, hd 128; B 8 at positions 99-8999, W
4096) over pages and over rows, mixtral's profiled decode step (B 4),
stablelm-1.6b's (H = Kv = 32, hd 64; B 8 at contexts 100-1000), and
glm4-9b's widths (Kv 2: g 16).  Needs one CUDA card and ``nvcc``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import time

import numpy as np
import torch

from repro_torch.kernels import _build, _paged
from repro_torch.launch.timing import device_ms
from repro_torch.models.attention import gather_paged_cache, quantize_kv

VARIANTS = (1, 0)    # QSPLIT_PDL
REPS = 20
BS = 16
PASSES = ("scores", "sums", "pv", "av")

# name, layout, (H, Kv, hd), window, positions
CASES = [
    ("mixtral rolling, W 4096, B 8 (row 2br)", "paged", (32, 8, 128), 4096,
     [99, 700, 2047, 4095, 4096, 4600, 7000, 8999]),
    ("mixtral rolling rows, W 4096, B 8 (row 2bcr)", "rows", (32, 8, 128),
     4096, [99, 700, 2047, 4095, 4096, 4600, 7000, 8999]),
    ("mixtral decode step, B 4", "paged", (32, 8, 128), 4096,
     [4700, 300, 4500, 100]),
    ("stablelm, B 8 (row 2b)", "paged", (32, 32, 64), 0,
     [99, 250, 377, 512, 640, 777, 900, 999]),
    ("glm4-9b widths, B 4", "paged", (32, 2, 128), 0, [639, 400, 611, 200]),
]


def _libs() -> dict:
    """Every variant's library, one nvcc each, all at once."""
    outs, procs = {}, []
    for pdl in VARIANTS:
        out = _build.BUILD_DIR / "sweep" / f"libdecode_quant_pdl{pdl}.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        outs[pdl] = out
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, f"-DQSPLIT_PDL={pdl}",
             "-o", str(out),
             str(_build.CSRC / "decode_attention_quant.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed:\n{log}")
    p, i = ctypes.c_void_p, ctypes.c_int
    libs = {}
    for v, out in outs.items():
        lib = libs[v] = ctypes.CDLL(str(out))
        lib.paged_decode_attention_quant.argtypes = [p] * 9 + [i] * 9 + [
            ctypes.c_float, p]
        lib.contiguous_decode_attention_quant.argtypes = [p] * 9 + [i] * 8 + [
            ctypes.c_float, p]
        lib.paged_decode_attention_quant.restype = i
        lib.contiguous_decode_attention_quant.restype = i
    return libs


def _case(gen, layout, shape, window, positions, dev):
    """The C call's tensors (q, k8, ks, v8, vs, tables or rows, positions)
    and its integer arguments but the split and window: a shuffled paged
    cache, or its rows, quantized from standard normal bf16 values."""
    h, kv, hd = shape
    pos = np.asarray(positions)
    n = np.minimum(pos + 1, window) if window else pos + 1
    nb = -(-int(n.max()) // BS)
    b = len(pos)
    n_phys = b * nb
    tables = gen.permutation(n_phys).reshape(b, nb).astype(np.int32)
    bf = lambda *s: torch.tensor(gen.standard_normal(s, np.float32),
                                 device=dev).bfloat16()
    q = bf(b, h, hd)
    cache = [*quantize_kv(bf(n_phys, BS, kv, hd)),
             *quantize_kv(bf(n_phys, BS, kv, hd))]
    t = torch.tensor(tables, device=dev)
    p = torch.tensor(pos, dtype=torch.int32, device=dev)
    if layout == "paged":
        width = min(nb * BS, window) if window else nb * BS
        return [q, *cache, t, p], [b, h, kv, hd, BS, nb, n_phys], width
    rows = [gather_paged_cache(c, t).contiguous() for c in cache]
    idx = torch.arange(b, dtype=torch.int32, device=dev)
    s = nb * BS
    return ([q, *rows, idx, p], [b, h, kv, hd, b, s],
            min(s, window) if window else s)


def _pass_ms(fn) -> dict:
    """Mean device ms of each pass's kernel over REPS calls."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        m = re.search(r"qsplit::(\w+)_kernel", ev.key)
        if m:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            out[m.group(1)] = out.get(m.group(1), 0.0) + total / 1e3 / REPS
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("decode_quant_passes: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.monotonic()
    libs = _libs()
    print(f"passes: built {len(libs)} variants in "
          f"{time.monotonic() - t0:.1f}s", flush=True)
    gen = np.random.default_rng(args.seed)
    stream = torch.cuda.current_stream().cuda_stream
    results = []
    for name, layout, shape, window, positions in CASES:
        tensors, dims, width = _case(gen, layout, shape, window, positions,
                                     dev)
        b, h, kv, hd = dims[:4]
        out = torch.empty((b, h * hd), dtype=torch.bfloat16, device=dev)
        ws = torch.empty(_paged.quant_decode_workspace(b, h, kv, hd, width),
                         dtype=torch.float32, device=dev)
        ptrs = [t.data_ptr() for t in tensors]

        def caller(variant):
            lib = libs[variant]
            entry = (lib.paged_decode_attention_quant if layout == "paged"
                     else lib.contiguous_decode_attention_quant)
            return lambda: entry(*ptrs, ws.data_ptr(), out.data_ptr(), *dims,
                                 _paged.DECODE_SPLIT, window, hd ** -0.5,
                                 stream)

        ref = None
        for rep in range(2):
            for variant in VARIANTS:
                call = caller(variant)
                if call():
                    raise RuntimeError(f"{name}: launch failed")
                torch.cuda.synchronize()
                if ref is None:
                    ref = out.clone()
                if not torch.equal(out, ref):
                    raise AssertionError(f"{name}: variant {variant} gives "
                                         f"other bits")
                ms = device_ms(call, REPS)
                passes = _pass_ms(call)
                results.append(dict(case=name, pdl=variant, rep=rep, ms=ms,
                                    passes=passes))
                parts = " ".join(f"{p}={passes.get(p, float('nan')):.4f}"
                                 for p in PASSES)
                print(f"passes {name}: pdl {variant} rep {rep}: call "
                      f"{ms:.4f} ms; passes (profiler) {parts} on {card}",
                      flush=True)
    print(card)
    print(json.dumps({"card": card, "passes": results}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
