"""What the compiler made of the port's CUDA kernels: for each kernel
library, each entry function's registers and spill bytes (``ptxas -v``,
from the build log) and the count of tensor-core (``mma.sync``: IMMA,
HMMA; ``wgmma``: HGMMA), TMA-load (UTMALDG) and local-memory (LDL, STL:
spills) instructions in its SASS (``cuobjdump -sass``).

    PYTHONPATH=src python -m repro_torch.launch.kernel_report [name ...]

Names are sources under ``csrc/`` without ``.cu`` (default: all).  Needs
the CUDA toolkit (``nvcc``, ``cuobjdump``); builds what is not built yet.
"""
from __future__ import annotations

import argparse
import collections
import os
import re
import shutil
import subprocess

from repro_torch.kernels import _build

OPCODES = ("IMMA", "HMMA", "HGMMA", "UTMALDG", "LDL", "STL")


def ptxas_lines(log: str):
    """(entry function, registers, spill store bytes, spill load bytes)
    for each entry function in a ``ptxas -v`` log."""
    out, name, spills = [], None, (0, 0)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name is not None:
            out.append((name, int(m.group(1)), *spills))
            name, spills = None, (0, 0)
    return out


def sass_counts(lib: str) -> collections.Counter:
    """Counts of OPCODES in the SASS of one shared library."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    counts = collections.Counter()
    for line in sass.splitlines():
        m = re.search(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)",
                      line)
        if m and m.group(1) in OPCODES:
            counts[m.group(1)] += 1
    return counts


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("names", nargs="*", help="csrc sources (default: all)")
    names = ap.parse_args().names or _build.sources()
    print(f"build {_build.build(names):.1f} s", flush=True)
    for n in names:
        lib = str(_build._target(n))
        counts = sass_counts(lib)
        print(f"{n}: " + " ".join(f"{op}={counts[op]}" for op in OPCODES)
              + f" ({os.path.getsize(lib)} bytes)")
        for fn, regs, st, ld in ptxas_lines(_build.build_log(n)):
            print(f"  {fn}: {regs} registers, spill stores {st} B, "
                  f"spill loads {ld} B")


if __name__ == "__main__":
    main()
