"""The port's compiled stage step: a stage's decode steps captured once per
shape as CUDA graphs and replayed from static device buffers.

The reference compiles each stage step once per shape (``jax.jit(decode_fn,
donate_argnums=(1,))``, repro/core/engine.py:182-189), counts the
executables in ``compile_stats()`` (:1150-1162), and its TSEM docstring
names them its stand-in for the paper's CUDA graphs (repro/core/
tsem.py:1-17).  :class:`StepGraphs` is the port's counterpart for decode
steps.  It keys them by shape: batch B and padded table width nb over the
paged cache, B alone over contiguous rows.  Those are the keys on which the
reference's ``decode_fn`` compiles, bounded the same way by
``max_table_buckets`` and the ``decode_enlarge_factor`` rungs.

* The first sight of a key copies the step's host inputs into new static
  device buffers, runs the step eagerly on them and returns that result.
  The kernels' first launches (module loads) and cuBLAS's first call
  happen there, never under capture.  Then it captures the same call on
  the same statics; the graph's output tensor is static too.
* A later sight copies the host inputs into the key's statics (pinned
  host memory, ``non_blocking``), replays, and copies the static output
  into a new pinned host buffer.  Each call returns a host array that no
  later step overwrites: the sampling worker reads logits on its own
  thread, after the stage has gone on.

Chunk steps (their unpadded count ``n_valid`` is a host int that shapes
the cache writes and the span kernels' launches) and prefill (its shapes
follow each prompt) stay eager.  A capture or replay error raises; there
is no quiet return to the eager step.

A replay runs no Python kernel wrapper, so the launches a capture makes
are recorded, not counted (``kernels/_paged.record_launches``), and every
replay adds them: the launch counters read the same on graph runs as on
eager runs.

What touches the device sits in a backend (:class:`CudaGraphs`), so that
the CPU tests drive the keys, the statics and the counting with a fake.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable, Dict, Hashable, Tuple

import numpy as np
import torch

from repro_torch.kernels import _paged


class CudaGraphs:
    """Capture and replay for one pipeline stage on one CUDA device.

    The stage gets its own stream: a capture needs a stream other than the
    default one, and two stage threads may capture at once.  It gets its
    own memory pool, which its graphs share: they replay one at a time on
    that stream, while another stage's graphs may replay concurrently.
    Captures use ``thread_local`` mode, so that the other stage threads'
    allocations and copies do not invalidate them."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device)
        self.pool = torch.cuda.graph_pool_handle()
        self._done = torch.cuda.Event()

    @contextlib.contextmanager
    def active(self):
        """Run the block on the stage's stream, after everything the
        calling thread has enqueued on its own (a CoW block copy)."""
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            yield

    def static(self, a: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
        """A device buffer shaped like host array ``a`` and its pinned
        host staging buffer."""
        dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
        host = torch.empty(a.shape, dtype=dtype, pin_memory=True)
        return torch.empty_like(host, device=self.device), host

    def upload(self, static: Tuple[torch.Tensor, torch.Tensor],
               a: np.ndarray) -> None:
        """``a`` into the static device buffer.  The staging buffer is
        free again: the last step that used it ended in :meth:`download`'s
        wait, after its copy."""
        dev, host = static
        np.copyto(host.numpy(), a)
        dev.copy_(host, non_blocking=True)

    def download(self, out: torch.Tensor) -> np.ndarray:
        """``out`` in a new pinned host buffer, once the stream has
        reached it."""
        host = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        host.copy_(out, non_blocking=True)
        self._done.record(self.stream)
        self._done.synchronize()
        return host.numpy()

    def capture(self, fn: Callable[[], torch.Tensor]):
        """Capture ``fn()`` into a graph in the stage's pool.  Returns the
        graph and ``fn``'s (static) output.  Raises if the capture
        fails."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = fn()
        except BaseException:
            try:
                graph.capture_end()
            except RuntimeError:
                pass     # the capture is invalid already; fn's error says why
            raise
        graph.capture_end()
        return graph, out

    def replay(self, graph) -> None:
        graph.replay()


@dataclasses.dataclass
class _Graph:
    graph: Any
    statics: Dict[str, Any]
    out: torch.Tensor
    launches: Dict[Any, int]      # kernel wrapper -> launches per replay


class StepGraphs:
    """One stage's captured decode steps, keyed by shape."""

    def __init__(self, backend):
        self.backend = backend
        self._graphs: Dict[Hashable, _Graph] = {}
        # one step at a time: a replay's statics and pool are the stage's
        self._lock = threading.Lock()
        self.replays = 0
        self.capture_s = 0.0

    def __len__(self) -> int:
        """Graphs captured (the stage's ``jit_executables``)."""
        return len(self._graphs)

    def run(self, key: Hashable, inputs: Dict[str, np.ndarray],
            step: Callable[..., torch.Tensor]) -> np.ndarray:
        """``step(**tensors)`` on device tensors holding the host arrays
        ``inputs``: eagerly, then captured, on the first sight of ``key``;
        replayed after.  ``inputs`` must have the same names, shapes and
        dtypes at every sight of a key.  Returns the output on the host,
        in an array no later call overwrites."""
        b = self.backend
        with self._lock, b.active():
            g = self._graphs.get(key)
            if g is None:
                statics = {}
                for name, a in inputs.items():
                    statics[name] = b.static(a)
                    b.upload(statics[name], a)
                args = {name: s[0] for name, s in statics.items()}
                out = step(**args)
                t0 = time.perf_counter()
                with _paged.record_launches() as launches:
                    graph, static_out = b.capture(lambda: step(**args))
                self.capture_s += time.perf_counter() - t0
                self._graphs[key] = _Graph(graph, statics, static_out,
                                           launches)
                return b.download(out)
            for name, a in inputs.items():
                b.upload(g.statics[name], a)
            b.replay(g.graph)
            _paged.add_launches(g.launches)
            self.replays += 1
            return b.download(g.out)
