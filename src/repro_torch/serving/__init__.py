"""HTTP serving front-end over the engine (docs/http.md).

The first transport layer of the reproduction: an OpenAI-style
``/v1/completions`` endpoint with SSE streaming (``server.py``), queue
caps + per-tenant fair queueing + request priorities (``admission.py``),
and N in-process engine replicas behind least-loaded-KV routing
(``router.py``).  Everything is stdlib-only — ``http.server`` +
``socket`` + ``threading`` — so the layer adds no dependencies.
"""
from repro_torch.serving.admission import AdmissionController, QueueFull, Ticket
from repro_torch.serving.protocol import (
    ProtocolError,
    completion_chunk,
    completion_response,
    parse_completion_request,
    render_prometheus,
    sse_event,
    SSE_DONE,
)
from repro_torch.serving.router import EngineReplica, Router
from repro_torch.serving.server import CompletionServer

__all__ = [
    "AdmissionController", "QueueFull", "Ticket",
    "ProtocolError", "completion_chunk", "completion_response",
    "parse_completion_request", "render_prometheus", "sse_event",
    "SSE_DONE",
    "EngineReplica", "Router", "CompletionServer",
]
