"""Wire protocol for the OpenAI-style completions front-end (docs/http.md).

Pure functions only — request parsing, SSE chunk framing, completion
JSON assembly, and Prometheus text rendering — so the whole layer is
golden-file testable without sockets (tests/test_http.py).  Every
builder takes the non-deterministic fields (request id, ``created``
timestamp) as explicit arguments; nothing in this module reads a clock.

The repo has no real tokenizer, so the prompt contract is token-id
first: ``prompt`` is a ``list[int]`` of token ids (the form every
bit-exactness test uses), or a ``str`` that is byte-level stub-encoded
(``2 + byte % (vocab - 2)`` — deterministic, keeps ids out of the
reserved 0/1 range).  Response ``text`` is the space-joined token ids;
the real ids always ride along in a ``token_ids`` extension field.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Union

from repro_torch.core.sampling_params import SamplingParams

SSE_DONE = b"data: [DONE]\n\n"


class ProtocolError(ValueError):
    """Malformed client request; the server maps it to HTTP 400."""


def encode_prompt(prompt: Union[str, List[int]], vocab_size: int) -> List[int]:
    """Token ids for a request prompt: pass-through for ``list[int]``
    (range-checked), byte-level stub encoding for ``str``."""
    if isinstance(prompt, str):
        if not prompt:
            raise ProtocolError("prompt must be non-empty")
        return [2 + (b % (vocab_size - 2)) for b in prompt.encode("utf-8")]
    if isinstance(prompt, list) and prompt \
            and all(isinstance(t, int) and not isinstance(t, bool)
                    for t in prompt):
        bad = [t for t in prompt if not 0 <= t < vocab_size]
        if bad:
            raise ProtocolError(
                f"prompt token ids out of range [0, {vocab_size}): {bad[:4]}")
        return list(prompt)
    raise ProtocolError(
        "prompt must be a non-empty string or list of token ids")


def decode_text(token_ids) -> str:
    """Stub detokenization: space-joined token ids (reversible, stable)."""
    return " ".join(str(int(t)) for t in token_ids)


@dataclasses.dataclass
class CompletionRequest:
    """A parsed, validated /v1/completions body."""

    prompt_ids: List[int]
    model: str
    max_tokens: int = 16
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    n: int = 1
    stream: bool = False
    priority: int = 0
    tier: str = "online"    # hybrid serving (docs/hybrid.md)
    tenant: str = "anonymous"
    echo_prompt: bool = False

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def sampling_params(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature if not self.greedy else 1.0,
            top_p=self.top_p, top_k=self.top_k, greedy=self.greedy,
            max_new_tokens=self.max_tokens, n=self.n,
            priority=self.priority, tier=self.tier)


def parse_completion_request(body: Dict[str, Any], vocab_size: int, *,
                             tenant: Optional[str] = None,
                             max_tokens_cap: int = 0) -> CompletionRequest:
    """Validate a decoded JSON body into a :class:`CompletionRequest`.

    ``tenant`` is the transport-layer key (``X-API-Key`` header /
    ``Authorization: Bearer`` token); it wins over the body's OpenAI
    ``user`` field.  ``max_tokens_cap`` > 0 clamps the per-request
    output budget (the server passes the engine's room)."""
    if not isinstance(body, dict):
        raise ProtocolError("request body must be a JSON object")

    def field(name, typ, default):
        v = body.get(name, default)
        if typ is float and isinstance(v, int) and not isinstance(v, bool):
            v = float(v)
        # JSON true/false must not pass int/float checks (bool subclasses int)
        if not isinstance(v, typ) or (typ is not bool
                                      and isinstance(v, bool)):
            raise ProtocolError(f"{name!r} must be {typ.__name__}, "
                                f"got {type(v).__name__}")
        return v

    if "prompt" not in body:
        raise ProtocolError("missing required field 'prompt'")
    prompt_ids = encode_prompt(body["prompt"], vocab_size)
    max_tokens = field("max_tokens", int, 16)
    if max_tokens < 1:
        raise ProtocolError(f"max_tokens must be >= 1, got {max_tokens}")
    if max_tokens_cap:
        max_tokens = min(max_tokens, max_tokens_cap)
    n = field("n", int, 1)
    if not 1 <= n <= 8:
        raise ProtocolError(f"n must be in [1, 8], got {n}")
    temperature = field("temperature", float, 1.0)
    if temperature < 0.0:
        raise ProtocolError("temperature must be >= 0")
    top_p = field("top_p", float, 1.0)
    if not 0.0 < top_p <= 1.0:
        raise ProtocolError("top_p must be in (0, 1]")
    tier = field("tier", str, "online")
    if tier not in ("online", "offline"):
        raise ProtocolError(
            f"tier must be 'online' or 'offline', got {tier!r}")
    return CompletionRequest(
        prompt_ids=prompt_ids,
        model=field("model", str, "repro"),
        max_tokens=max_tokens,
        temperature=temperature,
        top_p=top_p,
        top_k=field("top_k", int, 0),
        n=n,
        stream=field("stream", bool, False),
        priority=field("priority", int, 0),
        tier=tier,
        tenant=tenant or field("user", str, "anonymous"),
    )


# ---------------------------------------------------------------------------
# SSE framing + completion JSON
# ---------------------------------------------------------------------------

def sse_event(payload: Dict[str, Any]) -> bytes:
    """One Server-Sent-Events frame: ``data: <json>\\n\\n`` (compact
    separators, sorted keys — byte-stable for the golden tests)."""
    return b"data: " + json.dumps(
        payload, separators=(",", ":"), sort_keys=True).encode() + b"\n\n"


def _choice(index: int, token_ids: List[int],
            finish_reason: Optional[str]) -> Dict[str, Any]:
    return {
        "index": index,
        "text": decode_text(token_ids),
        "token_ids": [int(t) for t in token_ids],
        "finish_reason": finish_reason,
        "logprobs": None,
    }


def completion_chunk(request_id: int, created: int, model: str, index: int,
                     new_token_ids: List[int],
                     finish_reason: Optional[str] = None) -> Dict[str, Any]:
    """One streaming increment for one choice (SSE ``data:`` payload).
    ``text``/``token_ids`` carry only the DELTA since the previous chunk
    of this choice; the terminal chunk repeats an empty delta with the
    ``finish_reason`` set when the final tokens already streamed."""
    return {
        "id": f"cmpl-{request_id}",
        "object": "text_completion.chunk",
        "created": created,
        "model": model,
        "choices": [_choice(index, new_token_ids, finish_reason)],
    }


def completion_response(request_id: int, created: int, model: str,
                        choices: List[Dict[str, Any]], prompt_tokens: int,
                        ) -> Dict[str, Any]:
    """The non-streaming (``stream=false``) aggregate response.

    ``choices`` entries are ``{"token_ids": [...], "finish_reason": ...}``
    in completion-index order; usage counts come straight from the
    request's token lists (RequestOutput accounting)."""
    completion_tokens = sum(len(c["token_ids"]) for c in choices)
    return {
        "id": f"cmpl-{request_id}",
        "object": "text_completion",
        "created": created,
        "model": model,
        "choices": [_choice(i, c["token_ids"], c["finish_reason"])
                    for i, c in enumerate(choices)],
        "usage": {
            "prompt_tokens": prompt_tokens,
            "completion_tokens": completion_tokens,
            "total_tokens": prompt_tokens + completion_tokens,
        },
    }


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _metric_name(key: str) -> str:
    return "repro_" + "".join(c if c.isalnum() or c == "_" else "_"
                              for c in key)


def render_prometheus(per_replica: Dict[str, Dict[str, Any]],
                      extra: Optional[Dict[str, Any]] = None) -> str:
    """Prometheus text format over ``engine.metrics()`` snapshots.

    Scalar numeric fields become ``repro_<key>{replica="<name>"}`` gauge
    lines; nested structures (per-request records, stage lists) are
    skipped — they are debugging payload, not time series.  ``extra``
    adds unlabeled server-level series (admission counters)."""
    lines: List[str] = []
    for name, metrics in sorted(per_replica.items()):
        for key in sorted(metrics):
            val = metrics[key]
            if isinstance(val, bool) or not isinstance(val, (int, float)):
                continue
            lines.append(
                f'{_metric_name(key)}{{replica="{name}"}} {float(val):g}')
    for key in sorted(extra or {}):
        val = (extra or {})[key]
        if isinstance(val, bool) or not isinstance(val, (int, float)):
            continue
        lines.append(f"{_metric_name(key)} {float(val):g}")
    return "\n".join(lines) + "\n"
