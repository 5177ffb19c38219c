"""HTTP serving front end over the continuous batcher (counterpart of
``fastmax_tpu/inference/server.py``).

One scheduler thread owns the ``ContinuousBatcher`` and the device and
interleaves prefills and decodes across slots; a threaded stdlib HTTP
server accepts requests, streams tokens back as server-sent events, and
multiplexes any number of clients onto the ``n_slots`` lanes.

Endpoints:

* ``POST /v1/generate``: body ``{"prompt": str | [int], "max_new_tokens":
  int, "temperature": float, "top_k": int | null, "eos_id": int | null,
  "stream": bool}``. Without streaming, one JSON response ``{"text",
  "tokens", "prompt_tokens", "finish_reason"}``; with it, a
  ``text/event-stream`` of ``data: {"text": <delta>, "token_ids": [...]}``
  events and ``data: [DONE]`` (the text is decoded over the growing window
  of ids, so word-piece boundaries come out right). A body without a
  prompt, or with values of the wrong type, gets 400.
* ``GET /v1/health``: ``{"status", "model", "active_slots", "n_slots",
  "queued"}``.

The batcher is not thread-safe, so every batcher call happens on the
scheduler thread; HTTP threads reach it only through a submit inbox and
per-request token queues. Tokens flow out through ``Request.generated``
watermarks, which also catch the first token, sampled at admission.

The command line (``main``/``cli``) loads a checkpoint directory and its
tokenizer (``inference/generate.load_and_prepare``, ``models/tokenizer.py``),
builds the batcher, optionally registers a system prompt in its prefix cache,
and serves until interrupted, on the card unless ``--device cpu``:

    python -m fastmax_tpu_torch.inference.server --checkpoint_dir ckpt \
        --quantize bnb.nf4 --n_slots 8 --kv_cache_dtype int8 --port 8000

``--speculative_k k`` gives the batcher k prompt-lookup drafts a slot and a
batched verify a step. ``--tp``/``--fsdp`` above 1 shard the model over a
mesh of one process per rank, started by torchrun (each rank on
``cuda:LOCAL_RANK``); rank 0 answers HTTP and drives the batcher, the other
ranks follow its plan (``ContinuousBatcher.follow``):

    torchrun --nproc_per_node 2 -m fastmax_tpu_torch.inference.server \
        --checkpoint_dir ckpt --tp 2 --port 8000
"""

from __future__ import annotations

import json
import queue
import threading
import time
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from .continuous import ContinuousBatcher

_IDLE_SLEEP_S = 0.002


@dataclass
class _Ticket:
    """One in-flight request as the HTTP thread sees it."""

    prompt: np.ndarray
    max_new_tokens: int
    temperature: float
    top_k: Optional[int]
    eos_id: Optional[int]
    # scheduler -> handler: lists of new token ids; None = finished
    out: "queue.Queue" = field(default_factory=queue.Queue)
    emitted: int = 0  # watermark into Request.generated (scheduler-owned)
    req: object = None  # continuous.Request, set on submit (scheduler-owned)


class Scheduler:
    """Single thread that owns the ContinuousBatcher and the device."""

    def __init__(self, batcher: ContinuousBatcher):
        self.batcher = batcher
        self.inbox: "queue.Queue[_Ticket]" = queue.Queue()
        self._live: List[_Ticket] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def start(self) -> "Scheduler":
        self._thread.start()
        return self

    def stop(self) -> None:
        """Stop the thread, then end the followers' loops on a mesh."""
        self._stop.set()
        self._thread.join(timeout=30)
        self.batcher.close()

    def submit(self, ticket: _Ticket) -> _Ticket:
        self.inbox.put(ticket)
        return ticket

    def _drain_inbox(self) -> None:
        while True:
            try:
                t = self.inbox.get_nowait()
            except queue.Empty:
                return
            t.req = self.batcher.submit(
                t.prompt, t.max_new_tokens, temperature=t.temperature,
                top_k=t.top_k, eos_id=t.eos_id, return_request=True,
            )
            self._live.append(t)

    def _flush(self) -> None:
        """Push newly generated tokens to each ticket's queue; finish done
        ones. Reading Request.generated (not step()'s return value) also
        catches the token sampled at admission."""
        still = []
        for t in self._live:
            gen = t.req.generated
            if len(gen) > t.emitted:
                t.out.put(list(gen[t.emitted:]))
                t.emitted = len(gen)
            if t.req.done:
                t.out.put(None)
            else:
                still.append(t)
        self._live = still

    def _run(self) -> None:
        b = self.batcher
        while not self._stop.is_set():
            self._drain_inbox()
            if not self._live and b.inflight() == 0:
                time.sleep(_IDLE_SLEEP_S)
                continue
            b.step()
            self._flush()

    def stats(self) -> dict:
        b = self.batcher
        return {
            "active_slots": sum(s is not None for s in b.slots),
            "n_slots": b.n_slots,
            "queued": len(b.queue) + self.inbox.qsize(),
        }


def make_handler(scheduler: Scheduler, tokenizer, model_name: str,
                 default_eos: Optional[int]):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, obj: dict) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/v1/health":
                self._json(200, {"status": "ok", "model": model_name, **scheduler.stats()})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/v1/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                body = json.loads(self.rfile.read(n) or b"{}")
                prompt = body["prompt"]
                if isinstance(prompt, str):
                    ids = np.asarray(tokenizer.encode(prompt), np.int32)
                else:
                    ids = np.asarray(prompt, np.int32)
                ticket = _Ticket(
                    prompt=ids,
                    max_new_tokens=int(body.get("max_new_tokens", 64)),
                    temperature=float(body.get("temperature", 0.0)),
                    top_k=body.get("top_k"),
                    eos_id=body.get("eos_id", default_eos),
                )
            except (KeyError, TypeError, ValueError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return

            scheduler.submit(ticket)
            if body.get("stream"):
                self._stream_response(ticket)
            else:
                self._full_response(ticket, len(ids))

        def _collect(self, ticket: _Ticket):
            while True:
                chunk = ticket.out.get()
                if chunk is None:
                    return
                yield chunk

        def _full_response(self, ticket: _Ticket, prompt_tokens: int) -> None:
            tokens: List[int] = []
            for chunk in self._collect(ticket):
                tokens.extend(chunk)
            finish = "stop" if (ticket.eos_id is not None and tokens
                                and tokens[-1] == ticket.eos_id) else "length"
            text_tokens = tokens[:-1] if finish == "stop" else tokens
            self._json(200, {
                "text": tokenizer.decode(np.asarray(text_tokens, np.int64)),
                "tokens": tokens,
                "prompt_tokens": prompt_tokens,
                "finish_reason": finish,
            })

        def _stream_response(self, ticket: _Ticket) -> None:
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def chunk(data: str) -> None:
                payload = f"data: {data}\n\n".encode()
                self.wfile.write(f"{len(payload):X}\r\n".encode() + payload + b"\r\n")
                self.wfile.flush()

            so_far: List[int] = []
            text_sent = ""
            for ids in self._collect(ticket):
                if ticket.eos_id is not None and ticket.eos_id in ids:
                    ids = ids[: ids.index(ticket.eos_id)]
                    if not ids:
                        break
                so_far.extend(ids)
                text = tokenizer.decode(np.asarray(so_far, np.int64))
                delta, text_sent = text[len(text_sent):], text
                chunk(json.dumps({"text": delta, "token_ids": ids}))
            chunk("[DONE]")
            self.wfile.write(b"0\r\n\r\n")
            self.wfile.flush()

    return Handler


class Server:
    """Owns the HTTP server and scheduler pair (also the test harness handle)."""

    def __init__(self, batcher: ContinuousBatcher, tokenizer, *,
                 host: str = "127.0.0.1", port: int = 8000,
                 model_name: str = "", eos_id: Optional[int] = None):
        self.scheduler = Scheduler(batcher).start()
        handler = make_handler(self.scheduler, tokenizer, model_name, eos_id)
        self.httpd = ThreadingHTTPServer((host, port), handler)
        self._thread = threading.Thread(target=self.httpd.serve_forever, daemon=True)

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    def start(self) -> "Server":
        self._thread.start()
        return self

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def stop(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.scheduler.stop()


# ------------------------------------------------------------------- CLI


def main(
    checkpoint_dir: Path = Path("checkpoints"),
    host: str = "0.0.0.0",
    port: int = 8000,
    n_slots: int = 8,
    max_seq_length: Optional[int] = None,
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    precision: str = "bfloat16",
    weights_mode: str = "auto",
    tp: int = 1,
    fsdp: int = 1,
    kv_cache_dtype: Optional[str] = None,
    decode_quantum: int = 1,
    speculative_k: int = 0,
    prefix_cache_size: int = 0,
    prefill_chunk: int = 0,
    system_prompt: Optional[str] = None,
    device=None,
) -> None:
    """Serve a checkpoint over HTTP with continuous batching, on the card
    (``device="cpu"`` for the CPU), until interrupted; at tp or fsdp > 1,
    one rank of a torchrun mesh (see the module's docstring).

    system_prompt: when set (with prefix_cache_size > 0), its KV rows are
    prefilled once and shared by every request that starts with it."""
    from ..models.tokenizer import Tokenizer
    from .generate import load_and_prepare, rank_setup

    mesh, device = rank_setup(tp, fsdp, device, "fastmax_tpu_torch.inference.server")
    tokenizer = Tokenizer(Path(checkpoint_dir))
    cfg, params = load_and_prepare(Path(checkpoint_dir), quantize=quantize, attn_alg=attn_alg,
                                   precision=precision, tp=tp, fsdp=fsdp, device=device)
    batcher = ContinuousBatcher(
        cfg, params, n_slots=n_slots, max_seq_length=max_seq_length, weights_mode=weights_mode,
        cache_dtype=getattr(torch, kv_cache_dtype) if kv_cache_dtype else None,
        decode_quantum=decode_quantum, speculative_k=speculative_k,
        prefix_cache_size=prefix_cache_size, prefill_chunk=prefill_chunk, device=device,
        mesh=mesh)
    if mesh is not None and not mesh.leader:
        batcher.follow()  # until rank 0's server stops
        return
    if system_prompt:
        batcher.register_prefix(np.asarray(tokenizer.encode(system_prompt), np.int32))
    server = Server(batcher, tokenizer, host=host, port=port, model_name=cfg.name,
                    eos_id=tokenizer.eos_id)
    print(f"serving {cfg.name} on http://{host}:{server.port} "
          f"({n_slots} slots, quantize={quantize or 'none'}"
          + ("" if mesh is None else f", {mesh.shape} mesh of {mesh.size} ranks") + ")")
    server.start()
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        server.stop()


def cli(args=None) -> None:
    """The command line: ``main``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(main, args)


if __name__ == "__main__":
    cli()
