"""Interactive chat with streaming token-by-token decode (counterpart of
``fastmax_tpu/inference/chat.py``).

``prompt_config`` gives each model family's prompt template and stop-token
sequences (the reference's, family by family; a stop sequence naming tokens
the tokenizer lacks is dropped). ``StreamingSession`` prefills the prompt
into a KV cache through ``gpt.forward`` and then feeds one token a step,
yielding tokens as they come but holding back up to the longest stop
sequence, so that a stop sequence is never yielded; ``decode_stream``
detokenizes a growing window, so word-piece spaces come out right.
Streaming reads each token back to the host, which is what chat needs.
Sampling noise comes from an explicit ``torch.Generator`` (the reference
splits a ``jax.random`` key); greedy streams do not depend on it.

    python -m fastmax_tpu_torch.inference.chat --checkpoint_dir ckpt [--device cpu]

``--tp N`` shards the model over N ranks started by torchrun (``torchrun
--nproc_per_node N -m fastmax_tpu_torch.inference.chat --tp N ...``): rank 0
reads the prompts and prints, every rank runs the session on its shard, and
each token is rank 0's (broadcast), so that the ranks stop together.
"""

from __future__ import annotations

import re
import sys
import time
from pathlib import Path
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..models import gpt
from ..models.config import Config
from ..models.tokenizer import Tokenizer
from ..ops.rope import build_rope_cache
from ..ops.sampling import sample

# --------------------------------------------------------------- templates


def prompt_config(checkpoint_name: str, tokenizer: Tokenizer) -> Tuple[str, Tuple[List[int], ...]]:
    """(system template with {prompt}, stop-token sequences) per family
    (ref chat/base.py:191-370)."""
    name = checkpoint_name.lower()

    if re.search(r"stablelm-tuned-alpha", name):
        system = (
            "<|SYSTEM|># StableLM Tuned (Alpha version)\n- StableLM is a helpful and harmless "
            "open-source AI language model developed by StabilityAI.\n- StableLM will refuse to "
            "participate in anything that could harm a human."
            "\n<|USER|>{prompt}<|ASSISTANT|>"
        )
        return system, _stops(tokenizer, ["<|SYSTEM|>"], ["<|ASSISTANT|>"], ["<|USER|>"])
    if re.search(r"stablelm-zephyr", name):
        return "<|user|>\n{prompt}<|endoftext|>\n<|assistant|>\n", ([tokenizer.eos_id],)
    if re.search(r"redpajama-incite.*chat", name):
        # <human>/<bot> turns; no dedicated stop token, so match the
        # multi-token speaker tags (ref chat/base.py:214-223)
        stop = _stops(tokenizer, ["<", "human", ">:"], ["<", "bot", ">:"])
        return "<human>: {prompt}\n<bot>:", stop
    if re.search(r"redpajama-incite.*instruct", name):
        stop = _stops(tokenizer, ["Q", ":"], ["A", ":"],
                      [187, 187], [535])  # 187/535: gpt-neox newline ids
        return "Q: {prompt}\nA:", stop
    if re.search(r"falcon.*-instruct", name):
        # Falcon rarely emits eos; stop on a new "User:" turn instead
        # (ref chat/base.py:239-251)
        stop = _stops(tokenizer, ["User", ":"], [193, "User"])  # 193 = '\n'
        return "Do not prefix your replies with 'Bot: '\nUser: {prompt}\n", stop
    if re.search(r"function-calling", name):
        # function-calling Llama-2: a FUNCTIONS block precedes the normal
        # [INST] wrapping (ref chat/base.py:261-284)
        import json as _json

        fn = _json.dumps(
            {
                "function": "search_web",
                "description": "Search the web for content.",
                "arguments": [
                    {"name": "query", "type": "string", "description": "The search query"}
                ],
            }
        ).replace("{", "{{").replace("}", "}}")
        system = (
            f"<FUNCTIONS>{fn}</FUNCTIONS>\n\n[INST]<<SYS>>\nYou are a helpful assistant "
            "that responds only with JSON-formatted function calls\n<</SYS>>\n\n"
            "{prompt}[/INST]\n\n"
        )
        return system, ([tokenizer.eos_id],)
    if re.search(r"vicuna|longchat", name):
        system = (
            "A chat between a curious user and an artificial intelligence assistant. The "
            "assistant gives helpful, detailed, and polite answers to the user's questions. "
            "USER: {prompt} ASSISTANT:"
        )
        return system, ([tokenizer.eos_id],)
    if re.search(r"llama-2.*-chat", name):
        system = (
            "[INST] <<SYS>>\nYou are a helpful, respectful and honest assistant.\n<</SYS>>\n\n"
            "{prompt} [/INST]"
        )
        return system, ([tokenizer.eos_id],)
    if re.search(r"gemma.*-it", name):
        return "<start_of_turn>user\n{prompt}<end_of_turn>\n<start_of_turn>model\n", ([tokenizer.eos_id],)
    if re.search(r"freewilly2", name):
        system = "### System:\nThis is a system prompt, please behave and help the user.\n\n### User:\n{prompt}\n\n### Assistant:\n"
        return system, ([tokenizer.eos_id],)
    if re.search(r"platypus", name):
        return "### Instruction:\n\n{prompt}\n\n### Response:\n", ([tokenizer.eos_id],)
    if re.search(r"nous-hermes", name):
        return "### Instruction:\n{prompt}\n\n### Response:\n", ([tokenizer.eos_id],)
    if re.search(r"stablecode-instruct", name):
        return "###Instruction\n{prompt}###Response\n", ([tokenizer.eos_id],)
    if re.search(r"codellama.*-instruct|mistral.*-instruct|mixtral.*-instruct", name):
        return "<s>[INST] {prompt} [/INST]", ([tokenizer.eos_id],)
    if re.search(r"tinyllama.*chat", name):
        system = "<|system|>\nYou are a friendly chatbot.</s>\n<|user|>\n{prompt}</s>\n<|assistant|>\n"
        return system, ([tokenizer.eos_id],)
    if re.search(r"phi-1", name):
        # phi-1.5 rarely emits eos; stop on a new "Answer:" turn
        stop = _stops(tokenizer, ["Answer", ":"], [198, "Answer", ":"])
        return "{prompt}\n\nAnswer:", stop
    if re.search(r"phi-2", name):
        return "Instruct:{prompt}\nOutput:", ([tokenizer.eos_id],)
    if re.search(r"phi", name):
        return "{prompt}\n\nAnswer:", ([tokenizer.eos_id],)
    # default: raw continuation
    return "{prompt}", ([tokenizer.eos_id],)


def _has(tokenizer: Tokenizer, token: str) -> bool:
    try:
        tokenizer.token_to_id(token)
        return True
    except Exception:
        return False


def _stops(tokenizer: Tokenizer, *seqs) -> tuple:
    """Build stop-token sequences, dropping any whose named tokens this
    tokenizer doesn't have (family templates assume the family's own
    tokenizer; degrade to eos-only elsewhere)."""
    out = [[tokenizer.eos_id]]
    for seq in seqs:
        ids = []
        for item in seq:
            if isinstance(item, int):
                ids.append(item)
            elif _has(tokenizer, item):
                ids.append(tokenizer.token_to_id(item))
            else:
                ids = None
                break
        if ids:
            out.append(ids)
    return tuple(out)


# --------------------------------------------------------------- streaming


class StreamingSession:
    """A model, its RoPE table and a cache size; yields tokens one at a time."""

    def __init__(self, cfg: Config, params, max_seq_length: int, shard=None):
        """``shard``: the ``ShardPlan`` of a rank's local ``params`` on a mesh."""
        self.cfg = cfg
        self.params = params
        self.shard = shard
        self.max_seq_length = min(max_seq_length, cfg.block_size)
        self.device = params["wte"].device
        self.rope = build_rope_cache(self.max_seq_length, cfg.rope_n_elem, cfg.rope_base,
                                     cfg.rope_condense_ratio, device=self.device)
        self._dtype = params["wte"].dtype

    @torch.inference_mode()
    def _fwd(self, idx: torch.Tensor, pos: int, cache: dict):
        logits, cache = gpt.forward(self.params, self.cfg, idx, input_pos=pos, kv_cache=cache,
                                    rope_cache=self.rope, shard=self.shard)
        return logits[:, -1, :], cache

    def generate_stream(
        self,
        encoded: np.ndarray,
        max_returned_tokens: int,
        *,
        temperature: float = 0.8,
        top_k: Optional[int] = None,
        stop_tokens: Tuple[List[int], ...] = (),
        generator: Optional[torch.Generator] = None,
    ) -> Iterator[np.ndarray]:
        """Yield generated token ids until ``max_returned_tokens`` (prompt
        included); keeps a buffer as long as the longest stop sequence and
        stops, without yielding it, when one matches."""
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(time.time_ns() % (2**31))
        cache = gpt.init_kv_cache(self.cfg, 1, self.max_seq_length, self._dtype,
                                  device=self.device, n_groups=None if self.shard is None
                                  else self.shard.local_groups(self.cfg))
        idx = torch.as_tensor(np.asarray(encoded), device=self.device).to(torch.int32)[None]
        logits, cache = self._fwd(idx, 0, cache)
        buffer: List[int] = []
        max_stop_len = max((len(s) for s in stop_tokens), default=0)
        pos = len(encoded)
        while pos < max_returned_tokens:
            tok = sample(logits[0], temperature, top_k, generator=generator).reshape(1)
            if self.shard is not None:  # rank 0's token on every rank
                from ..parallel import collectives as col

                tok = col.broadcast(tok.to(torch.int32), 0, self.shard.mesh.world)
            tok = int(tok[0])
            buffer.append(tok)
            for s in stop_tokens:
                if len(buffer) >= len(s) and buffer[-len(s):] == list(s):
                    # flush everything before the stop sequence
                    head = buffer[: len(buffer) - len(s)]
                    if head:
                        yield np.asarray(head)
                    return
            if not max_stop_len or len(buffer) > max_stop_len:
                yield np.asarray([buffer.pop(0)])
            logits, cache = self._fwd(
                torch.tensor([[tok]], dtype=torch.int32, device=self.device), pos, cache)
            pos += 1
        if buffer:
            yield np.asarray(buffer)


def decode_stream(tokenizer: Tokenizer, token_stream: Iterator[np.ndarray], out=None) -> int:
    """Write the text of a token stream to ``out`` (default: the current
    ``sys.stdout``) as it comes, decoding the growing window of ids so that
    word-piece boundaries come out right; returns the number of tokens."""
    out = sys.stdout if out is None else out
    so_far: List[int] = []
    text_printed = ""
    for tok in token_stream:
        so_far.extend(int(x) for x in np.asarray(tok).reshape(-1))
        text = tokenizer.decode(np.asarray(so_far))
        out.write(text[len(text_printed):])
        out.flush()
        text_printed = text
    return len(so_far)


# -------------------------------------------------------------------- REPL


def main(
    checkpoint_dir: Path = Path("checkpoints"),
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    precision: str = "bfloat16",
    max_new_tokens: int = 256,
    top_k: Optional[int] = 200,
    temperature: float = 0.8,
    tp: int = 1,
    device=None,
) -> None:
    """Interactive chat on the card (``device="cpu"`` for the CPU): an empty
    prompt, end of input or Ctrl-C ends it. tp > 1: one rank of a torchrun
    mesh (see the module's docstring)."""
    from .engine import InferenceEngine
    from .generate import load_and_prepare, rank_setup

    mesh, device = rank_setup(tp, 1, device, "fastmax_tpu_torch.inference.chat")
    cfg, params = load_and_prepare(Path(checkpoint_dir), quantize=quantize, attn_alg=attn_alg,
                                   precision=precision, tp=tp, device=device)
    shard = None
    if mesh is None:
        params = InferenceEngine.prepare_params(params, "auto")
    else:
        params, shard = InferenceEngine.prepare_sharded(cfg, params, mesh, "auto", device)
    leader = mesh is None or mesh.leader
    tokenizer = Tokenizer(Path(checkpoint_dir))
    system_prompt, stop_tokens = prompt_config(cfg.name, tokenizer)
    session = StreamingSession(cfg, params, cfg.block_size, shard=shard)

    if leader:
        print(f"Now chatting with {cfg.name}.\nTo exit, press 'Enter' on an empty prompt.\n")
    while True:
        prompt = ""
        if leader:
            try:
                prompt = input(">> Prompt: ")
            except (EOFError, KeyboardInterrupt):
                prompt = ""
        if mesh is not None:  # rank 0's prompt (empty: the end) on every rank
            from ..parallel import collectives as col

            raw = np.frombuffer(prompt.encode(), np.uint8) if leader else None
            prompt = bytes(col.broadcast_ints(raw, 0, mesh.world, mesh.comm_device)
                           .astype(np.uint8)).decode()
        if not prompt:
            break
        encoded = tokenizer.encode(system_prompt.format(prompt=prompt))
        if not leader:
            for _ in session.generate_stream(
                    encoded, min(len(encoded) + max_new_tokens, session.max_seq_length),
                    temperature=temperature, top_k=top_k, stop_tokens=stop_tokens):
                pass
            continue
        print(">> Reply: ", end="", flush=True)
        t0 = time.perf_counter()
        stream = session.generate_stream(
            encoded, min(len(encoded) + max_new_tokens, session.max_seq_length),
            temperature=temperature, top_k=top_k, stop_tokens=stop_tokens)
        n = decode_stream(tokenizer, stream)
        dt = time.perf_counter() - t0
        print(f"\n** {n} tokens, {n / dt:.2f} tokens/sec **\n", file=sys.stderr)


def cli(args=None) -> None:
    """The command line: ``main``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    CLI(main, args)


if __name__ == "__main__":
    cli()
