"""Speculative decoding for a batch-1 engine (counterpart of
``fastmax_tpu/inference/speculative.py``).

Decode is bound by the weights' bytes: a forward over k+1 tokens reads the
same weights as a forward over one, so verifying k drafted tokens in one
forward saves a step for every draft accepted.

* ``temperature == 0``: a draft is accepted while it equals the verifier's
  argmax; every decided token is the argmax of a real forward over the
  decided prefix, so the output is the engine's greedy output (up to the
  rounding of a T = k+1 forward against a T = 1 one, which can flip a
  near-tie on the card).
* ``temperature > 0``: the rejection rule (``ops/sampling.speculative_accept``
  for prompt lookup, ``speculative_accept_logq`` for a draft model); every
  emitted token is distributed as the engine's own temperature/top-k sample.

``SpeculativeDecoder`` drafts by prompt lookup (``ngram_draft``: the k tokens
that followed the most recent earlier occurrence of the current bigram).
``DraftSpeculativeDecoder`` drafts with a small model of the same padded
vocabulary; its first draft forward re-feeds the last two decided tokens (T
= 2 at pos - 2), which fills the two-token hole a full-acceptance round
leaves in the draft cache.

The reference's ``jax.lax.while_loop`` is a Python loop of verify steps
here: each is one ``InferenceEngine._forward`` of T = k+1 tokens at pos - 1,
and the host reads the new length and the done flag once a step. No
rollback is needed for rejected drafts: both caches mask by absolute
position, and the next step rewrites a row before any query reads it.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops.sampling import (_gumbel, filtered_log_probs, sample, speculative_accept,
                            speculative_accept_logq)


def ngram_draft(hist: torch.Tensor, pos, k: int, max_seq: int) -> torch.Tensor:
    """Draft k tokens by bigram lookup in ``hist[:pos]``.

    hist: (S,) decided tokens (prompt + generated); pos: the current length
    (a Python int or a 0-d tensor). Returns (k,) int32 on hist's device; with
    no match, the last token repeated. As the reference's, the draft starts
    at clip(best + 2, 0, max_seq - k), so it may read entries of ``hist``
    past ``pos`` (zeros, or tokens of an earlier generation)."""
    s = hist.shape[0]
    pos = torch.as_tensor(pos, device=hist.device).long()
    idx = torch.arange(s, device=hist.device)
    b0 = hist[torch.clamp(pos - 2, min=0)]
    b1 = hist[torch.clamp(pos - 1, min=0)]
    nxt = torch.roll(hist, -1)
    # a match starts at i with hist[i:i+2] == (b0, b1), strictly before the current bigram
    ok = (hist == b0) & (nxt == b1) & (idx + 2 <= pos - 2)
    best = torch.max(torch.where(ok, idx, torch.full_like(idx, -1)))  # the most recent one
    # the reference's clip, then its dynamic_slice's clamp into [0, S - k]
    start = torch.clamp(torch.clamp(best + 2, 0, max_seq - k), 0, s - k)
    looked = hist[start + torch.arange(k, device=hist.device)]
    return torch.where(ok.any(), looked, b1.expand(k)).to(torch.int32)


def _commit(hist: torch.Tensor, pos, cand: torch.Tensor, a, k: int, eos_id, limit):
    """Write this verify step's decided tokens (cand[:a+1]) into ``hist`` at
    pos.., keeping an eos and dropping what follows it, and only while pos +
    i < limit. Returns (hist, new pos, done) with the last two 0-d tensors;
    ``hist`` is written in place (it carries k+1 slack entries, so the window
    never clamps)."""
    s = hist.shape[0]
    dev = hist.device
    pos = torch.as_tensor(pos, device=dev).long()
    within = torch.arange(k + 1, device=dev)
    take = within <= a
    if eos_id is not None:
        seen_eos = torch.cumsum(((cand == eos_id) & take).to(torch.int32), 0) > 0
        after = torch.roll(seen_eos, 1)
        after[0] = False
        take = take & ~after  # keep the eos itself, drop everything after it
    take = take & (pos + within < limit)
    n_new = take.sum()
    rows = torch.clamp(pos, 0, s - (k + 1)) + within
    hist[rows] = torch.where(take, cand.to(hist.dtype), hist[rows])
    done = torch.zeros((), dtype=torch.bool, device=dev)
    if eos_id is not None:
        done = ((cand == eos_id) & take).any()
    pos = pos + n_new
    return hist, pos, done | (pos >= limit)


def _greedy_accept(logits: torch.Tensor, draft: torch.Tensor):
    """(a, cand) at temperature 0: drafts accepted while they equal the
    argmax; the decided tokens are the argmaxes greedy[:a+1]."""
    greedy = torch.argmax(logits.float(), dim=-1).to(torch.int32)  # (k+1,)
    a = torch.cumprod((draft == greedy[:-1]).to(torch.int32), dim=0).sum()
    return a, greedy


def _check_engine(eng, name: Optional[str] = None) -> None:
    if eng.batch_size != 1:
        raise ValueError(f"{name} engine must have batch_size=1" if name else
                         "speculative decoding supports batch_size=1")
    if eng._linear_alg:
        raise ValueError(
            f"{name} engine must use the KV-cache (quadratic) path" if name else
            "speculative decoding requires the KV-cache (quadratic) path: linear-attention "
            "running state cannot roll back rejected drafts")


def _prepare(eng, prompt, max_returned_tokens: int, k: int, engines) -> tuple:
    prompt = torch.as_tensor(prompt, device=eng.device).to(torch.int32)
    if prompt.ndim == 1:
        prompt = prompt[None]
    for e, name in engines:
        if max_returned_tokens + k + 1 > e.max_seq_length:
            # a verify step writes up to k+1 cache rows past the current position
            which, hint = ((f"the {name} engine's ", "size both engines with headroom")
                           if name else ("", "size the engine with extra headroom"))
            raise ValueError(f"max_returned_tokens {max_returned_tokens} + k+1 ({k + 1}) "
                             f"exceeds {which}max_seq_length {e.max_seq_length}; {hint} for "
                             "speculation")
    return prompt


def _history(eng, prompt: torch.Tensor, first: torch.Tensor, k: int) -> torch.Tensor:
    t = prompt.shape[1]
    hist = torch.zeros(eng.max_seq_length + k + 1, dtype=torch.int32, device=eng.device)
    hist[:t] = prompt[0]
    hist[t] = first[0]
    return hist


def _agree(eng, hist: torch.Tensor, new_pos: torch.Tensor, done: torch.Tensor):
    """On a mesh (every rank runs the decoder), rank 0's history, position and
    done flag on every rank, so that a near-tie can never split the ranks."""
    if eng.mesh is None:
        return hist, new_pos, done
    n = hist.shape[0]
    both = eng._agree(torch.cat([hist, new_pos.reshape(1).to(hist.dtype),
                                 done.reshape(1).to(hist.dtype)]))
    return both[:n], both[n].long(), both[n + 1].bool()


def _finish(hist: torch.Tensor, pos: int, t: int, eos_id) -> torch.Tensor:
    out = hist[:pos][None]
    if eos_id is not None:
        hits = (out[0, t:] == eos_id).nonzero()
        if hits.numel():
            out = out[:, : t + int(hits[0, 0]) + 1]
    return out


class SpeculativeDecoder:
    """Prompt-lookup speculation for a batch-1 engine:
    ``SpeculativeDecoder(engine, k=8).generate(prompt, max_returned)``.
    ``last_steps`` holds the verify forwards of the last call and
    ``last_accepted`` the drafts accepted (the draft decoder's diagnostic)."""

    def __init__(self, engine, k: int = 8):
        _check_engine(engine)
        self.engine = engine
        self.k = k
        self.last_steps = 0
        self.last_accepted = 0

    @torch.inference_mode()
    def generate(self, prompt, max_returned_tokens: int, *, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 plain: bool = False) -> torch.Tensor:
        """Greedy at temperature 0 (the engine's greedy tokens), else sampled
        through the rejection rule with noise from ``generator``; ``plain``
        sends every kernel call to its plain version. Returns the (1, n)
        sequence, prompt included, on the engine's device."""
        eng, k = self.engine, self.k
        prompt = _prepare(eng, prompt, max_returned_tokens, k, ((eng, None),))
        t = prompt.shape[1]
        logits, cache = eng.prefill(prompt, eng.new_cache(), plain)
        first = eng._agree(sample(logits, temperature, top_k, generator=generator))
        hist = _history(eng, prompt, first, k)
        pos, steps, accepted = t + 1, 0, torch.zeros((), dtype=torch.int64, device=eng.device)
        done = eos_id is not None and int(first[0]) == eos_id
        while pos < max_returned_tokens and not done:
            draft = ngram_draft(hist, pos, k, hist.shape[0])
            x = torch.cat([hist[pos - 1:pos], draft])[None]  # (1, k+1)
            logits, cache = eng._forward(x, cache, pos - 1, plain)
            if temperature > 0.0:
                a, cand = speculative_accept(logits[0], draft, temperature, top_k,
                                             generator=generator)
            else:
                a, cand = _greedy_accept(logits[0], draft)
            hist, new_pos, done_t = _agree(eng, *_commit(hist, pos, cand, a, k, eos_id,
                                                          max_returned_tokens))
            accepted = accepted + a
            pos, done = torch.stack([new_pos, done_t.long()]).tolist()  # one read a step
            steps += 1
        self.last_steps = steps
        self.last_accepted = int(accepted)
        return _finish(hist, pos, t, eos_id)


class DraftSpeculativeDecoder:
    """Draft-model speculation for a batch-1 engine pair: the draft proposes
    k tokens one forward at a time, the target verifies the k+1 positions in
    one forward under the general rejection rule (greedy at temperature 0).
    ``last_steps`` holds the verify forwards and ``last_accepted`` the
    drafts accepted in the last call.

        spec = DraftSpeculativeDecoder(target_engine, draft_engine, k=4)
        out = spec.generate(prompt, max_returned, temperature=0.8)
    """

    def __init__(self, engine, draft_engine, k: int = 4):
        for eng, name in ((engine, "target"), (draft_engine, "draft")):
            _check_engine(eng, name)
        tv, dv = engine.cfg.padded_vocab_size, draft_engine.cfg.padded_vocab_size
        if tv != dv:
            raise ValueError(f"target/draft padded vocab sizes differ ({tv} vs {dv}); the "
                             "rejection rule subtracts the distributions elementwise")
        self.engine = engine
        self.draft = draft_engine
        self.k = k
        self.last_steps = 0
        self.last_accepted = 0

    def _pick(self, row: torch.Tensor, temperature: float, top_k, generator):
        """A draft token from one row of the draft's logits, and the
        log-probabilities it was drawn from (zeros at temperature 0, unused)."""
        if temperature > 0.0:
            lq = filtered_log_probs(row, temperature, top_k)
            noise = _gumbel(lq.shape, lq.device, generator)
            return torch.argmax(lq + noise).to(torch.int32), lq
        return (torch.argmax(row.float()).to(torch.int32),
                torch.zeros(row.shape[-1], device=row.device))

    def _draft_tokens(self, dcache, hist, pos: int, temperature, top_k, generator, plain):
        """k draft tokens (k,) and their log-probabilities (k, V). The first
        forward is T = 2 over the last two decided tokens at pos - 2."""
        deng = self.draft
        logits, dcache = deng._forward(hist[pos - 2:pos][None], dcache, pos - 2, plain)
        tok, lq = self._pick(logits[0, -1], temperature, top_k, generator)
        toks, lqs = [tok], [lq]
        for i in range(self.k - 1):
            logits, dcache = deng._forward(tok.view(1, 1), dcache, pos + i, plain)
            tok, lq = self._pick(logits[0, -1], temperature, top_k, generator)
            toks.append(tok)
            lqs.append(lq)
        return torch.stack(toks), torch.stack(lqs), dcache

    @torch.inference_mode()
    def generate(self, prompt, max_returned_tokens: int, *, eos_id: Optional[int] = None,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 plain: bool = False) -> torch.Tensor:
        """As ``SpeculativeDecoder.generate``; the prompt needs at least 2
        tokens. At temperature 0 the output is the target's greedy output."""
        eng, deng, k = self.engine, self.draft, self.k
        prompt = torch.as_tensor(prompt)
        if prompt.shape[-1] < 2:
            raise ValueError("draft speculation needs a prompt of >= 2 tokens")
        prompt = _prepare(eng, prompt, max_returned_tokens, k,
                          ((eng, "target"), (deng, "draft")))
        t = prompt.shape[1]
        logits, tcache = eng.prefill(prompt, eng.new_cache(), plain)
        _, dcache = deng.prefill(prompt.to(deng.device), deng.new_cache(), plain)
        first = eng._agree(sample(logits, temperature, top_k, generator=generator))
        hist = _history(eng, prompt, first, k)
        pos, steps, accepted = t + 1, 0, torch.zeros((), dtype=torch.int64, device=eng.device)
        done = eos_id is not None and int(first[0]) == eos_id
        while pos < max_returned_tokens and not done:
            draft, logq, dcache = self._draft_tokens(dcache, hist, pos, temperature, top_k,
                                                     generator, plain)
            x = torch.cat([hist[pos - 1:pos], draft])[None]  # (1, k+1)
            logits, tcache = eng._forward(x, tcache, pos - 1, plain)
            if temperature > 0.0:
                a, cand = speculative_accept_logq(logits[0], draft, logq, temperature, top_k,
                                                  generator=generator)
            else:
                a, cand = _greedy_accept(logits[0], draft)
            hist, new_pos, done_t = _agree(eng, *_commit(hist, pos, cand, a, k, eos_id,
                                                          max_returned_tokens))
            accepted = accepted + a
            pos, done = torch.stack([new_pos, done_t.long()]).tolist()  # one read a step
            steps += 1
        self.last_steps = steps
        self.last_accepted = int(accepted)
        return _finish(hist, pos, t, eos_id)
