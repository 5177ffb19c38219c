"""Continuous batching engine (counterpart of
``fastmax_tpu/inference/continuous.py``).

``n_slots`` sequences share one KV cache (L, n_slots, G, S, hs). A decode
step advances every slot by one token through ``gpt.forward`` with per-slot
positions; slots without a request compute garbage that nothing reads, as
in the reference. The host-side scheduler admits queued requests into free
slots between steps and retires finished ones:

* admission prefills one request over a bucketed length (``prefill_bucket``)
  into its slot, or a FIFO wave of up to 16 requests sharing a bucket as one
  (P, Tb) forward into fresh cache rows, with ``logits_at`` and the first
  token sampled on the device;
* ``decode_quantum = Q > 1`` issues Q decode steps back to back with the
  tokens and positions kept on the device, and reads the (Q, n_slots)
  tokens back once per quantum; ``adaptive_quantum`` runs a short quantum
  (min(8, Q)) while a slot is free and the full one when all are busy;
* ``prefill_chunk = C > 0`` prefills long prompts C tokens per scheduler
  step, interleaved with decode steps;
* ``prefix_cache_size > 0`` keeps admitted prompts' KV rows in an LRU (on
  the device, where the reference keeps host copies) and prefills only the
  suffix of a prompt that starts with a cached one;
* ``speculative_k = k > 0`` drafts k tokens a slot on the host by prompt
  lookup (``_draft_np``), verifies every slot's drafts in one (n_slots, k+1)
  forward with per-slot positions (``ops.sampling.speculative_accept_traced``:
  greedy rows accept while a draft is the argmax, hot rows take the rejection
  rule) and advances each slot by its accepted count + 1; the host reads the
  counts and the candidates once a step. It excludes ``decode_quantum`` (the
  drafts need the host between verifies); a verify writes k+1 rows past a
  slot's position, so the headroom and ``prefill_chunk`` cover k+1.
  ``spec_accepted`` / ``spec_drafted`` count the drafts accepted and offered.

At Llama-2-7B's 4096-token context every prefill above takes the flash
route (``ops/flash_attention.py``). Per-slot temperature and top-k are
sampled on the device (``ops.sampling.sample_traced``); an all-greedy batch
skips the sort and the noise, which the host knows from its requests, so
no device value is read to decide it.

With a linear ``attn_alg`` each slot holds an O(1) running state
(``gpt.init_linear_cache``, n_slots rows) instead of KV rows: admission
prefills the prompt padded to its bucket straight into the slot's rows,
overwriting what its arm reads (``n_valid`` keeps the padding out of the sums), and decode
advances every slot's state by one token. Such slots never take the batched
admission wave, and speculative decoding, the prefix cache and chunked
prefill refuse a linear arm with the reference's ``ValueError``: a running
state cannot roll back, share a prefix, or absorb a prompt in pieces.

With a ``mesh`` (``parallel/sharding.make_mesh``; one process per rank) the
weights resolve on the whole tree and each rank keeps its shard, and the
slotted cache holds the rank's query groups (the linear arms' state stays
whole, the reference's choice). Rank 0 owns the scheduler: its ``submit``,
``step``, ``run_to_completion`` and ``register_prefix`` drive the mesh, and
each ``step`` first broadcasts a plan (the requests submitted since the last
one: ids, prompts, budgets and sampling parameters). The other ranks run
``follow()``, which applies each plan to their own copy of the scheduler's
state and takes the same step; the host decisions (admission, slots, drafts,
the prefix cache) are a function of that state, and every sampled token is
broadcast from rank 0, so that the ranks never part. ``close()`` on rank 0
ends the followers' loops.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from ..models import gpt
from ..models.config import Config
from ..ops.rope import build_rope_cache
from ..ops.sampling import sample, sample_traced, speculative_accept_traced
from .engine import InferenceEngine, _to_device, default_device

# the commands of the plan that rank 0 broadcasts to the followers
_STOP, _STEP, _PREFIX = 0, 1, 2


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray
    max_new_tokens: int
    temperature: float = 0.0
    top_k: Optional[int] = None
    eos_id: Optional[int] = None
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ContinuousBatcher:
    def __init__(
        self,
        cfg: Config,
        params,
        *,
        n_slots: int = 4,
        max_seq_length: Optional[int] = None,
        prefill_bucket: int = 128,
        weights_mode: str = "auto",
        speculative_k: int = 0,
        prefix_cache_size: int = 0,
        cache_dtype=None,
        decode_quantum: int = 1,
        adaptive_quantum: bool = False,
        prefill_chunk: int = 0,
        mesh=None,
        device=None,
        generator: Optional[torch.Generator] = None,
        plain: bool = False,
    ):
        """As the reference's batcher, plus ``device`` (default: the card),
        ``generator``, the source of sampling noise (default: one seeded
        with 0, as the reference starts from PRNGKey(0)), and ``plain``, a
        test hook that sends every forward through the kernels' plain
        PyTorch versions, as ``InferenceEngine._forward``'s. ``mesh``: see
        the module's docstring (params: the whole tree, or a rank's
        ``ShardedParams``)."""
        self._linear_alg = cfg.attn_alg in gpt.LINEAR_ALGS
        if speculative_k and self._linear_alg:
            raise ValueError(
                "speculative continuous batching requires the KV-cache (quadratic) path: "
                "linear-attention running state cannot roll back rejected drafts")
        if prefix_cache_size and self._linear_alg:
            raise ValueError("prefix caching requires the KV-cache (quadratic) path")
        if prefill_chunk and self._linear_alg:
            raise ValueError(
                "chunked prefill requires the KV-cache (quadratic) path: linear-state prefill "
                "must absorb the exact prompt in one pass")
        self.cfg = cfg
        self.plain = bool(plain)
        self.device = default_device(device)
        self.mesh = mesh
        self.shard = None
        if mesh is None:
            self.params = InferenceEngine.prepare_params(_to_device(params, self.device),
                                                         weights_mode)
        else:
            self.params, self.shard = InferenceEngine.prepare_sharded(cfg, params, mesh,
                                                                      weights_mode, self.device)
        self._unsent: List[Request] = []  # rank 0: submitted since the last plan
        self.n_slots = n_slots
        self.max_seq_length = min(max_seq_length or cfg.block_size, cfg.block_size)
        self.prefill_bucket = prefill_bucket
        self.decode_quantum = int(decode_quantum)
        self.adaptive_quantum = bool(adaptive_quantum)
        if self.adaptive_quantum and self.decode_quantum <= 1:
            raise ValueError("adaptive_quantum requires decode_quantum > 1")
        self._q_small = min(8, self.decode_quantum)
        self.speculative_k = int(speculative_k)
        if self.speculative_k and self.decode_quantum > 1:
            raise ValueError("decode_quantum and speculative_k are mutually exclusive "
                             "(speculation needs host drafts between verify steps)")
        # a speculative verify writes k+1 cache rows past each slot's position; a quantum Q
        self._headroom = max(self.speculative_k + 1, self.decode_quantum)
        self.spec_accepted = 0  # drafts accepted / offered over the batcher's life
        self.spec_drafted = 0
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk and self._headroom > self.prefill_chunk:
            raise ValueError(
                "prefill_chunk must be >= decode_quantum and speculative_k+1: a mid-prefill "
                "slot's garbage decode rows must fit inside the range its next chunk "
                "overwrites")
        self._prefilling: Dict[int, int] = {}  # slot -> tokens prefilled so far
        self._pf_next = 0  # round-robin pointer over mid-prefill slots
        self.prefix_cache_size = int(prefix_cache_size)
        self._prefix_cache: "OrderedDict[bytes, dict]" = OrderedDict()
        self.prefix_cache_hits = 0  # tokens whose prefill a cached prefix saved
        self.rope = build_rope_cache(self.max_seq_length, cfg.rope_n_elem, cfg.rope_base,
                                     cfg.rope_condense_ratio, device=self.device)
        if self._linear_alg:
            self.cache = gpt.init_linear_cache(cfg, n_slots, device=self.device)
        else:
            self.cache = gpt.init_kv_cache(
                cfg, n_slots, self.max_seq_length, cache_dtype or self.params["wte"].dtype,
                device=self.device,
                n_groups=None if self.shard is None else self.shard.local_groups(cfg))
        self.positions = np.zeros(n_slots, np.int32)  # next write position
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue: List[Request] = []
        self._next_id = 0
        if generator is None:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(0)
        self.generator = generator
        # wave sizes of the batched admission prefill; remainders admit one by one
        self.prefill_batch_buckets = tuple(p for p in (16, 8, 4) if p <= n_slots)
        self.batched_admissions = 0  # requests admitted in waves

    # ------------------------------------------------------------- requests

    def submit(self, prompt: np.ndarray, max_new_tokens: int, *,
               temperature: float = 0.0, top_k: Optional[int] = None,
               eos_id: Optional[int] = None, return_request: bool = False):
        """Queue a request; returns its id (or the Request itself with
        ``return_request=True``: a serving frontend follows
        ``Request.generated``/``.done``, see inference/server.py)."""
        self._check_leader("submit")
        req = Request(self._next_id, np.asarray(prompt, np.int32), max_new_tokens,
                      temperature, top_k, eos_id)
        self._next_id += 1
        self.queue.append(req)
        if self.mesh is not None:
            self._unsent.append(req)
        return req if return_request else req.request_id

    def inflight(self) -> int:
        """Requests queued or occupying a slot."""
        return len(self.queue) + sum(s is not None for s in self.slots)

    # ------------------------------------------------------------ prefill

    def _bucket(self, n: int, limit: int) -> int:
        return min(limit, -(-n // self.prefill_bucket) * self.prefill_bucket)

    def _prefill(self, tokens: np.ndarray, n_valid: int, row: dict, p0: int) -> torch.Tensor:
        """One sequence over a padded length into ``row`` (views of one slot
        of the cache, or a fresh row, written in place); ``p0`` is the
        position of tokens[0]. Returns the logits (1, V) at n_valid - 1 (at
        the last token for a chunk that ends before it, which nothing reads)."""
        idx = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)[None]
        logits, _ = gpt.forward(self.params, self.cfg, idx, input_pos=p0, kv_cache=row,
                                rope_cache=self.rope, plain=self.plain, shard=self.shard)
        return logits[:, min(n_valid - p0, idx.shape[1]) - 1]

    def _prefill_linear(self, tokens: np.ndarray, n_valid: int, row: dict) -> torch.Tensor:
        """A prompt padded to its bucket into a slot's running state ``row``
        (views, overwritten in place); returns the logits (1, V) at n_valid - 1."""
        idx = torch.as_tensor(tokens, dtype=torch.int32, device=self.device)[None]
        logits, _ = gpt.forward_linear_cache(self.params, self.cfg, idx, state=row, input_pos=0,
                                             rope_cache=self.rope, is_prefill=True,
                                             n_valid=n_valid, plain=self.plain, shard=self.shard)
        return logits[:, n_valid - 1]

    def _slot_row(self, slot: int) -> dict:
        return {k: v[:, slot:slot + 1] for k, v in self.cache.items()}

    def _first_token(self, req: Request, last: torch.Tensor) -> int:
        tok = sample(last[0], req.temperature, req.top_k, generator=self.generator)
        return int(self._agree(tok.reshape(1))[0])

    @torch.inference_mode()
    def _admit(self) -> None:
        self._admit_batched()
        for slot in range(self.n_slots):
            if self.slots[slot] is not None or not self.queue:
                continue
            req = self.queue.pop(0)
            t = len(req.prompt)
            row = self._slot_row(slot)
            if self._linear_alg:
                padded = np.zeros(self._bucket(t, self.max_seq_length), np.int32)
                padded[:t] = req.prompt[:padded.size]
                last = self._prefill_linear(padded, t, row)
            else:
                p0 = self._apply_prefix(req.prompt[:t], row) if self.prefix_cache_size else 0
                if self.prefill_chunk:
                    # chunked admission: claim the slot, start at the shared prefix
                    # (if cached); _prefill_tick does the work
                    self._prefilling[slot] = p0
                    self.positions[slot] = p0
                    self.slots[slot] = req
                    continue
                n_suffix = t - p0
                bucket = self._bucket(n_suffix, self.max_seq_length - p0)
                padded = np.zeros(bucket, np.int32)
                padded[:n_suffix] = req.prompt[p0:p0 + bucket][:n_suffix]
                last = self._prefill(padded, t, row, p0)
                if self.prefix_cache_size:
                    self._prefix_insert(req.prompt[:t], row)
            first = self._first_token(req, last)
            req.generated.append(first)
            self.positions[slot] = t
            self.slots[slot] = req
            self._maybe_finish(slot, first)

    def _admit_batched(self) -> None:
        """Admit FIFO waves of queued requests that share a padded bucket
        through one (P, Tb) prefill into fresh cache rows (valid because a
        slot's positions >= its prompt length are never attended before
        decode overwrites them). Prefix-cache hits and chunked admission
        take the per-request path; only full P-bucket groups run here."""
        if self._linear_alg or self.prefill_chunk or not self.prefill_batch_buckets:
            return
        while True:
            free = [s for s in range(self.n_slots) if self.slots[s] is None]
            if len(free) < self.prefill_batch_buckets[-1] or not self.queue:
                return
            b0 = self._bucket(len(self.queue[0].prompt), self.max_seq_length)
            group = []
            for req in self.queue:
                if len(group) >= min(len(free), self.prefill_batch_buckets[0]):
                    break
                if self._bucket(len(req.prompt), self.max_seq_length) != b0:
                    break
                if self.prefix_cache_size and self._prefix_lookup(req.prompt) is not None:
                    break
                group.append(req)
            p = next((p for p in self.prefill_batch_buckets if p <= len(group)), None)
            if p is None:
                return
            group, slots = group[:p], free[:p]
            tokens = np.zeros((p, b0), np.int32)
            n_valid = np.zeros(p, np.int32)
            temps = np.zeros(p, np.float32)
            topk = np.full(p, self.cfg.padded_vocab_size, np.int32)
            for i, req in enumerate(group):
                t = min(len(req.prompt), b0)
                tokens[i, :t] = req.prompt[:t]
                n_valid[i] = t
                temps[i] = req.temperature
                if req.top_k:
                    topk[i] = req.top_k
            rows = {k: torch.zeros(v.shape[:1] + (p,) + v.shape[2:], dtype=v.dtype,
                                   device=self.device) for k, v in self.cache.items()}
            dev = self._dev
            logits, _ = gpt.forward(self.params, self.cfg, dev(tokens), input_pos=0,
                                    kv_cache=rows, rope_cache=self.rope,
                                    logits_at=dev(n_valid - 1), plain=self.plain,
                                    shard=self.shard)
            first = self._agree(sample_traced(logits[:, 0], dev(temps), dev(topk),
                                              generator=self.generator,
                                              hot=bool((temps > 0).any())))
            self.batched_admissions += p
            idx = torch.as_tensor(slots, device=self.device)
            for k, v in self.cache.items():
                v[:, idx] = rows[k]
            first = first.cpu().numpy()
            for i, (req, slot) in enumerate(zip(group, slots)):
                self.queue.remove(req)
                if self.prefix_cache_size:
                    self._prefix_insert(req.prompt, {k: v[:, i:i + 1] for k, v in rows.items()})
                req.generated.append(int(first[i]))
                self.positions[slot] = n_valid[i]
                self.slots[slot] = req
                self._maybe_finish(slot, int(first[i]))

    def _prefill_tick(self) -> None:
        """Advance one mid-prefill slot (round-robin) by one chunk; on its
        last chunk, sample the first token and hand the slot to decode."""
        if not self._prefilling:
            return
        order = sorted(self._prefilling)
        slot = next((s for s in order if s >= self._pf_next), order[0])
        self._pf_next = slot + 1
        req = self.slots[slot]
        t = len(req.prompt)
        p = self._prefilling[slot]
        n = min(self.prefill_chunk, t - p)
        padded = np.zeros(self.prefill_chunk, np.int32)
        padded[:n] = req.prompt[p:p + n]
        row = self._slot_row(slot)
        last = self._prefill(padded, t, row, p)
        p += n
        if p < t:
            self._prefilling[slot] = p
            self.positions[slot] = p
            return
        del self._prefilling[slot]
        if self.prefix_cache_size:
            self._prefix_insert(req.prompt, row)
        first = self._first_token(req, last)
        req.generated.append(first)
        self.positions[slot] = t
        self._maybe_finish(slot, first)

    def _decodable(self, slot: int) -> bool:
        """Slot holds a request that is past prefill (decode may advance it)."""
        return self.slots[slot] is not None and slot not in self._prefilling

    def _maybe_finish(self, slot: int, token: int) -> None:
        req = self.slots[slot]
        if req is None:
            return
        if (req.eos_id is not None and token == req.eos_id) or \
                len(req.generated) >= req.max_new_tokens or \
                self.positions[slot] + self._headroom >= self.max_seq_length:
            req.done = True
            self.slots[slot] = None

    # -------------------------------------------------------- prefix cache

    @torch.inference_mode()
    def register_prefix(self, tokens: np.ndarray) -> None:
        """Prefill and cache a shared prefix (a system prompt) without
        occupying a slot: later requests that start with it skip its
        prefill. Admitted prompts are cached in full as well."""
        if not self.prefix_cache_size:
            raise ValueError("prefix_cache_size is 0: enable the prefix cache first")
        self._check_leader("register_prefix")
        tokens = np.asarray(tokens, np.int32)
        if self.mesh is not None:
            self._publish(_PREFIX, tokens)
        self._register_prefix(tokens)

    def _register_prefix(self, tokens: np.ndarray) -> None:
        t = len(tokens)
        row = {k: torch.zeros_like(v[:, :1]) for k, v in self.cache.items()}
        p0 = self._apply_prefix(np.concatenate([tokens, [0]]).astype(np.int32), row, count=False)
        n_suffix = t - p0
        bucket = self._bucket(n_suffix, self.max_seq_length - p0)
        padded = np.zeros(bucket, np.int32)
        padded[:n_suffix] = tokens[p0:p0 + bucket][:n_suffix]
        self._prefill(padded, t, row, p0)
        self._prefix_insert(tokens, row)

    def _prefix_lookup(self, prompt: np.ndarray):
        """Longest cached prompt that is a strict prefix of ``prompt`` (at
        least one suffix token must remain to give logits); refreshes the
        hit in the LRU order."""
        best_key, best = None, None
        for key_b, entry in self._prefix_cache.items():
            n = entry["len"]
            if (best is None or n > best["len"]) and n <= len(prompt) - 1 and \
                    np.array_equal(prompt[:n], entry["tokens"]):
                best_key, best = key_b, entry
        if best_key is not None:
            self._prefix_cache.move_to_end(best_key)
        return best

    def _apply_prefix(self, prompt: np.ndarray, row: dict, count: bool = True) -> int:
        """Copy the longest cached strict prefix of ``prompt`` into ``row``;
        returns its length p0 (0 on a miss), counted in ``prefix_cache_hits``
        unless ``count`` is False."""
        entry = self._prefix_lookup(prompt)
        if entry is None:
            return 0
        p0 = entry["len"]
        for k in row:
            row[k][:, :, :, :p0] = entry[k]
        if count:
            self.prefix_cache_hits += p0
        return p0

    def _prefix_insert(self, prompt: np.ndarray, row: dict) -> None:
        """Keep a device copy of this prompt's KV rows, LRU-bounded."""
        key_b = prompt.tobytes()
        if key_b in self._prefix_cache:
            self._prefix_cache.move_to_end(key_b)
            return
        t = len(prompt)
        entry = {"tokens": prompt.copy(), "len": t}
        for k, v in row.items():
            entry[k] = v[:, :, :, :t].clone()
        self._prefix_cache[key_b] = entry
        while len(self._prefix_cache) > self.prefix_cache_size:
            self._prefix_cache.popitem(last=False)

    # -------------------------------------------------------------- decode

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _decode_step(self, tokens, positions, temps, topk, hot: bool) -> torch.Tensor:
        """One token for every slot: tokens, positions (n_slots,) on the
        device; returns the next tokens (n_slots,) int32 on the device."""
        if self._linear_alg:
            logits, _ = gpt.forward_linear_cache(self.params, self.cfg, tokens[:, None],
                                                 state=self.cache, input_pos=positions,
                                                 rope_cache=self.rope, is_prefill=False,
                                                 plain=self.plain, shard=self.shard)
        else:
            logits, _ = gpt.forward(self.params, self.cfg, tokens[:, None], input_pos=positions,
                                    kv_cache=self.cache, rope_cache=self.rope, plain=self.plain,
                                    shard=self.shard)
        return self._agree(sample_traced(logits[:, -1], temps, topk, generator=self.generator,
                                         hot=hot))

    def _slot_inputs(self, decodable):
        tokens = np.zeros(self.n_slots, np.int32)
        temps = np.zeros(self.n_slots, np.float32)
        topk = np.full(self.n_slots, self.cfg.padded_vocab_size, np.int32)
        for i, req in enumerate(self.slots):
            if decodable[i]:
                tokens[i] = req.generated[-1]
                temps[i] = req.temperature
                if req.top_k:
                    topk[i] = req.top_k
        return tokens, temps, topk

    # ---------------------------------------------------------------- the mesh

    def _check_leader(self, what: str) -> None:
        if self.mesh is not None and not self.mesh.leader:
            raise RuntimeError(f"{what}: rank {self.mesh.rank} follows rank 0's plan "
                               "(call follow()); only rank 0 drives the batcher")

    def _agree(self, tokens: torch.Tensor) -> torch.Tensor:
        """Rank 0's sampled tokens on every rank of the mesh."""
        if self.mesh is None:
            return tokens
        from ..parallel import collectives as col

        return col.broadcast(tokens.to(torch.int32).contiguous(), 0, self.mesh.world)

    def _publish(self, cmd: int, tokens: Optional[np.ndarray] = None) -> None:
        """Rank 0: broadcast one plan, [cmd, ...]: for a step, each request
        submitted since the last plan as [id, max_new_tokens, temperature's
        float32 bits, top_k or -1, eos_id or -1, prompt length, prompt...];
        for a prefix, its tokens."""
        from ..parallel import collectives as col

        body = [cmd]
        if cmd == _STEP:
            for r in self._unsent:
                body += [r.request_id, r.max_new_tokens,
                         int(np.float32(r.temperature).view(np.int32)),
                         -1 if r.top_k is None else r.top_k, -1 if r.eos_id is None else r.eos_id,
                         len(r.prompt), *r.prompt.tolist()]
            self._unsent = []
        elif cmd == _PREFIX:
            body += np.asarray(tokens).tolist()
        col.broadcast_ints(np.asarray(body, np.int64), 0, self.mesh.world, self.mesh.comm_device)

    def follow(self) -> None:
        """A rank other than 0: apply rank 0's plans, step for step, until it
        calls ``close()``."""
        from ..parallel import collectives as col

        if self.mesh is None or self.mesh.leader:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh")
        while True:
            msg = col.broadcast_ints(None, 0, self.mesh.world, self.mesh.comm_device)
            cmd = int(msg[0])
            if cmd == _STOP:
                return
            if cmd == _PREFIX:
                self._register_prefix(msg[1:].astype(np.int32))
                continue
            i = 1
            while i < len(msg):
                rid, n_new, t_bits, top_k, eos, n = (int(v) for v in msg[i:i + 6])
                prompt = msg[i + 6:i + 6 + n].astype(np.int32)
                i += 6 + n
                self.queue.append(Request(
                    rid, prompt, n_new, float(np.int32(t_bits).view(np.float32)),
                    None if top_k < 0 else top_k, None if eos < 0 else eos))
                self._next_id = rid + 1
            self._step_local()

    def close(self) -> None:
        """Rank 0: end the followers' ``follow()`` loops (a no-op off a mesh)."""
        if self.mesh is not None and self.mesh.leader:
            self._publish(_STOP)

    @torch.inference_mode()
    def step(self):
        """Advance every active slot; returns {request_id: token}, or
        {request_id: [tokens]} with ``speculative_k`` or ``decode_quantum`` > 1.
        On a mesh, rank 0 only: it broadcasts the plan first."""
        if self.mesh is not None:
            self._check_leader("step")
            self._publish(_STEP)
        return self._step_local()

    @torch.inference_mode()
    def _step_local(self):
        if self.speculative_k:
            return self._step_speculative()
        if self.decode_quantum > 1:
            return self._step_quantum()
        self._admit()
        self._prefill_tick()
        active = [self._decodable(i) for i in range(self.n_slots)]
        if not any(active):
            return {}
        tokens, temps, topk = self._slot_inputs(active)
        nxt = self._decode_step(self._dev(tokens), self._dev(self.positions), self._dev(temps),
                                self._dev(topk), hot=bool((temps > 0).any()))
        nxt = nxt.cpu().numpy()
        out: Dict[int, int] = {}
        for i, req in enumerate(self.slots):
            if not active[i]:
                continue
            self.positions[i] += 1
            tok = int(nxt[i])
            req.generated.append(tok)
            out[req.request_id] = tok
            self._maybe_finish(i, tok)
        return out

    def _step_quantum(self) -> Dict[int, List[int]]:
        """Advance every active slot by up to ``decode_quantum`` tokens: the
        steps are issued back to back with tokens and positions on the
        device, and the tokens are read back once at the end."""
        self._admit()
        self._prefill_tick()
        decodable = [self._decodable(i) for i in range(self.n_slots)]
        if not any(decodable):
            return {}
        tokens, temps, topk = self._slot_inputs(decodable)
        # adaptive: a free slot means someone could be admitted at the next
        # boundary, so keep it close; all slots busy: the full quantum
        q = (self._q_small if self.adaptive_quantum and any(s is None for s in self.slots)
             else self.decode_quantum)
        hot = bool((temps > 0).any())
        tok, pos = self._dev(tokens), self._dev(self.positions)
        temps_d, topk_d = self._dev(temps), self._dev(topk)
        toks = torch.empty((q, self.n_slots), dtype=torch.int32, device=self.device)
        for i in range(q):
            tok = self._decode_step(tok, pos, temps_d, topk_d, hot)
            toks[i] = tok
            pos = pos + 1
        toks = toks.cpu().numpy()  # (Q, n_slots)
        out: Dict[int, List[int]] = {}
        for i, req in enumerate(self.slots):
            if not decodable[i]:
                continue
            lane = toks[:, i].tolist()
            lane = lane[: req.max_new_tokens - len(req.generated)]
            if req.eos_id is not None and req.eos_id in lane:
                lane = lane[: lane.index(req.eos_id) + 1]
            req.generated.extend(lane)
            self.positions[i] += len(lane)
            out[req.request_id] = lane
            self._maybe_finish(i, lane[-1] if lane else -1)
        return out

    def _draft_np(self, req: Request, k: int) -> np.ndarray:
        """Prompt lookup on the host: the k tokens that followed the most
        recent earlier occurrence of the request's current bigram (the rule
        of ``inference/speculative.ngram_draft``, but a short match is padded
        with the last token and nothing past the history is read)."""
        hist = np.concatenate([req.prompt, np.asarray(req.generated, np.int32)])
        n = len(hist)
        if n >= 4:
            b0, b1 = hist[-2], hist[-1]
            starts = np.nonzero((hist[:-1] == b0) & (hist[1:] == b1))[0]
            starts = starts[starts + 2 <= n - 2]  # strictly earlier occurrence
            if starts.size:
                d = hist[starts[-1] + 2: starts[-1] + 2 + k]
                if d.size < k:
                    d = np.concatenate([d, np.full(k - d.size, hist[-1], np.int32)])
                return d.astype(np.int32)
        return np.full(k, hist[-1], np.int32)

    def _step_speculative(self) -> Dict[int, List[int]]:
        """One batched draft-verify step over every decodable slot: the
        (n_slots, k+1) rows [current, k drafts] through one forward at the
        slots' positions, then each slot's decided tokens, cut to its budget,
        then at its eos."""
        self._admit()
        self._prefill_tick()
        active = [self._decodable(i) for i in range(self.n_slots)]
        if not any(active):
            return {}
        k = self.speculative_k
        cur, temps, topk = self._slot_inputs(active)
        tokens = np.zeros((self.n_slots, k + 1), np.int32)
        tokens[:, 0] = cur
        for i, req in enumerate(self.slots):
            if active[i]:
                tokens[i, 1:] = self._draft_np(req, k)
        logits, _ = gpt.forward(self.params, self.cfg, self._dev(tokens),
                                input_pos=self._dev(self.positions), kv_cache=self.cache,
                                rope_cache=self.rope, plain=self.plain, shard=self.shard)
        a, cand = speculative_accept_traced(logits, self._dev(tokens[:, 1:]), self._dev(temps),
                                            self._dev(topk), generator=self.generator,
                                            hot=bool((temps > 0).any()))
        both = self._agree(torch.cat([a.to(torch.int32)[:, None], cand.to(torch.int32)],
                                     dim=1)).cpu().numpy()  # one read
        out: Dict[int, List[int]] = {}
        for i, req in enumerate(self.slots):
            if not active[i]:
                continue
            n_acc = int(both[i, 0])
            self.spec_accepted += min(n_acc, k)
            self.spec_drafted += k
            toks = both[i, 1:n_acc + 2].tolist()
            # budget, then eos truncation (keep the eos itself)
            toks = toks[: req.max_new_tokens - len(req.generated)]
            if req.eos_id is not None and req.eos_id in toks:
                toks = toks[: toks.index(req.eos_id) + 1]
            req.generated.extend(toks)
            self.positions[i] += len(toks)
            out[req.request_id] = toks
            self._maybe_finish(i, toks[-1] if toks else -1)
        return out

    def run_to_completion(self, max_steps: int = 100_000) -> Dict[int, List[int]]:
        """Drain queue and slots; returns {request_id: generated tokens}."""
        tracked: List[Request] = list(self.queue)
        tracked += [s for s in self.slots if s is not None]
        for _ in range(max_steps):
            if not self.queue and all(s is None for s in self.slots):
                break
            self.step()
        return {req.request_id: req.generated for req in tracked}
