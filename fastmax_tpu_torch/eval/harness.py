"""Evaluation harness (counterpart of ``fastmax_tpu/eval/harness.py``).

Two layers:

1. ``FastmaxLM``: a model adapter with the EleutherAI lm-eval contract
   (loglikelihood over (context, continuation) pairs, rolling
   loglikelihood, greedy generation), scoring requests in batches of
   ``batch_size`` rows padded to length buckets of 64 tokens, each batch one
   no-cache forward (``gpt.forward``; quadratic attention at T >= 1024 takes
   the trainable flash route, K6 on the card). When the ``lm_eval`` package
   is installed, ``run_eval_harness --tasks`` runs its tasks through it.
2. Evaluators that need no package: token perplexity over a text file, and
   multiple-choice accuracy over a local JSON task (``eval_assets/tasks``).

    python -m fastmax_tpu_torch.eval.harness --checkpoint_dir ckpt \\
        --local_task_file eval_assets/tasks/code_cloze.json [--device cpu]

The token-id methods (``loglikelihood_tokens_batch``,
``perplexity_on_tokens``) do not touch the tokenizer, so ``FastmaxLM`` works
with ``tokenizer=None`` on token ids.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models import gpt
from ..models.config import Config
from ..models.tokenizer import Tokenizer


class FastmaxLM:
    """Loglikelihood/generation adapter over the model. ``plain=True`` sends
    every kernel call of its forwards to the plain PyTorch version (a test
    hook for holding the kernels against them on the card)."""

    def __init__(self, cfg: Config, params, tokenizer: Optional[Tokenizer],
                 max_seq_length: Optional[int] = None, batch_size: int = 1,
                 plain: bool = False):
        self.cfg = cfg
        self.params = params
        self.tokenizer = tokenizer
        self.max_seq_length = min(max_seq_length or cfg.block_size, cfg.block_size)
        self.batch_size = batch_size
        self.plain = plain
        self.device = params["wte"].device
        self._cached_engine = None

    @torch.inference_mode()
    def _fwd(self, idx: torch.Tensor) -> torch.Tensor:
        """(B, T, V) float32 log-probabilities of the no-cache forward."""
        logits, _ = gpt.forward(self.params, self.cfg, idx, plain=self.plain)
        return torch.log_softmax(logits.float(), dim=-1)

    @torch.inference_mode()
    def _score(self, idx: torch.Tensor, mask: torch.Tensor):
        """(sum log-prob of the masked tokens, all of them greedy) per row.
        idx: (B, T) tokens; mask: (B, T) 1.0 where a token belongs to the
        scored continuation; the logits at position i predict token i + 1."""
        logp = self._fwd(idx)[:, :-1]
        tgt = idx[:, 1:].long()
        tok_lp = torch.gather(logp, 2, tgt[..., None])[..., 0]
        hit = torch.argmax(logp, dim=-1) == tgt
        m = mask[:, 1:]
        ll = torch.sum(tok_lp * m, dim=-1)
        greedy = torch.all(torch.where(m > 0, hit, torch.ones_like(hit)), dim=-1)
        return ll, greedy

    def _engine(self):
        """One engine per LM, made at the first generation."""
        if self._cached_engine is None:
            from ..inference.engine import InferenceEngine

            self._cached_engine = InferenceEngine(self.cfg, self.params,
                                                  max_seq_length=self.max_seq_length,
                                                  batch_size=1, device=self.device)
        return self._cached_engine

    # -- lm-eval style interface ------------------------------------------

    @property
    def eot_token_id(self):
        return self.tokenizer.eos_id

    def tok_encode(self, string: str) -> List[int]:
        return self.tokenizer.encode(string, bos=False, eos=False).tolist()

    def tok_decode(self, tokens: Sequence[int]) -> str:
        return self.tokenizer.decode(np.asarray(tokens))

    def _prep_tokens(self, context: List[int], continuation: List[int]):
        """Truncate to max_seq_length with lm-eval's semantics: keep at least
        one context token and the continuation's tail that fits. Returns
        (tokens, n_ctx)."""
        if len(continuation) >= self.max_seq_length:
            continuation = continuation[-(self.max_seq_length - 1):]
        tokens = (context + continuation)[-self.max_seq_length:]
        n_ctx = len(tokens) - len(continuation)
        assert n_ctx >= 1, (len(tokens), len(continuation))
        return tokens, n_ctx

    def loglikelihood_tokens(self, context: List[int],
                             continuation: List[int]) -> Tuple[float, bool]:
        """(sum log-prob of the continuation, is_greedy) for one request."""
        return self.loglikelihood_tokens_batch([(context, continuation)])[0]

    def loglikelihood_tokens_batch(
        self, requests: List[Tuple[List[int], List[int]]]
    ) -> List[Tuple[float, bool]]:
        """Score many (context tokens, continuation tokens) pairs: sorted by
        length, then ``batch_size`` at a time in one (batch_size, bucket)
        forward, the bucket the group's longest rounded up to 64."""
        prepped = [self._prep_tokens(list(c), list(t)) for c, t in requests]
        order = sorted(range(len(prepped)), key=lambda i: len(prepped[i][0]))
        results: List[Optional[Tuple[float, bool]]] = [None] * len(prepped)
        bs = self.batch_size
        for group_start in range(0, len(order), bs):
            idxs = order[group_start: group_start + bs]
            bucket = min(self.max_seq_length,
                         ((max(len(prepped[i][0]) for i in idxs) + 63) // 64) * 64)
            toks = np.zeros((bs, bucket), np.int32)
            mask = np.zeros((bs, bucket), np.float32)
            for row, i in enumerate(idxs):
                tokens, n_ctx = prepped[i]
                toks[row, : len(tokens)] = tokens
                mask[row, n_ctx: len(tokens)] = 1.0
            ll, greedy = self._score(torch.from_numpy(toks).to(self.device),
                                     torch.from_numpy(mask).to(self.device))
            ll, greedy = ll.cpu().numpy(), greedy.cpu().numpy()
            for row, i in enumerate(idxs):
                results[i] = (float(ll[row]), bool(greedy[row]))
        return results  # type: ignore[return-value]

    def loglikelihood(self, requests: List[Tuple[str, str]]) -> List[Tuple[float, bool]]:
        token_reqs = []
        for context, continuation in requests:
            ctx = self.tok_encode(context) or [self.eot_token_id]
            token_reqs.append((ctx, self.tok_encode(continuation)))
        return self.loglikelihood_tokens_batch(token_reqs)

    def loglikelihood_rolling_tokens(self, toks: List[int]) -> float:
        """Rolling loglikelihood of a whole token stream in lm-eval's
        disjoint windows: every token is scored exactly once; the first
        window is conditioned on the EOT token alone, each later one on the
        single token before it. Each window scores ``max_seq_length - 1``
        tokens (the context token and the predictions fill the forward), so
        the window boundaries sit one token from lm-eval's and the sum is
        exact."""
        if not toks:
            return 0.0
        pred_len = max(self.max_seq_length - 1, 1)
        first = min(len(toks), pred_len)
        reqs: List[Tuple[List[int], List[int]]] = [([self.eot_token_id], list(toks[:first]))]
        pos = first
        while pos < len(toks):
            n_new = min(pred_len, len(toks) - pos)
            reqs.append(([int(toks[pos - 1])], list(toks[pos: pos + n_new])))
            pos += n_new
        return float(sum(ll for ll, _ in self.loglikelihood_tokens_batch(reqs)))

    def greedy_until(self, prompt: str, max_new_tokens: int = 64,
                     stop: Sequence[str] = ()) -> str:
        # prompt and generation must fit max_seq_length: the prompt keeps its tail
        max_new_tokens = min(max_new_tokens, self.max_seq_length - 1)
        enc = self.tokenizer.encode(prompt)[-(self.max_seq_length - max_new_tokens):]
        out = self._engine().generate(torch.from_numpy(enc), len(enc) + max_new_tokens,
                                      temperature=0.0, eos_id=self.tokenizer.eos_id)
        text = self.tokenizer.decode(out[0, len(enc):].cpu().numpy())
        for s in stop:
            if s in text:
                text = text.split(s)[0]
        return text


class CachingLM:
    """A persistent request-level result cache around a ``FastmaxLM``
    (``--use_cache``): a later run recomputes only the requests missing from
    the JSON cache file, in one batched call, and appends them."""

    def __init__(self, lm: FastmaxLM, cache_path: Path):
        self.lm = lm
        self.cache_path = Path(cache_path)
        self._cache: dict = {}
        if self.cache_path.exists():
            with open(self.cache_path, encoding="utf-8") as fp:
                self._cache = json.load(fp)

    def __getattr__(self, name):
        return getattr(self.lm, name)

    @staticmethod
    def _key(context: str, continuation: str) -> str:
        import hashlib

        h = hashlib.sha256()
        h.update(context.encode())
        h.update(b"\x1f")
        h.update(continuation.encode())
        return h.hexdigest()

    def loglikelihood(self, requests: List[Tuple[str, str]]) -> List[Tuple[float, bool]]:
        keys = [self._key(c, t) for c, t in requests]
        miss = [i for i, k in enumerate(keys) if k not in self._cache]
        if miss:
            computed = self.lm.loglikelihood([requests[i] for i in miss])
            for i, res in zip(miss, computed):
                self._cache[keys[i]] = list(res)
            self._save()
        return [(self._cache[k][0], bool(self._cache[k][1])) for k in keys]

    def _save(self) -> None:
        tmp = self.cache_path.with_suffix(".tmp")
        with open(tmp, "w", encoding="utf-8") as fp:
            json.dump(self._cache, fp)
        tmp.replace(self.cache_path)


# --------------------------------------------------------- local evaluators


def perplexity_on_tokens(lm: FastmaxLM, tokens: np.ndarray, stride: int = 512) -> float:
    """Token perplexity over a long stream, in windows of ``stride`` targets."""
    total_nll, total_count = 0.0, 0
    n = len(tokens)
    for start in range(0, max(n - 1, 1), stride):
        window = np.asarray(tokens[start: start + stride + 1])
        if len(window) < 2:
            break
        idx = torch.from_numpy(window[:-1].astype(np.int32))[None].to(lm.device)
        logp = lm._fwd(idx)[0]
        tgt = torch.from_numpy(window[1:].astype(np.int64)).to(lm.device)
        total_nll -= float(torch.sum(logp[torch.arange(len(tgt), device=lm.device), tgt]))
        total_count += len(tgt)
    return math.exp(total_nll / max(total_count, 1))


def multiple_choice_accuracy(lm: FastmaxLM, task_file: Path) -> dict:
    """Accuracy over a local JSON task: a list of {"query": str, "choices":
    [str, ...], "gold": int} records (the arc/piqa/hellaswag record shape),
    every (query, choice) pair scored in one batched call."""
    with open(task_file, encoding="utf-8") as fp:
        records = json.load(fp)
    requests = [(rec["query"], " " + choice) for rec in records for choice in rec["choices"]]
    lls = iter(lm.loglikelihood(requests))
    correct = correct_norm = 0
    for rec in records:
        scores = [(ll, ll / max(len(choice), 1)) for choice, (ll, _) in zip(rec["choices"], lls)]
        correct += int(np.argmax([s[0] for s in scores])) == rec["gold"]
        correct_norm += int(np.argmax([s[1] for s in scores])) == rec["gold"]
    n = len(records)
    return {"acc": correct / n, "acc_norm": correct_norm / n, "n": n}


# --------------------------------------------------------------- lm-eval


def run_eval_harness(
    checkpoint_dir: Path,
    tasks: Optional[str] = None,
    quantize: Optional[str] = None,
    attn_alg: Optional[str] = None,
    precision: str = "float32",
    num_fewshot: int = 0,
    limit: Optional[int] = None,
    save_filepath: Optional[Path] = None,
    local_task_file: Optional[Path] = None,
    ppl_text_file: Optional[Path] = None,
    batch_size: int = 8,
    use_cache: Optional[Path] = None,
    device=None,
) -> dict:
    """Evaluate a checkpoint on the card (``device="cpu"`` for the CPU).
    ``--tasks`` runs the EleutherAI harness (the ``lm_eval`` package);
    ``--local_task_file``/``--ppl_text_file`` the built-in evaluators;
    batch_size: loglikelihood requests scored per forward; use_cache: a JSON
    file caching per-request results across runs."""
    from ..inference.engine import default_device
    from ..inference.generate import load_and_prepare

    device = default_device(device)
    tokenizer = Tokenizer(Path(checkpoint_dir))
    cfg, params = load_and_prepare(Path(checkpoint_dir), quantize=quantize, attn_alg=attn_alg,
                                   precision=precision, device=device)
    lm = FastmaxLM(cfg, params, tokenizer, batch_size=batch_size)
    if use_cache:
        lm = CachingLM(lm, Path(use_cache))

    results: dict = {"model": cfg.name, "quantize": quantize}
    if local_task_file:
        results["local_task"] = multiple_choice_accuracy(lm, Path(local_task_file))
    if ppl_text_file:
        toks = tokenizer.encode(Path(ppl_text_file).read_text(encoding="utf-8"))
        results["perplexity"] = perplexity_on_tokens(lm, toks)
    if tasks:
        try:
            import lm_eval  # noqa: F401
        except ImportError:
            raise ImportError(
                "the lm_eval package is not installed; use --local_task_file / "
                "--ppl_text_file for the built-in evaluators"
            )
        results["harness"] = _run_lm_eval(lm, tasks.split(","), num_fewshot, limit)

    if save_filepath:
        Path(save_filepath).write_text(json.dumps(results, indent=2))
    print(json.dumps(results, indent=2))
    return results


def _run_lm_eval(lm: FastmaxLM, tasks: List[str], num_fewshot: int, limit):
    import lm_eval
    from lm_eval.api.model import LM

    class _Wrapper(LM):
        def loglikelihood(self, requests):
            return lm.loglikelihood([req.args for req in requests])

        def loglikelihood_rolling(self, requests):
            out = []
            for req in requests:
                (text,) = req.args
                out.append((lm.loglikelihood_rolling_tokens(lm.tok_encode(text)),))
            return out

        def generate_until(self, requests):
            out = []
            for req in requests:
                context, gen_kwargs = req.args
                out.append(lm.greedy_until(context, stop=gen_kwargs.get("until", [])))
            return out

    return lm_eval.simple_evaluate(model=_Wrapper(), tasks=tasks, num_fewshot=num_fewshot,
                                   limit=limit)["results"]


def main(args=None) -> dict:
    """The command line: ``run_eval_harness``'s parameters as flags (``utils/cli.py``)."""
    from ..utils.cli import CLI

    return CLI(run_eval_harness, args)


if __name__ == "__main__":
    main()
