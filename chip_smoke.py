#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``fastmax_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits non-zero):

1. header: the card's name and power limit (nvidia-smi), torch and CUDA versions;
2. build: every CUDA kernel of the port, from ``fastmax_tpu_torch/csrc``;
3. the int4 rank-1 matmul kernel against its plain PyTorch version at the four
   Llama-2-7B linear shapes, m in {1, 5, 8, 16, 64, 512} (each path: gemv,
   tensor cores, FMA tile), stacked (layer 2 of 3) and per-layer, f32 and bf16
   x, at gk = 8 (m in {1, 8, 64}) and at a ragged k = 1540, n = 11000 with u,
   v in [0.5, 2]; a bit-for-bit repeat at m = 8; device
   times (weights cold) at m in {1, 8, 16, 32, 64}, 4 < m <= 64 on the tensor
   cores and on the FMA tile kernel;
4. the int8 decode-attention kernel against its plain version on both of its
   routes (the one-block kernel and the split over the cache positions) and
   through both entries (stacked, per-layer): 7B batch 1 (B=1, G=32, D=128,
   S=1024) at pos in {0, 63, 1023} and at the split's chunk edges, f32 and
   bf16; a GQA case; D=64; slots in different chunks, one at pos 0; R=4; the
   serving shape (B=8, S=4096) at pos 3000 and at mixed positions; bf16 held
   by its largest error and its mean error over the mean |plain|; a
   bit-for-bit repeat at the serving shape; device times (cache cold) at batch
   1 pos 191 and 1023 and at the serving shape, both routes in turns;
5. the batch-1 path: a random Llama-2-7B (full width, all 32 layers) in the
   rank-1 int4 format, int8 KV cache, block_size 1024, a 64-token prompt,
   ``InferenceEngine.generate`` of 256 tokens greedy; launch counts of K1 and
   K2 during that call (each must be > 0); TTFT, decode tok/s and peak
   memory; first-token and first-decode-step logits with the kernels against
   the same forward through the plain versions;
6. the flash prefill kernel against its plain version at the 7B shapes
   (B=1, Hq=G=32, D=128, S=4096, bf16: 512-row chunks at pos0 0, 1536 and
   3584, a whole 2048-token prompt, a 1024-token suffix at pos0 2048, and a
   wave of 8 1024-token prompts; a GQA case with ragged T; head sizes 192 and
   256; an f32 case; kv_len below pos0 + T, cutting the last rows' keys under
   their causal frontier or, below pos0, every row's), bf16 held by its largest
   error and by its mean error over the mean |plain|; a bit-for-bit repeat at
   T=512, pos0 3584; device
   times (k/v cold), bounds and one ``scaled_dot_product_attention`` call as
   yardstick;
7. the serving path: the same 7B at its full 4096-token context behind a
   ``ContinuousBatcher`` (8 slots, int8 cache, decode quantum 8, adaptive)
   and the HTTP ``Server``: 8 requests from 4 client threads (prompts of
   256-3072 tokens, 64 new tokens; six greedy, two sampled, one streamed),
   then ``run_load`` closed loop over 16 requests, over 16 requests that
   share a 2048-token prefix registered in the prefix cache, and over 8
   requests of one 128-token bucket, admitted as one batched wave; launch counts of
   K1, K2 and K3 over the whole phase (each must be > 0); tok/s, TTFT
   percentiles, peak memory; profiles of one prefill and one decode step;
   the batcher's greedy tokens against ``InferenceEngine.generate`` (a
   divergence fails unless the top-2 margin there is a near-tie) and its
   first-token logits against the engine's; and 32-layer prefill logits at
   S=4096 with the kernels against the plain route, through the engine's
   512-token chunks and through the batcher's whole-prompt and prefix-suffix
   prefills;
8. training: the fastmax kernels K4 (forward, with and without its g and
   state outputs) and K5 (the reverse walk), through ``fastmax_trainable``
   and ``fastmax_forward``, against their plain versions at the shape a
   training step gives them (B=4, H=8, N=512, D=64, p=2, f32 and bf16; p=1;
   N=2048 at D=16; a ragged N=200 through ``fastmax()``), on inputs where
   s = q.k / z is of order 1 so that the degree-2 terms weigh as much as the
   others; those terms alone (p=2 minus p=1) kernels against plain; K4 and
   K5 repeating bit for bit; device times (inputs cold) of K4 and K5 on their
   tensor-core and FMA kernels, each held against the plain walk, and the
   bounds of each;
   ``pretrain.setup`` on
   easy-transformer-fastmax with its defaults (float32, global batch 8,
   micro-batch 4, T=512, remat, AdamW) for 20 steps over a ``train.bin``
   made from the repository's own ``*.md`` and ``*.py`` bytes: tokens/s, step
   time, MFU against the card's f32 peak, peak memory, the first and last
   logged loss (the last must be lower), K4/K5 launch counts (exactly 2 and 1
   per layer per micro-batch under remat), a profile of one step; one step's
   loss and every gradient with the kernels against ``plain=True`` (qkv
   weights scaled so that s is of order 1); the
   same 20 steps of easy-transformer (quadratic attention) as a yardstick;
   and 6 steps each of easy-transformer-fastmax with ``attn_alg``
   linearmax and performer (their chunked scans: no K4/K5 launch, a finite
   loss that falls);
9. finetuning: the trainable flash kernels K6 (forward: out and lse) and K7
   (backward: dq, dk, dv), through ``flash_attention_fused``,
   ``flash_attention_trainable`` and ``attention()`` (T=1088, padded to 1536),
   against ``plain=True`` at the finetune shape (B=2, H=32, T=2048, D=128,
   bf16 and f32), at D=64, 192 and 256, on inputs whose scores have a
   standard deviation of about 3, with a float64 yardstick; K6/K7 repeating
   bit for bit; device times in a CUDA graph (inputs cold), bounds, the plain
   versions and ``scaled_dot_product_attention`` (forward; forward and
   backward); then ``finetune.setup`` itself: QLoRA (LoRA r 8, alpha 16 on
   query and value) on an NF4 Llama-2-7B at full width, bf16, T up to 2048,
   global batch 8, micro-batch 2, remat, over SFT examples of 1100-2600
   tokens made from the repository's own text: step time, tokens/s, peak
   memory, the loss, lora_B moved off zero, K6/K7 launches (exactly 2 and 1
   per layer per micro-batch), the written lora_weights.safetensors read
   back, a profile of one step; and one step of the same model cut to 4
   layers, kernels against plain (bf16 and f32), loss and every LoRA
   gradient; then the linear arms at D = 128: (a) masked fastmax's
   reversible float32 scan at the finetune shape (no K4/K5 launch) against
   the same scan in float64 on the card (output, dq, dk, dv) and the O(N^2)
   formula in float64 (output), its forward and forward + backward times and
   TFLOP/s; (b) ``finetune.setup`` QLoRA on the same NF4 Llama-2-7B cut to 2
   of its 32 layers with fastmax, linearmax and performer, 2 steps each: step time, tokens/s, peak
   memory, the losses, lora_B moved, no K4-K7 launch, and for fastmax one
   micro-batch on the host clock, its device time and busy share profiled,
   and the scan's part of it;
10. quantized serving: the exact 4-bit codebook kernel K8 against its plain
   version at the three Llama-2-7B linears it takes (m in {1, 8, 64, 512},
   f32 and bf16 x, a double-quant and two FP4 cases), the model's route at
   mlp.proj (k = 11008: dequantize + matmul), and the blockwise int4 kernel
   K9 at the four linears (m in {1, 8, 64, 128}, f32 and bf16, and its raw
   nibble mode), inputs with a non-zero mean; device times in a CUDA graph,
   weights cold, beside the bound, the plain version and dequantize +
   ``torch.matmul``; then a random bf16 Llama-2-7B (seed 0, full width, cut
   to 8 of its 32 layers) quantized to bnb.nf4 on the card and served by
   ``InferenceEngine.generate`` (int8 KV cache, block_size 1024, 64-token
   prompt) in each weights mode: "quantized" (autotune's choice and times
   printed, then the "pallas" backend set so that K8 is on the path),
   "preload_int4_block" (K9), "preload_int4" and "auto" (K1),
   "preload_int8", "preload"; exact K8/K9/K1 launch counts, TTFT, decode
   tok/s, peak memory, prefill and first-step logits kernels against plain
   (gated with float32 activations, reported in bf16);
   each mode against "quantized" on layer 0's four linears ("preload" within
   LOGITS_REL_TOL, the int4/int8 re-representations at a correlation above
   0.95) and on the whole model's logits (error, correlation, top-1 agreement);
   last an 8-slot ``ContinuousBatcher`` in "quantized" and in
   "preload_int4_block" serving 8 requests of 256 tokens (K8/K9 at m = 8)
   with float32 activations and a dense cache, its first-token logits and
   greedy tokens against the engine's; and in "preload_int4_block" under the
   int8 cache, through the kernels held to the same batcher through the
   plain versions (near-tie rule), each one's divergence from the engine
   (m = 1) reported;
11. the int4/NF4 kernel labs (``fastmax_tpu_torch/tools/``): K10 (raw int4
   nibbles with bf16 x on the tensor cores), K11 (the q4 byte layout: NF4 and
   linear int4, scaled before the product or per block), K12 (the
   column-nibble layout, v8-v11) and K13 (the read-rate probes) against their
   plain versions at the four Llama-2-7B linears, m in {1, 8}, every mode,
   with a float64 yardstick for the f32 modes; device times (weights cold),
   bounds and the probes' read rates (above 105 % of the data-sheet rate
   fails), also over 512 MB; the lab functions that equal K1, K8 or K9
   launching them; then the three lab mains end to end (``int4_opt_r04``,
   ``int4_opt_r05``, ``nf4_lab_r04`` with every impl at m = 1 and 8), every
   line checked, with the launch counts of the phase;
12. the training command lines: each command's flags read from its launch
   script (``exec`` wrappers followed, shell variables substituted), a few
   appended to cut the run, run in-process through the port's ``main()``:
   (a) ``pretrain_easy_transformer_enwik8.sh`` (easy-transformer-fastmax,
   K4/K5) for 4 steps on a gzipped enwik8 file of the repository's text, its
   ``out_dir/final`` loaded back bit for bit; (b) a random Llama-2-7B at full
   width and 2 layers written as an HF-named ``model.safetensors``, converted
   by ``scripts/convert_hf_checkpoint.py`` and loaded back bit for bit, with
   write, conversion and load rates; (c) ``finetune_qlora.sh`` (quadratic,
   bnb.nf4) from that directory at T up to 2048 for 2 steps (K6/K7, lora_B
   moved, ``lora_weights.safetensors`` read back); (d) ``finetune_full.sh``
   from it for one step at T up to 512, ``full_weights.safetensors`` holding
   every input name at its shape, moved, and reloading to the final state;
   step times, peak memory and the launch counts of each command;
13. the inference and eval command lines, inside phase 12's directory: (a)
   ``bench_serving.main`` on a random Llama-2-7B at full width, 8 of 32 layers,
   bnb.nf4 under "auto" (K1), int8 cache (K2), 8 slots, quantum 8: 16 requests
   of 64 + 64 tokens, then 8 of 2048 + 16 at a 4096 cache (K3), each JSON line
   checked, tok/s, TTFT and peak memory; (b) ``generate.load_and_prepare`` of
   phase 12's 2-layer directory with its QLoRA delta merged (the dense merge
   within one bf16 step of W + (A @ B) scale) and quantized to bnb.nf4, the
   engine greedy over a 64-token prompt (K1, K2), logits kernels vs plain; (c)
   ``chat.StreamingSession`` on the same weights with a bf16 cache, its tokens
   against (b)'s (near-tie rule) and cut by a two-token stop sequence; (d) the
   entries that build a tokenizer: where ``tokenizers`` imports,
   ``generate.main``, ``chat.main`` (one prompt), ``run_eval_harness`` (a
   local task, perplexity) and ``prepare_alpaca`` end to end with a BPE
   tokenizer trained here on the repository's text; where it does not,
   ``generate.main``, ``server.main`` and ``run_eval_harness`` raising
   ModuleNotFoundError naming it, as the reference does;
   (e) ``merge_lora``, ``convert_lit_checkpoint`` and ``convert_hf_checkpoint``
   back, bit for bit, with their rates, and ``lora.merge_lora`` into an NF4
   base on the card against the dense merge requantized; (f) ``FastmaxLM`` in
   float32 on token ids: 16 requests of 64-1984 context tokens (K6 at the
   buckets of 1024 tokens and more), batched vs serial and kernels vs plain,
   log-probs at (8, 2048) kernels vs plain, perplexity over 4096 tokens; (g)
   ``convert_pretrained_checkpoint`` on phase 12's pretraining out_dir, loaded
   back to its ``final`` bit for bit;
14. the linear arms' serving path (the O(1) running state; no kernel of its
   own, as the reference has none there), inside phase 12's directory: (a)
   each arm's state prefill (output and the state entries it reads) and 16
   in-place decode steps in float32 against the same functions in float64 on
   the card, fastmax at (1, 8, 512, 64) and (1, 32, 512, 128), linearmax and
   performer at (1, 32, 512, 128), fastmax's steps also against the full
   masked ``fastmax()`` (K4 at D = 64, the scan at D = 128), with the prefill
   and one decode step timed; (b) ``InferenceEngine`` on
   easy-transformer-fastmax (random f32 weights): 32 greedy tokens after a
   64-token prompt against recomputing the no-cache forward each step (K4),
   logits against that forward and kernels against plain; (c) the engine on a
   random Llama-2-7B cut to 8 of its 32 layers, bnb.nf4 -> preload_int4 (K1), with each of
   fastmax, linearmax and performer: prompts of 64 and 512 tokens, 32 new
   tokens, prefill ms, decode ms a token, the device busy share, peak memory,
   the state's bytes against the reckoning, K1 launches, logits kernels vs
   plain; (d) a ``ContinuousBatcher`` on that 7B with float32 activations
   (fastmax 2 slots, the others 8; prompts of different lengths in one
   bucket), each slot's tokens against the engine's; (e) ``generate.main``, ``bench_serving.main`` and the eval
   harness's ``greedy_until`` on phase 12's 2-layer checkpoint with
   ``--attn_alg`` each arm; (f) the batcher refusing the prefix cache,
   ``prefill_chunk`` and ``speculative_k`` with a linear arm, with the
   reference's ValueError;
15. Gemma's GeGLU and Mixtral's MoE, the adapter methods and the optimizers:
   (a) a random Gemma-7B at full width cut to 14 of its 28 layers (16 heads of 256,
   vocab 256000) bnb.nf4 -> ``preload_int4`` (K1), int8 cache, 4096 context:
   prompts of 64 and 512 tokens (K3 at D = 256) + 32 new, prefill ms, decode
   ms a token, busy share, peak memory, logits kernels vs plain (max and mean,
   float32 activations, gated against the model's own spread under a moved
   linear), a 4-slot batcher against the engine (near-tie rule); K3 at (1, 16,
   512, S 4096, 256) and K6/K7 at (1, 16, 1024, 256) against plain and SDPA;
   (b) Gemma-7B QLoRA (LoRA on query, value and the GeGLU MLP, T = 1024: K6/K7
   at D = 256), 2 steps, a falling loss; (c) Mixtral-8x7B at full width cut
   to 8 of its 32 layers (its bf16 experts, 2.82 GB a layer, stay dense as in
   the reference): the same serving measures (K1, K2), the MoE host reads a
   layer, the sorted route twice bit for bit and against the dense one, QLoRA
   on qkv and the router (K6/K7 at D = 128); (d) the adapter methods on an NF4
   Llama-2-7B at T = 2048 (adapter, adapter_v2, adapter_v2 with adamw8bit),
   the optimizer state's bytes; (e) adamw8bit, lion and adafactor, 10 steps
   each of phase 8's pretraining (K4/K5), the loss falling; (f) inside phase
   12's directory, ``finetune`` main with ``--method adapter_v2`` and
   ``generate.main`` on its delta, whose text must equal the engine's;
16. the rest of training: (a) one step of TinyLlama (22 layers at full width,
   bs 8, T 2048, bf16) under each remat policy (none, full, attn, dots,
   dots_attn, dots@8:full), the loss bit for bit and the gradients against
   "none", K6 launched once a layer a step and twice where the policy
   recomputes the attention (full, dots), K7 once; ``bench_mfu.run`` under
   each policy (adamw, 3 timed steps: step ms, tok/s, MFU against the bf16
   peak, peak memory, launches), then its fastmax arm under "full" (K4/K5);
   (b) the ``auto`` probe at (8, 32, 2048, 64): both timings, the winner the
   faster, a second call from the cache, a step under it launching K6 if and
   only if flash2 won; (c) ``prepare_packed`` on 4 MB of the repository's text
   with a BPE tokenizer trained here, the native reader (built here with g++;
   ``native_available()`` must be True and the C++ reader, not its numpy
   fallback, must run, here and inside pretraining) against ``PackedDataset``,
   ``pretrain.setup(data_format="packed")`` on
   easy-transformer-fastmax (K4/K5), the loss falling, logged to TensorBoard;
   (d) GPTQ (int4, nf4) on the card at Llama-2-7B's width on 1 layer, the
   hidden states' error below round-to-nearest's, and inside phase 12's
   directory one QLoRA step of ``finetune.setup(gptq_calib=True)`` and
   ``generate.main --gptq_calib`` on the "pallas" backend (K8); (e) the W&B
   logger's branch (the package imported, or the CSV fallback);
17. speculative decoding: (a) K3 at the verify's shapes, T = k+1 in {2, 5, 9}
   rows at pos0 in {63, 2047, 4086} over kv_len = pos0 + T keys (B=1, Hq=G=32,
   D=128, S=4096, bf16 and f32) under phase 6's gates, timed at T = 9; K1 at
   m = 9 and m = 72 at the four 7B linears under phase 3's gates, a layer's
   four timed; (b) ``SpeculativeDecoder`` (prompt lookup, k = 8) on the random
   Llama-2-7B of phases 5 and 7 cut to 8 of its 32 layers (q4r1, int8 cache, 4096
   positions, so that
   every verify is one K3 call of 9 ragged rows): a 512-token prompt of the
   repository's text in which a 64-token segment repeats, 128 new tokens
   greedy against ``engine.generate`` and 32 against its own ``plain=True``
   run (near-tie rule), tok/s of both, verify forwards, acceptance, K1
   launches by path, K3 exactly once a layer a forward; a sampled run
   (temperature 0.8, top_k 50); one verify forward profiled against a step's
   host time; (c) ``DraftSpeculativeDecoder`` with TinyLlama-1.1B at full
   width (random bf16) drafting k = 4 for the 7B, 32 tokens, greedy against its engine
   (near-tie rule), the acceptance of two random models; (d) an 8-slot
   ``ContinuousBatcher`` with ``speculative_k`` 8 (K1 at m = 72 on the FMA
   tile): 8 requests (4 greedy, 2 at top_k 1, 2 hot) against the batcher
   without speculation (near-tie rule), ``spec_acceptance``; a 1024-token
   shared prefix in the prefix cache with ``prefill_chunk`` 256; (e) inside
   phase 12's directory, ``generate --speculative_k`` with and without
   ``--draft_checkpoint_dir`` (TinyLlama's width cut to 2 layers) and the
   server with ``--speculative_k``, on bnb.nf4 (K1), against the engine;
18. multi-GPU serving, inside phase 12's directory: two ranks on the one card
   (``parallel/collectives.spawn_local``, gloo: NCCL takes no two ranks on one
   GPU, so the collectives cross the host and no figure is a multi-GPU one),
   each on its shard, against one rank: (a) Llama-2-7B (8 layers, 4096 context,
   preload_int4, int8 cache) at tp 2, 64-token prompt, 16 greedy tokens (K1 on
   the split linears, K3 on the prefill, K2 over 16 of 32 groups; near-tie
   rule), each rank's weight bytes, kept-whole linears and launches, and the
   first step's logits with f32 activations and cache at phase 15's limits; (b)
   the 8-slot batcher, quantum 8, 8 requests x 16 tokens, tok/s of both; (c)
   an NF4 7B cut to 4 layers in ``quantized`` (K8) and ``preload_int4_block``
   (K9), 8 tokens each; (d) ``generate --tp 2`` and the server at ``--tp 2``
   answering 2 requests, and ``load_sharded_model_params`` (each rank's leaves
   bit-equal to the same cut of the whole load; the bytes each read); (e) one
   rank over NCCL: the (1, 1, 1) mesh engine's tokens are the no-mesh
   engine's bit for bit;
19. multi-GPU training: two ranks on the one card over gloo again, each
   trainer's entry point on a (dp, fsdp, tp) mesh against one rank on the same
   seed and batches: (a) ``pretrain.setup`` on easy-transformer-fastmax, 16 x
   512, f32, 2 steps at (2, 1, 1), (1, 2, 1) and (1, 1, 2) (K4/K5 on a rank's
   rows and heads, 2 and 1 a layer and micro-batch; every step's loss within
   1e-4 relative; each rank's parameter and optimizer bytes); (b)
   ``finetune.setup`` QLoRA on an NF4 Llama-2-7B at full width cut to 4
   layers, T 2048, one step of a global micro-batch of 2 at dp 2 and at fsdp
   2 (K6/K7 2 and 1 a layer and micro-batch, K8 as on one rank; the loss and
   the LoRA gradients within twice the distance between one rank's
   micro-batch of 2 and its two accumulated micro-batches of 1); (c)
   ``bench_mfu.run`` on TinyLlama cut to 11 of 22 layers at fsdp 2, 8 x 2048;
   (d) ring attention and
   the sequence-parallel loss at TinyLlama's width (2 layers, f32, T 2048 over
   2 ranks) against one rank's dense loss and gradients, one
   ``make_sp_train_step`` step and ``make_sp_tp_fsdp_loss_fn``; (e) (a) at
   one rank over NCCL, bit for bit against the run with no mesh;
20. the last of the JAX package, two ranks on the one card over gloo again:
   (a) GPipe (``parallel/pipeline.py``): easy-transformer-fastmax at full width
   and depth (16 layers, f32) as 2 stages of 8, batch 8 x 513, n_micro 2 and
   4, the loss (1e-4 relative) and every gradient (atol 3e-4, rtol 2e-3)
   against one rank's dense loss, K4/K5 exactly (M + P - 1) x 8 x (2, 1) a
   rank; (b) ``make_pp_train_step`` on TinyLlama-1.1B at full width and depth
   (bf16, random weights) as 2 stages of 11, batch 4 x 2049, n_micro 4, AdamW
   for 3 steps: a falling loss, step ms, a rank's parameter and optimizer
   bytes against the whole tree's, peak memory, K6/K7 exactly (M + P - 1) x
   11 x (2, 1) a step; (c) ``graft_entry.dryrun_multichip(4)`` over gloo
   (modes 1-4, 7 and 8 against the unsharded loss and tokens; K8 launched by
   the tp NF4 decode); (d) ``scaling_bench.run`` on pythia-160m at 1 and 2
   ranks; (e) ``graft_entry.entry()``'s forward: the logits' shape, finite.

It prints the kernels' JSON line, the card line and, last, the device JSON
line. Details go to ``chiprun_out/chip_smoke.json``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import io
import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): device memory rate, f32 rate outside the
# tensor cores, dense bf16 and TF32 tensor-core rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
BF16_TC_FLOPS_PER_S = 989e12
TF32_TC_FLOPS_PER_S = 494.7e12

# tolerances, stated before the run
INT4_ATOL, INT4_RTOL = 2e-4, 2e-3          # f32 x: the reference's own (test_quant_pallas.py)
INT4_BF16_RTOL = 2.0 ** -7                 # bf16 x: one bf16 ulp of the rounded output
ATTN_MAX_ABS = 2e-2                        # bf16 q: the reference's own (test_decode_attention.py)
ATTN_F32_MAX_ABS = 1e-4                    # f32 q: the port's CPU tests' (test_torch_decode_attention.py)
# K2 in bf16 is also held by its mean error over the mean |plain|. Each output averages
# hundreds to thousands of positions and |out| is small (~0.02), so the max gate above
# cannot see p * v_scale rounded to bf16 against the wrong normaliser: on the CPU, at
# phase 4's input law, batch 1 at pos 1023 and the serving shape at pos 3000, rounding it
# against each chunk's own max and sum and rescaling the partials (flash-decoding's usual
# form, another function than the reference's) moves the output by 9.8e-4 at most, far
# under 2e-2, and by 2.2e-3 and 2.3e-3 of its mean, 44 and 46 times this gate; the split
# done right (the row's max and sum before the rounding) by at most 1.9e-6 of the mean
# at phase 4's cases (tests/test_torch_decode_attention.py).
ATTN_BF16_MEAN = 5e-5
LOGITS_REL_TOL = 2e-2                      # full 7B forward, kernels vs plain, bf16 activations
FLASH_BF16_ATOL = 1e-2                     # a bf16 ulp (2^-7) of outputs up to 2, and a p rounding
# K3 in bf16 is also held by its mean error over the mean |plain|. At the long-context
# serving shapes each row averages thousands of keys and |out| is small (at most ~0.13,
# ~0.02 on average at T=512, pos0 3584), so the absolute gate above cannot see a wrong
# rounding of p: on the CPU, at phase 6's input law, p rounded against the max of each
# block's first 64 keys moves the output by 4.9e-4 at most (1.4e-3 of its mean), p
# truncated to bf16 by 4.9e-4 (3.8e-3 of the mean); both pass 1e-2. The sums taken in
# another order (float64, then rounded) move it by 7.3e-6 of the mean. Phase 9's gate
# lies between: 20-75 times below the faults, 7-20 times above a sound reordering. (On an
# H100 the tensor-core kernel's f32 sums, in the mma's order, give up to 1.7e-5.)
FLASH_BF16_MEAN = 5e-5
FLASH_F32_ATOL, FLASH_F32_RTOL = 2e-5, 1e-4  # the reference's own (test_flash_attention.py)
NEAR_TIE_REL = LOGITS_REL_TOL              # top-2 margin under this x max|logit|: a near-tie
N_SLOTS = 8
# fastmax K4/K5 against their plain walks. q and k are drawn with the standard
# deviation below, so that s = q.k / z (z = 8 sqrt(D)) has one of about 1 at
# p = 2 and the degree-2 terms s^2 / 2 weigh as much as the others (at std 0.5
# they would move the outputs by about 1e-5 of their size); p = 1 at std 1,
# where its normaliser, a sum of 1 + s, stays away from 0. v and the output
# cotangent have std 1. Each output is held by max|kernel - plain| / max|plain|:
# float32 1e-5 forward and 1e-4 gradients (dq sums terms far larger than
# itself, which cancel: on an H100 two f32 walks differ there by 1e-5 to 3e-5
# of the largest dq, and each lies as far from a float64 O(N^2) reference,
# which the checks report); bfloat16 the reference's (test_fastmax_pallas.py)
# 4e-2 forward and 6e-2 gradients. A walk of 16 chunks or more rewinds its
# state by subtracting 16 or more updates from the final one, and its f32 dq
# then lies up to 1.5e-4 of the largest from float64 by either route: its
# gradients are held at 1e-3. The
# degree-2 terms alone, o, dq, dk and dv at p = 2 minus p = 1 on the same
# inputs (q, k std 1), are held at 1e-3 of the plain difference's largest value.
FASTMAX_QK_STD = {2: 8.0 ** 0.5, 1: 1.0}
FASTMAX_F32_REL = {"fwd": 1e-5, "grad": 1e-4, "grad, 16 chunks": 1e-3}
FASTMAX_BF16_REL = {"fwd": 4e-2, "grad": 6e-2}
FASTMAX_PAIR_REL = 1e-3
# one training step, kernels against plain=True, f32, with the qkv weights
# scaled so that s has a standard deviation of about 1 (at the init std 0.02
# it is 0.025): the loss (relative) and each gradient leaf (of its largest entry)
TRAIN_LOSS_REL, TRAIN_GRAD_REL = 1e-6, 1e-4
TRAIN_STEPS = 20           # phase 8's pretraining steps (40 until the script neared its limit)
# the fork's linear arms at every head size (phases 8 and 9). Masked fastmax at
# D = 128 runs the reversible float32 scan (ops/fastmax.py; the reference has no
# Pallas kernel there, so neither has the port). Op check at the finetune shape
# (FT_SHAPE), q, k at FASTMAX_QK_STD[2] (s of std ~1), v and the cotangent std 1,
# against the same scan in float64 on the card and the forward also against the
# O(N^2) formula in float64, each by max|diff| / max|float64|: forward 1e-5;
# gradients the larger of phase 8's 1e-4 and twice the JAX package's own scan's
# float32 dq error from float64 at (1, 4, 2048, 128), chunk 256 (7.519e-05 on the
# CPU, `JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_linear_attention.py`;
# at (1, 8, 2048, 64) 6.076e-05): the rewind's cancellation belongs to the
# algorithm, the port's own float32 scan lay 1.016e-04 from float64 there.
JAX_SCAN_F32_GRAD_REL = 7.519e-05
LINEAR_F32_REL = {"fwd": 1e-5, "grad": max(FASTMAX_F32_REL["grad"], 2.0 * JAX_SCAN_F32_GRAD_REL)}
LINEAR_ARMS = ("fastmax", "linearmax", "performer")
LINEAR_FT_STEPS = 2        # QLoRA steps of each arm: the fewest that time a step after the first
# the arms' QLoRA model: Llama-2-7B at full width cut to 2 of its 32 layers, so that the
# script fits in its time limit (fastmax's two steps took 112.7 s at full depth and 34.0 s
# at 8 layers on one H100 at 700 W)
LINEAR_FT_LAYERS = 2
LINEAR_TRAIN_STEPS = 6     # pretraining steps of linearmax and performer (10 before phase 20)
# the random Llama-2-7B's layers (of 32) in phases 10, 13 (a), 14 (c)-(d), 17 (b)-(d) and 18
# (a)-(b): the script's time limit forces the cut (all 32 before phase 20). Phases 5 and 7 keep
# all 32: their bf16 gates (phase 5's decode step on each route's own first token, phase 7's
# first-token logits at 1.6e-02 of their 2e-02) hold at that depth and are not re-derived
LAYERS_7B = 8
FASTMAX_KERNELS = ("fastmax_fwd", "fastmax_bwd")

LLAMA7B_LINEARS = [("qkv", 4096, 12288), ("attn_proj", 4096, 4096),
                   ("fc_12", 4096, 22016), ("mlp_proj", 11008, 4096)]


def log(*a):
    print(*a, flush=True)


def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` eager calls, by CUDA events. Where the
    host issues work more slowly than the card runs it, this is host time."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls: int, reps: int = 3) -> float:
    """Device ms per call: ``calls`` calls captured in one CUDA graph and
    replayed ``reps`` times, timed by CUDA events (no host time inside)."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (reps * calls)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def bound(nbytes: int, flops: int, bf16: bool) -> dict:
    """Least time of a call: its bytes (each input read once, each output
    written once) over the memory rate, against its operations over the
    peak rate for its inputs' type (bf16: the tensor cores; f32: the f32
    units). ``bound_f32_ms`` takes the operations at the f32 rate, the rate
    the kernels that do not use the tensor cores compute at."""
    b_ms = nbytes / HBM_BYTES_PER_S * 1e3
    o_ms = flops / (BF16_TC_FLOPS_PER_S if bf16 else F32_FLOPS_PER_S) * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_ms": max(b_ms, o_ms),
            "bound_by": "bytes" if b_ms >= o_ms else "operations",
            "bound_f32_ms": max(b_ms, flops / F32_FLOPS_PER_S * 1e3)}


# ----------------------------------------------------------------- phase 3
INT4_CHECKED_M = (1, 5, N_SLOTS, 16, 64, 512)
INT4_TIMED_M = (1, N_SLOTS, 16, 32, 64)
# u, v of phase 3's 7B linears, and of its ragged case: k % 16 != 0, so the
# tensor-core kernel's last 16-row step runs past k into random words, and u,
# v in [0.5, 2] (tests/test_torch_quant_kernels.py's law), where x*u is of
# order 1 and the f32 gate's atol is as tight as f32 sums allow
INT4_7B_UV = ((0.005, 0.035), (0.5, 1.5))
INT4_RAGGED = ("ragged", 1540, 11000, ((0.5, 2.0), (0.5, 2.0)))


def int4_weights(torch, gen, k, n, tk=None, uv=INT4_7B_UV, layers: int = 3) -> dict:
    """Stacked q4r1 params of random words (every nibble a code, the rows
    k..k_pad too, so a kernel that lets them into the sum is seen), u and v
    uniform in the ranges ``uv``."""
    k_pad, n_pad = k + (-k) % 512, n + (-n) % 1024
    tk = tk or k_pad
    pw = torch.randint(-2**31 + 1, 2**31 - 1, (layers, k_pad // tk, n_pad // 1024, tk, 128),
                       generator=gen, device="cuda", dtype=torch.int32)
    (u0, u1), (v0, v1) = uv
    u = torch.rand((layers, k), generator=gen, device="cuda") * (u1 - u0) + u0
    v = torch.rand((layers, n), generator=gen, device="cuda") * (v1 - v0) + v0
    return {"q4r1": pw, "u4": u, "v4": v}


def int4_case(torch, gen, what, p, m) -> dict:
    """K1 on layer 2 of ``p`` against its plain version at m rows: f32 x
    through the stacked entry and (m <= 128) the per-layer one, held at
    INT4_ATOL + INT4_RTOL |plain|; bf16 x through the stacked entry, at
    INT4_ATOL + INT4_BF16_RTOL |plain|. Raises AssertionError naming K1."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    pw, u, v = p["q4r1"], p["u4"], p["v4"]
    k = u.shape[1]
    path = qk.int4_path(m, pw.shape[3])
    x = torch.randn((m, k), generator=gen, device="cuda")
    ref = qk.int4_matmul_rank1_plain(x, pw[2], u[2], v[2])
    checks = [("stacked", qk.int4_matmul_rank1_stacked(x, p, 2))]
    if m <= qk._INT4_MAX_M:
        checks.append(("per-layer", qk.int4_matmul_rank1(
            x, {"q4r1": pw[2], "u4": u[2], "v4": v[2]})))
    for entry, got in checks:
        err = (got - ref).abs()
        over = err > INT4_ATOL + INT4_RTOL * ref.abs()
        if bool(over.any()) or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"K1 int4 {what} m={m} ({path}) {entry}: max err "
                                 f"{float(err.max()):.3e}, {float(over.float().mean()):.3f} "
                                 "of the outputs over the gate")
    xb = x.to(torch.bfloat16)
    refb = qk.int4_matmul_rank1_plain(xb, pw[2], u[2], v[2])
    errb = (qk.int4_matmul_rank1_stacked(xb, p, 2).float() - refb).abs()
    if bool((errb > INT4_ATOL + INT4_BF16_RTOL * refb.abs()).any()):
        raise AssertionError(f"K1 int4 {what} m={m} ({path}) bf16: max err "
                             f"{float(errb.max()):.3e}")
    torch.cuda.synchronize()
    return {"path": path, "f32": max(float((got - ref).abs().max()) for _, got in checks),
            "bf16": float(errb.max())}


def int4_repeats(torch, gen, what, p, m=N_SLOTS, runs: int = 3) -> None:
    """K1 gives the same bits on every run (no float atomics), f32 and bf16 x."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    x = torch.randn((m, p["u4"].shape[1]), generator=gen, device="cuda")
    for xt in (x, x.to(torch.bfloat16)):
        first = qk.int4_matmul_rank1_stacked(xt, p, 2)
        for _ in range(runs - 1):
            if not torch.equal(qk.int4_matmul_rank1_stacked(xt, p, 2), first):
                raise AssertionError(f"K1 int4 {what} m={m} {xt.dtype}: a repeat differs")


def int4_times(torch, gen, name, k, n, ms) -> list:
    """Device time of K1 a call at one 7B linear in a CUDA graph, weights cold (rotating
    over enough layers to exceed the 50 MB L2), bf16 x, at each m of ``ms``; 4 < m <= 64
    also on the FMA tile kernel; beside an eager call, the plain version and the bound."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    k_pad, n_pad = k + (-k) % 512, n + (-n) % 1024
    layer_bytes = k_pad * n_pad // 2
    n_layers = max(2, math.ceil(160e6 / layer_bytes))
    pw = torch.randint(-2**31 + 1, 2**31 - 1, (n_layers, 1, n_pad // 1024, k_pad, 128),
                       generator=gen, device=dev, dtype=torch.int32)
    u = torch.full((n_layers, k), 0.02, device=dev)
    v = torch.ones((n_layers, n), device=dev)
    p = {"q4r1": pw, "u4": u, "v4": v}
    rows = []
    for m in ms:
        x = torch.randn((m, k), generator=gen, device=dev).to(torch.bfloat16)
        it = iter(range(10**9))

        def call(plain=False):
            return qk.int4_matmul_rank1_stacked(x, p, next(it) % n_layers, plain=plain)
        path = qk.int4_path(m, k_pad)
        kern_ms = graph_ms(call, calls=2 * n_layers)
        fma_ms = None
        if path == "tc":
            tc_max, qk.TC_MAX_M = qk.TC_MAX_M, qk.GEMV_MAX_M
            try:
                fma_ms = graph_ms(call, calls=2 * n_layers)
            finally:
                qk.TC_MAX_M = tc_max
        call_ms = time_ms(call, iters=2 * n_layers)
        plain_ms = graph_ms(lambda: call(plain=True), calls=n_layers, reps=1)
        nbytes = k * n_pad // 2 + m * k * 2 + k * 4 + n * 4 + m * n * 2
        rows.append({"shape": name, "k": k, "n": n, "m": m, "x_dtype": "bf16",
                     "path": path, "ms": kern_ms, "fma_ms": fma_ms, "call_ms": call_ms,
                     "plain_ms": plain_ms, **bound(nbytes, 2 * m * k * n, bf16=True)})
        fma = f"  FMA tile {fma_ms * 1e3:8.1f} us" if fma_ms is not None else ""
        log(f"  int4 {name:9s} m={m:3d} bf16: {path:4s} {kern_ms * 1e3:8.1f} us (eager call "
            f"{call_ms * 1e3:7.1f} us){fma}  plain {plain_ms * 1e3:8.1f} us  bound "
            f"{rows[-1]['bound_ms'] * 1e3:6.1f} us ({rows[-1]['bound_by']}; "
            f"{rows[-1]['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate)")
    del pw, u, v, p
    return rows


def check_int4(torch, gen, results):
    from fastmax_tpu_torch.ops import quant_kernels as qk

    dev = torch.device("cuda")
    worst = 0.0
    rows = []
    for name, k, n in LLAMA7B_LINEARS:
        k_pad, n_pad = k + (-k) % 512, n + (-n) % 1024
        p = int4_weights(torch, gen, k, n)
        for m in INT4_CHECKED_M:
            err = int4_case(torch, gen, name, p, m)
            worst = max(worst, err["f32"])
            log(f"  int4 {name:9s} k={k:5d} n={n:5d} m={m:3d} ({err['path']}): ok, max abs err "
                f"f32 {err['f32']:.3e} bf16 {err['bf16']:.3e}")
        int4_repeats(torch, gen, name, p)
        log(f"  int4 {name:9s} m={N_SLOTS}: 3 runs bit for bit, f32 and bf16")
        del p
        rows += int4_times(torch, gen, name, k, n, INT4_TIMED_M)
    card = card_line()
    for m in INT4_TIMED_M:
        layer = [r for r in rows if r["m"] == m]
        fma = (f", FMA tile {sum(r['fma_ms'] for r in layer) * 1e3:.1f} us"
               if layer[0]["fma_ms"] is not None else "")
        log(f"  int4 a layer's 4 linears, m={m:3d} bf16: {layer[0]['path']} "
            f"{sum(r['ms'] for r in layer) * 1e3:.1f} us{fma}, bound "
            f"{sum(r['bound_ms'] for r in layer) * 1e3:.1f} us   [{card}]")
    # several k tiles (gk = 8, tk = 512): the general word addressing; and the
    # ragged case
    name, k, n, uv = INT4_RAGGED
    for what, p, ms in (("gk=8 tk=512", int4_weights(torch, gen, 4096, 4096, tk=512),
                         (1, N_SLOTS, 64)),
                        (name, int4_weights(torch, gen, k, n, uv=uv), INT4_CHECKED_M)):
        for m in ms:
            err = int4_case(torch, gen, what, p, m)
            worst = max(worst, err["f32"])
            log(f"  int4 {what} k={p['u4'].shape[1]:5d} n={p['v4'].shape[1]:5d} m={m:3d} "
                f"({err['path']}): ok, max abs err f32 {err['f32']:.3e} bf16 {err['bf16']:.3e}")
        del p
    results["int4_times"] = rows
    results["int4_max_abs_err"] = worst
    return worst, rows


# ----------------------------------------------------------------- phase 4
def attn_inputs(torch, gen, n_layers, b, g, s, d):
    """A stacked int8 cache of random codes, scales uniform in [0.001, 0.02]."""
    kc = torch.randint(-127, 128, (n_layers, b, g, s, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    vc = torch.randint(-127, 128, (n_layers, b, g, s, d), generator=gen, device="cuda",
                       dtype=torch.int8)
    ks = torch.rand((n_layers, b, g, s), generator=gen, device="cuda") * 0.019 + 0.001
    vs = torch.rand((n_layers, b, g, s), generator=gen, device="cuda") * 0.019 + 0.001
    return kc, vc, ks, vs


def attn_held(torch, what, got, ref, qdt) -> tuple:
    """K2's max abs error and mean error over the mean |plain|; raises
    AssertionError naming K2 where a gate fails (bf16: ATTN_MAX_ABS and
    ATTN_BF16_MEAN; f32: ATTN_F32_MAX_ABS)."""
    err = (got.float() - ref.float()).abs()
    worst = float(err.max())
    mean = float(err.mean() / ref.float().abs().mean())
    if qdt == torch.bfloat16:
        bad = not (worst <= ATTN_MAX_ABS and mean <= ATTN_BF16_MEAN)
    else:
        bad = not worst <= ATTN_F32_MAX_ABS
    if bad or got.dtype != qdt or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K2 {what}: max abs err {worst:.3e}, mean err {mean:.3e} of the "
                             f"mean |plain| (gates: bf16 {ATTN_MAX_ABS}, {ATTN_BF16_MEAN}; f32 "
                             f"{ATTN_F32_MAX_ABS})")
    return worst, mean


def attn_split_route(da, b, hq, g, s, d) -> int:
    """The split route's nsplit at a shape: decode_splits' where it splits,
    else 64-position chunks."""
    nsplit = da.decode_splits(b * g, s, hq // g, d)
    return nsplit if nsplit > 1 else -(-s // 64)


def attn_case(torch, gen, b, hq, g, s, d, qdt, positions, routes=None) -> dict:
    """K2 at one shape against its plain version at each vector of slot
    positions, through the stacked (layer 2 of 3) and the per-layer entry, on
    each route (default: the one-block kernel, nsplit 1, and the split route).
    Raises AssertionError naming K2; returns the worst errors, over all and by
    route."""
    from fastmax_tpu_torch.ops import decode_attention as da

    kc, vc, ks, vs = attn_inputs(torch, gen, 3, b, g, s, d)
    q = torch.randn((b, hq, 1, d), generator=gen, device="cuda").to(qdt)
    routes = routes or (1, attn_split_route(da, b, hq, g, s, d))
    by_route = {split: (0.0, 0.0) for split in routes}
    for slots in positions:
        posv = torch.tensor(slots, dtype=torch.int32, device="cuda")
        ref = da.int8_decode_attention_plain(q, kc[2], vc[2], ks[2], vs[2], posv,
                                             scale=d ** -0.5)
        for split in routes:
            for entry, got in (
                    ("stacked", da.int8_decode_attention_stacked(
                        q, kc, vc, ks, vs, 2, posv, scale=d ** -0.5, split=split)),
                    ("per-layer", da.int8_decode_attention(
                        q, kc[2], vc[2], ks[2], vs[2], posv, scale=d ** -0.5, split=split))):
                w, m = attn_held(torch, f"B={b} Hq={hq} G={g} S={s} D={d} {str(qdt)[6:]} "
                                 f"pos={slots} nsplit={split} {entry}", got, ref, qdt)
                by_route[split] = (max(by_route[split][0], w), max(by_route[split][1], m))
    torch.cuda.synchronize()
    return {"max_abs_err": max(w for w, _ in by_route.values()),
            "mean_err": max(m for _, m in by_route.values()), "by_route": by_route}


def attn_cases(torch, da) -> list:
    """Phase 4's cases: (B, Hq, G, S, D, q dtype, vectors of slot positions)."""
    bf, f32 = torch.bfloat16, torch.float32
    c1 = da.split_chunk(1024, attn_split_route(da, 1, 32, 32, 1024, 128))  # 7B batch 1
    c64 = da.split_chunk(512, attn_split_route(da, 1, 32, 32, 512, 64))
    cs = da.split_chunk(4096, attn_split_route(da, N_SLOTS, 32, 32, 4096, 128))  # serving
    return [
        # the cases before the split (a second slot 3 positions back)
        (1, 32, 32, 1024, 128, bf, [(0,), (63,), (1023,)]),
        (2, 8, 2, 1024, 128, bf, [(5, 2), (700, 697)]),
        (1, 32, 32, 512, 64, bf, [(0,), (200,), (511,)]),
        (1, 32, 32, 1024, 128, f32, [(63,), (1023,)]),
        # the split's chunk edges: the last position of a chunk, the first of the next
        (1, 32, 32, 1024, 128, bf, [(c1 - 1,), (c1,), (2 * c1,), (1023,)]),
        (1, 32, 32, 1024, 128, f32, [(c1 - 1,), (c1,), (1023,)]),
        (1, 32, 32, 512, 64, bf, [(c64 - 1,), (c64,)]),
        # slots in different chunks, one at pos 0; R = 4 (GQA)
        (4, 32, 32, 1024, 128, bf, [(0, c1 - 1, c1 + 5, 1023)]),
        (2, 32, 8, 1024, 128, bf, [(1023, 300), (c1, 0)]),
        # the serving shape at the phase 7 profile's positions, and mixed
        (N_SLOTS, 32, 32, 4096, 128, bf,
         [(3000,) * N_SLOTS, (0, cs - 1, cs, 1000, 2047, 3000, 4000, 4095)]),
    ]


def attn_repeats(torch, gen, runs: int = 3) -> None:
    """K2 gives the same bits on every run at the serving shape, on both routes
    (no float atomics; the split sums its chunks in a fixed order)."""
    from fastmax_tpu_torch.ops import decode_attention as da

    kc, vc, ks, vs = attn_inputs(torch, gen, 1, N_SLOTS, 32, 4096, 128)
    q = torch.randn((N_SLOTS, 32, 1, 128), generator=gen, device="cuda").to(torch.bfloat16)
    posv = torch.tensor((0, 255, 256, 1000, 2047, 3000, 4000, 4095), dtype=torch.int32,
                        device="cuda")
    for split in (1, attn_split_route(da, N_SLOTS, 32, 32, 4096, 128)):
        first = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, posv,
                                                 scale=128 ** -0.5, split=split)
        for _ in range(runs - 1):
            again = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, 0, posv,
                                                     scale=128 ** -0.5, split=split)
            if not torch.equal(again, first):
                raise AssertionError(f"K2 nsplit={split}: a repeat differs")


# K2's timed shapes: (label, slots, S, pos, layers rotated so that the cache is cold:
# 16 x 8.4 MB at batch 1, 2 x 268 MB at the serving shape)
ATTN_TIMED = (("batch 1", 1, 1024, 191, 16), ("batch 1", 1, 1024, 1023, 16),
              ("serving", N_SLOTS, 4096, 3000, 2))


def attn_bound(b, hq, g, d, pos, bf16: bool = True) -> dict:
    """K2's least time: each slot reads its int8 K and V codes and their f32
    scales at pos + 1 positions, q and pos, and writes its output; two products
    of 2 operations a code."""
    n = pos + 1
    return bound(b * (g * n * (2 * d + 2 * 4) + 2 * hq * d * (2 if bf16 else 4) + 4),
                 4 * b * hq * n * d, bf16=bf16)


def attn_times(torch, gen, card, rounds: int = 2) -> list:
    """Device time a call of K2 in a CUDA graph, cache cold, at ATTN_TIMED's
    shapes (bf16 q, Hq = G = 32, D = 128), the one-block kernel and the split
    route in turns (A B B A); the eager call and the plain version once."""
    from fastmax_tpu_torch.ops import decode_attention as da

    rows = []
    for label, b, s, pos, n_layers in ATTN_TIMED:
        kc, vc, ks, vs = attn_inputs(torch, gen, n_layers, b, 32, s, 128)
        q = torch.randn((b, 32, 1, 128), generator=gen, device="cuda").to(torch.bfloat16)
        posv = torch.full((b,), pos, dtype=torch.int32, device="cuda")
        it = iter(range(10**9))

        def call(split=None, plain=False):
            return da.int8_decode_attention_stacked(q, kc, vc, ks, vs, next(it) % n_layers, posv,
                                                    scale=128 ** -0.5, split=split, plain=plain)
        chosen = da.decode_splits(b * 32, s, 1, 128)
        routes = (1, chosen)
        runs = {split: [] for split in routes}
        for rnd in range(rounds):
            for split in (routes if rnd % 2 == 0 else routes[::-1]):
                runs[split].append(graph_ms(lambda: call(split), calls=2 * n_layers))
        call_ms = time_ms(call, iters=2 * n_layers)
        plain_ms = graph_ms(lambda: call(plain=True), calls=n_layers, reps=1)
        bnd = attn_bound(b, 32, 32, 128, pos)
        for split in routes:
            ms = sum(runs[split]) / len(runs[split])
            rows.append({"shape": label, "b": b, "s": s, "pos": pos,
                         "route": "one-block" if split == 1 else "split", "nsplit": split,
                         "chunk": s if split == 1 else da.split_chunk(s, split), "ms": ms,
                         "ms_runs": runs[split], "plain_ms": plain_ms,
                         "call_ms": call_ms if split == chosen else None, **bnd})
            log(f"  attn {label} B={b} S={s} pos={pos:4d} {rows[-1]['route']:9s} nsplit={split:2d}"
                f" (chunk {rows[-1]['chunk']:4d}): {ms * 1e3:7.2f} us ("
                f"{', '.join(f'{m * 1e3:.2f}' for m in runs[split])})  plain {plain_ms * 1e3:7.1f}"
                f" us  bound {bnd['bound_ms'] * 1e3:5.2f} us ({bnd['bound_by']}), "
                f"{bnd['bound_ms'] / ms:.3f} of it   [{card}]")
        log(f"  attn {label} pos={pos}: eager call on the chosen route {call_ms * 1e3:.1f} us")
        del kc, vc, ks, vs
    return rows


def check_attention(torch, gen, results):
    from fastmax_tpu_torch.ops import decode_attention as da

    worst = mean = 0.0
    for b, hq, g, s, d, qdt, positions in attn_cases(torch, da):
        err = attn_case(torch, gen, b, hq, g, s, d, qdt, positions)
        worst, mean = max(worst, err["max_abs_err"]), max(mean, err["mean_err"])
        errs = "; ".join(f"nsplit {split}: max abs err {w:.3e}, mean err {m:.3e}"
                         for split, (w, m) in err["by_route"].items())
        log(f"  attn B={b} Hq={hq:2d} G={g:2d} S={s:4d} D={d:3d} {str(qdt)[6:]:8s} "
            f"positions {positions}: ok, both entries ({errs} of the mean |plain|)")
    attn_repeats(torch, gen)
    log("  attn serving shape, mixed positions: 3 runs bit for bit on both routes")
    rows = attn_times(torch, gen, card_line())
    results["attn_times"] = rows
    results["attn_max_abs_err"] = worst
    results["attn_mean_err"] = mean
    return worst, mean, rows


# ----------------------------------------------------------------- phase 5
KERNEL_GROUPS = (("K1 int4_rank1_matmul", ("int4_gemv_kernel", "int4_rank1_tc_kernel",
                                             "int4_gemm_kernel", "int4_splitk_reduce_kernel")),
                 ("K2 int8_decode_attention", ("int8_decode_attention_kernel",
                                               "int8_decode_split_scores_kernel",
                                               "int8_decode_split_values_kernel",
                                               "int8_decode_split_combine_kernel")),
                 ("K3 flash_attention", ("flash_attention_kernel", "flash_attention_tc_kernel")),
                 ("K4 fastmax_fwd", ("fastmax_fwd_kernel", "fastmax_fwd_tc_kernel",
                                     "fastmax_fwd_finish")),
                 ("K5 fastmax_bwd", ("fastmax_bwd_kernel", "fastmax_bwd_tc_kernel",
                                     "fastmax_bwd_finish")),
                 ("K6 flash_train_fwd", ("flash_train_fwd_kernel",
                                         "flash_train_fwd_tc_kernel")),
                 ("K7 flash_train_bwd", ("flash_train_bwd_kernel",
                                         "flash_train_bwd_tc_kernel",
                                         "flash_train_bwd_tc_pair_kernel")),
                 ("K8 nf4_matmul", ("nf4_gemv_kernel", "nf4_tc_kernel", "nf4_gemm_kernel",
                                    "nf4_splitk_reduce_kernel")),
                 ("K9 int4_block_matmul", ("int4_block_gemv_kernel", "int4_block_tc_kernel",
                                           "int4_block_gemm_kernel", "int4_block_reduce_kernel")),
                 ("K11 q4_byte_matmul", ("q4_byte_kernel", "q4_byte_tc_kernel",
                                         "q4_byte_reduce_kernel")),
                 ("K12 int4_colnibble_matmul", ("colnibble_kernel", "colnibble_tc_kernel",
                                                "colnibble_reduce_kernel")),
                 ("gemm (cuBLAS)", ("gemm", "cutlass", "nvjet", "xmma")))


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        if end > reach:
            total += end - max(start, reach)
            reach = end
    return total


def profile_device(torch, fn, label, per: int = 1, cpu: bool = True) -> dict:
    """Device time of ``fn`` by kernel group (torch.profiler), per ``per``
    (steps or tokens), with the top kernels and the aten calls issued
    (``cpu=False`` records the device's activity alone, no aten calls). A
    group's time, and the total, is the time some kernel of it ran: the union
    of their intervals, since K2's second and third launches are programmatic
    dependents that start, and wait, while the launch before them runs (summed
    durations would count that time twice). The top kernels' times are summed
    durations. The profiler's raw events are read, not its parsed ones: a
    fastmax finetune micro-batch issues ~400 000 kernels, whose parse took
    minutes."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = {name: [] for name, _ in KERNEL_GROUPS}
    spans["other"] = []
    group_of = {}  # a kernel's group by its name
    kernels = {}   # name -> [launches, summed us]
    aten = 0
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        if ev.device_type() != torch.autograd.DeviceType.CUDA:
            aten += name.startswith("aten::")
            continue
        if ev.duration_ns() <= 0:
            continue
        if name not in group_of:
            group_of[name] = next((g for g, keys in KERNEL_GROUPS
                                   if any(k in name.lower() for k in keys)), "other")
        start = ev.start_ns() / 1e3
        spans[group_of[name]].append((start, start + ev.duration_ns() / 1e3))
        row = kernels.setdefault(name[:90], [0, 0.0])
        row[0] += 1
        row[1] += ev.duration_ns() / 1e3
    groups = {name: union_us(s) / per for name, s in spans.items()}
    total = union_us([iv for s in spans.values() for iv in s]) / per
    if total <= 0:
        log(f"  profile of {label}: the profiler recorded no device time (not measured)")
        return {"device_us": None}
    aten = aten / per if cpu else None
    by_group = ", ".join(f"{k} {v:.1f}" for k, v in groups.items())
    log(f"  profile of {label}: device {total:.1f} us ({by_group}); aten calls (nested ones "
        f"included) {'not recorded' if aten is None else f'{aten:.0f}'}")
    top = sorted(((us / per, name, n / per) for name, (n, us) in kernels.items()),
                 reverse=True)[:8]
    for dev_us, name, count in top:
        log(f"    {dev_us:10.1f} us  x{count:7.1f}  {name}")
    return {"device_us": total, "by_group_us": groups, "aten_calls": aten,
            "kernel_launches": sum(n for n, _ in kernels.values()) / per,
            "top": [{"us": d, "name": n, "calls": c} for d, n, c in top],
            "names": sorted(kernels)}


def profile_decode(torch, engine, first, tok_s, steps: int = 8) -> dict:
    """Device time per token of ``steps`` decode steps, and the device's busy
    share at the unprofiled decode rate ``tok_s``."""
    cache = engine.new_cache()
    _, cache = engine.prefill(torch.zeros((1, 64), dtype=torch.int32, device="cuda"), cache)
    prof = profile_device(torch, lambda: engine.decode(cache, first, 64, steps + 1),
                          f"{steps} decode steps, per token", per=steps)
    if prof["device_us"]:
        prof["busy_share"] = prof["device_us"] * 1e-6 * tok_s
        log(f"  device busy share at {tok_s:.2f} tok/s: {prof['busy_share']:.4f}")
    return prof


def main_path(torch, results, card):
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4
    from fastmax_tpu_torch.ops.sampling import sample

    cfg = Config.from_name("Llama-2-7b-hf")
    cfg.block_size = 1024
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = build_fake_7b_int4(cfg, seed=0)
    torch.cuda.synchronize()
    log(f"  model build (on device): {time.perf_counter() - t0:.2f} s")
    engine = InferenceEngine(cfg, params, max_seq_length=1024, batch_size=1,
                             weights_mode="quantized", cache_dtype=torch.int8)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(1, 32000, 64), dtype=torch.int32)
    n_new = 256

    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = engine.generate(prompt, 64 + n_new, temperature=0.0)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    counts = build.launch_counts()
    log(f"  generate(64 + {n_new}): {gen_s:.3f} s, launches {counts}")
    if tuple(out.shape) != (1, 64 + n_new):
        raise AssertionError(f"generate returned shape {tuple(out.shape)}")
    if counts["int4_rank1_matmul"] <= 0 or counts["int8_decode_attention"] <= 0:
        raise AssertionError(f"a kernel of the batch-1 path was never launched: {counts}")
    first16 = out[0, 64:80].tolist()
    log(f"  first 16 generated tokens: {first16}")

    # TTFT: prefill of the 64-token prompt + first token, warm, best of 3
    ttft = []
    for _ in range(3):
        cache = engine.new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompt[None].cuda(), cache)
        first = sample(logits)
        first.cpu()
        ttft.append((time.perf_counter() - t0) * 1e3)
    # decode rate: 256 tokens after that prefill
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gen, _ = engine.decode(cache, first, 64, n_new)
    gen.cpu()
    dec_s = time.perf_counter() - t0
    tok_s = (gen.shape[1] - 1) / dec_s
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  TTFT (64-token prompt, warm, best of 3): {min(ttft):.2f} ms   [{card}]")
    log(f"  decode: {gen.shape[1] - 1} tokens in {dec_s:.3f} s = {tok_s:.2f} tok/s   [{card}]")
    log(f"  peak device memory: {peak_gb:.3f} GB   [{card}]")
    profile = profile_decode(torch, engine, first, tok_s)

    # kernels vs plain versions through the full 32-layer forward
    cmp = {}
    for plain in (False, True):
        cache = engine.new_cache()
        logits, cache = engine.prefill(prompt[None].cuda(), cache, plain=plain)
        tok = sample(logits)
        with torch.inference_mode():
            step, _ = engine._forward(tok[:, None], cache, 64, plain=plain)
        cmp[plain] = (logits.float(), step[:, -1].float(), tok)
    rel = {}
    for i, name in ((0, "prefill"), (1, "decode_step")):
        a, b = cmp[False][i], cmp[True][i]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"non-finite {name} logits")
        rel[name] = float((a - b).abs().max() / b.abs().max())
    log(f"  logits kernels vs plain, max|diff|/max|plain|: prefill {rel['prefill']:.3e}, "
        f"decode step {rel['decode_step']:.3e} (tolerance {LOGITS_REL_TOL})")
    if max(rel.values()) > LOGITS_REL_TOL:
        raise AssertionError(f"logits differ beyond {LOGITS_REL_TOL}: {rel}")
    results["main_path"] = {
        "model": "Llama-2-7b-hf (random weights, seed 0), q4r1 int4, int8 KV cache",
        "prompt_tokens": 64, "new_tokens": n_new, "generate_s": gen_s,
        "ttft_ms": min(ttft), "ttft_ms_all": ttft, "decode_tok_s": tok_s,
        "peak_gb": peak_gb, "launches": counts, "first16": first16, "profile": profile,
        "logits_rel_diff": rel, "logits_rel_tol": LOGITS_REL_TOL,
        "first_token_kernels_vs_plain": [int(cmp[False][2][0]), int(cmp[True][2][0])],
        "card": card}
    return counts


# ----------------------------------------------------------------- phase 6
def flash_bound(b, hq, g, t, d, pos0, kv_len, bf16: bool) -> dict:
    """Least time for one call: bytes (q, the k/v rows below kv_len, out,
    each once) against the operations (4*D flops per visible (row, key)
    pair)."""
    visible = sum(min(pos0 + i + 1, kv_len) for i in range(t))
    nbytes = (2 if bf16 else 4) * (2 * b * hq * t * d + 2 * b * g * kv_len * d)
    return bound(nbytes, 4 * b * hq * d * visible, bf16)


def sdpa_backend(torch, q, k, v, mask, scale, is_causal: bool = False) -> str:
    """Name of the backend scaled_dot_product_attention picks for these inputs."""
    from torch.nn.attention import SDPBackend

    names = {int(val): name for name, val in SDPBackend.__members__.items()}
    try:  # a private function: the name is a label, not a result, so a miss is reported
        choice = torch._fused_sdp_choice(q, k, v, mask, 0.0, is_causal, scale=scale)
    except (AttributeError, RuntimeError, TypeError) as e:
        return f"not determined ({type(e).__name__})"
    return names.get(int(choice), str(choice))


def flash_case(torch, gen, b, hq, g, s, d, dtype, t, pos0, kv_len=None) -> dict:
    """K3 against its plain version on one random input (q, k, v ~ N(0, 1)), T rows at pos0
    over kv_len keys (default pos0 + T; below it, the last rows lose keys under their causal
    frontier, and below pos0 every row does). float32: each element within FLASH_F32_ATOL +
    FLASH_F32_RTOL |plain|; bfloat16: within FLASH_BF16_ATOL, and the mean error within
    FLASH_BF16_MEAN of the mean |plain|. Raises AssertionError naming the case; returns
    the case, its max abs error and its mean error of the mean."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    q = torch.randn((b, hq, t, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, g, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, g, s, d), generator=gen, device=dev).to(dtype)
    kv_len = pos0 + t if kv_len is None else kv_len
    got = fa.flash_attention(q, k, v, pos0=pos0, kv_len=kv_len)
    ref = fa.flash_attention_plain(q, k, v, pos0=pos0, kv_len=kv_len)
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs()
    max_abs = float(err.max())
    mean = float(err.mean()) / max(float(ref.float().abs().mean()), 1e-30)
    if dtype == torch.bfloat16:
        bad = not (max_abs <= FLASH_BF16_ATOL and mean <= FLASH_BF16_MEAN)
    else:
        bad = bool((err > FLASH_F32_ATOL + FLASH_F32_RTOL * ref.float().abs()).any())
    tag = (f"flash B={b} Hq={hq} G={g} S={s} D={d} T={t} pos0={pos0}"
           + ("" if kv_len == pos0 + t else f" kv_len={kv_len}") + f" {str(dtype)[6:]}")
    if bad or got.dtype != dtype or got.shape != ref.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"K3 {tag}: max abs err {max_abs:.3e}, mean err {mean:.3e} of the "
                             f"mean (bf16 gates {FLASH_BF16_ATOL}, {FLASH_BF16_MEAN})")
    return {"case": tag, "max_abs_err": max_abs, "mean_err": mean}


def flash_repeats(torch, gen, t=512, pos0=3584, runs: int = 3) -> None:
    """K3 gives the same bits on every call at a 7B shape (no atomics); raises otherwise."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
               for shape in ((1, 32, t, 128), (1, 32, 4096, 128), (1, 32, 4096, 128)))
    outs = [fa.flash_attention(q, k, v, pos0=pos0, kv_len=pos0 + t) for _ in range(runs)]
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(f"K3 differs between two calls on the same inputs (T={t} "
                             f"pos0={pos0} bf16)")


# K3 with kv_len < pos0 + T, (B, Hq, G, S, D, dtype, T, pos0, kv_len): a 7B chunk whose
# last 212 rows lose keys, GQA at D = 64 cut mid-chunk and below pos0, and f32
FLASH_KV_CUT = ((1, 32, 32, 4096, 128, "bfloat16", 512, 1536, 1836),
                (2, 8, 2, 4096, 64, "bfloat16", 300, 1000, 1100),
                (2, 8, 2, 4096, 64, "bfloat16", 300, 1000, 900),
                (1, 32, 32, 4096, 128, "float32", 512, 3584, 3900))


# (T, pos0) of the timed 7B bf16 calls: 512-row chunks, a whole 2048-token prompt, a
# 1024-token suffix after a cached 2048-token prefix
FLASH_TIMED = ((512, 0), (512, 1536), (512, 3584), (2048, 0), (1024, 2048))


def flash_times(torch, gen, shapes, n_sets: int = 4, heads: int = 32, label: str = "7B") -> list:
    """Device time of K3 a call in a CUDA graph, k/v cold (n_sets layers' k/v: 256 MB at
    D = 128 in bf16), at B=1 Hq=G=``heads`` S=4096, for each (dtype, D, T, pos0) of
    ``shapes``, beside its plain version, one scaled_dot_product_attention call and the
    bound."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    rows = []
    for dt, d, t, pos0 in shapes:
        kv = [tuple(torch.randn((1, heads, 4096, d), generator=gen, device=dev).to(dt)
                    for _ in range(2)) for _ in range(n_sets)]
        q = torch.randn((1, heads, t, d), generator=gen, device=dev).to(dt)
        kv_len = pos0 + t
        it = iter(range(10**9))

        def call(plain=False):
            k, v = kv[next(it) % n_sets]
            return fa.flash_attention(q, k, v, pos0=pos0, kv_len=kv_len, plain=plain)

        kern_ms = graph_ms(call, calls=2 * n_sets)
        plain_ms = graph_ms(lambda: call(plain=True), calls=n_sets, reps=1)
        keys = torch.arange(4096, device=dev)[None, :]
        mask = (keys <= pos0 + torch.arange(t, device=dev)[:, None]) & (keys < kv_len)
        backend = sdpa_backend(torch, q, kv[0][0], kv[0][1], mask, d ** -0.5)

        def library():
            k, v = kv[next(it) % n_sets]
            return torch.nn.functional.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                                    scale=d ** -0.5)

        lib_ms = graph_ms(library, calls=2 * n_sets)
        bnd = flash_bound(1, heads, heads, t, d, pos0, kv_len, bf16=dt == torch.bfloat16)
        rows.append({"dtype": str(dt)[6:], "heads": heads, "d": d, "pos0": pos0, "t": t,
                     "kv_len": kv_len,
                     "ms": kern_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                     "library_backend": backend, **bnd})
        log(f"  flash {label} {str(dt)[6:]:8s} D={d} T={t:4d} pos0={pos0:4d}: kernel "
            f"{kern_ms * 1e3:8.1f} us ({bnd['flops'] / (kern_ms * 1e-3) / 1e12:.1f} TFLOP/s, "
            f"{bnd['bound_ms'] / kern_ms:.3f} of the bound)  plain {plain_ms * 1e3:8.1f} us  "
            f"SDPA ({backend}) {lib_ms * 1e3:8.1f} us  bound {bnd['bound_ms'] * 1e3:6.1f} us "
            f"({bnd['bound_by']}; {bnd['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate)")
        del kv, q, mask
    return rows


def check_flash(torch, gen, results):
    bf16, f32 = torch.bfloat16, torch.float32
    worst = {bf16: 0.0, f32: 0.0}
    worst_mean = 0.0
    # (B, Hq, G, S, D, dtype, T, pos0s): the 7B shapes serving launches K3 at
    # (512-row chunks, a whole bucketed prompt, a suffix after a cached
    # 2048-token prefix, a batched wave of 8), GQA with ragged T, the head
    # sizes 192 and 256, and f32
    cases = [(1, 32, 32, 4096, 128, bf16, 512, (0, 1536, 3584)),
             (1, 32, 32, 4096, 128, bf16, 2048, (0,)),
             (1, 32, 32, 4096, 128, bf16, 1024, (2048,)),
             (8, 32, 32, 4096, 128, bf16, 1024, (0,)),
             (2, 8, 2, 4096, 64, bf16, 300, (0, 1000)),
             (1, 8, 4, 4096, 192, bf16, 256, (0, 2048)),
             (1, 8, 8, 4096, 256, bf16, 130, (100,)),
             (1, 32, 32, 4096, 128, f32, 512, (0, 3584))]
    checks = []
    for b, hq, g, s, d, dt, t, positions in cases:
        for pos0 in positions:
            c = flash_case(torch, gen, b, hq, g, s, d, dt, t, pos0)
            checks.append(c)
            worst[dt] = max(worst[dt], c["max_abs_err"])
            if dt == bf16:
                worst_mean = max(worst_mean, c["mean_err"])
            log(f"  {c['case']}: ok, max abs err {c['max_abs_err']:.3e}, mean err "
                f"{c['mean_err']:.2e} of the mean")
    # kv_len < pos0 + T: the last rows' keys cut below their causal frontier (the
    # tensor-core kernel at D = 64 and 128, and the f32 path), and kv_len < pos0 (every row)
    for b, hq, g, s_, d, dt_name, t, pos0, kv_len in FLASH_KV_CUT:
        dt = getattr(torch, dt_name)
        c = flash_case(torch, gen, b, hq, g, s_, d, dt, t, pos0, kv_len)
        checks.append(c)
        worst[dt] = max(worst[dt], c["max_abs_err"])
        if dt == bf16:
            worst_mean = max(worst_mean, c["mean_err"])
        log(f"  {c['case']}: ok, max abs err {c['max_abs_err']:.3e}, mean err "
            f"{c['mean_err']:.2e} of the mean")
    flash_repeats(torch, gen)
    log("  flash B=1 Hq=32 T=512 pos0=3584 bf16: equal bit for bit over 3 calls")
    results["flash_checks"] = {"cases": checks, "repeat_bitwise": True}
    rows = flash_times(torch, gen, [(bf16, 128, t, pos0) for t, pos0 in FLASH_TIMED])
    # the FMA kernel's paths at the longest-context chunk: f32, and bf16 at D = 256
    results["flash_fma_times"] = flash_times(torch, gen, [(f32, 128, 512, 3584),
                                                          (bf16, 256, 512, 3584)])
    results["flash_times"] = rows
    results["flash_max_abs_err"] = {str(k)[6:]: v for k, v in worst.items()}
    results["flash_mean_err"] = worst_mean
    return worst[bf16], worst_mean, rows


# ----------------------------------------------------------------- phase 7
class ByteTokenizer:
    """Stand-in tokenizer: UTF-8 bytes as ids 3..258 (Llama's byte-fallback
    ids); other ids decode as ``<id>``."""

    eos_id = None

    def encode(self, text):
        return [c + 3 for c in text.encode()]

    def decode(self, ids):
        out = bytearray()
        for i in (int(i) for i in ids):
            out += bytes([i - 3]) if 3 <= i < 259 else f"<{i}>".encode()
        return out.decode(errors="replace")


def http_requests(server, prompts, n_new):
    """8 requests from 4 client threads, two each: six greedy, two sampled
    (temperature 0.8, top-k 40), request 0 as text and request 1 streamed."""
    import threading
    import urllib.request

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{server.port}/v1/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=600)

    out = [None] * len(prompts)
    errors = []

    def one(i):
        body = {"prompt": prompts[i], "max_new_tokens": n_new}
        if i in (3, 6):
            body.update(temperature=0.8, top_k=40)
        t0 = time.perf_counter()
        if i == 1:
            body["stream"] = True
            tokens, first = [], None
            with post(body) as conn:
                for raw in conn:
                    line = raw.decode().strip()
                    if not line.startswith("data: ") or line == "data: [DONE]":
                        continue
                    first = first or time.perf_counter()
                    tokens += json.loads(line[6:])["token_ids"]
            out[i] = {"tokens": tokens, "finish_reason": "length", "stream": True,
                      "ttft_s": first - t0}
        else:
            with post(body) as conn:
                out[i] = json.load(conn)
        out[i]["wall_s"] = time.perf_counter() - t0

    def worker(w):
        try:
            for i in (w, w + 4):
                one(i)
        except Exception as e:  # noqa: BLE001 - reported and failed below
            errors.append(f"client {w}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=900)
    if errors or any(th.is_alive() for th in threads):
        raise AssertionError(f"HTTP clients failed: {errors or 'timed out'}")
    return out


def first_divergence(torch, engine, prompt, a, b):
    """Index of the first differing token of two greedy runs, and the
    engine's top-2 margin and max |logit| there (None if equal)."""
    diff = [i for i, (x, y) in enumerate(zip(a, b)) if x != y]
    if not diff:
        return None
    i = diff[0]
    seq = torch.as_tensor(list(prompt) + list(a[:i]), dtype=torch.int32, device="cuda")[None]
    logits, _ = engine.prefill(seq, engine.new_cache())
    top2 = torch.topk(logits[0].float(), 2).values
    return i, float(top2[0] - top2[1]), float(logits[0].float().abs().max())


def fresh_row(torch, batcher) -> dict:
    """An empty one-slot cache row, as the batcher prefills into."""
    return {k: torch.zeros_like(v[:, :1]) for k, v in batcher.cache.items()}


def batcher_prefill(torch, gpt, batcher, seq, p0: int, row: dict, plain: bool):
    """The batcher's admission prefill of ``seq`` (1, t) from position p0
    (the rows before it already in ``row``): the suffix padded to its
    128-token bucket, one forward; the logits (1, V) at the last real token."""
    t = seq.shape[1]
    bucket = batcher._bucket(t - p0, batcher.max_seq_length - p0)
    tokens = torch.zeros((1, bucket), dtype=torch.int32, device=batcher.device)
    tokens[:, :t - p0] = seq[:, p0:]
    logits, _ = gpt.forward(batcher.params, batcher.cfg, tokens, input_pos=p0, kv_cache=row,
                            rope_cache=batcher.rope, plain=plain)
    return logits[:, t - p0 - 1]


SERVING_KERNELS = ("int4_rank1_matmul", "int8_decode_attention", "flash_attention")


def serving_path(torch, results, card):
    import numpy as np

    from fastmax_tpu_torch.inference.bench_serving import run_load
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.inference.server import Server
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4
    from fastmax_tpu_torch.ops import quant_kernels as qk

    cfg = Config.from_name("Llama-2-7b-hf")
    cfg.block_size = 4096
    n_new = 64
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = build_fake_7b_int4(cfg, seed=0)
    batcher = ContinuousBatcher(cfg, params, n_slots=N_SLOTS, max_seq_length=4096,
                                weights_mode="quantized", cache_dtype=torch.int8,
                                decode_quantum=8, adaptive_quantum=True, prefix_cache_size=4)
    rng = np.random.default_rng(0)
    lengths = rng.integers(256, 3073, 8)
    prompts = [rng.integers(1, 32000, n).tolist() for n in lengths]
    prompts[0] = "".join(chr(c) for c in rng.integers(32, 127, lengths[0]))  # a text prompt
    load_prompts = [rng.integers(1, 32000, n).astype(np.int32)
                    for n in rng.integers(256, 3073, 16)]
    shared = rng.integers(1, 32000, 2048).astype(np.int32)
    prefix_prompts = [np.concatenate([shared, rng.integers(1, 32000, n).astype(np.int32)])
                      for n in rng.integers(64, 1025, 16)]
    # one 128-token bucket (897-1024 tokens: padded to 1024), so the 8 are
    # admitted as one batched wave into the 8 free slots
    wave_prompts = [rng.integers(1, 32000, n).astype(np.int32)
                    for n in rng.integers(897, 1025, N_SLOTS)]
    check_seq = torch.as_tensor(rng.integers(1, 32000, 4096), device="cuda")[None]
    log(f"  prompt lengths: HTTP {lengths.tolist()}, load {[len(p) for p in load_prompts]}, "
        f"prefix load 2048 + {[len(p) - 2048 for p in prefix_prompts]}, wave "
        f"{[len(p) for p in wave_prompts]}")
    # warm-up (cuBLAS handles, first launches) outside the counted run
    w = batcher.submit(np.arange(1, 300, dtype=np.int32), 9, return_request=True)
    while not w.done:
        batcher.step()
    torch.cuda.synchronize()

    build.reset_launch_counts()
    t0 = time.perf_counter()
    server = Server(batcher, ByteTokenizer(), port=0, model_name=cfg.name).start()
    try:
        answers = http_requests(server, prompts, n_new)
    finally:
        server.stop()
    http_s = time.perf_counter() - t0
    for i, a in enumerate(answers):
        toks = a["tokens"]
        if len(toks) != n_new or not all(0 <= x < cfg.padded_vocab_size for x in toks):
            raise AssertionError(f"HTTP request {i}: {len(toks)} tokens, {toks[:8]}...")
    log(f"  HTTP: 8 requests from 4 clients answered in {http_s:.2f} s; walls "
        f"{[round(a['wall_s'], 2) for a in answers]} s; request 1 streamed, first event after "
        f"{answers[1]['ttft_s'] * 1e3:.1f} ms")
    load = run_load(batcher, load_prompts, n_new)
    log(f"  run_load closed loop, 16 requests: {load}   [{card}]")
    t1 = time.perf_counter()
    batcher.register_prefix(shared)
    torch.cuda.synchronize()
    register_s = time.perf_counter() - t1
    hits0 = batcher.prefix_cache_hits
    load_prefix = run_load(batcher, prefix_prompts, n_new)
    hits = batcher.prefix_cache_hits - hits0
    log(f"  run_load closed loop, 16 requests on a shared 2048-token prefix (registered in "
        f"{register_s * 1e3:.1f} ms; {hits} prompt tokens reused): {load_prefix}   [{card}]")
    waves0 = batcher.batched_admissions
    load_wave = run_load(batcher, wave_prompts, n_new)
    waved = batcher.batched_admissions - waves0
    torch.cuda.synchronize()
    counts = build.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  run_load closed loop, {N_SLOTS} requests of one 128-token bucket ({waved} admitted "
        f"in batched waves): {load_wave}   [{card}]")
    log(f"  launches over the serving phase: {counts}; requests admitted in batched waves: "
        f"{batcher.batched_admissions}; peak device memory {peak_gb:.3f} GB   [{card}]")
    if any(counts[k] <= 0 for k in SERVING_KERNELS):
        raise AssertionError(f"a kernel of the serving path was never launched: {counts}")
    if hits < 16 * 2048:
        raise AssertionError(f"the prefix cache reused {hits} tokens, not 16 x 2048")
    if waved != N_SLOTS:
        raise AssertionError(f"{waved} of the {N_SLOTS} one-bucket requests were admitted in "
                             "a batched wave")

    # the batcher's greedy tokens against InferenceEngine.generate (batch 1)
    engine = InferenceEngine(cfg, batcher.params, max_seq_length=4096,
                             weights_mode="quantized", cache_dtype=torch.int8)
    checks = []
    for i in (2, 4):
        p = prompts[i]
        want = engine.generate(torch.as_tensor(p), len(p) + n_new)[0, len(p):].tolist()
        div = first_divergence(torch, engine, p, want, answers[i]["tokens"])
        # first-token logits: the batcher's whole-prompt prefill against the
        # engine's 512-token chunks
        with torch.inference_mode():
            seq = torch.as_tensor(p, dtype=torch.int32, device="cuda")[None]
            eng_logits = engine.prefill(seq, engine.new_cache())[0][0].float()
            bat_logits = batcher_prefill(torch, gpt, batcher, seq, 0, fresh_row(torch, batcher),
                                         plain=False)[0].float()
        route_rel = float((bat_logits - eng_logits).abs().max() / eng_logits.abs().max())
        checks.append({"request": i, "prompt_len": len(p), "divergence": div,
                       "first_logits_rel_diff": route_rel})
        log(f"  request {i} ({len(p)} tokens): first-token logits, batcher route vs engine "
            f"route, max|diff|/max|engine|: {route_rel:.3e} (tolerance {LOGITS_REL_TOL})")
        if route_rel > LOGITS_REL_TOL:
            raise AssertionError(f"batcher and engine first-token logits differ: {route_rel}")
        if div is None:
            log(f"  request {i} ({len(p)} tokens): batcher greedy tokens == engine.generate's")
            continue
        step, margin, top = div
        near = margin <= NEAR_TIE_REL * top
        log(f"  request {i} ({len(p)} tokens): first divergence at generated token {step}, "
            f"engine top-2 margin {margin:.4f} of max |logit| {top:.3f}: "
            f"{'a near-tie' if near else 'NOT a near-tie'}")
        if not near:
            raise AssertionError(f"batcher and engine diverge beyond a near-tie: {div}")
    del engine

    # where a prefill and a decode step spend the card's time
    with torch.inference_mode():
        row = fresh_row(torch, batcher)
        prof_prefill = profile_device(torch, lambda: gpt.forward(
            batcher.params, cfg, check_seq[:, :2048], input_pos=0, kv_cache=row,
            rope_cache=batcher.rope), "one 2048-token prefill")
        if prof_prefill["device_us"]:
            k3_us = prof_prefill["by_group_us"]["K3 flash_attention"]
            prof_prefill["k3_share"] = k3_us / prof_prefill["device_us"]
            log(f"  K3 in that prefill: {k3_us:.1f} us, {prof_prefill['k3_share']:.3f} of its "
                f"device time, {k3_us / cfg.n_layer:.1f} us a layer")
        del row
        toks = torch.ones(N_SLOTS, dtype=torch.int32, device="cuda")
        pos = torch.full((N_SLOTS,), 3000, dtype=torch.int32, device="cuda")
        temps0, topk0 = torch.zeros(N_SLOTS, device="cuda"), torch.full((N_SLOTS,), 32000,
                                                                        device="cuda")
        prof_decode = profile_device(torch, lambda: batcher._decode_step(
            toks, pos, temps0, topk0, False), f"one decode step at {N_SLOTS} slots, positions 3000")
        if prof_decode["device_us"]:
            k1_us = prof_decode["by_group_us"]["K1 int4_rank1_matmul"]
            prof_decode["k1_share"] = k1_us / prof_decode["device_us"]
            log(f"  K1 in that decode step (m = {N_SLOTS}, {qk.int4_path(N_SLOTS, 4096)}): "
                f"{k1_us:.1f} us, {prof_decode['k1_share']:.3f} of its device time, "
                f"{k1_us / cfg.n_layer:.1f} us a layer   [{card}]")
            # K2 at the serving shape, positions 3000
            k2 = attn_bound(N_SLOTS, cfg.n_head, cfg.n_query_groups, cfg.head_size, 3000)
            prof_decode["k2_us_a_launch"] = (prof_decode["by_group_us"]["K2 int8_decode_attention"]
                                             / cfg.n_layer)
            prof_decode["k2_bound"] = k2
            log(f"  K2 in that decode step: {prof_decode['k2_us_a_launch']:.1f} us a launch, "
                f"bound {k2['bound_ms'] * 1e3:.1f} us ({k2['bound_by']}: {k2['bytes'] / 1e6:.1f} "
                f"MB), {k2['bound_ms'] * 1e3 / prof_decode['k2_us_a_launch']:.3f} of it   "
                f"[{card}]")
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        for _ in range(8):
            batcher._decode_step(toks, pos, temps0, topk0, False)
        torch.cuda.synchronize()
        prof_decode["wall_ms_per_step"] = (time.perf_counter() - t2) / 8 * 1e3
        if prof_decode["device_us"]:
            prof_decode["busy_share"] = prof_decode["device_us"] / 1e3 / prof_decode[
                "wall_ms_per_step"]
        log(f"  8 decode steps back to back: {prof_decode['wall_ms_per_step']:.2f} ms a step on "
            f"the host clock (busy share {prof_decode.get('busy_share', 'not measured')})   "
            f"[{card}]")

        # 32-layer prefill logits at S=4096: kernels against the plain route,
        # four 512-token chunks (positions 0-2047, K1 at m=512 and K3)
        # and the batcher's routes: a whole 2900-token prompt (bucket 2944) at
        # pos0 0, then, over its first 2048 rows as a prefix hit leaves
        # them, a 1000-token suffix (bucket 1024) at pos0 2048
        got = {}
        for plain in (False, True):
            cache = gpt.init_kv_cache(cfg, 1, 4096, torch.int8, device="cuda")
            for p0 in range(0, 2048, 512):
                logits, _ = gpt.forward(batcher.params, cfg, check_seq[:, p0:p0 + 512],
                                        input_pos=p0,
                                        kv_cache=cache, rope_cache=batcher.rope, plain=plain)
            del cache
            row = fresh_row(torch, batcher)
            whole = batcher_prefill(torch, gpt, batcher, check_seq[:, :2900], 0, row, plain)
            suffix = batcher_prefill(torch, gpt, batcher, check_seq[:, :3048], 2048, row, plain)
            got[plain] = (logits.float(), whole.float(), suffix.float())
            del row
    rel = {}
    for i, name in enumerate(("engine chunk at pos0 1536", "batcher whole prompt 2900",
                              "batcher suffix 1000 at pos0 2048")):
        a, b = got[False][i], got[True][i]
        if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
            raise AssertionError(f"non-finite prefill logits ({name})")
        rel[name] = float((a - b).abs().max() / b.abs().max())
    log(f"  prefill logits at S=4096, kernels vs plain, max|diff|/max|plain|: "
        f"{', '.join(f'{k} {v:.3e}' for k, v in rel.items())} (tolerance {LOGITS_REL_TOL})")
    if max(rel.values()) > LOGITS_REL_TOL:
        raise AssertionError(f"prefill logits differ beyond {LOGITS_REL_TOL}: {rel}")
    results["serving"] = {
        "model": "Llama-2-7b-hf (random weights, seed 0), q4r1 int4, int8 KV cache, "
                 "block_size 4096",
        "n_slots": N_SLOTS, "decode_quantum": 8, "adaptive_quantum": True, "new_tokens": n_new,
        "http_s": http_s, "http": [{k: v for k, v in a.items() if k != "text"} for a in answers],
        "load": load, "load_prefix": load_prefix, "load_wave": load_wave,
        "prefix_register_ms": register_s * 1e3,
        "prefix_hits": hits, "batched_admissions": batcher.batched_admissions,
        "launches": counts, "peak_gb": peak_gb,
        "engine_checks": checks, "profile_prefill_2048": prof_prefill,
        "profile_decode_step": prof_decode, "prefill_logits_rel_diff": rel, "card": card}
    return counts


# ----------------------------------------------------------------- phase 8
def fastmax_work(bh, n, d, p, chunk, elem, backward: bool) -> tuple:
    """(bytes, operations) of one fastmax call: the function's work, not the
    kernels' tiling. Operations: 4 D (forward) or 10 D (backward) per causal
    (row, key) pair inside a chunk; per row the D x D state products and, for
    p = 2, the pair terms over P = D (D + 1) / 2 pairs m <= j (2 P D each:
    f2 and the S3 update forward; the rewind, dq2, dk2, dv and dS3 backward).
    Bytes: each input read once and each output written once."""
    causal = (n // chunk) * chunk * (chunk + 1) // 2
    pairs = d * (d + 1) // 2
    sym = -(-pairs // 128) * 128  # the packed state's padded rows
    state = 4 * (d * d + d + (sym * d + d * d if p == 2 else 0))
    if backward:
        per_row = (20 if p == 2 else 10) * d * d + ((10 * pairs * d + 11 * pairs) if p == 2 else 0)
        ops = bh * (causal * 10 * d + n * per_row)
        nbytes = bh * (5 * n * d * elem + 4 * n + state + 3 * n * d * elem)
    else:
        per_row = (10 if p == 2 else 4) * d * d + ((4 * pairs * d + 2 * pairs) if p == 2 else 0)
        ops = bh * (causal * 4 * d + n * per_row)
        nbytes = bh * (3 * n * d * elem + n * d * elem + 4 * n + state)
    return nbytes, ops


def tensor_core_f32_bound(flops: int, nbytes: int) -> dict:
    """Least time of float32 work on the tensor cores at three TF32 products a
    multiply (the rate of K5's split: six bf16 products at twice the TF32 rate
    cost the same), against the bytes."""
    b_ms, o_ms = nbytes / HBM_BYTES_PER_S * 1e3, 3 * flops / TF32_TC_FLOPS_PER_S * 1e3
    return {"bound_tc_f32_ms": max(b_ms, o_ms),
            "bound_tc_f32_by": "bytes" if b_ms >= o_ms else "operations"}


def k4_bound(row: dict, path: str) -> tuple:
    """K4's bound for the kernel of ``path`` on a phase 8 timing row, as
    ``k5_bound`` gives K5's."""
    return k5_bound(row, path, "fwd_bound")


def k5_bound(row: dict, path: str, key: str = "bwd_bound") -> tuple:
    """(ms, bound_by) of K5's bound for the kernel of ``path`` on a phase 8
    timing row: float32 on the tensor-core kernel at three TF32 products a
    multiply, else ``bound``'s (float32: the f32 units; bfloat16: the bf16
    tensor cores)."""
    b = row[key]
    if path == "tc" and row["dtype"] == "float32":
        return b["bound_tc_f32_ms"], b["bound_tc_f32_by"]
    return b["bound_ms"], b["bound_by"]


def fastmax_close(torch, what, got, ref, kind, dt):
    """max|got - ref| and that over max|ref|; raises past the tolerance."""
    got, ref = got.float(), ref.float()
    err = float((got - ref).abs().max())
    rel = err / max(float(ref.abs().max()), 1e-30)
    tol = (FASTMAX_F32_REL if dt == torch.float32 else FASTMAX_BF16_REL)[kind]
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or not rel <= tol:
        raise AssertionError(f"fastmax {what}: max abs err {err:.3e}, {rel:.3e} of the largest "
                             f"value (tolerance {tol})")
    return err, rel


def fastmax_qkv(torch, gen, shape, p, dt):
    """q, k (std FASTMAX_QK_STD[p]), v and the output cotangent (std 1) on the card."""
    std = FASTMAX_QK_STD[p]
    return [(torch.randn(shape, generator=gen, device="cuda") * s).to(dt)
            for s in (std, std, 1.0, 1.0)]


def fastmax_case(torch, gen, shape, p, chunk, dt):
    """K4 and K5 against the plain walks on one random (B, H, N, D) input:
    o through ``fastmax_trainable`` and ``fastmax_forward`` (K4 with and
    without its g and state outputs), dq, dk, dv through the autograd
    backward (K5), and K4's g and final state through its launcher. Raises
    on a mismatch; returns {output: (max abs err, that of the largest value)}
    and, for float32, ``fastmax_f64_errors``."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, p, dt)
    b, h, n, d = shape
    out = {}
    for plain in (False, True):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fk.fastmax_trainable(*ts, p, 8.0, chunk, plain=plain)
        o.backward(do)
        only = fk.fastmax_forward(q, k, v, p, 8.0, chunk, plain=plain)
        out[plain] = {"o": o.detach(), "o (forward only)": only,
                      "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}
    flat = [x.reshape(b * h, n, d) for x in (q, k, v)]
    z = 8.0 * math.sqrt(d)
    for plain, (_, g, state) in ((False, fk._fwd_launch(*flat, p, z, chunk, train=True)),
                                 (True, fk.fastmax_fwd_plain(*flat, p, z, chunk))):
        out[plain].update(zip(("g", "s_kv", "s_k", "s_kkv", "s_kk"), (g,) + tuple(state)))
    tag = f"B={b} H={h} N={n} D={d} p={p} {str(dt)[6:]}"
    errs = {}
    for name, ref in out[True].items():
        kind = "grad" if name in ("dq", "dk", "dv") else "fwd"
        label = "K5" if kind == "grad" else "K4"
        if kind == "grad" and n // chunk >= 16 and dt == torch.float32:
            kind = "grad, 16 chunks"
        errs[name] = fastmax_close(torch, f"{label} {name} {tag}", out[False][name], ref, kind, dt)
    return errs, (fastmax_f64_errors(torch, q, k, v, do, p, out) if dt == torch.float32 else None)


def fastmax_f64_errors(torch, q, k, v, do, p, out) -> dict:
    """Each route's distance from the O(N^2) reference in float64, of its
    largest value: {output: (kernels, plain)}. A yardstick, not a check."""
    from fastmax_tpu_torch.ops.fastmax import polynomial_attention_reference

    ts = [x.double().requires_grad_(True) for x in (q, k, v)]
    o = polynomial_attention_reference(*ts, p=p, mask=True)
    o.backward(do.double())
    ref = {"o": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}
    return {name: tuple(float((out[plain][name].double() - r).abs().max() / r.abs().max())
                        for plain in (False, True))
            for name, r in ref.items()}


def fastmax_pair_terms(torch, gen, shape, chunk):
    """The degree-2 terms alone: o, dq, dk, dv at p = 2 minus p = 1 on the same
    f32 inputs (q, k std 1), kernels against plain, held at FASTMAX_PAIR_REL of
    the plain difference's largest value. Returns {output: (that error, the
    difference's largest value over the p = 2 output's)}."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, 1, torch.float32)
    got = {}
    for plain in (False, True):
        per_p = {}
        for p in (2, 1):
            ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
            o = fk.fastmax_trainable(*ts, p, 8.0, chunk, plain=plain)
            o.backward(do)
            per_p[p] = [o.detach()] + [t.grad for t in ts]
        got[plain] = (per_p[2], [a - b for a, b in zip(per_p[2], per_p[1])])
    errs = {}
    for i, name in enumerate(("o", "dq", "dk", "dv")):
        a, b = got[False][1][i], got[True][1][i]
        rel = float((a - b).abs().max()) / float(b.abs().max())
        share = float(b.abs().max()) / float(got[True][0][i].abs().max())
        if not rel <= FASTMAX_PAIR_REL:
            raise AssertionError(f"fastmax degree-2 terms of {name}: kernels vs plain "
                                 f"{rel:.3e} of the largest value (tolerance {FASTMAX_PAIR_REL})")
        errs[name] = (rel, share)
    return errs


def fastmax_repeats(torch, gen, shape, chunk, runs: int = 3) -> None:
    """K4 and K5 give the same bits on every call (no float atomics: every sum
    has a fixed order); raises otherwise."""
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    q, k, v, do = fastmax_qkv(torch, gen, shape, 2, torch.float32)
    outs = []
    for _ in range(runs):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = fk.fastmax_trainable(*ts, 2, 8.0, chunk)
        o.backward(do)
        outs.append([o.detach()] + [t.grad for t in ts])
    for other in outs[1:]:
        for name, a, b in zip(("o", "dq", "dk", "dv"), outs[0], other):
            if not torch.equal(a, b):
                raise AssertionError(f"fastmax {name} differs between two calls on the same "
                                     f"inputs by {float((a - b).abs().max()):.3e}")


def check_fastmax(torch, gen, results):
    from fastmax_tpu_torch.ops import fastmax as tfm
    from fastmax_tpu_torch.ops import fastmax_kernels as fk

    dev = torch.device("cuda")
    f32, bf16 = torch.float32, torch.bfloat16
    train_shape = (4, 8, 512, 64)
    # ((B, H, N, D), p, chunk, dtype): the training shape, p = 1, 16 chunks at D = 16,
    # chunks of 256 rows (fastmax()'s at N >= 2048), which the pair CTAs of K4 and K5
    # take in two parts, at N = 1024: at N = 2048 the f32 dq of both K5 kernels lies 0.9e-4 to
    # 5.6e-4 of its largest value from the plain walk and from float64, the tc kernel
    # no farther than the FMA kernel (the long rewind's cancellation, as at 16 chunks)
    cases = [(train_shape, 2, 128, f32), (train_shape, 2, 128, bf16), (train_shape, 1, 128, f32),
             ((1, 2, 2048, 16), 2, 128, f32), ((1, 8, 1024, 64), 2, 256, f32),
             ((1, 8, 1024, 64), 2, 256, bf16)]
    checks = []
    for shape, p, chunk, dt in cases:
        errs, f64 = fastmax_case(torch, gen, shape, p, chunk, dt)
        checks.append({"shape": shape, "p": p, "dtype": str(dt)[6:], "errors": errs,
                       "from_f64_kernels_plain": f64})
        log(f"  fastmax {shape} p={p} {str(dt)[6:]}: ok, max abs err (of the largest value) "
            + ", ".join(f"{k} {a:.2e} ({r:.1e})" for k, (a, r) in errs.items()))
        if f64:
            log("    from the float64 O(N^2) reference, of its largest value, kernels / plain: "
                + ", ".join(f"{k} {a:.1e} / {b:.1e}" for k, (a, b) in f64.items()))
    train_errs = checks[0]["errors"]
    own_err = {"fastmax_fwd": max(train_errs[k][0] for k in ("o", "o (forward only)")),
               "fastmax_bwd": max(train_errs[k][0] for k in ("dq", "dk", "dv"))}
    pair = fastmax_pair_terms(torch, gen, train_shape, 128)
    log(f"  fastmax {train_shape} degree-2 terms (p=2 - p=1, q/k std 1) kernels vs plain, of "
        f"the largest value (tolerance {FASTMAX_PAIR_REL}): "
        + ", ".join(f"{k} {r:.2e}" for k, (r, _) in pair.items())
        + "; their share of the p=2 output: "
        + ", ".join(f"{k} {s:.2e}" for k, (_, s) in pair.items()))
    fastmax_repeats(torch, gen, train_shape, 128)
    log(f"  fastmax {train_shape} p=2 f32: o, dq, dk, dv equal bit for bit over 3 calls")
    # a ragged N = 200 through fastmax(): padded to 256 at the tail; output and
    # gradients, kernels against plain
    q, k, v, do = fastmax_qkv(torch, gen, (4, 8, 200, 64), 2, f32)
    got = {}
    for plain in (False, True):
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        o = tfm.fastmax(*ts, p=2, plain=plain)
        o.backward(do)
        got[plain] = [o.detach()] + [t.grad for t in ts]
    ragged = {n: fastmax_close(torch, f"fastmax() N=200 {n}", a, b,
                               "fwd" if n == "o" else "grad", f32)
              for n, a, b in zip(("o", "dq", "dk", "dv"), got[False], got[True])}
    log("  fastmax() B=4 H=8 N=200 (padded to 256) D=64 p=2 f32: ok, max abs err (of the "
        "largest value) " + ", ".join(f"{k} {a:.2e} ({r:.1e})" for k, (a, r) in ragged.items()))
    results["fastmax_checks"] = {"cases": checks, "degree2_terms": pair, "ragged_n200": ragged,
                                 "repeat_bitwise": True}

    # device time at the training shape, inputs cold: four input sets (67 MB f32);
    # then p = 2 at N = 2048 in chunks of 256 (what fastmax() picks there), which
    # the pair CTAs of K4 and K5 take in two parts. K4 and K5 at p = 2 on both of
    # their kernels, the path passed explicitly, and each held against the plain walk
    # on the first set
    rows = []
    n_sets = 4
    for p, dt, n, chunk in ((2, f32, 512, 128), (2, bf16, 512, 128), (1, f32, 512, 128),
                            (2, f32, 2048, 256), (2, bf16, 2048, 256)):
        sets = [[(torch.randn((32, n, 64), generator=gen, device=dev) * 0.5).to(dt)
                 for _ in range(4)] for _ in range(n_sets)]
        z = 8.0 * math.sqrt(64)
        fwd_out = [fk.fastmax_fwd_plain(q, k, v, p, z, chunk) for q, k, v, _ in sets]
        it = iter(range(10**9))

        def fwd(train=True, plain=False, path=None):
            q, k, v, _ = sets[next(it) % n_sets]
            if plain:
                return fk.fastmax_fwd_plain(q, k, v, p, z, chunk)
            return fk._fwd_launch(q, k, v, p, z, chunk, train=train, path=path)

        def bwd(plain=False, path=None):
            i = next(it) % n_sets
            q, k, v, do = sets[i]
            o, g, st = fwd_out[i]
            if plain:
                return fk.fastmax_bwd_plain(q, k, v, do, o, g, st, p, z, chunk)
            return fk._bwd_launch(q, k, v, do, o, g, st, p, z, chunk, path=path)

        k4 = graph_ms(fwd, calls=2 * n_sets)
        k4_only = graph_ms(lambda: fwd(train=False), calls=2 * n_sets)
        plain_f = graph_ms(lambda: fwd(plain=True), calls=n_sets, reps=1)
        path4 = fk.fwd_path(p, 64)
        k4_fma = graph_ms(lambda: fwd(path="fma"), calls=2 * n_sets) if path4 == "tc" else k4
        if path4 == "tc":  # both kernels against the plain walk on the first set
            q, k, v, _ = sets[0]
            ref = fwd_out[0]
            for kernel in ("tc", "fma"):
                o, g, st = fk._fwd_launch(q, k, v, p, z, chunk, train=True, path=kernel)
                for name, a, b in zip(("o", "g", "s_kv", "s_k", "s_kkv", "s_kk"),
                                      (o, g) + tuple(st), ref[:2] + tuple(ref[2])):
                    fastmax_close(torch, f"K4 ({kernel}) {name} timing set N={n}", a, b,
                                  "fwd", dt)
        k5 = graph_ms(bwd, calls=2 * n_sets)
        plain_b = graph_ms(lambda: bwd(plain=True), calls=n_sets, reps=1)
        path = fk.bwd_path(p, 64)
        k5_fma = graph_ms(lambda: bwd(path="fma"), calls=2 * n_sets) if path == "tc" else k5
        if path == "tc":  # both kernels against the plain walk on the first set
            q, k, v, do = sets[0]
            ref = fk.fastmax_bwd_plain(q, k, v, do, *fwd_out[0], p, z, chunk)
            for kernel in ("tc", "fma"):
                got = fk._bwd_launch(q, k, v, do, *fwd_out[0], p, z, chunk, path=kernel)
                for name, a, b in zip(("dq", "dk", "dv"), got, ref):
                    fastmax_close(torch, f"K5 ({kernel}) {name} timing set N={n}", a, b,
                                  "grad", dt)
        elem = 2 if dt == bf16 else 4
        b_f = bound(*fastmax_work(32, n, 64, p, chunk, elem, False), bf16=dt == bf16)
        b_f.update(tensor_core_f32_bound(b_f["flops"], b_f["bytes"]))
        b_b = bound(*fastmax_work(32, n, 64, p, chunk, elem, True), bf16=dt == bf16)
        b_b.update(tensor_core_f32_bound(b_b["flops"], b_b["bytes"]))
        rows.append({"p": p, "dtype": str(dt)[6:], "n": n, "chunk": chunk, "k4_ms": k4,
                     "k4_path": path4, "k4_fma_ms": k4_fma, "k4_forward_only_ms": k4_only,
                     "plain_fwd_ms": plain_f, "k5_ms": k5, "k5_path": path,
                     "k5_fma_ms": k5_fma, "plain_bwd_ms": plain_b, "fwd_bound": b_f,
                     "bwd_bound": b_b})
        b4 = k4_bound(rows[-1], path4)
        log(f"  fastmax B=4 H=8 N={n} D=64 chunk {chunk} p={p} {str(dt)[6:]:8s}: K4 ({path4}) "
            f"{k4 * 1e3:8.1f} us (forward only {k4_only * 1e3:8.1f}), FMA kernel "
            f"{k4_fma * 1e3:8.1f} us  plain {plain_f * 1e3:8.1f} us  bound {b4[0] * 1e3:6.1f} us "
            f"({b4[1]});  K5 ({path}) {k5 * 1e3:8.1f} us, FMA kernel {k5_fma * 1e3:8.1f} "
            f"us  plain {plain_b * 1e3:8.1f} us  bound {k5_bound(rows[-1], path)[0] * 1e3:6.1f} "
            f"us ({k5_bound(rows[-1], path)[1]})   [{card_line()}]")
        log(f"    K4 bounds: {b_f['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate (share: "
            f"{path4} {b_f['bound_f32_ms'] / k4:.3f}, FMA {b_f['bound_f32_ms'] / k4_fma:.3f}); "
            f"{b_f['bound_tc_f32_ms'] * 1e3:6.1f} us at three TF32 products a multiply on the "
            f"tensor cores (share: {path4} {b_f['bound_tc_f32_ms'] / k4:.3f}, FMA "
            f"{b_f['bound_tc_f32_ms'] / k4_fma:.3f}); {b_f['bound_ms'] * 1e3:6.1f} us at the "
            f"rate of the type (share: {path4} {b_f['bound_ms'] / k4:.3f})")
        log(f"    K5 bounds: {b_b['bound_f32_ms'] * 1e3:6.1f} us at the f32 rate (share: "
            f"{path} {b_b['bound_f32_ms'] / k5:.3f}, FMA {b_b['bound_f32_ms'] / k5_fma:.3f}); "
            f"{b_b['bound_tc_f32_ms'] * 1e3:6.1f} us at three TF32 products a multiply on the "
            f"tensor cores (share: {path} {b_b['bound_tc_f32_ms'] / k5:.3f}, FMA "
            f"{b_b['bound_tc_f32_ms'] / k5_fma:.3f})")
        del sets, fwd_out
    results["fastmax_times"] = rows
    return own_err, rows


def repo_text_tokens(np):
    """The bytes of the repository's own *.md and *.py files, bytes >= 205
    (the easy-transformer vocabulary) dropped, as uint16 tokens."""
    skip = {"_build", "_checkout", "chiprun_out", "__pycache__"}
    files = sorted(f for f in REPO.rglob("*") if f.suffix in (".md", ".py") and f.is_file()
                   and not skip.intersection(f.relative_to(REPO).parts))
    raw = np.frombuffer(b"".join(f.read_bytes() for f in files), np.uint8)
    return raw[raw < 205].astype(np.uint16), len(files)


def clone_tree(tree, requires_grad: bool):
    if isinstance(tree, dict):
        return {k: clone_tree(v, requires_grad) for k, v in tree.items()}
    return tree.detach().clone().requires_grad_(requires_grad)


def train_args(steps: int = TRAIN_STEPS):
    """``pretrain.setup``'s defaults, ``steps`` steps, a log line every step."""
    from fastmax_tpu_torch.utils.args import TrainArgs

    return TrainArgs(global_batch_size=8, micro_batch_size=4, max_iters=steps,
                     learning_rate=6e-4, save_interval=1000, log_interval=1)


def training_run(torch, pretrain, build, data, out, model_name, card, attn_alg=None,
                 train=None):
    """``pretrain.setup`` with its defaults (``attn_alg`` None: the model's own;
    ``train`` None: ``train_args()``); the step time from step 10 on (step 2 on
    for runs of 10 steps or fewer)."""
    import csv

    from fastmax_tpu_torch.utils.args import IOArgs

    gc.collect()  # what earlier phases left in reference cycles (the 7B batcher)
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    train = train or train_args()
    n_steps = train.max_iters
    t0 = time.perf_counter()
    state = pretrain.setup(model_name=model_name, data_format="openwebtext", attn_alg=attn_alg,
                           train=train,
                           io=IOArgs(train_data_dir=data, out_dir=out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9  # the run's own peak
    with open(out / "metrics.csv", newline="") as f:
        steps = {int(r["step"]): r for r in csv.DictReader(f)}
    losses = [float(steps[s]["loss"]) for s in sorted(steps)]
    last, first = n_steps, (10 if n_steps > 10 else 2)
    step_s = (float(steps[last]["time"]) - float(steps[first]["time"])) / (last - first)
    tok_s = 8 * 512 / step_s
    name = f"{model_name} ({attn_alg})" if attn_alg else model_name
    run = {"model": name, "steps": state.step, "wall_s": wall, "step_s": step_s,
           "tokens_per_s": tok_s, "peak_gb": peak_gb, "held_before_gb": held / 1e9,
           "launches": counts,
           "first_loss": losses[0], "last_loss": losses[-1], "losses": losses,
           "est_mfu_logged": float(steps[last].get("est_mfu") or "nan"), "card": card}
    log(f"  {name}: {state.step} steps in {wall:.2f} s; steps {first + 1}-{last}: "
        f"{step_s * 1e3:.2f} ms a step, {tok_s:.1f} tokens/s; loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; peak {peak_gb:.3f} GB; launches {counts}   [{card}]")
    return state, run


def step_kernels_vs_plain(torch, cfg, batch, seed: int = 1337) -> dict:
    """One training step's loss and every gradient, kernels against
    ``plain=True``, f32, from ``init_params(seed)`` with the qkv weights scaled
    to a standard deviation of sqrt(8 / n_embd): q and k then have one of about
    sqrt(8) and s = q.k / z one of about 1 (at the init std 0.02 it is about
    0.025, where the degree-2 terms would hardly show). Raises past
    TRAIN_LOSS_REL or TRAIN_GRAD_REL."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves

    params0 = gpt.init_params(cfg, seed=seed, device="cuda")
    qkv = params0["blocks"]["attn"]["attn"]["kernel"]
    qkv.mul_(math.sqrt(8.0 / cfg.n_embd) / float(qkv.std()))
    res = {}
    for plain in (False, True):
        ps = clone_tree(params0, True)
        loss = make_loss_fn(cfg, remat=True, plain=plain)(ps, batch)
        loss.backward()
        res[plain] = (float(loss.detach()), [p.grad for p in tree_leaves(ps)])
    loss_rel = abs(res[False][0] - res[True][0]) / abs(res[True][0])
    grad_rel = max(float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)
                   for a, b in zip(res[False][1], res[True][1]))
    log(f"  one step, kernels vs plain (qkv std sqrt(8/n_embd)): loss {res[False][0]:.6f} vs "
        f"{res[True][0]:.6f} (rel {loss_rel:.2e}, tolerance {TRAIN_LOSS_REL}); worst gradient "
        f"leaf max|diff|/max|plain| {grad_rel:.2e} (tolerance {TRAIN_GRAD_REL})")
    if not (loss_rel <= TRAIN_LOSS_REL and grad_rel <= TRAIN_GRAD_REL):
        raise AssertionError(f"kernels vs plain: loss rel {loss_rel}, grad rel {grad_rel}")
    return {"loss": [res[False][0], res[True][0]], "loss_rel": loss_rel, "worst_grad_rel": grad_rel}


def training_path(torch, results, card):
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.training.fit import build_optimizer
    from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves
    from fastmax_tpu_torch.utils.flops import estimate_flops

    cfg = Config.from_name("easy-transformer-fastmax")
    tokens, n_files = repo_text_tokens(np)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "data"
        data.mkdir()
        tokens.tofile(data / "train.bin")
        (data / "meta.json").write_text('{"dtype": "uint16"}')
        log(f"  train.bin: {tokens.size} tokens from {n_files} *.md/*.py files of the repository")
        state, run = training_run(torch, pretrain, build, data, Path(tmp) / "fm",
                                  "easy-transformer-fastmax", card)
        n_params = sum(p.numel() for p in tree_leaves(state.params))
        flops_tok = estimate_flops(cfg, n_params, 512) / 512
        run["mfu_f32"] = run["tokens_per_s"] * flops_tok / F32_FLOPS_PER_S
        mb = TRAIN_STEPS * 2
        want = {"fastmax_fwd": 2 * cfg.n_layer * mb, "fastmax_bwd": cfg.n_layer * mb}
        log(f"  easy-transformer-fastmax: {n_params} parameters, {flops_tok / 1e6:.1f} MFLOP a "
            f"token (6N + attention, the reference's count), MFU {run['mfu_f32']:.4f} of the "
            f"f32 peak; K4/K5 launches {run['launches']['fastmax_fwd']}/"
            f"{run['launches']['fastmax_bwd']} (remat: {want['fastmax_fwd']}/"
            f"{want['fastmax_bwd']})   [{card}]")
        if {k: run["launches"][k] for k in want} != want:
            raise AssertionError(f"K4/K5 launches {run['launches']} != {want}")
        if not run["last_loss"] < run["first_loss"]:
            raise AssertionError(f"the loss did not fall: {run['losses']}")

        # one step's device time by kernel group, and the busy share
        loss_fn = make_loss_fn(cfg, remat=True)
        leaves = tree_leaves(state.params)
        batches = [torch.as_tensor(tokens[i * 2052:(i + 1) * 2052].astype(np.int64),
                                   device="cuda").reshape(4, 513) for i in range(2)]
        optimizer = build_optimizer(train_args())

        def one_step():
            for p in leaves:
                p.grad = None
            for b in batches:
                loss_fn(state.params, b).backward()
            optimizer.update(state.params, [p.grad / 2 for p in leaves], state.opt_state)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_device(torch, one_step, "one training step (2 micro-batches)")
        prof["wall_ms"] = wall_ms
        if prof["device_us"]:
            prof["busy_share"] = prof["device_us"] / 1e3 / wall_ms
        log(f"  one step: {wall_ms:.2f} ms on the host clock, device busy share "
            f"{prof.get('busy_share', 'not measured')}   [{card}]")
        if prof["device_us"]:
            prof["k5_share"] = prof["by_group_us"]["K5 fastmax_bwd"] / prof["device_us"]
            prof["k4_share"] = prof["by_group_us"]["K4 fastmax_fwd"] / prof["device_us"]
            log(f"  one step: K5 {prof['k5_share']:.3f} and K4 {prof['k4_share']:.3f} of "
                f"{prof['device_us'] / 1e3:.3f} ms of device time   [{card}]")
        run["profile_step"] = prof
        del state, leaves, optimizer
        out["fastmax"] = run

        # one step's loss and every gradient: kernels against plain=True
        out["kernels_vs_plain"] = step_kernels_vs_plain(torch, cfg, batches[0])

        # the yardstick: the same steps with quadratic attention
        _, quad = training_run(torch, pretrain, build, data, Path(tmp) / "quad",
                               "easy-transformer", card)
        out["quadratic"] = quad
        log(f"  tokens/s: easy-transformer-fastmax {run['tokens_per_s']:.1f}, easy-transformer "
            f"(quadratic) {quad['tokens_per_s']:.1f}   [{card}]")

        # the other linear arms at head size 64: their chunked scans, never K4/K5
        for arm in ("linearmax", "performer"):
            _, lin = training_run(torch, pretrain, build, data, Path(tmp) / arm,
                                  "easy-transformer-fastmax", card, attn_alg=arm,
                                  train=train_args(LINEAR_TRAIN_STEPS))
            out[arm] = lin
            fused = {k: lin["launches"][k] for k in FASTMAX_KERNELS}
            if any(fused.values()):
                raise AssertionError(f"{arm} launched the fastmax kernels: {fused}")
            if not (all(math.isfinite(x) for x in lin["losses"])
                    and lin["last_loss"] < lin["first_loss"]):
                raise AssertionError(f"{arm}: the loss did not fall: {lin['losses']}")
    results["training"] = out
    return run["launches"]


# ----------------------------------------------------------------- phase 9
# K6/K7 against the plain versions. q and k are drawn at std sqrt(3), so the
# scores q.k / sqrt(D) have a standard deviation of about 3: rows put most of
# their weight on a few keys, where a missing mask, delta or rounding shows.
# v and the output cotangent have std 1. Each output is held by max|kernel -
# plain| over its largest value: float32 1e-5 (out, lse) and 1e-4 (dq, dk, dv,
# whose ds terms cancel); bfloat16 2^-7, one bf16 ulp of any element (the
# outputs are rounded values, and two f32 sums in other orders round to
# neighbours now and then), and, since such a flip is rare where a rounding
# step is missing it is not, also by mean|kernel - plain| over mean|plain| at
# FLASH_TRAIN_BF16_MEAN (a missing rounding of p moves dv by about 2^-9 of a
# term: ~1e-3 of the mean). lse is f32 in both: 1e-5.
FLASH_TRAIN_QK_STD = 3.0 ** 0.5
FLASH_TRAIN_REL = {"float32": {"out": 1e-5, "grad": 1e-4}, "bfloat16": {"out": 2.0 ** -7,
                                                                        "grad": 2.0 ** -7}}
FLASH_TRAIN_LSE_REL = 1e-5
FLASH_TRAIN_BF16_MEAN = 5e-5
FT_SHAPE = (2, 32, 2048, 128)   # micro-batch 2 of Llama-2-7B at T = 2048
FT_REPEAT_256 = (1, 4, 1024, 256)  # the bit-for-bit repeat at Gemma's head (K7's warp pairs)
FT_STEPS = 3   # 4 before phase 20
# one step of the 4-layer QLoRA model, kernels against plain=True: the loss
# (relative) and each LoRA gradient leaf (of its largest entry). f32: sums in
# other orders; bf16: every activation is rounded, and a flipped attention
# output element moves what follows by a bf16 ulp.
FT_STEP_TOL = {"float32": (1e-5, 1e-3), "bfloat16": (5e-3, 5e-2)}
K6_K7 = {"out": "K6", "lse": "K6", "dq": "K7", "dk": "K7", "dv": "K7"}


def flash_train_fn(entry: str, d: int, plain: bool):
    from fastmax_tpu_torch.ops import flash_attention as fa
    from fastmax_tpu_torch.ops.attention import attention

    if entry == "fused":
        return lambda q, k, v: fa.flash_attention_fused(q, k, v, plain=plain)
    if entry == "trainable":
        return lambda q, k, v: fa.flash_attention_trainable(q, k, v, plain=plain)
    return lambda q, k, v: attention(q, k, v, attn_alg="quadratic", head_size=d, plain=plain)


def flash_train_run(fn, q, k, v, w) -> dict:
    ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = fn(*ts)
    o.backward(w)
    return {"out": o.detach(), "dq": ts[0].grad, "dk": ts[1].grad, "dv": ts[2].grad}


def flash_train_inputs(torch, gen, shape, dtype):
    s = FLASH_TRAIN_QK_STD
    return [(torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)
            for std in (s, s, 1.0, 1.0)]


def flash_train_f64(torch, q, k, v, w, res) -> dict:
    """Each route's distance from dense causal softmax attention in float64 on
    the same inputs, of the reference's largest value: {output: (kernels,
    plain)}. A yardstick, not a check."""
    t, d = q.shape[2], q.shape[3]
    ts = [x.double().requires_grad_(True) for x in (q, k, v)]
    s = torch.einsum("bhid,bhjd->bhij", ts[0], ts[1]) * d ** -0.5
    s = s.masked_fill(~torch.ones((t, t), dtype=torch.bool, device=q.device).tril(), float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    o = torch.einsum("bhij,bhjd->bhid", torch.exp(s - lse[..., None]), ts[2])
    o.backward(w.double())
    ref = {"out": o.detach(), "lse": lse.detach(), "dq": ts[0].grad, "dk": ts[1].grad,
           "dv": ts[2].grad}
    del s, o
    return {name: tuple(float((res[plain][name].double() - r).abs().max() / r.abs().max())
                        for plain in (False, True))
            for name, r in ref.items() if name in res[False]}


def flash_train_case(torch, gen, entry, shape, dtype, f64: bool = True) -> dict:
    """K6 and K7 through ``entry`` ("fused", "trainable" or "attention": the
    dispatch, which pads T) against plain=True on one random input: out,
    dq, dk, dv (the autograd backward) and, for the entries, lse (K6 launched
    once more by itself). Raises on a mismatch; returns {output: (max abs
    err, that of the largest value, mean err of the mean)} and the float64
    yardstick."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    q, k, v, w = flash_train_inputs(torch, gen, shape, dtype)
    d = shape[3]
    res = {plain: flash_train_run(flash_train_fn(entry, d, plain), q, k, v, w)
           for plain in (False, True)}
    if entry != "attention":
        block = fa._fused_block(shape[2]) if entry == "fused" else fa.DEFAULT_BLOCK_K
        res[False]["lse"] = fa._train_fwd(q, k, v, d ** -0.5, block, False)[1]
        res[True]["lse"] = fa.flash_train_fwd_plain(q, k, v, d ** -0.5, block)[1]
    torch.cuda.synchronize()
    dt = str(dtype)[6:]
    tag = f"{entry} B={shape[0]} H={shape[1]} T={shape[2]} D={d} {dt}"
    errs = {}
    for name, ref in res[True].items():
        got = res[False][name]
        err = (got.float() - ref.float()).abs()
        max_abs = float(err.max())
        rel = max_abs / max(float(ref.float().abs().max()), 1e-30)
        mean = float(err.mean()) / max(float(ref.float().abs().mean()), 1e-30)
        tol = FLASH_TRAIN_LSE_REL if name == "lse" else \
            FLASH_TRAIN_REL[dt]["out" if name == "out" else "grad"]
        bad = (got.shape != ref.shape or got.dtype != ref.dtype
               or not bool(torch.isfinite(got).all()) or not rel <= tol)
        if dtype == torch.bfloat16 and name != "lse" and not mean <= FLASH_TRAIN_BF16_MEAN:
            bad = True
        if bad:
            raise AssertionError(
                f"{K6_K7[name]} {name} {tag}: max abs err {max_abs:.3e}, {rel:.3e} of the largest "
                f"value (tolerance {tol}), mean err {mean:.3e} of the mean")
        errs[name] = (max_abs, rel, mean)
    yard = flash_train_f64(torch, q, k, v, w, res) if f64 else None
    del res
    return {"case": tag, "errors": errs, "from_f64_kernels_plain": yard}


def flash_train_repeats(torch, gen, shape, dtype, runs: int = 3) -> None:
    """K6 and K7 give the same bits on every call (no atomics); raises otherwise."""
    q, k, v, w = flash_train_inputs(torch, gen, shape, dtype)
    fn = flash_train_fn("fused", shape[3], False)
    outs = [flash_train_run(fn, q, k, v, w) for _ in range(runs)]
    for other in outs[1:]:
        for name in outs[0]:
            if not torch.equal(outs[0][name], other[name]):
                raise AssertionError(f"{K6_K7[name]} {name} differs between two calls on the "
                                     "same inputs")


def flash_train_work(b, h, t, d, elem, backward: bool) -> tuple:
    """(bytes, operations) of one call: 4 D (forward) or 10 D (backward: s, dp,
    dv, dk, dq) flops per visible (row, key) pair; each input read once and
    each output written once (lse and delta f32)."""
    pairs = b * h * t * (t + 1) // 2
    n = b * h * t * d
    if backward:
        return elem * 7 * n + 4 * 2 * b * h * t, 10 * d * pairs
    return elem * 4 * n + 4 * b * h * t, 4 * d * pairs


def flash_train_times(torch, gen, dtype, n_sets: int = 4, shape=FT_SHAPE) -> dict:
    """Device time per call in a CUDA graph, inputs cold (n_sets input sets,
    128 MB in bf16 at the finetune shape), at ``shape`` (B, H, T, D): K6 (the
    fused entry's block, and the other entry's 128-key block), K7, their plain
    versions, and SDPA's causal forward and forward + backward (autograd
    captured in the graph)."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    b, h, t, d = shape
    scale, blk = d ** -0.5, fa._fused_block(t)
    sets = []
    for _ in range(n_sets):
        q, k, v, w = flash_train_inputs(torch, gen, shape, dtype)
        out, lse = fa._train_fwd(q, k, v, scale, blk, False)
        sets.append((q, k, v, w, lse, torch.sum(w.float() * out.float(), dim=-1)))
    it = iter(range(10**9))

    def fwd(plain=False, block=blk):
        q, k, v, *_ = sets[next(it) % n_sets]
        return fa._train_fwd(q, k, v, scale, block, plain)

    def bwd(plain=False):
        q, k, v, w, lse, delta = sets[next(it) % n_sets]
        return fa._train_bwd(q, k, v, w, lse, delta, scale, plain)

    def lib_fwd():
        q, k, v, *_ = sets[next(it) % n_sets]
        return torch.nn.functional.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                scale=scale)

    def lib_fwd_bwd():
        q, k, v, w, *_ = sets[next(it) % n_sets]
        ts = [x.detach().requires_grad_(True) for x in (q, k, v)]
        torch.nn.functional.scaled_dot_product_attention(*ts, is_causal=True,
                                                         scale=scale).backward(w)

    elem = 2 if dtype == torch.bfloat16 else 4
    row = {"dtype": str(dtype)[6:], "shape": shape,
           "k6_ms": graph_ms(fwd, calls=2 * n_sets),
           "k6_block128_ms": graph_ms(lambda: fwd(block=fa.DEFAULT_BLOCK_K), calls=2 * n_sets),
           "plain_fwd_ms": graph_ms(lambda: fwd(plain=True), calls=n_sets, reps=1),
           "k7_ms": graph_ms(bwd, calls=2 * n_sets),
           "plain_bwd_ms": graph_ms(lambda: bwd(plain=True), calls=n_sets, reps=1),
           "sdpa_fwd_ms": graph_ms(lib_fwd, calls=2 * n_sets),
           "sdpa_fwd_bwd_ms": graph_ms(lib_fwd_bwd, calls=2 * n_sets),
           "sdpa_backend": sdpa_backend(torch, *sets[0][:3], None, scale, is_causal=True),
           "fwd_bound": bound(*flash_train_work(b, h, t, d, elem, False), bf16=elem == 2),
           "bwd_bound": bound(*flash_train_work(b, h, t, d, elem, True), bf16=elem == 2)}
    del sets
    return row


def check_flash_train(torch, gen, results):
    f32, bf16 = torch.float32, torch.bfloat16
    # (entry, (B, H, T, D), dtype): the finetune shape through both entries in
    # both types; T=1088 through attention() (padded to 1536); D=64; 256 (bf16:
    # the tensor cores, K7's warp pairs); 192 (bf16: the FMA kernels' only bf16
    # head); a ragged T=200 in one whole-T block (the tensor-core K6's tile and
    # block edges: 200 is no multiple of 64)
    cases = [("fused", FT_SHAPE, bf16), ("fused", FT_SHAPE, f32),
             ("trainable", FT_SHAPE, bf16), ("trainable", FT_SHAPE, f32),
             ("attention", (2, 32, 1088, 128), bf16), ("fused", (4, 32, 2048, 64), bf16),
             ("fused", (1, 8, 1024, 256), bf16), ("fused", (1, 8, 1024, 192), bf16),
             ("trainable", (1, 8, 640, 192), f32), ("fused", (1, 4, 200, 128), bf16)]
    checks = []
    for entry, shape, dt in cases:
        c = flash_train_case(torch, gen, entry, shape, dt, f64=entry != "attention")
        checks.append(c)
        log(f"  {c['case']}: ok; max abs err (of the largest; mean of the mean) "
            + ", ".join(f"{k} {a:.2e} ({r:.1e}; {m:.1e})" for k, (a, r, m) in c["errors"].items()))
        if c["from_f64_kernels_plain"]:
            log("    from float64 dense attention, of its largest value, kernels / plain: "
                + ", ".join(f"{k} {a:.1e} / {b:.1e}"
                            for k, (a, b) in c["from_f64_kernels_plain"].items()))
    for shape in (FT_SHAPE, FT_REPEAT_256):
        flash_train_repeats(torch, gen, shape, bf16)
        log(f"  fused {shape} bf16: out, dq, dk, dv equal bit for bit over 3 calls")
    rows = []
    for dt in (bf16, f32):
        r = flash_train_times(torch, gen, dt)
        rows.append(r)
        fb, bb = r["fwd_bound"], r["bwd_bound"]
        rate = ", ".join(f"{fb['flops'] / (r[key] * 1e-3) / 1e12:.1f} TFLOP/s, "
                         f"{fb['bound_ms'] / r[key]:.3f} of the bound"
                         for key in ("k6_ms", "k6_block128_ms"))
        rate7 = (f"{bb['flops'] / (r['k7_ms'] * 1e-3) / 1e12:.1f} TFLOP/s, "
                 f"{bb['bound_ms'] / r['k7_ms']:.3f} of the bound")
        log(f"  {FT_SHAPE} {r['dtype']:8s}: K6 {r['k6_ms'] * 1e3:9.1f} us (128-key blocks "
            f"{r['k6_block128_ms'] * 1e3:9.1f}; {rate})  plain "
            f"{r['plain_fwd_ms'] * 1e3:9.1f}  SDPA ({r['sdpa_backend']}) "
            f"{r['sdpa_fwd_ms'] * 1e3:8.1f}  bound {fb['bound_ms'] * 1e3:7.1f} ({fb['bound_by']}; "
            f"{fb['bound_f32_ms'] * 1e3:7.1f} at the f32 rate);  K7 {r['k7_ms'] * 1e3:9.1f} us "
            f"({rate7})  "
            f"plain {r['plain_bwd_ms'] * 1e3:9.1f}  SDPA forward+backward "
            f"{r['sdpa_fwd_bwd_ms'] * 1e3:8.1f}  bound {bb['bound_ms'] * 1e3:7.1f} "
            f"({bb['bound_by']}; {bb['bound_f32_ms'] * 1e3:7.1f} at the f32 rate)")
    results["flash_train_checks"] = {"cases": checks, "repeat_bitwise": True}
    results["flash_train_times"] = rows
    main = checks[0]["errors"]  # the finetune shape, bf16, fused: the path's
    own = {"flash_train_fwd": max(main[k][0] for k in ("out", "lse")),
           "flash_train_bwd": max(main[k][0] for k in ("dq", "dk", "dv"))}
    return own, rows


def sft_examples(np, n: int = 48, seed: int = 0):
    """SFT examples from the repository's own text (``repo_text_tokens``) as
    Llama's byte-fallback ids (byte + 3): lengths drawn from 1100..2600, the
    first quarter of each example's labels masked (-1)."""
    tokens, _ = repo_text_tokens(np)
    ids = tokens.astype(np.int64) + 3
    rng = np.random.default_rng(seed)
    examples, off = [], 0
    for _ in range(n):
        length = int(rng.integers(1100, 2601))
        if off + length > ids.size:
            off = 0
        x = ids[off:off + length]
        off += length
        labels = x.copy()
        labels[: length // 4] = -1
        examples.append({"input_ids": x, "labels": labels})
    return examples, ids.size


def finetune_step_vs_plain(torch, batch, dtype, seed: int = 1337) -> dict:
    """One step of the QLoRA model cut to 4 layers, kernels against plain=True:
    the loss and every LoRA gradient. lora_B is drawn (std 0.02) so that the
    deltas reach the output and lora_A gets a gradient; the NF4 absmax of the
    qkv weights is scaled so that the dequantized weights have a standard
    deviation of 1/sqrt(n_embd): q and k then have one of about 1 and the
    scores one of about 1."""
    from fastmax_tpu_torch.models import gpt, lora
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops.quant import dequantize, quantize_model
    from fastmax_tpu_torch.training.finetune import sft_loss_fn
    from fastmax_tpu_torch.training.step import tree_leaves

    cfg = Config.from_name("Llama-2-7b-hf", n_layer=4, attn_alg="quadratic")
    params = quantize_model(gpt.init_params(cfg, seed, dtype, "cuda"), "bnb.nf4")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    params = lora.add_lora_params(params, cfg, lora.LoRAConfig(r=8, alpha=16.0), gen, dtype)
    qkv = params["blocks"]["attn"]["attn"]
    w_std = float(dequantize({k: v[0] for k, v in qkv.items() if not k.startswith("lora")}).std())
    qkv["absmax"] = qkv["absmax"] * (cfg.n_embd ** -0.5 / w_std)
    qkv["lora_B"] = (torch.randn(qkv["lora_B"].shape, generator=gen, device="cuda")
                     * 0.02).to(dtype)
    mask = tree_leaves(lora.trainable_mask(params))
    res = {}
    for plain in (False, True):
        ps = clone_tree(params, False)
        leaves = tree_leaves(ps)
        for p, m in zip(leaves, mask):
            p.requires_grad_(m)
        loss = sft_loss_fn(cfg, plain=plain)(ps, batch)
        loss.backward()
        res[plain] = (float(loss.detach()), [p.grad for p, m in zip(leaves, mask) if m])
    loss_tol, grad_tol = FT_STEP_TOL[str(dtype)[6:]]
    loss_rel = abs(res[False][0] - res[True][0]) / abs(res[True][0])
    grad_rel = max(float((a.float() - b.float()).abs().max()) / max(float(b.float().abs().max()),
                                                                   1e-30)
                   for a, b in zip(res[False][1], res[True][1]))
    log(f"  one step, 4 layers, {str(dtype)[6:]}, kernels vs plain: loss {res[False][0]:.6f} vs "
        f"{res[True][0]:.6f} (rel {loss_rel:.2e}, tolerance {loss_tol}); worst LoRA gradient "
        f"leaf max|diff|/max|plain| {grad_rel:.2e} (tolerance {grad_tol})")
    if not (math.isfinite(res[False][0]) and loss_rel <= loss_tol and grad_rel <= grad_tol):
        raise AssertionError(f"kernels vs plain: loss rel {loss_rel}, grad rel {grad_rel}")
    return {"loss": [res[False][0], res[True][0]], "loss_rel": loss_rel,
            "worst_grad_rel": grad_rel, "qkv_weight_std_before": w_std}


def cut_model(name: str, n_layer: int) -> str:
    """A registry entry of ``name`` cut to ``n_layer`` layers (full width); its name."""
    from fastmax_tpu_torch.models.config import registry

    cut = f"{name}-{n_layer}-layers"
    registry()[cut] = {**registry()[name], "name": cut, "n_layer": n_layer}
    return cut


def qlora_run(torch, data, out, attn_alg, train, model_name="Llama-2-7b-hf") -> tuple:
    """``finetune.setup`` QLoRA on the full-width Llama-2-7B (random weights in
    bnb.nf4, bf16, LoRA r 8, alpha 16 on query and value) with ``attn_alg``
    over the SFT examples at ``data``: (state, {wall_s (setup included),
    step_s and tokens_per_s over steps 2 on, peak_gb above held_before_gb,
    the losses, max|lora_B|, the launch counts})."""
    import csv

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.utils.args import IOArgs

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    state = finetune.setup(method="lora", model_name=model_name, data_path=data,
                           quantize="bnb.nf4", attn_alg=attn_alg, precision="bfloat16",
                           lora_r=8, lora_alpha=16.0, lora_query=True, lora_value=True,
                           train=train, io=IOArgs(out_dir=out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    with open(out / "metrics.csv", newline="") as f:
        steps = {int(r["step"]): r for r in csv.DictReader(f)}
    last = train.max_iters
    dt = float(steps[last]["time"]) - float(steps[1]["time"])
    toks = float(steps[last]["tokens"]) - float(steps[1]["tokens"])
    moved = float(state.params["blocks"]["attn"]["attn"]["lora_B"].detach().float().abs().max())
    return state, {"steps": state.step, "wall_s": wall, "step_s": dt / (last - 1),
                   "tokens_per_s": toks / dt, "peak_gb": peak_gb, "held_before_gb": held / 1e9,
                   "launches": counts, "losses": [float(steps[i]["loss"]) for i in sorted(steps)],
                   "lora_b_max": moved}


def finetune_path(torch, results, card):
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.data.lm_datasets import SFTDataset
    from fastmax_tpu_torch.models import lora
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.training.fit import build_optimizer
    from fastmax_tpu_torch.training.step import tree_leaves
    from fastmax_tpu_torch.utils.args import TrainArgs
    from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint

    cfg = Config.from_name("Llama-2-7b-hf")
    examples, n_tokens = sft_examples(np)
    train = TrainArgs(global_batch_size=8, micro_batch_size=2, max_iters=FT_STEPS,
                      learning_rate=3e-4, save_interval=1000, log_interval=1,
                      max_seq_length=2048)
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "sft.npz"
        np.savez(data, examples=np.array(examples, dtype=object))
        log(f"  sft.npz: {len(examples)} examples of 1100-2600 tokens from {n_tokens} bytes of the "
            "repository's *.md/*.py files (those below 205)")
        out = Path(tmp) / "ft"
        state, run = qlora_run(torch, data, out, "quadratic", train)
        counts, losses, moved = run["launches"], run["losses"], run["lora_b_max"]
        mb = FT_STEPS * train.gradient_accumulation_iters()
        want = {"flash_train_fwd": 2 * cfg.n_layer * mb, "flash_train_bwd": cfg.n_layer * mb}
        _, delta = lora.split_lora_state(state.params)
        back = load_flat_checkpoint(out / "lora_weights.safetensors")
        flat = finetune._flatten(delta)
        same = sorted(back) == sorted(flat) and all(
            torch.equal(back[n], flat[n].detach().cpu()) for n in flat)
        log(f"  finetune.setup: {state.step} steps in {run['wall_s']:.2f} s (setup included); "
            f"steps 2-{FT_STEPS}: {run['step_s'] * 1e3:.1f} ms a step, "
            f"{run['tokens_per_s']:.1f} tokens/s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; peak "
            f"{run['peak_gb']:.3f} GB; max|lora_B| {moved:.3e}; "
            f"launches {counts} (want {want}); lora_weights.safetensors: {len(back)} tensors "
            f"read back {'equal' if same else 'DIFFERENT'}   [{card}]")
        if {k: counts[k] for k in want} != want:
            raise AssertionError(f"K6/K7 launches {counts} != {want}")
        if not all(math.isfinite(x) for x in losses) or not moved > 0 or not same:
            raise AssertionError(f"finetune: losses {losses}, max|lora_B| {moved}, "
                                 f"checkpoint read back {same}")
        run.update({"model": "Llama-2-7b-hf (random weights, seed 1337), bnb.nf4, bf16",
                    "lora": {"r": 8, "alpha": 16.0, "query": True, "value": True},
                    "checkpoint_read_back": same, "card": card})

        # one step's device time by kernel group, and the busy share
        trainable = lora.trainable_mask(state.params)
        ds = SFTDataset.load(data, 7)
        batches = [tuple(torch.as_tensor(x, device="cuda") for x in ds.sample_batch(2, 2048))
                   for _ in range(train.gradient_accumulation_iters())]
        loss_fn = finetune.sft_loss_fn(cfg)
        optimizer = build_optimizer(train, trainable)
        leaves = tree_leaves(state.params)
        mask = tree_leaves(trainable)

        def one_step():
            for p in leaves:
                p.grad = None
            for b in batches:
                loss_fn(state.params, b).backward()
            optimizer.update(state.params, [p.grad / len(batches) if m else None
                                            for p, m in zip(leaves, mask)], state.opt_state)

        one_step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof = profile_device(torch, one_step, "one finetune step (4 micro-batches)")
        prof["wall_ms"] = wall_ms
        prof["batch_t"] = [int(b[0].shape[1]) for b in batches]
        if prof["device_us"]:
            prof["busy_share"] = prof["device_us"] / 1e3 / wall_ms
        log(f"  one step (T {prof['batch_t']}): {wall_ms:.1f} ms on the host clock, device busy "
            f"share {prof.get('busy_share', 'not measured')}   [{card}]")
        run["profile_step"] = prof
        del state, leaves, optimizer, trainable
        gc.collect()
        torch.cuda.empty_cache()
        batch = batches[0]
        run["step_vs_plain"] = {str(dt)[6:]: finetune_step_vs_plain(torch, batch, dt)
                                for dt in (torch.bfloat16, torch.float32)}
    results["finetune"] = run
    return counts



def linear_scan_flops(bh: int, n: int, d: int, chunk: int, backward: bool) -> int:
    """The matmul operations of the reversible p = 2 scan on bh heads: a chunk's
    forward (q k^T and f(s) v: 2 C^2 D each; q s_kv, q s_kk and the
    contraction of q (q s_kkv) with q: 2 C D^2 each; q s_kkv: 2 C D^3) and its
    state update (k^T v and k^T k: 2 C D^2 each; kk^T v: 2 C D^3). The
    backward takes both again (the rewind and the re-run forward) and their
    VJPs, two products each: four times the forward in all."""
    c = chunk
    fwd = (n // c) * (4 * c * c * d + 10 * c * d * d + 4 * c * d ** 3)
    return bh * fwd * (4 if backward else 1)


def linear_rel(torch, what, got, ref, tol) -> float:
    """max|got - ref| / max|ref|; raises past ``tol`` or on a non-finite value."""
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    if got.shape != ref.shape or not bool(torch.isfinite(got).all()) or not rel <= tol:
        raise AssertionError(f"{what}: {rel:.3e} of the largest value (tolerance {tol})")
    return rel


def linear_op_check(torch, gen, results, card) -> dict:
    """(a) The port's masked fastmax at D = 128, the finetune shape, in f32 on
    the card (the reversible scan, head groups from ``_auto_head_groups``):
    output and q, k, v gradients against the same scan in float64, the output
    also against the O(N^2) formula in float64; the forward and the fwd+bwd
    times of one call (one layer of one micro-batch) by CUDA events, and their
    rate against the f32 data-sheet peak."""
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import fastmax as fm

    b, h, n, d = FT_SHAPE
    q, k, v, do = fastmax_qkv(torch, gen, FT_SHAPE, 2, torch.float32)
    z, chunk = 8.0 * math.sqrt(d), fm._auto_chunk(fm.DEFAULT_CHUNK, n)
    groups = fm._auto_head_groups(b, h, d, 2)

    def fwd_bwd(dtype):
        ts = [x.detach().to(dtype).requires_grad_(True) for x in (q, k, v)]
        if dtype == torch.float32:
            o = fm.fastmax(*ts, mask=True, p=2)
        else:  # the same scan the entry runs, in float64
            o = fm._masked_grouped(*ts, z, 2, chunk, None)
        o.backward(do.to(dtype))
        return [o.detach()] + [t.grad for t in ts]

    build.reset_launch_counts()
    got = fwd_bwd(torch.float32)
    torch.cuda.synchronize()
    fused = {k_: build.launch_counts()[k_] for k_ in FASTMAX_KERNELS}
    if any(fused.values()):
        raise AssertionError(f"fastmax at D = 128 launched the fastmax kernels: {fused}")
    ref = fwd_bwd(torch.float64)
    rel = {name: linear_rel(torch, f"fastmax D=128 {name} vs float64",
                            x, r, LINEAR_F32_REL["fwd" if name == "o" else "grad"])
           for name, x, r in zip(("o", "dq", "dk", "dv"), got, ref)}
    del ref
    with torch.no_grad():
        quad = torch.cat([fm.polynomial_attention_reference(*(x[:, i:i + 4].double()
                                                              for x in (q, k, v)), p=2)
                          for i in range(0, h, 4)], dim=1)
    rel["o vs O(N^2)"] = linear_rel(torch, "fastmax D=128 o vs the O(N^2) formula", got[0], quad,
                                    LINEAR_F32_REL["fwd"])
    del quad, got

    def fwd():
        with torch.no_grad():
            fm.fastmax(q, k, v, mask=True, p=2)

    def step():
        ts = [x.clone().requires_grad_(True) for x in (q, k, v)]
        fm.fastmax(*ts, mask=True, p=2).backward(do)

    fwd_ms, step_ms = time_ms(fwd, 3, warmup=1), time_ms(step, 3, warmup=1)
    flops = linear_scan_flops(b * h, n, d, chunk, backward=True)
    fwd_flops = linear_scan_flops(b * h, n, d, chunk, backward=False)
    row = {"shape": list(FT_SHAPE), "chunk": chunk, "head_groups": groups, "rel": rel,
           "tolerance": LINEAR_F32_REL, "fwd_ms": fwd_ms, "fwd_bwd_ms": step_ms,
           "fwd_flops": fwd_flops, "fwd_bwd_flops": flops,
           "fwd_tflops": fwd_flops / fwd_ms / 1e9, "fwd_bwd_tflops": flops / step_ms / 1e9,
           "share_of_f32_peak": flops / step_ms * 1e3 / F32_FLOPS_PER_S, "card": card}
    log(f"  (a) fastmax D=128 at B={b} H={h} N={n}, f32, chunk {chunk}, {groups} head groups: "
        "max|diff| / max|float64| " + ", ".join(f"{k_} {x:.3e}" for k_, x in rel.items())
        + f" (tolerances {LINEAR_F32_REL}); forward {fwd_ms:.2f} ms "
        f"({row['fwd_tflops']:.1f} TFLOP/s), forward + backward {step_ms:.2f} ms "
        f"({flops / 1e12:.3f} TFLOP of matmuls, {row['fwd_bwd_tflops']:.1f} TFLOP/s, "
        f"{row['share_of_f32_peak']:.3f} of the f32 data-sheet {F32_FLOPS_PER_S / 1e12:.0f})"
        f"   [{card}]")
    results["linear_op_check"] = row
    return row


def linear_finetune_path(torch, results, card, op_row):
    """(b) ``finetune.setup`` QLoRA on the full-width Llama-2-7B cut to
    LINEAR_FT_LAYERS layers (random weights in bnb.nf4, bf16, LoRA r 8 on query
    and value, T <= 2048, batch 8, micro-batch 2) with each linear arm, LINEAR_FT_STEPS steps each: step time,
    tokens/s, peak memory, the losses, lora_B moved, and no launch of K4-K7
    (at D = 128 no arm takes a kernel route in the reference). fastmax also:
    one micro-batch's host time, device time and busy share, and the part the
    scan's calls take (``linear_step_profile``)."""
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.utils.args import TrainArgs

    examples, _ = sft_examples(np)
    train = TrainArgs(global_batch_size=8, micro_batch_size=2, max_iters=LINEAR_FT_STEPS,
                      learning_rate=3e-4, save_interval=1000, log_interval=1,
                      max_seq_length=2048)
    banned = FASTMAX_KERNELS + ("flash_train_fwd", "flash_train_bwd")
    name = cut_model("Llama-2-7b-hf", LINEAR_FT_LAYERS)
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        data = Path(tmp) / "sft.npz"
        np.savez(data, examples=np.array(examples, dtype=object))
        for arm in LINEAR_ARMS:
            state, run = qlora_run(torch, data, Path(tmp) / arm, arm, train, name)
            run.update(arm=arm, card=card, layers=LINEAR_FT_LAYERS)
            counts, losses, moved = run["launches"], run["losses"], run["lora_b_max"]
            log(f"  (b) QLoRA Llama-2-7B cut to {LINEAR_FT_LAYERS} layers, {arm}: {state.step} steps in {run['wall_s']:.2f} s "
                f"(setup included); step {LINEAR_FT_STEPS}: {run['step_s']:.2f} s, "
                f"{run['tokens_per_s']:.1f} tokens/s; loss "
                f"{' -> '.join(f'{x:.4f}' for x in losses)}; peak {run['peak_gb']:.3f} GB above "
                f"{run['held_before_gb']:.3f} held; max|lora_B| {moved:.3e} "
                f"({'moved' if moved > 0 else 'NOT moved'}); K4-K7 launches "
                f"{ {k_: counts[k_] for k_ in banned} }   [{card}]")
            if any(counts[k_] for k_ in banned):
                raise AssertionError(f"{arm} at D = 128 launched K4-K7: {counts}")
            if not all(math.isfinite(x) for x in losses) or not moved > 0:
                raise AssertionError(f"{arm}: losses {losses}, max|lora_B| {moved}")
            if arm == "fastmax":
                run["profile_micro_batch"] = linear_step_profile(torch, state, data, op_row,
                                                                 card, name)
            out[arm] = run
            del state
    results["linear_finetune"] = out
    return out


def linear_step_profile(torch, state, data, op_row, card, name="Llama-2-7b-hf") -> dict:
    """One micro-batch of a fastmax QLoRA step (forward and backward of the
    loss on 2 examples, cut at T = 2048) on the host clock, then the same
    micro-batch profiled: device time and busy share. The window is a quarter
    of a step because a step issues ~1.6 M kernels, whose profile alone took
    minutes on an H100. The scan's part of it is estimated from the op
    check's times: each layer's call runs its forward twice under remat and
    its backward once, scaled by the matmul operations at the batch's length."""
    from fastmax_tpu_torch.data.lm_datasets import SFTDataset
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import fastmax as fm
    from fastmax_tpu_torch.training import finetune

    cfg = Config.from_name(name, attn_alg="fastmax")
    batch = tuple(torch.as_tensor(x, device="cuda")
                  for x in SFTDataset.load(data, 7).sample_batch(2, 2048))
    loss_fn = finetune.sft_loss_fn(cfg)

    def micro_batch():
        loss_fn(state.params, batch).backward()

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    micro_batch()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof = profile_device(torch, micro_batch, "one fastmax QLoRA micro-batch (2 examples)",
                          cpu=False)
    t = int(batch[0].shape[1])
    prof.update(wall_ms=wall_ms, batch_t=t)
    if prof["device_us"]:
        prof["busy_share"] = prof["device_us"] / 1e3 / wall_ms
    b, h, _, d = FT_SHAPE
    per_fwd = op_row["fwd_ms"] / op_row["fwd_flops"]
    per_bwd = (op_row["fwd_bwd_ms"] - op_row["fwd_ms"]) / (op_row["fwd_bwd_flops"]
                                                           - op_row["fwd_flops"])
    c = fm._auto_chunk(fm.DEFAULT_CHUNK, t)
    f = linear_scan_flops(b * h, t + (-t) % c, d, c, backward=False)
    prof["scan_ms_estimate"] = cfg.n_layer * (2 * f * per_fwd + 3 * f * per_bwd)
    prof["scan_share_of_wall"] = prof["scan_ms_estimate"] / wall_ms
    log(f"  (b) one fastmax QLoRA micro-batch (T {t}): {wall_ms:.1f} ms on the host clock, "
        f"device busy share {prof.get('busy_share', 'not measured')}, "
        f"{prof.get('kernel_launches', 0):.0f} kernels; the scan's calls "
        f"~{prof['scan_ms_estimate']:.1f} ms of it ({prof['scan_share_of_wall']:.3f}, from the "
        f"op check's times)   [{card}]")
    return prof


# ----------------------------------------------------------------- phase 10
NF4_ATOL, NF4_RTOL = 2e-4, 1e-4   # f32 x: the reference's own (test_quant_pallas.py:25)
# raw nibbles (s_t None) sum codes in [-8, 7] where the scaled path sums q * s / 8
# with s ~ 0.15: 64x the absolute rounding, so 64x the absolute tolerance
INT4_RAW_ATOL = 64 * INT4_ATOL
QSERVE_MODES = ("quantized", "preload_int4_block", "preload_int4", "preload_int8", "preload",
                "auto")
QSERVE_BATCH_NEW = 16             # new tokens a batcher request (32 before phase 20)
QSERVE_KERNELS = {"quantized": ("nf4_matmul", 3), "preload_int4_block": ("int4_block_matmul", 4),
                  "preload_int4": ("int4_rank1_matmul", 4), "auto": ("int4_rank1_matmul", 4)}
CORR_MIN = 0.95                   # re-representations vs quantized (test_quant_pallas.py:134)
# the linears of one block by (module, linear) path, and the config field of their input width
BLOCK_LINEARS = (("qkv", "attn", "attn", "n_embd"), ("attn_proj", "attn", "proj", "n_embd"),
                 ("fc_12", "mlp", "fc_12", "n_embd"), ("mlp_proj", "mlp", "proj",
                                                       "intermediate_size"))


def held(torch, what, got, ref, atol, rtol) -> float:
    """max|got - ref|; raises unless every element is within atol + rtol |ref|."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    if (got.shape != ref.shape or not bool(torch.isfinite(got).all())
            or bool((err > atol + rtol * ref.abs()).any())):
        raise AssertionError(f"{what}: max abs err {float(err.max()):.3e} (atol {atol}, rtol "
                             f"{rtol})")
    return float(err.max())


def nf4_case(torch, gen, k, n, m, dtype, kind="nf4", dq=False) -> float:
    """K8 against ``nf4_matmul_plain`` through ``quantized_matmul_pallas``
    on a random (k, n) kernel quantized on the card, x with mean 0.5."""
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.ops import quant_kernels as qk

    p = quant.quantize_4bit(torch.randn((k, n), generator=gen, device="cuda") * 0.05, kind,
                            double_quant=dq)
    x = (torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dtype)
    got = qk.quantized_matmul_pallas(x, p)
    ref = qk.quantized_matmul_pallas(x, p, plain=True)
    torch.cuda.synchronize()
    rtol = NF4_RTOL if dtype == torch.float32 else INT4_BF16_RTOL
    return held(torch, f"K8 {kind}{'-dq' if dq else ''} k={k} n={n} m={m} {str(dtype)[6:]} "
                f"({qk.nf4_path(m)})", got, ref, NF4_ATOL, rtol)


def nf4_repeats(torch, gen, k, n) -> None:
    """K8 at m = 8 gives the same bits on 3 runs (no float atomics), f32 and bf16 x."""
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.ops import quant_kernels as qk

    p = quant.quantize_4bit(torch.randn((k, n), generator=gen, device="cuda") * 0.05)
    x = torch.randn((N_SLOTS, k), generator=gen, device="cuda") + 0.5
    for xt in (x, x.to(torch.bfloat16)):
        first = qk.quantized_matmul_pallas(xt, p)
        for _ in range(2):
            if not torch.equal(qk.quantized_matmul_pallas(xt, p), first):
                raise AssertionError(f"K8 k={k} n={n} m={N_SLOTS} {xt.dtype}: a repeat differs")


@contextlib.contextmanager
def earlier_route(mod, kind):
    """A kernel's route as it was before its tensor-core path, on the module
    that routes it: K9 the FMA tile above m = 4 (``ops/quant_kernels``:
    ``TC_MAX_M`` set to ``GEMV_MAX_M``), K8 the gemv up to m = 8 and the FMA
    tile above (``NF4_GEMV_MAX_M`` and ``NF4_TC_MAX_M`` set to 8), K11 and K12
    the gemv at every m (``tools/lab_kernels``: ``LAB_TC_MAX_M`` set to
    ``LAB_GEMV_MAX_M``)."""
    if kind == "K9":
        values = {"TC_MAX_M": mod.GEMV_MAX_M}
    elif kind == "K8":
        values = {"NF4_GEMV_MAX_M": 8, "NF4_TC_MAX_M": 8}
    elif kind in ("K11", "K12"):
        values = {"LAB_TC_MAX_M": mod.LAB_GEMV_MAX_M}
    else:
        raise ValueError(f"{kind} has no tensor-core path")
    saved = {name: getattr(mod, name) for name in values}
    for name, value in values.items():
        setattr(mod, name, value)
    try:
        yield
    finally:
        for name, value in saved.items():
            setattr(mod, name, value)


# K9's timed calls by (m, x type): decode, the block batcher's step (f32 x), a short prefill
K9_LAYER_TIMES = ((1, "bf16"), (N_SLOTS, "bf16"), (N_SLOTS, "f32"), (64, "bf16"), (128, "bf16"))
# K8's: decode, the quantized batcher's step (f32 x), 16 rows, a 64-token prefill chunk, prefill
K8_LAYER_TIMES = ((1, "bf16"), (N_SLOTS, "bf16"), (N_SLOTS, "f32"), (16, "bf16"), (64, "bf16"),
                  (512, "bf16"))


def int4_block_weights(torch, gen, k, n) -> dict:
    """Blockwise int4 of a random (k, n) kernel quantized on the card, with
    random words in the rows k..k_pad (every nibble a code), so a kernel that
    lets them into the sum is seen: the reference zero-pads x there."""
    from fastmax_tpu_torch.ops import quant

    p = quant.quantize_int4_tiled(torch.randn((k, n), generator=gen, device="cuda") * 0.05,
                                  "block")
    pad = p["q4b"][:, :, k:, :]  # one k tile: quantize_int4_tiled packs k_pad rows at once
    pad.copy_(torch.randint(-2**31 + 1, 2**31 - 1, pad.shape, generator=gen, device="cuda",
                            dtype=torch.int32))
    return p


def int4_block_case(torch, gen, k, n, m, dtype, raw=False) -> float:
    """K9 against ``int4_matmul_tiled_plain`` on ``int4_block_weights``, x
    with mean 0.5; ``raw`` takes the raw nibbles of the same words (x padded
    to k_pad)."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    p = int4_block_weights(torch, gen, k, n)
    x = (torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dtype)
    rtol = INT4_RTOL if dtype == torch.float32 else INT4_BF16_RTOL
    if raw:
        xs = torch.nn.functional.pad(x, (0, p["q4b"].shape[0] * p["q4b"].shape[2] - k))
        got = qk.int4_matmul_tiled(xs, p["q4b"])
        ref = qk.int4_matmul_tiled(xs, p["q4b"], plain=True)
        atol, what = INT4_RAW_ATOL, "raw"
    else:
        got, ref = qk.int4_matmul_block(x, p), qk.int4_matmul_block(x, p, plain=True)
        atol, what = INT4_ATOL, "block"
    torch.cuda.synchronize()
    path = qk.int4_path(m, p["q4b"].shape[2])
    return held(torch, f"K9 {what} k={k} n={n} m={m} {str(dtype)[6:]} ({path})", got, ref, atol,
                rtol)


def int4_block_repeats(torch, gen, k, n) -> None:
    """K9 at m = 8 gives the same bits on 3 runs (no float atomics), f32 and bf16 x."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    p = int4_block_weights(torch, gen, k, n)
    x = torch.randn((N_SLOTS, k), generator=gen, device="cuda") + 0.5
    for xt in (x, x.to(torch.bfloat16)):
        first = qk.int4_matmul_block(xt, p)
        for _ in range(2):
            if not torch.equal(qk.int4_matmul_block(xt, p), first):
                raise AssertionError(f"K9 k={k} n={n} m={N_SLOTS} {xt.dtype}: a repeat differs")


def quant_times(torch, gen, kind, k, n, ms, card):
    """Device time a call (CUDA graph, weights cold: enough copies to exceed
    the 50 MB L2) of K8 or K9 at bf16 x, its plain version and dequantize +
    torch.matmul, with the call's bound; one row per m. Both also at f32 x and
    m = 8 (what the batchers launch). On the tensor-core path each is also
    timed on the route it took before (``earlier_route``: K9 the FMA tile; K8
    the gemv at m = 8, the FMA tile above), ``earlier_path`` and
    ``earlier_ms``."""
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.ops import quant_kernels as qk

    w = torch.randn((k, n), generator=gen, device="cuda") * 0.05
    if kind == "K8":
        p = quant.quantize_4bit(w)
        nbytes_w = k * n // 2 + k // 64 * n * 4 + 64
        fns = (qk.quantized_matmul_pallas,
               lambda x, p: qk.quantized_matmul_pallas(x, p, plain=True))
    else:
        p = quant.quantize_int4_tiled(w, "block")
        nbytes_w = p["q4b"].numel() * 4 + p["scale4"].numel() * 4
        fns = (qk.int4_matmul_block, lambda x, p: qk.int4_matmul_block(x, p, plain=True))
    del w
    copies = [p] + [{key: v.clone() for key, v in p.items()}
                    for _ in range(max(1, math.ceil(160e6 / nbytes_w)) - 1)]

    def path_of(m):
        return qk.int4_path(m, p["q4b"].shape[2]) if kind == "K9" else qk.nf4_path(m)

    rows = []
    cases = [(m, torch.bfloat16) for m in ms] + [(N_SLOTS, torch.float32)]
    for m, dt in cases:
        x = (torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dt)
        it = iter(range(10**9))

        def call(fn):
            return lambda: fn(x, copies[next(it) % len(copies)])

        kern_ms = graph_ms(call(fns[0]), calls=2 * len(copies))
        path = path_of(m)
        earlier_ms = earlier_path = None
        if path == "tc":
            with earlier_route(qk, kind):
                earlier_path = path_of(m)
                earlier_ms = graph_ms(call(fns[0]), calls=2 * len(copies))
        plain_ms = graph_ms(call(fns[1]), calls=len(copies), reps=1)
        deq_ms = graph_ms(call(lambda x, p: torch.matmul(x, quant.dequantize(p, x.dtype))),
                          calls=len(copies), reps=1)
        elem = x.element_size()
        rows.append({"kernel": kind, "k": k, "n": n, "m": m,
                     "x_dtype": "bf16" if dt == torch.bfloat16 else "f32", "path": path,
                     "ms": kern_ms, "earlier_path": earlier_path, "earlier_ms": earlier_ms,
                     "plain_ms": plain_ms,
                     "dequant_matmul_ms": deq_ms,
                     **bound(nbytes_w + m * k * elem + m * n * elem, 2 * m * k * n,
                             bf16=dt == torch.bfloat16)})
        r = rows[-1]
        if path == "tc" and dt == torch.float32:
            # f32 x runs on the tensor cores: read it against their f32 rate, and the
            # earlier route against the f32 units' (bound_f32_ms)
            tcb = tensor_core_f32_bound(r["flops"], r["bytes"])
            r.update(bound_ms=tcb["bound_tc_f32_ms"], bound_by=tcb["bound_tc_f32_by"])
        earlier = (f" (earlier route: {earlier_path} {earlier_ms * 1e3:8.1f} us)"
                   if earlier_ms is not None else "")
        log(f"  {kind} k={k:5d} n={n:5d} m={m:3d} {r['x_dtype']:4s}: kernel"
            f" {path} {kern_ms * 1e3:8.1f} us{earlier}  plain "
            f"{plain_ms * 1e3:8.1f} us  dequantize + matmul {deq_ms * 1e3:8.1f} us  bound "
            f"{r['bound_ms'] * 1e3:6.1f} us ({r['bound_by']}; {r['bound_f32_ms'] * 1e3:6.1f} us "
            f"at the f32 rate)   [{card}]")
    return rows


def check_quant_kernels(torch, gen, results):
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import quant

    from fastmax_tpu_torch.ops import quant_kernels as qk

    worst = {"nf4_matmul": 0.0, "int4_block_matmul": 0.0}
    for name, k, n in LLAMA7B_LINEARS[:3]:  # mlp.proj (k = 11008) is not K8's: below
        for m in (1, N_SLOTS, 16, 64, 512):
            errs = [nf4_case(torch, gen, k, n, m, dt) for dt in (torch.float32, torch.bfloat16)]
            worst["nf4_matmul"] = max(worst["nf4_matmul"], *errs)
            log(f"  K8 {name:9s} k={k:5d} n={n:5d} m={m:3d} ({qk.nf4_path(m)}): ok, max abs err "
                f"f32 {errs[0]:.3e} bf16 {errs[1]:.3e}")
    # k = 11008 (172 quant blocks), where a warp of the tensor-core kernel takes several
    # blocks of a split; an odd block count with n % 128 != 0; double-quant scales; FP4
    for args, label in (((11008, 4096, N_SLOTS, torch.float32), "nf4"),
                        ((1088, 3000, N_SLOTS, torch.float32), "nf4"),
                        ((4096, 12288, N_SLOTS, torch.float32), "nf4 double-quant"),
                        ((4096, 12288, N_SLOTS, torch.float32), "fp4"),
                        ((4096, 12288, 1, torch.float32), "fp4"),
                        ((4096, 4096, 64, torch.bfloat16), "fp4")):
        err = nf4_case(torch, gen, *args, kind="fp4" if label == "fp4" else "nf4",
                       dq=label.endswith("quant"))
        worst["nf4_matmul"] = max(worst["nf4_matmul"], err)
        log(f"  K8 {label} k={args[0]} n={args[1]} m={args[2]} {str(args[3])[6:]} "
            f"({qk.nf4_path(args[2])}): ok, max abs err {err:.3e}")
    nf4_repeats(torch, gen, 4096, 12288)
    log(f"  K8 qkv m={N_SLOTS} ({qk.nf4_path(N_SLOTS)}): 3 runs bit for bit, f32 and bf16")
    # the model's route at mlp.proj (k = 11008): not pallas_eligible, so dequantize + matmul
    quant.set_quant_backend("pallas")
    p = quant.quantize_4bit(torch.randn((11008, 4096), generator=gen, device="cuda") * 0.05)
    x = (torch.randn((1, 11008), generator=gen, device="cuda") + 0.5).to(torch.bfloat16)
    before = build.KERNELS["nf4_matmul"].launches
    got = quant.quantized_matmul(x, p)
    if build.KERNELS["nf4_matmul"].launches != before or logits_rel(
            torch, got.float(), torch.matmul(x, quant.dequantize(p, x.dtype)).float()) > 1e-3:
        raise AssertionError("K8 route: mlp.proj (k = 11008) did not take dequantize + matmul")
    log("  K8 route at mlp.proj (k=11008 n=4096): dequantize + matmul, no launch, as the "
        "reference")
    for name, k, n in LLAMA7B_LINEARS:
        for m in (1, N_SLOTS, 64, 128):
            errs = [int4_block_case(torch, gen, k, n, m, dt)
                    for dt in (torch.float32, torch.bfloat16)]
            worst["int4_block_matmul"] = max(worst["int4_block_matmul"], *errs)
            log(f"  K9 {name:9s} k={k:5d} n={n:5d} m={m:3d}: ok, max abs err f32 {errs[0]:.3e} "
                f"bf16 {errs[1]:.3e}")
    # a true k that is not a multiple of 16 (k_pad 1536): the tensor-core kernel's last
    # 16-row step runs past k into random words
    for m in (N_SLOTS, 64):
        errs = [int4_block_case(torch, gen, 1100, 3000, m, dt)
                for dt in (torch.float32, torch.bfloat16)]
        worst["int4_block_matmul"] = max(worst["int4_block_matmul"], *errs)
        log(f"  K9 ragged k= 1100 n= 3000 m={m:3d}: ok, max abs err f32 {errs[0]:.3e} bf16 "
            f"{errs[1]:.3e}")
    for m in (1, N_SLOTS, 64):
        err = int4_block_case(torch, gen, 4096, 4096, m, torch.float32, raw=True)
        log(f"  K9 raw nibbles (s_t None) k=4096 n=4096 m={m}: ok, max abs err {err:.3e}")
    int4_block_repeats(torch, gen, 4096, 12288)
    log(f"  K9 qkv m={N_SLOTS}: 3 runs bit for bit, f32 and bf16")
    card = card_line()
    rows = []
    for name, k, n in LLAMA7B_LINEARS[:3]:
        rows += [dict(r, shape=name) for r in quant_times(torch, gen, "K8", k, n,
                                                          (1, N_SLOTS, 16, 64, 512), card)]
    for name, k, n in LLAMA7B_LINEARS:
        rows += [dict(r, shape=name) for r in quant_times(torch, gen, "K9", k, n,
                                                          (1, N_SLOTS, 64, 128), card)]
    for kind, times, what in (("K8", K8_LAYER_TIMES, "qkv, attn.proj and fc_12"),
                              ("K9", K9_LAYER_TIMES, "a layer's 4 linears")):
        for m, xdt in times:
            layer = [r for r in rows
                     if r["kernel"] == kind and r["m"] == m and r["x_dtype"] == xdt]
            earlier = (f", earlier route: {layer[0]['earlier_path']} "
                       f"{sum(r['earlier_ms'] for r in layer) * 1e3:.1f} us"
                       if layer[0]["earlier_ms"] is not None else "")
            log(f"  {kind} {what}, m={m:3d} {xdt}: {layer[0]['path']} "
                f"{sum(r['ms'] for r in layer) * 1e3:.1f} us{earlier}, bound "
                f"{sum(r['bound_ms'] for r in layer) * 1e3:.1f} us (at the f32 rate "
                f"{sum(r['bound_f32_ms'] for r in layer) * 1e3:.1f} us)   [{card}]")
    results["quant_kernel_times"] = rows
    results["quant_kernel_max_abs_err"] = worst
    return worst, rows


def logits_rel(torch, a, b) -> float:
    if not (bool(torch.isfinite(a).all()) and bool(torch.isfinite(b).all())):
        raise AssertionError("non-finite logits")
    return float((a - b).abs().max() / b.abs().max())


def with_f32_activations(torch, params: dict) -> dict:
    """The tree with its bf16 embedding, lm_head and norm weights in float32, so
    that the forward's activations are float32; the block linears are the same
    tensors."""
    def walk(node, path):
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if node.dtype == torch.bfloat16 and not (path[0] == "blocks" and path[-1] == "kernel"):
            return node.float()
        return node

    return walk(params, ())


def kernels_vs_plain(torch, engine, prompt, step_token, moved=None):
    """The engine's prefill logits and first decode step's (at the prompt's length),
    kernels against plain=True, both steps on the same token (``step_token``, else the
    first route's first token). With ``moved`` (a stand-in for ``gpt.linear``), the first
    route is plain=True with it in place. Returns ({step: max|diff|/max|plain|}, {step:
    mean|diff|/mean|plain|}, the first route's (prefill logits, step logits, token))."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.ops.sampling import sample

    cmp, tok, real, prompt = {}, step_token, gpt.linear, prompt.cuda()
    for plain in (False, True):
        if moved is not None and not plain:
            gpt.linear = moved
        try:
            cache = engine.new_cache()
            logits, cache = engine.prefill(prompt[None], cache, plain=plain or moved is not None)
            tok = sample(logits) if tok is None else tok
            with torch.inference_mode():
                step, _ = engine._forward(tok[:, None], cache, prompt.numel(),
                                          plain=plain or moved is not None)
        finally:
            gpt.linear = real
        cmp[plain] = (logits.float(), step[:, -1].float(), tok)
        del cache
    pairs = {name: (cmp[False][i], cmp[True][i]) for i, name in enumerate(("prefill",
                                                                          "decode_step"))}
    rel = {name: logits_rel(torch, a, b) for name, (a, b) in pairs.items()}
    mean = {name: float((a - b).abs().mean() / b.abs().mean()) for name, (a, b) in pairs.items()}
    return rel, mean, cmp[False]


def serve_mode(torch, cfg, nf4, mode, prompt, step_token, probe, card) -> tuple:
    """``InferenceEngine`` over the NF4 tree in ``mode``: generate with exact
    launch counts, TTFT, decode tok/s, peak memory; prefill and first decode
    step logits, kernels against plain=True. Returns the measures, the
    kernels' logits (the decode step takes ``step_token`` where given) and
    layer 0's four linears applied to ``probe`` (inputs by width)."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.ops.linear import linear
    from fastmax_tpu_torch.ops.sampling import sample

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    quant.LAST_AUTOTUNE.clear()
    t0 = time.perf_counter()
    engine = InferenceEngine(cfg, nf4, max_seq_length=1024, weights_mode=mode,
                             cache_dtype=torch.int8)
    torch.cuda.synchronize()
    out = {"mode": mode, "prepare_s": time.perf_counter() - t0}
    if mode == "quantized":
        if not quant.LAST_AUTOTUNE:
            raise AssertionError("the engine ran no autotune on the card")
        tune = dict(quant.LAST_AUTOTUNE, choice=quant.get_quant_backend())
        log(f"  autotune on the largest linear (k={tune['k']}, n={tune['n']}, m=1, {tune['iters']} "
            f"calls each): K8 {tune['pallas_s'] * 1e3:.3f} ms, dequantize + matmul "
            f"{tune['xla_s'] * 1e3:.3f} ms -> {tune['choice']!r}   [{card}]")
        log("  backend set to 'pallas' for the timed run, so that K8 is on the path")
        quant.set_quant_backend("pallas")
        out["autotune"] = tune
    # 64 new tokens for the two kernels' modes (128 until the script neared its time limit)
    n_new = 64 if mode in ("quantized", "preload_int4_block") else 32
    build.reset_launch_counts()
    t0 = time.perf_counter()
    gen = engine.generate(prompt, 64 + n_new)
    torch.cuda.synchronize()
    out["generate_s"] = time.perf_counter() - t0
    counts = build.launch_counts()
    if tuple(gen.shape) != (1, 64 + n_new):
        raise AssertionError(f"{mode}: generate returned shape {tuple(gen.shape)}")
    if counts["int8_decode_attention"] <= 0:
        raise AssertionError(f"{mode}: K2 was never launched: {counts}")
    if mode in QSERVE_KERNELS:  # one prefill forward and n_new - 1 decode steps
        name, per_layer = QSERVE_KERNELS[mode]
        want = per_layer * cfg.n_layer * n_new
        if counts[name] != want:
            raise AssertionError(f"{mode}: {name} launched {counts[name]} times, not {want}")
    ttft = []
    for _ in range(3):
        cache = engine.new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompt[None].cuda(), cache)
        first = sample(logits)
        first.cpu()
        ttft.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    dec, _ = engine.decode(cache, first, 64, n_new)
    dec.cpu()
    tok_s = (dec.shape[1] - 1) / (time.perf_counter() - t0)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    # kernels vs plain: in the path's bf16, reported (a random 32-layer model carries a
    # one-ulp difference of a linear's output into the logits with a gain of ~15), and
    # gated with float32 activations, where both routes differ by their sums' order only
    rel, _, kern = kernels_vs_plain(torch, engine, prompt, step_token)
    saved, engine.params = engine.params, with_f32_activations(torch, engine.params)
    rel32, _, _ = kernels_vs_plain(torch, engine, prompt, kern[2])
    engine.params = saved
    if max(rel32.values()) > LOGITS_REL_TOL:
        raise AssertionError(f"{mode}: f32 logits kernels vs plain differ beyond "
                             f"{LOGITS_REL_TOL}: {rel32} (bf16: {rel})")
    out.update(new_tokens=n_new, launches=counts, ttft_ms=min(ttft), ttft_ms_all=ttft,
               decode_tok_s=tok_s, peak_gb=peak_gb, held_before_gb=base / 1e9,
               logits_kernels_vs_plain={"bf16": rel, "f32": rel32},
               first16=gen[0, 64:80].tolist(), card=card)
    log(f"  {mode:18s}: prepare {out['prepare_s']:.2f} s; generate(64 + {n_new}) "
        f"{out['generate_s']:.2f} s; TTFT {min(ttft):.2f} ms; decode {tok_s:.2f} tok/s; peak "
        f"{peak_gb:.3f} GB above {base / 1e9:.3f} held; launches "
        f"{ {k: v for k, v in counts.items() if v} }; logits kernels vs plain, max|diff|/"
        f"max|plain|: f32 prefill {rel32['prefill']:.3e}, decode step "
        f"{rel32['decode_step']:.3e} (tolerance {LOGITS_REL_TOL}); bf16 {rel['prefill']:.3e}, "
        f"{rel['decode_step']:.3e}   [{card}]")
    if mode in ("quantized", "preload_int4_block"):
        out["profile_decode"] = profile_decode(torch, engine, first, tok_s)
    with torch.inference_mode():
        lin = {name: linear(engine.params["blocks"][mod][sub], probe[width], 0).float()
               for name, mod, sub, width in BLOCK_LINEARS}
    del engine, cache
    return out, kern, lin


def batcher_paths(torch, batcher, kind, card) -> dict:
    """An 8-slot batcher's decode step (m = 8) on each path of its kernel,
    ``kind`` "K9" (the block batcher) or "K8" (the quantized one): the tensor
    cores, and the route the kernel took at m = 8 before (``earlier_route``;
    K9: the FMA tile, K8: the gemv). For each, in turns (the earlier route
    first): one decode step at every slot's position 255 + QSERVE_BATCH_NEW (the
    last of phase 10's batchers: 256-token prompts and QSERVE_BATCH_NEW new
    tokens) profiled (device µs by
    kernel group), and 8 steps back to back on the host clock, with the
    device's busy share: whether a cut in the kernel's time can reach tok/s or
    the host hides it."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    pos = 255 + QSERVE_BATCH_NEW
    toks = torch.ones(N_SLOTS, dtype=torch.int32, device="cuda")
    posv = torch.full((N_SLOTS,), pos, dtype=torch.int32, device="cuda")
    temps0 = torch.zeros(N_SLOTS, device="cuda")
    topk0 = torch.full((N_SLOTS,), 32000, device="cuda")
    group = "K9 int4_block_matmul" if kind == "K9" else "K8 nf4_matmul"
    which = "block" if kind == "K9" else "quantized"
    out = {}
    for path in (("fma", "tc") if kind == "K9" else ("gemv", "tc")):
        route = earlier_route(qk, kind) if path != "tc" else contextlib.nullcontext()
        with route, torch.inference_mode():
            prof = profile_device(torch, lambda: batcher._decode_step(
                toks, posv, temps0, topk0, False), f"one decode step of the {which} batcher "
                f"at {N_SLOTS} slots, positions {pos}, {kind} on the {path} path")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(8):
                batcher._decode_step(toks, posv, temps0, topk0, False)
            torch.cuda.synchronize()
        prof.update(path=path, kernel=kind, wall_ms_per_step=(time.perf_counter() - t0) / 8 * 1e3)
        if prof["device_us"]:
            prof["busy_share"] = prof["device_us"] / 1e3 / prof["wall_ms_per_step"]
            prof["kernel_us"] = prof["by_group_us"][group]
        log(f"  {which} batcher, {kind} {path}: a decode step "
            f"{prof['wall_ms_per_step']:.2f} ms on the host clock, "
            f"{prof['device_us'] if prof['device_us'] is None else round(prof['device_us'], 1)} "
            f"us of device time ({kind} {prof.get('kernel_us', 'not measured')} us, busy share "
            f"{prof.get('busy_share', 'not measured')})   [{card}]")
        out[path] = prof
    return out


def batcher_mode(torch, cfg, nf4, mode, prompts, n_new, card, cache_dtype=None,
                 plain: bool = False, against: dict | None = None,
                 held: bool = True, paths: bool = False) -> dict:
    """An 8-slot ``ContinuousBatcher`` over the NF4 tree (float32
    activations; a dense cache, or ``cache_dtype``) in ``mode`` serving
    ``prompts`` (one batched admission wave, then decode at m = 8), through
    the kernels or, with ``plain``, their plain versions; its first-token
    logits and greedy tokens against ``InferenceEngine``'s (the kernels, m =
    1, the same cache type) on the same weights: a divergence beyond a
    near-tie raises. With ``against`` (another run's tokens by request id),
    the tokens are held to those under the near-tie rule instead, and the
    engine's are only reported; ``held=False`` only reports. ``paths`` adds
    ``batcher_paths`` after the checks."""
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.ops import quant

    gc.collect()
    torch.cuda.empty_cache()
    batcher = ContinuousBatcher(cfg, nf4, n_slots=N_SLOTS, max_seq_length=1024,
                                weights_mode=mode, cache_dtype=cache_dtype, plain=plain)
    if mode == "quantized":
        quant.set_quant_backend("pallas")
    build.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [batcher.submit(p, n_new) for p in prompts]
    res = batcher.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    name = QSERVE_KERNELS[mode][0]
    route = (f"f32, {'int8' if cache_dtype == torch.int8 else 'dense'} cache"
             + (", plain versions" if plain else ""))
    if plain and any(counts.values()):
        raise AssertionError(f"batcher {mode}, plain: kernels were launched: {counts}")
    if not plain and counts[name] <= 0:
        raise AssertionError(f"batcher {mode}: {name} was never launched: {counts}")
    engine = InferenceEngine(cfg, batcher.params, max_seq_length=1024, weights_mode="quantized",
                             cache_dtype=cache_dtype)
    quant.set_quant_backend("pallas")  # the engine's autotune may have picked "xla"
    with torch.inference_mode():  # a whole-prompt prefill's first-token logits, vs the engine's
        seq = torch.as_tensor(prompts[0], dtype=torch.int32, device="cuda")[None]
        eng_logits = engine.prefill(seq, engine.new_cache())[0][0].float()
        bat_logits = batcher_prefill(torch, gpt, batcher, seq, 0, fresh_row(torch, batcher),
                                     plain=plain)[0].float()
    first_rel = logits_rel(torch, bat_logits, eng_logits)
    if first_rel > LOGITS_REL_TOL:
        raise AssertionError(f"batcher {mode}: first-token logits differ from the engine's by "
                             f"{first_rel}")
    checks, vs_other = [], []
    for rid, p in zip(rids, prompts):
        want = engine.generate(torch.as_tensor(p), len(p) + n_new)[0, len(p):].tolist()
        div = first_divergence(torch, engine, p, want, res[rid])
        checks.append(div)
        if against is not None:
            div = first_divergence(torch, engine, p, against[rid], res[rid])
            vs_other.append(div)
        if held and div is not None and not div[1] <= NEAR_TIE_REL * div[2]:
            raise AssertionError(f"batcher {mode} ({route}), against "
                                 f"{'the other run' if against else 'the engine'}: request "
                                 f"{rid} diverges beyond a near-tie: {div}")
    tok_s = len(prompts) * n_new / wall
    log(f"  batcher {mode:18s} ({route}): {len(prompts)} requests x {n_new} new "
        f"tokens in {wall:.2f} s "
        f"({tok_s:.1f} tok/s, prefill included; {batcher.batched_admissions} admitted in "
        f"batched waves); launches { {k: v for k, v in counts.items() if v} }; first-token "
        f"logits vs the engine's {first_rel:.3e}; tokens == engine's for "
        f"{sum(d is None for d in checks)} of {len(checks)}; the rest (step, top-2 margin, "
        f"max|logit|): {[d for d in checks if d is not None]}"
        + (f"; tokens == the other run's for {sum(d is None for d in vs_other)} of "
           f"{len(vs_other)} {[d for d in vs_other if d is not None]}" if against else "")
        + f"   [{card}]")
    by_path = (batcher_paths(torch, batcher, "K9" if mode == "preload_int4_block" else "K8",
                             card) if paths else None)
    del batcher, engine
    return {"mode": mode, "route": route, "wall_s": wall, "tok_s": tok_s, "launches": counts,
            "first_logits_rel": first_rel, "divergences": checks, "vs_other": vs_other,
            "tokens": res, "by_path": by_path, "card": card}


def quant_serving_path(torch, results, card):
    import numpy as np

    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import quant

    cfg = Config.from_name("Llama-2-7b-hf", n_layer=LAYERS_7B)
    cfg.block_size = 1024
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    dense = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
    nf4 = quant.quantize_model(dense, "bnb.nf4")
    del dense
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    log(f"  random bf16 Llama-2-7B (seed 0) at full width cut to {LAYERS_7B} of its 32 layers, "
        f"quantized to bnb.nf4 on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB held")
    rng = np.random.default_rng(0)
    prompt = torch.as_tensor(rng.integers(1, 32000, 64), dtype=torch.int32)
    gen = torch.Generator(device="cuda").manual_seed(5)
    probe = {w: (torch.randn((N_SLOTS, getattr(cfg, w)), generator=gen, device="cuda")
                 + 0.5).to(torch.bfloat16) for w in ("n_embd", "intermediate_size")}
    modes, logits, lin = {}, {}, {}
    counts = {}
    step_token = None
    for mode in QSERVE_MODES:
        modes[mode], logits[mode], lin[mode] = serve_mode(torch, cfg, nf4, mode, prompt,
                                                          step_token, probe, card)
        step_token = logits["quantized"][2]
        for k, v in modes[mode]["launches"].items():
            counts[k] = counts.get(k, 0) + v

    # Each mode against "quantized": layer 0's linears on the probe (gated: preload within
    # LOGITS_REL_TOL, the re-representations at a correlation above CORR_MIN) and the
    # 32-layer logits (reported: a random model carries a weight error into them with a
    # gain that grows with depth; on the CPU at width 512, block int4 fell from a
    # correlation of 0.95 at 2 layers to 0.09 at 32)
    def compare(mode):
        row = {}
        pairs = [(name, lin[mode][name], lin["quantized"][name]) for name, *_ in BLOCK_LINEARS]
        pairs += [(f"logits {name}", logits[mode][i], logits["quantized"][i])
                  for i, name in enumerate(("prefill", "decode_step"))]
        for name, a, b in pairs:
            corr = float(torch.corrcoef(torch.stack([a.reshape(-1), b.reshape(-1)]))[0, 1])
            row[name] = {"rel": logits_rel(torch, a, b), "corr": corr}
            if name.startswith("logits"):
                row[name]["top1_agree"] = bool(a.argmax() == b.argmax())
        return row

    rerep = {mode: compare(mode) for mode in ("preload", "preload_int4", "preload_int4_block",
                                              "preload_int8")}
    for mode, row in rerep.items():
        log(f"  {mode} vs quantized, max|diff|/max|quantized| and correlation: " + "; ".join(
            f"{n} {r['rel']:.3e} {r['corr']:.6f}"
            + (f" top-1 {'same' if r['top1_agree'] else 'different'}" if "top1_agree" in r
               else "") for n, r in row.items()))
        layer0 = [r for n, r in row.items() if not n.startswith("logits")]
        if mode == "preload" and max(r["rel"] for r in layer0) > LOGITS_REL_TOL:
            raise AssertionError(f"preload and quantized differ beyond {LOGITS_REL_TOL}: {row}")
        if min(r["corr"] for r in layer0) <= CORR_MIN:
            raise AssertionError(f"{mode} correlates with quantized at {row}")
    rel = {n: rerep["preload"][f"logits {n}"]["rel"] for n in ("prefill", "decode_step")}
    # the batcher with float32 activations and a dense cache: its greedy tokens are held to
    # the engine's, and a one-ulp bf16 difference between their routes (m = 8 against m = 1,
    # a wave prefill against one prompt), or an int8 cache code it flips, moves a random
    # 7B's logits by several per cent
    batch_prompts = [rng.integers(1, 32000, 256).astype(np.int32) for _ in range(N_SLOTS)]
    nf4_f32 = with_f32_activations(torch, nf4)
    batchers = [batcher_mode(torch, cfg, nf4_f32, mode, batch_prompts, QSERVE_BATCH_NEW, card,
                             paths=True)
                for mode in ("quantized", "preload_int4_block")]
    # the blockwise-int4 batcher under the int8 cache: the kernels against the plain versions
    # (the same m = 8 route) under the near-tie rule; against the engine (m = 1) reported: an
    # f32 rounding difference there flips an int8 cache code now and then, and a random 7B
    # carries it to another token (a reference hazard, ROADMAP.md)
    plain_int8 = batcher_mode(torch, cfg, nf4_f32, "preload_int4_block", batch_prompts,
                              QSERVE_BATCH_NEW, card,
                              cache_dtype=torch.int8, plain=True, held=False)
    batchers += [plain_int8, batcher_mode(torch, cfg, nf4_f32, "preload_int4_block",
                                          batch_prompts, QSERVE_BATCH_NEW, card,
                                          cache_dtype=torch.int8,
                                          against=plain_int8["tokens"])]
    del nf4_f32
    for b in batchers:
        for k, v in b["launches"].items():
            counts[k] = counts.get(k, 0) + v
    results["quant_serving"] = {
        "model": f"Llama-2-7b-hf (random bf16 weights, seed 0, {LAYERS_7B} of 32 layers) "
                 "quantized to bnb.nf4, int8 KV "
                 "cache, block_size 1024, 64-token prompt",
        "modes": modes, "preload_vs_quantized": rel, "rerep_vs_quantized": rerep,
        "batchers": batchers, "launches": counts, "card": card}
    del nf4
    gc.collect()
    torch.cuda.empty_cache()
    return counts


# ----------------------------------------------------------------- phase 11
# K10-K13 against their plain versions. Both round where the reference rounds
# (x, code values and v10's weights to bf16; each weight's scale in f32), and
# every product of bf16 operands is exact in f32, so on K10 and on K11's and
# K12's gemv (m <= 4) they differ by the order of f32 sums alone. K11's and
# K12's tensor-core kernels (4 < m <= 64) add two things. f32 operands go in as
# bf16 parts: K12's f32 x in three, exactly; K11's f32 NF4 values in three and
# its f32 x in two, of which x1 c1, x2 c0 and the smaller products are dropped
# (each within 2^-17 of |x c|). And where the reference scales each weight (v1,
# v2, v6, v8, v9), the scale multiplies each 64-row block's f32 sum instead,
# which changes only the f32 rounding of c * s. The gate: each output within
# 2e-5 of the largest |plain| plus 2e-4 of its own (on the H100, on the gemv: at
# most 2e-6 of the largest; a v10 that skips its product's rounding lies 4e-4
# of the largest off, inside the CPU tests' reference tolerance of 2e-4 / 2e-3;
# tests/test_torch_lab_tc.py holds an emulation of the tensor-core sums within
# it). The probes bit for bit. A probe that reads faster than 105 % of the
# data-sheet memory rate did not read what it claims.
LAB_ATOL, LAB_RTOL = 2e-5, 2e-4
PROBE_RATE_MAX = 1.05 * HBM_BYTES_PER_S
LAB_MODES = {"K10": ("raw",), "K11": ("v1", "v5", "v6", "v7"),
             "K12": ("v8", "v9", "v10", "v11"), "K13": ("stream_ref", "stream_bytes")}
LAB_KERNEL = {"K10": "int4_tiled_bf16", "K11": "q4_byte_matmul",
              "K12": "int4_colnibble_matmul", "K13": "stream_probe"}
LAB_BF16 = {"raw", "v5", "v7", "v10", "v11"}  # bf16 operands: the tensor-core rate bounds them
# error lines a lab main prints where the reference itself fails on the shape (an assert, a
# packer's tile that does not divide k_pad, v wider than the words' column tiles), or where
# the weights it draws have another k tile than the call halves to (k = 11008, a reference
# hazard: the port checks the shapes)
LAB_REFERENCE_ERRORS = {
    "int4_opt_r04": {("tk2048", 11008, 4096)},
    "int4_opt_r05": {("tk2048", 11008, 4096)},
    "nf4_lab_r04": {(v, 4096, 22016) for v in ("v8", "v9", "v10", "v11", "v12", "v12b")}
    | {(v, 11008, 4096) for v in ("v9t", "v12", "v12b")},
}
LAB_PLAIN_IMPLS = {"xla", "bf16", "int8", "int4", "nf4_xla"}
# K11's and K12's tensor-core checks: the rows of x, and the shapes: qkv, mlp.proj (k =
# 11008, where a warp takes several 64-row blocks of its split) and a ragged one (k =
# 1088: 17 blocks, an odd count; K11 at n = 3000, a partial 256-column tile)
LAB_TC_M = (5, N_SLOTS, 16, 64)
LAB_TC_SHAPES = {"K11": (LLAMA7B_LINEARS[0], LLAMA7B_LINEARS[3], ("ragged", 1088, 3000)),
                 "K12": (LLAMA7B_LINEARS[0], LLAMA7B_LINEARS[3], ("ragged", 1088, 3072))}


def lab_setup(torch, gen, kernel, variant, k, n, m, tile_k=None) -> dict:
    """Inputs of one lab kernel mode at (k, n, m) on the card, x with mean 0.5,
    codes uniform, absmax 0.01-0.03: {"w": weights, "x", "call": (x, w, plain)
    -> output, "f64": (x, w) -> float64 yardstick or None, bytes of w, bytes
    of x and the output, flops, bf16, exact}. ``tile_k``: K10's words packed in
    k tiles of that many rows (gk > 1)."""
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.tools import int4_opt_r05 as t05
    from fastmax_tpu_torch.tools import lab_kernels as lk
    from fastmax_tpu_torch.tools import nf4_lab_r04 as tlab
    from fastmax_tpu_torch.tools import nf4_variants_r04 as tv

    dev = "cuda"

    def absmax(rows, cols):
        return torch.rand((rows, cols), generator=gen, device=dev) * 0.02 + 0.01

    def xin(cols):
        return torch.randn((m, cols), generator=gen, device=dev) + 0.5

    out = {"bf16": variant in LAB_BF16, "exact": kernel == "K13", "f64": None}
    if kernel == "K10":
        codes = torch.randint(-8, 8, (k, n), generator=gen, device=dev, dtype=torch.int8)
        w = {"pw": quant.pack_int4_tiled(codes, tile_k)}
        k_pad, n_pad = w["pw"].shape[0] * w["pw"].shape[2], w["pw"].shape[1] * 1024
        x = torch.nn.functional.pad(xin(k), (0, k_pad - k))
        out.update(call=lambda x, w, plain: lk.int4_tiled_bf16(x, w["pw"], plain=plain),
                   f64=lambda x, w: x.to(torch.bfloat16).double() @ quant._unpack_int4_tiled(
                       w["pw"]).double(),
                   io=m * k_pad * 2 + m * n_pad * 4, flops=2 * m * k_pad * n_pad)
    elif kernel == "K11":
        w = {"q4": torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint8), "absmax": absmax(k // 64, n)}
        x = xin(k)
        getter = tv.get_int4 if variant in ("v6", "v7") else tv.get
        out.update(call=lambda x, w, plain: getter(variant, k, n, tk=512, tn=256, plain=plain)(
            x, w), io=m * k * 4 + m * n * 4, flops=2 * m * k * n)
        # the mode's function in float64 on its rounded operands
        nf4 = torch.as_tensor(quant.NF4_CODE, device=dev)
        table = {"v1": nf4, "v2": nf4, "v5": nf4.to(torch.bfloat16).float()}.get(
            variant, torch.arange(-8, 8, device=dev).float())
        mul = 0.125 if variant in ("v6", "v7") else 1.0
        xr = (lambda x: x) if variant in ("v1", "v2") else (
            lambda x: x.to(torch.bfloat16).float())
        out["f64"] = lambda x, w: xr(x).double() @ (
            lk._q4_values(w["q4"], table).double()
            * (w["absmax"].double() * mul).repeat_interleave(64, 0))
    elif kernel == "K12":
        w = {"pw": torch.randint(0, 2**31 - 1, (k, n // 8), generator=gen, device=dev,
                                 dtype=torch.int32), "s": absmax(k // 64, n)}
        x = xin(k)
        get = {"v8": lambda p: tv.get_v8(k, n, tk=512, plain=p),
               "v9": lambda p: tv.get_v9(k, n, tk=512, plain=p)}.get(
            variant, lambda p: tv.get_v10(variant, k, n, tk=512, plain=p))
        out.update(call=lambda x, w, plain: get(plain)(x, w), io=m * k * 4 + m * n * 4,
                   flops=2 * m * k * n)
        xr = (lambda x: x) if variant in ("v8", "v9") else (
            lambda x: x.to(torch.bfloat16).float())

        def f64(x, w):  # the mode's function in float64 on its rounded operands
            q = lk._colnibble_codes(w["pw"], variant == "v8")
            s8 = (w["s"] * 0.125).repeat_interleave(64, 0)
            wts = ((q.to(torch.bfloat16) * s8.to(torch.bfloat16)).double() if variant == "v10"
                   else q.double() * s8.double())
            return xr(x).double() @ wts
        out["f64"] = f64
    elif variant == "stream_ref":
        k_pad, gn = k + (-k) % 512, -(-n // 1024)
        w = {"pw": torch.randint(-2**31, 2**31 - 1, (1, gn, k_pad, 128), generator=gen,
                                 device=dev, dtype=torch.int32)}
        x = xin(1)
        out.update(call=lambda x, w, plain: t05.stream_ref(w["pw"], plain=plain),
                   io=gn * 1024 * 4, flops=0)
    else:  # stream_bytes, the lab's tk 512 and tn 256
        w = {"q4": torch.randint(0, 256, (k // 2, n), generator=gen, device=dev,
                                 dtype=torch.int32).to(torch.uint8), "absmax": absmax(k // 64, n)}
        x = xin(1)
        out.update(call=lambda x, w, plain: tlab.stream_bytes(w["q4"], w["absmax"], 512, 256,
                                                              plain=plain), io=n * 4, flops=0)
    if variant == "stream_bytes":  # the tiles the Pallas grid covers
        tiles = k // 512
        out["bytes_w"] = tiles * 256 * n + tiles * 8 * n * 4
    else:
        out["bytes_w"] = sum(t.numel() * t.element_size() for t in w.values())
    out.update(w=w, x=x)
    return out


def lab_cases(k, n, m) -> list:
    """Every (kernel, mode, k, n, m) of K10-K13 that the shape takes (K12 only
    whole 1024-column tiles; the probes at m = 1)."""
    return [(kern, v, k, n, 1 if kern == "K13" else m) for kern, modes in LAB_MODES.items()
            for v in modes if not (kern == "K12" and n % 1024)]


def lab_case(torch, gen, kernel, variant, k, n, m, tile_k=None) -> dict:
    """One lab kernel mode against its plain version (the probes bit for bit),
    with the float64 yardstick where the mode's operands are f32; raises with
    the kernel's name on a miss."""
    s = lab_setup(torch, gen, kernel, variant, k, n, m, tile_k)
    got = s["call"](s["x"], s["w"], False)
    ref = s["call"](s["x"], s["w"], True)
    torch.cuda.synchronize()
    what = f"{kernel} {variant} k={k} n={n} m={m}"
    if s["exact"]:
        if got.shape != ref.shape or not torch.equal(got, ref):
            raise AssertionError(f"{what}: not bit for bit (max abs err "
                                 f"{float((got - ref).abs().max()):.3e})")
        return {"err": 0.0}
    r = {"err": held(torch, what, got, ref, LAB_ATOL * float(ref.abs().max()), LAB_RTOL)}
    if s["f64"] is not None:
        exact = s["f64"](s["x"], s["w"])
        r["f64_kernel"] = float((got.double() - exact).abs().max())
        r["f64_plain"] = float((ref.double() - exact).abs().max())
    return r


def lab_time(torch, gen, kernel, variant, k, n, m, plain: bool = True) -> dict:
    """Device time a call (CUDA graph, weights cold: enough copies to exceed
    the 50 MB L2) of one lab kernel mode and, with ``plain``, of its plain
    version, beside the call's bound. Where K11 or K12 takes the tensor cores,
    also on the gemv (the earlier route), the two in turns (A B B A)."""
    from fastmax_tpu_torch.tools import lab_kernels as lk

    s = lab_setup(torch, gen, kernel, variant, k, n, m)
    copies = [s["w"]] + [{key: v.clone() for key, v in s["w"].items()}
                         for _ in range(max(1, math.ceil(160e6 / s["bytes_w"])) - 1)]
    it = iter(range(10**9))

    def call(p):
        return lambda: s["call"](s["x"], copies[next(it) % len(copies)], p)

    path = lk.lab_path(m, n) if kernel in ("K11", "K12") else None
    runs = {"route": [], "earlier": []}
    for turn in (("route", "earlier", "earlier", "route") if path == "tc" else ("route",)):
        with earlier_route(lk, kernel) if turn == "earlier" else contextlib.nullcontext():
            runs[turn].append(graph_ms(call(False), calls=2 * len(copies)))
    b = bound(s["bytes_w"] + s["io"], s["flops"], bf16=s["bf16"])
    if path == "tc" and not s["bf16"]:  # f32 operands on the tensor cores, read as K8's and K9's
        tcb = tensor_core_f32_bound(s["flops"], s["bytes_w"] + s["io"])
        b.update(bound_ms=tcb["bound_tc_f32_ms"], bound_by=tcb["bound_tc_f32_by"])
    row = {"kernel": kernel, "variant": variant, "k": k, "n": n, "m": m, "path": path,
           "ms": sum(runs["route"]) / len(runs["route"]), "ms_runs": runs["route"],
           "earlier_path": "gemv" if runs["earlier"] else None,
           "earlier_ms": sum(runs["earlier"]) / len(runs["earlier"]) if runs["earlier"] else None,
           **b}
    row["gbps"] = s["bytes_w"] / (row["ms"] * 1e-3) / 1e9
    if kernel == "K13":  # a read yardstick: PyTorch's own reduction over the same bytes
        row["yardstick_ms"] = graph_ms(lambda: [
            torch.sum(t.view(torch.int32) if t.dtype == torch.float32 else t, dtype=torch.int64)
            for t in copies[next(it) % len(copies)].values()], calls=2 * len(copies))
    if plain:
        row["plain_ms"] = graph_ms(call(True), calls=len(copies), reps=1)
    return row


def probe_rate(torch, gen, which, k, n) -> dict:
    """K13's read rate at (k, n), weights cold; fails above PROBE_RATE_MAX."""
    row = lab_time(torch, gen, "K13", which, k, n, 1, plain=False)
    if row["gbps"] * 1e9 > PROBE_RATE_MAX:
        raise AssertionError(f"K13 {which} k={k} n={n}: reads {row['gbps']:.1f} GB/s, above "
                             f"105 % of {HBM_BYTES_PER_S / 1e9:.0f} GB/s: it did not read what "
                             "it claims")
    return row


# K10's checks beside the four linears at m = 1 and 8 (where fc_12 takes 3 splits of 1408
# rows, the last partial): rows of x that leave a chunk short or take several chunks (5, 16,
# 64) at qkv and mlp.proj (k_pad 11264 in 1408-row splits at m <= 24), and words packed in k
# tiles of 512 rows (gk = 8) at attn.proj
K10_CHECKS = tuple((name, k, n, m, None) for name, k, n in (LLAMA7B_LINEARS[0], LLAMA7B_LINEARS[3])
                   for m in (5, 16, 64)) + tuple(("attn_proj tk 512", 4096, 4096, m, 512)
                                                 for m in (1, N_SLOTS))


def check_k10(torch, gen, worst) -> list:
    """K10 against its plain version at every case of K10_CHECKS, then three
    runs bit for bit at qkv, m = 1 and 8. Raises on a miss; adds the largest
    error to ``worst``."""
    from fastmax_tpu_torch.tools import lab_kernels as lk

    rows = []
    for name, k, n, m, tile_k in K10_CHECKS:
        r = lab_case(torch, gen, "K10", "raw", k, n, m, tile_k)
        worst["int4_tiled_bf16"] = max(worst["int4_tiled_bf16"], r["err"])
        k_pad = k + (-k) % 512
        rows.append({"case": (name, k, n, m, tile_k), "plan": lk.k10_plan(
            m, k_pad, -(-n // 1024), torch.cuda.get_device_properties(0).multi_processor_count),
            **r})
    log("  K10 " + "; ".join(f"{r['case'][0]} m={r['case'][3]} splits {r['plan'][0]} x "
                             f"{r['plan'][1]} rows: {r['err']:.3e}" for r in rows))
    _, k, n = LLAMA7B_LINEARS[0]
    for m in (1, N_SLOTS):
        s = lab_setup(torch, gen, "K10", "raw", k, n, m)
        first = s["call"](s["x"], s["w"], False)
        for _ in range(2):
            if not torch.equal(s["call"](s["x"], s["w"], False), first):
                raise AssertionError(f"K10 raw k={k} n={n} m={m}: a repeat differs")
    log(f"  K10 at qkv, m=1 and {N_SLOTS}: 3 runs bit for bit")
    return rows


def lab_tc_cases() -> list:
    """K11's and K12's tensor-core cases: (kernel, mode, k, n, m)."""
    return [(kern, v, k, n, m) for kern, shapes in LAB_TC_SHAPES.items() for _, k, n in shapes
            for v in LAB_MODES[kern] for m in LAB_TC_M]


def check_lab_tc(torch, gen, worst) -> list:
    """K11 and K12 on the tensor cores against their plain versions at every
    mode, row count and shape of ``lab_tc_cases``, with the float64 yardstick's
    distance for kernel and plain; then three runs bit for bit at m = 8, every
    mode, at qkv. Raises on a miss; adds each kernel's largest error to
    ``worst``."""
    from fastmax_tpu_torch.tools import lab_kernels as lk

    rows = []
    for case in lab_tc_cases():
        kern, v, k, n, m = case
        if lk.lab_path(m, n) != "tc":
            raise AssertionError(f"{kern} {v} k={k} n={n} m={m}: not routed to the tensor cores")
        r = lab_case(torch, gen, *case)
        worst[LAB_KERNEL[kern]] = max(worst[LAB_KERNEL[kern]], r["err"])
        rows.append({"case": case, **r})
    for kern, shapes in LAB_TC_SHAPES.items():
        for name, k, n in shapes:
            got = [r for r in rows if r["case"][0] == kern and r["case"][2:4] == (k, n)]
            log(f"  {kern} tensor cores {name:9s} k={k:5d} n={n:5d} m={LAB_TC_M}, every mode: "
                f"ok, max abs err {max(r['err'] for r in got):.3e}; from float64, kernel / plain "
                f"{max(r['f64_kernel'] for r in got):.3e} / {max(r['f64_plain'] for r in got):.3e}")
    _, k, n = LLAMA7B_LINEARS[0]
    for kern in ("K11", "K12"):
        for v in LAB_MODES[kern]:
            s = lab_setup(torch, gen, kern, v, k, n, N_SLOTS)
            first = s["call"](s["x"], s["w"], False)
            for _ in range(2):
                if not torch.equal(s["call"](s["x"], s["w"], False), first):
                    raise AssertionError(f"{kern} {v} k={k} n={n} m={N_SLOTS}: a repeat differs")
    log(f"  K11, K12 tensor cores at qkv, m={N_SLOTS}, every mode: 3 runs bit for bit")
    return rows


def lab_routes(torch, gen) -> dict:
    """The lab functions that equal an already ported kernel launch it, once a
    call, and agree with its plain version: onedot, sem and the f32 m8 go to
    K9's raw mode, v9t to K9 with scales, v3/v4 to K8 (mlp.proj's k = 11008
    too), the f32 v12 to K1. Returns {kernel: [{"route", "shape", bound of
    the call's inputs}]}."""
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.tools import int4_opt_r04 as t04
    from fastmax_tpu_torch.tools import int4_opt_r05 as t05
    from fastmax_tpu_torch.tools import nf4_variants_r04 as tv

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    seen = {}
    for name, k, n in LLAMA7B_LINEARS:
        codes = torch.randint(-8, 8, (k, n), generator=gen, device="cuda", dtype=torch.int8)
        pw, pw1024 = quant.pack_int4_tiled(codes), quant.pack_int4_tiled(codes, 1024)
        k_pad, n_pad = pw.shape[0] * pw.shape[2], pw.shape[1] * 1024
        x1 = torch.nn.functional.pad(torch.randn((1, k), generator=gen, device="cuda") + 0.5,
                                     (0, k_pad - k))
        x8 = x1.repeat(8, 1)
        q4 = torch.randint(0, 256, (k // 2, n), generator=gen, device="cuda",
                           dtype=torch.int32).to(torch.uint8)
        am = torch.rand((k // 64, n), generator=gen, device="cuda") * 0.02 + 0.01
        raw = 2 * k_pad * n_pad
        # (route, kernel, call, bytes of its inputs and output, operations at m = rows of x)
        cases = [("onedot", "int4_block_matmul", lambda p: t04.onedot_matmul(x1, pw1024, plain=p),
                  nbytes(x1, pw1024) + n_pad * 4, raw),
                 ("sem", "int4_block_matmul", lambda p: t05.sem_matmul(x1, pw, plain=p),
                  nbytes(x1, pw) + n_pad * 4, raw),
                 ("m8 f32", "int4_block_matmul", lambda p: t04.m8_matmul(x8, pw, plain=p),
                  nbytes(x8, pw) + 8 * n_pad * 4, 8 * raw)]
        for v in ("v3", "v4"):
            for xm in (x1, x8):
                cases.append((f"{v} m={xm.shape[0]}", "nf4_matmul",
                              lambda p, v=v, xm=xm: tv.get(v, k, n, plain=p)(
                                  xm[:, :k], {"q4": q4, "absmax": am}),
                              nbytes(xm[:, :k], q4, am) + xm.shape[0] * n * 4,
                              2 * xm.shape[0] * k * n))
        if k % 512 == 0:  # pack_v9t's tiles (512 rows) cover k
            s_t = quant.tile_scales(am, 512, n_pad)
            pw_t = quant.pack_int4_tiled(codes, 512)
            cases.append(("v9t", "int4_block_matmul", lambda p: tv.get_v9t(
                k, n_pad, tk=512, plain=p)(x1[:, :k], {"pw": pw_t, "s": s_t}),
                nbytes(x1, pw_t, s_t) + n_pad * 4, raw))
            u = torch.rand(k, generator=gen, device="cuda") + 0.5
            v_ = torch.rand(n_pad, generator=gen, device="cuda") + 0.5
            cases.append(("v12 f32", "int4_rank1_matmul", lambda p: tv.get_v12(
                k, n_pad, tk=k, plain=p)(x1[:, :k], {"pw": pw, "u": u, "v": v_}),
                nbytes(x1, pw, u, v_) + n_pad * 4, raw))
        for what, kern, fn, nb, flops in cases:
            before = build.launch_counts()[kern]
            got = fn(False)
            launched = build.launch_counts()[kern] - before
            ref = fn(True)
            torch.cuda.synchronize()
            if launched != 1:
                raise AssertionError(f"route {what} at {name}: {launched} launches of {kern}")
            held(torch, f"route {what} ({kern}) k={k} n={n}", got, ref,
                 LAB_ATOL * float(ref.abs().max()), LAB_RTOL)
            b = bound(nb, flops, bf16=False)
            # the routes at m = 8 take K9's and K8's tensor-core paths: f32 x at their rate
            if what in ("m8 f32", "v3 m=8", "v4 m=8"):
                tcb = tensor_core_f32_bound(flops, nb)
                b.update(bound_ms=tcb["bound_tc_f32_ms"], bound_by=tcb["bound_tc_f32_by"])
            seen.setdefault(kern, []).append({"route": what, "shape": name, **b})
    return seen


def run_lab_main(module, argv) -> list:
    """A lab's main in this process with its standard output captured; its
    JSON lines."""
    import contextlib
    import importlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        importlib.import_module(f"fastmax_tpu_torch.tools.{module}").main(argv)
    return [json.loads(line) for line in buf.getvalue().splitlines() if line.startswith("{")]


def check_lab_lines(script, lines, expected: int) -> list:
    """Every line of a variant that runs a kernel carries ``us`` and launches
    equal to the timer's calls; the only error lines are the reference's own
    (LAB_REFERENCE_ERRORS)."""
    if len(lines) != expected:
        raise AssertionError(f"{script}: {len(lines)} lines, expected {expected}")
    bad, errors = [], []
    for r in lines:
        name = r.get("variant", r.get("impl"))
        if "error" in r:
            errors.append((name, r["k"], r["n"]))
            if (name, r["k"], r["n"]) not in LAB_REFERENCE_ERRORS[script]:
                bad.append(r)
        elif "skip" in r:
            if not (name == "nf4_v0" and r["k"] % 512):
                bad.append(r)
        elif not (r["us"] > 0 and (name in LAB_PLAIN_IMPLS or r["launches"] == r["calls"] > 0)):
            bad.append(r)
    if bad:
        raise AssertionError(f"{script}: lines out of order: {bad[:4]}")
    log(f"  {script}: {len(lines)} lines, each in order; the reference's own errors at "
        f"{sorted(set(errors))}")
    return lines


LAB_IMPLS = ("bf16", "int8", "int4", "nf4_xla", "nf4_v0", "stream", "v1", "v2", "v3", "v4", "v5",
             "v6", "v7", "v8", "v9", "v10", "v11", "v9t", "v12", "v12b")


def lab_path(torch, results, card):
    """Phase 11: K10-K13 against plain at the 7B shapes, their times and the
    probes' read rates, the routes onto K1/K8/K9, then the three lab mains end
    to end (the slice's main path: the launch counts are theirs)."""
    from fastmax_tpu_torch.kernels import build

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(11)
    worst = {name: 0.0 for name in LAB_KERNEL.values()}
    f64 = []
    for name, k, n in LLAMA7B_LINEARS:
        for m in (1, N_SLOTS):
            for case in lab_cases(k, n, m):
                if case[0] == "K13" and m != 1:
                    continue
                r = lab_case(torch, gen, *case)
                kern = LAB_KERNEL[case[0]]
                worst[kern] = max(worst[kern], r["err"])
                if "f64_kernel" in r:
                    f64.append({"case": case, **r})
        log(f"  K10-K13 {name:9s} k={k:5d} n={n:5d} m=1,{N_SLOTS}: every mode ok")
    log(f"  max abs err vs plain: {worst}; against float64, kernel / plain: max "
        f"{max(r['f64_kernel'] for r in f64):.3e} / {max(r['f64_plain'] for r in f64):.3e}")
    tc = check_lab_tc(torch, gen, worst)
    k10 = check_k10(torch, gen, worst)
    rows = []
    for name, k, n in LLAMA7B_LINEARS:
        for kernel, modes in LAB_MODES.items():
            for v in modes:
                if kernel == "K12" and n % 1024:
                    continue
                for m in ((1,) if kernel == "K13" else (1, N_SLOTS)):
                    row = (probe_rate(torch, gen, v, k, n) if kernel == "K13"
                           else lab_time(torch, gen, kernel, v, k, n, m, plain=m == 1))
                    if kernel == "K13":
                        row["plain_ms"] = lab_time(torch, gen, kernel, v, k, n, 1)["plain_ms"]
                    rows.append(dict(row, shape=name))
                    log(f"  {kernel} {v:12s} {name:9s} m={m}: {row['ms'] * 1e3:8.1f} us "
                        + (f"on {row['path']} " if row.get("path") else "")
                        + f"({row['gbps']:7.1f} GB/s of weights) bound {row['bound_ms'] * 1e3:6.1f}"
                        f" us ({row['bound_by']})"
                        + (f" {row['earlier_path']} {row['earlier_ms'] * 1e3:8.1f} us"
                           if row.get("earlier_ms") else "")
                        + (f" plain {row['plain_ms'] * 1e3:8.1f} us" if "plain_ms" in row
                           else "")
                        + (f" read yardstick (torch.sum int64) {row['yardstick_ms'] * 1e3:8.1f}"
                           " us" if "yardstick_ms" in row else "") + f"   [{card}]")
    big = probe_rate(torch, gen, "stream_ref", 16384, 65536)  # 512 MB of words, one copy
    log(f"  K13 stream_ref over 512 MB: {big['ms'] * 1e3:.1f} us, {big['gbps']:.1f} GB/s; read "
        f"yardstick (torch.sum int64) {big['yardstick_ms'] * 1e3:.1f} us   [{card}]")
    routes = lab_routes(torch, gen)
    per_route = {}
    for x in (x for v in routes.values() for x in v):
        per_route[x["route"]] = per_route.get(x["route"], 0.0) + x["bound_ms"]
    log(f"  routes onto ported kernels: { {k: len(v) for k, v in routes.items()} } calls, each "
        "one launch, each within tolerance of its plain version; bounds (us, the linears "
        "summed): " + "; ".join(f"{r} {ms * 1e3:.1f}" for r, ms in sorted(per_route.items())))
    gc.collect()
    torch.cuda.empty_cache()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    mains = {
        "int4_opt_r04": check_lab_lines("int4_opt_r04", run_lab_main("int4_opt_r04", []), 32),
        "int4_opt_r05": check_lab_lines("int4_opt_r05", run_lab_main(
            "int4_opt_r05", ["--iters-lo", "10", "--iters-hi", "50"]), 36),
        "nf4_lab_r04": check_lab_lines("nf4_lab_r04", run_lab_main(
            "nf4_lab_r04", [*LAB_IMPLS, "--m", "1,8", "--iters", "2", "--reps", "64"]),
            4 * 2 * len(LAB_IMPLS)),
    }
    counts = build.launch_counts()
    mains_s = time.perf_counter() - t0
    missing = [k for k in LAB_KERNEL.values() if counts[k] <= 0]
    if missing:
        raise AssertionError(f"the lab mains never launched {missing}: {counts}")
    phase_s = time.perf_counter() - t_phase
    log(f"  the three lab mains in {mains_s:.1f} s, the phase in {phase_s:.1f} s; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    results["lab"] = {"max_abs_err": worst, "f64": f64, "tc": tc, "k10": k10, "times": rows,
                      "probe_512mb": big,
                      "routes": routes, "mains": mains, "mains_s": mains_s, "phase_s": phase_s,
                      "launches": counts, "card": card}
    return worst, rows, counts


# ----------------------------------------------------------------- phase 12
# The training command lines of launch_scripts/, run in-process through the port's
# main() with the script's own flags, then a few appended that cut the run (argparse
# keeps a flag's last occurrence) and log every step. The checkpoint directory is
# Llama-2-7B at its full width cut to CMD_DEPTH of its 32 layers (the card's disk and
# the run's time; full depth at full width runs from model_name in phase 9).
CMD_DEPTH = 2
CMD_LOG = ["--train.log_interval", "1"]
CMD_PRETRAIN = ["--train.max_iters", "4", "--train.global_batch_size", "8"]
CMD_QLORA = ["--train.max_seq_length", "2048", "--train.max_iters", "2",
             "--train.global_batch_size", "4"]
# one step, and its learning rate not the warmup's 0 at step 0
CMD_FULL = ["--train.max_iters", "1", "--train.max_seq_length", "512",
            "--train.lr_warmup_steps", "0"]
ENWIK8_MIN_BYTES = 1 << 20


def launch_command(name: str, args: list, env=None) -> tuple:
    """(module, flags) of the python command that ``launch_scripts/<name>``
    runs with positional ``args``: ``exec`` wrappers followed, ``VAR=...``
    assignments and ``${N:?...}``/``${N:-default}``/``$VAR`` substituted;
    ``NCHIPS`` is 1 unless ``env`` sets it."""
    import re
    import shlex

    env = dict(env or {"NCHIPS": "1"})

    def sub(text: str) -> str:
        def param(m):
            var, op, default = m.group(1), m.group(2), m.group(3)
            if not var.isdigit():
                return env[var]
            i = int(var) - 1
            if i < len(args):
                return args[i]
            if op != "-":
                raise ValueError(f"{name}: positional ${var} is required")
            return default
        text = re.sub(r"\$\{(\w+)(?::([?-])([^}]*))?\}", param, text)
        return re.sub(r"\$([A-Za-z_]\w*)", lambda m: env[m.group(1)], text)

    text = (REPO / "launch_scripts" / name).read_text().replace("\\\n", " ")
    for line in (raw.strip() for raw in text.splitlines()):
        if not line or line.startswith(("#", "set ")):
            continue
        wrapper = re.match(r'exec "\$\(dirname "\$0"\)/([\w.]+)"\s+(.*)$', line)
        if wrapper:
            return launch_command(wrapper.group(1), shlex.split(sub(wrapper.group(2))), env)
        assign = re.match(r"(\w+)=(.*)$", line)
        if assign:
            if assign.group(1) not in env:
                env[assign.group(1)] = shlex.split(sub(assign.group(2)))[0]
            continue
        words = shlex.split(sub(line))
        if words[:2] != ["python", "-m"]:
            raise ValueError(f"{name}: not a python -m command: {words}")
        return words[2], words[3:]
    raise ValueError(f"{name}: no command")


def run_command(torch, main_fn, flags: list, out: Path, card: str) -> tuple:
    """``main_fn(flags)`` with the launch counts set to 0 just before and read
    just after: (state, {wall_s, step_s, peak_gb, losses, launches})."""
    import csv

    from fastmax_tpu_torch.kernels import build

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    state = main_fn(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = build.launch_counts()
    peak_gb = (torch.cuda.max_memory_allocated() - held) / 1e9
    with open(out / "metrics.csv", newline="") as f:
        rows = [r for r in csv.DictReader(f) if r.get("loss")]
    if len(rows) > 1:  # steps 2 on
        step_s = (float(rows[-1]["time"]) - float(rows[0]["time"])) / (len(rows) - 1)
    else:  # the fit loop's own time of its one step
        step_s = float(rows[0]["tokens"]) / float(rows[0]["tokens_per_sec"])
    return state, {"steps": state.step, "wall_s": wall, "step_s": step_s, "peak_gb": peak_gb,
                   "held_before_gb": held / 1e9, "losses": [float(r["loss"]) for r in rows],
                   "launches": counts, "card": card}


def trees_equal(torch, a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and sorted(a) == sorted(b) and all(
            trees_equal(torch, a[k], b[k]) for k in a)
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b.to(a.device))


def hf_llama_flat(cfg, flat: dict, conv) -> dict:
    """A lit-gpt flat dict of a Llama model under HF's names, the fused QKV
    split back into q_proj/k_proj/v_proj (what save_pretrained writes)."""
    to_hf = {}
    for hf_name, lit_name in conv.llama_weight_map(cfg).items():
        if lit_name is not None:
            for i in range(cfg.n_layer):
                to_hf[lit_name.format(i)] = hf_name.format(i)
    out = {}
    for name, t in flat.items():
        if name.endswith("attn.attn.weight"):
            i = int(name.split(".")[2])
            for proj, part in zip("qkv", conv.split_qkv(t, cfg)):
                out[f"model.layers.{i}.self_attn.{proj}_proj.weight"] = part
        else:
            out[to_hf[name]] = t
    return out


def command_path(torch, results, card, then=None):
    """Phase 12: the pretraining, conversion and finetuning command lines,
    each through the port's own entry point. ``then(tmp, ckpt, lora_file,
    pretrain_out)`` runs inside the phase's temporary directory, on what the
    phase wrote, before it is removed; its result is returned beside the
    phase's launch counts."""
    import gzip
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.models import gpt, lora
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.params import flat_to_params, params_to_flat
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.scripts import convert_hf_checkpoint as conv
    from fastmax_tpu_torch.training import finetune, pretrain
    from fastmax_tpu_torch.utils.checkpoint import (load_flat_checkpoint, load_model_params,
                                                    save_flat_checkpoint)

    t_phase = time.perf_counter()
    out = {}
    # each command runs as in a fresh process: the 4-bit matmul backend is process-global,
    # and phase 10 leaves it at "pallas" (K8 wherever x needs no gradient)
    backend = quant.get_quant_backend()
    quant.set_quant_backend("xla")
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)

        # (a) pretraining: the fork's fastmax run on an enwik8 file of the repository's text
        tokens, n_files = repo_text_tokens(np)
        text = np.resize(tokens.astype(np.uint8), max(tokens.size, ENWIK8_MIN_BYTES)).tobytes()
        gz = tmp / "enwik8.gz"
        gz.write_bytes(gzip.compress(text, compresslevel=1))
        module, flags = launch_command("pretrain_easy_transformer_enwik8.sh", [str(gz)])
        flags += CMD_PRETRAIN + CMD_LOG + ["--io.out_dir", str(tmp / "pt")]
        log(f"  (a) {module} (the port's) {' '.join(flags)}")
        log(f"      enwik8.gz: {len(text)} bytes from {n_files} *.md/*.py files of the repository")
        state, run = run_command(torch, pretrain.main, flags, tmp / "pt", card)
        _, final = load_model_params(tmp / "pt" / "final", device="cuda")
        same = trees_equal(torch, final, state.params)
        k45 = {k: run["launches"][k] for k in FASTMAX_KERNELS}
        log(f"      {run['steps']} steps in {run['wall_s']:.2f} s; steps 2-{run['steps']}: "
            f"{run['step_s'] * 1e3:.1f} ms a step; peak {run['peak_gb']:.3f} GB; losses "
            f"{[round(x, 4) for x in run['losses']]}; K4/K5 launches {k45}; out_dir/final "
            f"reloads {'bit for bit' if same else 'DIFFERENT'}   [{card}]")
        if not (all(k45.values()) and all(math.isfinite(x) for x in run["losses"]) and same):
            raise AssertionError(f"pretrain command: launches {k45}, losses {run['losses']}, "
                                 f"final checkpoint equal {same}")
        out["pretrain"] = dict(run, module=module, flags=flags)
        del state, final

        # (b) a checkpoint directory: Llama-2-7B's width at CMD_DEPTH layers, written under
        # HF's names, converted by the port's converter and loaded back
        cfg = Config.from_name("Llama-2-7b-hf", n_layer=CMD_DEPTH)
        drawn = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
        hf_dir, ckpt = tmp / "hf", tmp / "Llama-2-7b-hf"
        hf_dir.mkdir()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_flat_checkpoint(hf_llama_flat(cfg, params_to_flat(drawn, cfg), conv),
                             hf_dir / "model.safetensors")
        write_s = time.perf_counter() - t0
        nbytes = (hf_dir / "model.safetensors").stat().st_size
        t0 = time.perf_counter()
        conv.main(["--checkpoint_dir", str(hf_dir), "--model_name", "Llama-2-7b-hf",
                   "--out_dir", str(ckpt)])
        convert_s = time.perf_counter() - t0
        lit = json.loads((ckpt / "lit_config.json").read_text())
        lit["n_layer"] = CMD_DEPTH
        (ckpt / "lit_config.json").write_text(json.dumps(lit, indent=2))
        t0 = time.perf_counter()
        _, loaded = load_model_params(ckpt, dtype=torch.bfloat16, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        same = trees_equal(torch, loaded, drawn)
        n_params = sum(t.numel() for t in params_to_flat(drawn, cfg).values())
        log(f"  (b) Llama-2-7B width, {CMD_DEPTH} layers: {n_params} parameters, {nbytes / 1e9:.3f} "
            f"GB in bf16; HF-named model.safetensors written in {write_s:.2f} s "
            f"({nbytes / write_s / 1e9:.2f} GB/s), converted in {convert_s:.2f} s "
            f"({nbytes / convert_s / 1e9:.2f} GB/s), loaded onto the card in {load_s:.2f} s "
            f"({nbytes / load_s / 1e9:.2f} GB/s; file cache warm); the loaded tree "
            f"{'equals the drawn one bit for bit' if same else 'DIFFERS'}   [{card}]")
        if not same:
            raise AssertionError("the converted checkpoint does not load back to the drawn tree")
        out["checkpoint"] = {"n_layer": CMD_DEPTH, "n_params": n_params, "bytes": nbytes,
                             "write_s": write_s, "convert_s": convert_s, "load_s": load_s,
                             "card": card}
        shutil.rmtree(hf_dir)
        del drawn, loaded

        # (c) QLoRA from that directory: quadratic attention at T up to 2048 (K6/K7)
        examples, _ = sft_examples(np, n=16)
        data = tmp / "sft.npz"
        np.savez(data, examples=np.array(examples, dtype=object))
        module, flags = launch_command("finetune_qlora.sh",
                                       [str(ckpt), str(data), "quadratic", "bnb.nf4"])
        flags += CMD_QLORA + CMD_LOG + ["--io.out_dir", str(tmp / "qlora")]
        log(f"  (c) {module} (the port's) {' '.join(flags)}")
        state, run = run_command(torch, finetune.main, flags, tmp / "qlora", card)
        k67 = {k: run["launches"][k] for k in ("flash_train_fwd", "flash_train_bwd")}
        moved = float(state.params["blocks"]["attn"]["attn"]["lora_B"].detach().float().abs().max())
        back = load_flat_checkpoint(tmp / "qlora" / "lora_weights.safetensors")
        delta = finetune._flatten(lora.split_lora_state(state.params)[1])
        saved = sorted(back) == sorted(delta) and all(
            torch.equal(back[n], delta[n].detach().cpu()) for n in delta)
        log(f"      {run['steps']} steps in {run['wall_s']:.2f} s (load and NF4 included); step 2: "
            f"{run['step_s'] * 1e3:.1f} ms; peak {run['peak_gb']:.3f} GB; losses "
            f"{[round(x, 4) for x in run['losses']]}; max|lora_B| {moved:.3e}; K6/K7 launches "
            f"{k67}; lora_weights.safetensors {sorted(back)} "
            f"{'read back equal' if saved else 'DIFFERENT'}   [{card}]")
        if not (all(k67.values()) and all(math.isfinite(x) for x in run["losses"]) and moved > 0
                and saved):
            raise AssertionError(f"QLoRA command: launches {k67}, losses {run['losses']}, "
                                 f"max|lora_B| {moved}, lora weights saved {saved}")
        out["qlora"] = dict(run, module=module, flags=flags, lora_b_max=moved)
        del state

        # (d) full finetuning from that directory: one step at T up to 512
        module, flags = launch_command("finetune_full.sh", [str(ckpt), str(data)])
        flags += CMD_FULL + CMD_LOG + ["--io.out_dir", str(tmp / "full")]
        log(f"  (d) {module} (the port's) {' '.join(flags)}")
        state, run = run_command(torch, finetune.main, flags, tmp / "full", card)
        written = load_flat_checkpoint(tmp / "full" / "full_weights.safetensors")
        source = load_flat_checkpoint(ckpt)
        shapes = sorted(written) == sorted(source) and all(
            written[n].shape == source[n].shape for n in source)
        changed = shapes and any(not torch.equal(written[n], source[n]) for n in source)
        reloaded = trees_equal(torch, flat_to_params(written, Config.from_checkpoint(ckpt),
                                                     torch.bfloat16, "cuda"), state.params)
        log(f"      {run['steps']} step in {run['wall_s']:.2f} s (load included); the step "
            f"{run['step_s'] * 1e3:.1f} ms; peak {run['peak_gb']:.3f} GB; loss "
            f"{run['losses']}; full_weights.safetensors: {len(written)} tensors, every lit name "
            f"and shape of the input {shapes}, moved off the input {changed}, reloads to the "
            f"final state bit for bit {reloaded}   [{card}]")
        if not (shapes and changed and reloaded and all(math.isfinite(x) for x in run["losses"])):
            raise AssertionError(f"full command: names/shapes {shapes}, changed {changed}, "
                                 f"reloaded {reloaded}, losses {run['losses']}")
        out["full"] = dict(run, module=module, flags=flags)
        del state, written, source
        counts = {}
        for name in ("pretrain", "qlora", "full"):
            for k, v in out[name]["launches"].items():
                counts[k] = counts.get(k, 0) + v
        out["phase_s"] = time.perf_counter() - t_phase
        log(f"  the phase in {out['phase_s']:.1f} s; launches "
            f"{({k: v for k, v in counts.items() if v})}")
        results["commands"] = out
        after = None if then is None else then(
            tmp, ckpt, tmp / "qlora" / "lora_weights.safetensors", tmp / "pt")
    quant.set_quant_backend(backend)
    return counts, after


# ----------------------------------------------------------------- phase 13
# The inference and eval command lines, inside phase 12's temporary directory, on what
# phase 12 wrote: its 2-layer checkpoint of Llama-2-7B's full width, the QLoRA run's
# lora_weights.safetensors and the pretraining out_dir. bench_serving draws its 7B at full
# depth on the card. Its first load names --max_seq_length 256: without it the cache
# length is prompt + new + quantum = 136, not the multiple of 128 that K2 takes.
INF_BENCH_MODEL = ["--quantize", "bnb.nf4",
                   "--kv_cache_dtype", "int8", "--n_slots", str(N_SLOTS), "--decode_quantum", "8"]
INF_BENCH_LOADS = (
    ("decode", ["--n_requests", "16", "--prompt_len", "64", "--max_new_tokens", "64",
                "--max_seq_length", "256"], ("int4_rank1_matmul", "int8_decode_attention")),
    ("long prompts", ["--prompt_len", "2048", "--max_seq_length", "4096", "--n_requests", "8",
                      "--max_new_tokens", "16"],
     ("int4_rank1_matmul", "int8_decode_attention", "flash_attention")),
)
INF_PROMPT, INF_NEW = 64, 64
EVAL_F32_ATOL = 1e-4     # the port's f32 logits tolerance (log-probs, kernels vs plain)
EVAL_REL = 1e-4          # summed log-probs: batched vs serial, kernels vs plain
EVAL_REQUESTS, EVAL_CONT = 16, 16
EVAL_PPL_TOKENS, EVAL_PPL_STRIDE = 4096, 512


def launched(torch, fn):
    """``fn()`` with the launch counts set to 0 just before and read just after:
    (its result, the non-zero counts, seconds)."""
    from fastmax_tpu_torch.kernels import build

    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return out, {k: v for k, v in build.launch_counts().items() if v}, dt


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def bf16_steps(torch, got, want, scale) -> float:
    """The largest |got - want| in bf16 steps (2^-7) of ``scale``, the larger of
    the two terms summed at each element: the f32 sums of the merge, taken in
    two orders, differ by a rounding of the terms, and a value that cancels to
    near 0 has no bf16 step of its own to be held to."""
    err = (got.float() - want).abs()
    return float((err / (scale * 2.0 ** -7).clamp_min(1e-30)).max())


def inference_path(torch, results, card, tmp, ckpt, lora_file, pt_out) -> dict:
    """Phase 13: the inference and eval command lines through the port's own
    entry points; returns the phase's launch counts."""
    import builtins
    import importlib.util
    import io

    import numpy as np

    from fastmax_tpu_torch.eval import harness
    from fastmax_tpu_torch.inference import bench_serving, chat, generate, server
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import lora
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.scripts import convert_hf_checkpoint as conv
    from fastmax_tpu_torch.scripts import convert_lit_checkpoint, convert_pretrained_checkpoint
    from fastmax_tpu_torch.scripts import merge_lora, prepare_alpaca
    from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint, load_model_params

    log("[13] the inference and eval command lines through the port's entry points: "
        f"bench_serving on {LAYERS_7B} of the 7B's layers, generate's load, chat's stream, the "
        "tokenizer entries, merge and convert, the eval harness, the pretrained converter")
    t_phase = time.perf_counter()
    out, counts = {}, {}
    gc.collect()
    torch.cuda.empty_cache()

    # (a) bench_serving.main: random Llama-2-7B weights on the card, LAYERS_7B layers
    out["bench_serving"] = []
    for what, load, must in INF_BENCH_LOADS:
        flags = ["--model_name", cut_model("Llama-2-7b-hf", LAYERS_7B)] + INF_BENCH_MODEL + load
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got, launches, wall = launched(torch, lambda f=flags: bench_serving.main(f))
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        peak = (torch.cuda.max_memory_allocated() - held) / 1e9
        add_counts(counts, launches)
        log(f"  (a) bench_serving {' '.join(flags)}")
        log(f"      {what}: {line['generated_tokens']} tokens, {line['aggregate_tok_s']} tok/s; "
            f"TTFT p50 {line['ttft_p50_ms']} ms, p95 {line['ttft_p95_ms']} ms; latency p50 "
            f"{line['latency_p50_s']} s, p95 {line['latency_p95_s']} s; peak {peak:.3f} GB; "
            f"{wall:.1f} s with the 7B drawn and quantized; launches {launches}   [{card}]")
        want = {"metric", "model", "n_slots", "decode_quantum", "n_requests",
                "generated_tokens", "aggregate_tok_s", "wall_s", "ttft_p50_ms", "ttft_p95_ms",
                "latency_p50_s", "latency_p95_s"}
        n_req, n_new = int(load[load.index("--n_requests") + 1]), int(
            load[load.index("--max_new_tokens") + 1])
        if not (line == got and set(line) == want and line["generated_tokens"] == n_req * n_new
                and all(launches.get(k, 0) for k in must)):
            raise AssertionError(f"bench_serving ({what}): line {line}, launches {launches}, "
                                 f"kernels that must launch {must}")
        out["bench_serving"].append(dict(line, what=what, flags=flags, peak_gb=peak,
                                         launches=launches, wall_s=wall, card=card))
    gc.collect()
    torch.cuda.empty_cache()

    # (b) generate.load_and_prepare: the 2-layer directory with the QLoRA delta merged,
    # then quantized; the engine greedy over a 64-token prompt of the repository's text
    tokens, _ = repo_text_tokens(np)
    prompt = torch.as_tensor(tokens[:INF_PROMPT].astype(np.int64), device="cuda")
    delta = load_flat_checkpoint(lora_file)
    _, base = load_model_params(ckpt, dtype=torch.bfloat16, device="cuda")
    cfg, dense = generate.load_and_prepare(ckpt, finetuned_path=lora_file, method="lora")
    a, b = (delta[f"blocks.attn.attn.lora_{k}"].cuda().float() for k in "AB")
    w = base["blocks"]["attn"]["attn"]["kernel"].float()
    dw = (torch.matmul(a, b) * delta["blocks.attn.attn.lora_scale"].cuda().float()
          .reshape(-1, 1, 1) * delta["blocks.attn.attn.lora_mask"].cuda().float()[:, None, :])
    ulps = bf16_steps(torch, dense["blocks"]["attn"]["attn"]["kernel"], w + dw,
                      torch.maximum(w.abs(), dw.abs()))
    moved = not torch.equal(dense["blocks"]["attn"]["attn"]["kernel"],
                            base["blocks"]["attn"]["attn"]["kernel"])
    del dense, w, dw
    (cfg, nf4), _, load_s = launched(torch, lambda: generate.load_and_prepare(
        ckpt, quantize="bnb.nf4", finetuned_path=lora_file, method="lora"))
    engine = InferenceEngine(cfg, nf4, max_seq_length=INF_PROMPT + INF_NEW,
                             cache_dtype=torch.int8)
    gen, launches, gen_s = launched(torch, lambda: engine.generate(prompt, INF_PROMPT + INF_NEW))
    add_counts(counts, launches)
    engine_tokens = gen[0, INF_PROMPT:].tolist()
    rel, _, _ = kernels_vs_plain(torch, engine, prompt, None)
    log(f"  (b) generate.load_and_prepare(bnb.nf4, the QLoRA delta merged) in {load_s:.2f} s: "
        f"merged qkv kernel vs W + (A @ B) scale, at most {ulps:.3f} bf16 step of the "
        f"larger term apart "
        f"(moved off W: {moved}); engine (auto, int8 cache) {INF_PROMPT} + {INF_NEW} greedy in "
        f"{gen_s:.2f} s, launches {launches}; logits kernels vs plain, max|diff|/max|plain|: "
        f"prefill {rel['prefill']:.3e}, decode step {rel['decode_step']:.3e} (tolerance "
        f"{LOGITS_REL_TOL})   [{card}]")
    if not (ulps <= 1 and moved and launches.get("int4_rank1_matmul")
            and launches.get("int8_decode_attention") and len(engine_tokens) == INF_NEW
            and max(rel.values()) <= LOGITS_REL_TOL):
        raise AssertionError(f"generate's load and engine: {ulps} ulps, moved {moved}, "
                             f"launches {launches}, logits {rel}")
    out["generate"] = {"merge_ulps": ulps, "load_s": load_s, "generate_s": gen_s,
                       "launches": launches, "logits_rel": rel, "card": card}

    # (c) chat's streaming session on prepare_params(..., "auto"), dense bf16 cache
    session = chat.StreamingSession(cfg, InferenceEngine.prepare_params(nf4, "auto"),
                                    cfg.block_size)
    prompt_np = prompt.cpu().numpy()
    stream, launches, stream_s = launched(torch, lambda: [
        int(t) for c in session.generate_stream(prompt_np, INF_PROMPT + INF_NEW,
                                                temperature=0.0) for t in c])
    add_counts(counts, launches)
    div = first_divergence(torch, engine, prompt.tolist(), engine_tokens, stream)
    near = div is None or div[1] <= NEAR_TIE_REL * div[2]
    pair = stream[2:4]
    cut = [int(t) for c in session.generate_stream(prompt_np, INF_PROMPT + INF_NEW,
                                                   temperature=0.0, stop_tokens=(pair,))
           for t in c]
    first = next(i for i in range(len(stream) - 1) if stream[i:i + 2] == pair)
    log(f"  (c) chat.StreamingSession (auto, bf16 cache): {len(stream)} tokens in "
        f"{stream_s:.2f} s ({len(stream) / stream_s:.1f} tok/s, a host read a token), launches "
        f"{launches}; equal to the engine's (int8 cache): {div is None}"
        + ("" if div is None else f", first divergence at step {div[0]}, top-2 margin "
           f"{div[1]:.4f} of max|logit| {div[2]:.4f} "
           f"({'a near-tie' if near else 'NOT a near-tie'})")
        + f"; stop pair {pair} cuts it to {len(cut)} tokens (first match at {first})   [{card}]")
    if not (len(stream) == INF_NEW and near and cut == stream[:first]
            and launches.get("int4_rank1_matmul")):
        raise AssertionError(f"chat stream: {len(stream)} tokens, divergence {div}, cut {cut} "
                             f"vs {stream[:first]}, launches {launches}")
    out["chat"] = {"tokens": len(stream), "stream_s": stream_s, "divergence": div,
                   "launches": launches, "card": card}
    del engine, session, nf4
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the entries that build a Tokenizer, on the directory with a tokenizer.json
    have_tokenizers, have_sentencepiece = (importlib.util.find_spec(m) is not None
                                           for m in ("tokenizers", "sentencepiece"))
    (ckpt / "tokenizer_config.json").write_text(json.dumps({"eos_token": "</s>"}))
    if not have_tokenizers:
        # a placeholder: the backend's import fails before the file is read
        (ckpt / "tokenizer.json").write_text("{}")
        entries = {"generate.main": lambda: generate.main(checkpoint_dir=ckpt),
                   "server.main": lambda: server.main(checkpoint_dir=ckpt),
                   "run_eval_harness": lambda: harness.run_eval_harness(ckpt)}
        raised = {}
        for name, fn in entries.items():
            try:
                fn()
            except ModuleNotFoundError as e:
                raised[name] = e.name
            else:
                raise AssertionError(f"{name} ran without the tokenizers package")
        log(f"  (d) this machine has no tokenizers package (sentencepiece: "
            f"{have_sentencepiece}): each entry raises "
            f"ModuleNotFoundError naming it, as the reference does: {raised}")
        if set(raised.values()) != {"tokenizers"}:
            raise AssertionError(f"tokenizer entries raised {raised}")
        out["tokenizer_entries"] = {"tokenizers": False, "raised": raised}
    else:
        from tokenizers import Tokenizer as HFTok
        from tokenizers.models import BPE
        from tokenizers.pre_tokenizers import Whitespace
        from tokenizers.trainers import BpeTrainer

        tok = HFTok(BPE(unk_token="<unk>"))
        tok.pre_tokenizer = Whitespace()
        text = bytes(tokens[:200_000].astype(np.uint8)).decode("latin-1")
        tok.train_from_iterator(text.splitlines(), BpeTrainer(
            special_tokens=["<unk>", "</s>"], vocab_size=min(2000, cfg.vocab_size)))
        tok.save(str(ckpt / "tokenizer.json"))
        text = text[:60_000]
        task = json.loads((REPO / "eval_assets" / "tasks" / "code_cloze.json").read_text())[:4]
        (tmp / "task.json").write_text(json.dumps(task))
        (tmp / "ppl.txt").write_text(text[:20_000])
        (tmp / "records.json").write_text(json.dumps(
            [{"instruction": text[i:i + 100], "input": "", "output": text[i + 100:i + 300]}
             for i in range(0, 9600, 300)]))
        answers = iter(["def main", ""])
        real_input = builtins.input
        builtins.input = lambda prompt="": next(answers)
        entries = {
            "generate.main": lambda: generate.main(prompt="def main", checkpoint_dir=ckpt,
                                                   max_new_tokens=16, temperature=0.0),
            "chat.main": lambda: chat.main(checkpoint_dir=ckpt, max_new_tokens=16,
                                           temperature=0.0),
            "run_eval_harness": lambda: harness.run_eval_harness(
                ckpt, local_task_file=tmp / "task.json", ppl_text_file=tmp / "ppl.txt"),
            "prepare_alpaca": lambda: prepare_alpaca.prepare(
                tmp / "records.json", ckpt, tmp / "alpaca", max_seq_length=512)}
        ran, printed = {}, {}
        try:
            for name, fn in entries.items():
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                    ran[name], launches, _ = launched(torch, fn)
                add_counts(counts, launches)
                printed[name] = buf.getvalue()
        finally:
            builtins.input = real_input
        from fastmax_tpu_torch.data.lm_datasets import SFTDataset

        n_sft = len(SFTDataset.load(tmp / "alpaca" / "train.npz").examples)
        ev = ran["run_eval_harness"]
        log(f"  (d) tokenizers imports (sentencepiece: {have_sentencepiece}): with a BPE "
            f"tokenizer of {tok.get_vocab_size()} tokens trained here on the repository's "
            f"text, end to end: generate.main printed {printed['generate.main'].strip()!r}; "
            f"chat.main replied to one prompt ({printed['chat.main'].count('>> Reply: ')} "
            f"reply); run_eval_harness: local task {ev['local_task']}, perplexity "
            f"{ev['perplexity']:.1f}; prepare_alpaca wrote {n_sft} training examples")
        if not (printed["generate.main"].strip() and printed["chat.main"].count(">> Reply: ") == 1
                and ev["local_task"]["n"] == len(task) and math.isfinite(ev["perplexity"])
                and n_sft > 0):
            raise AssertionError(f"tokenizer entries: printed {printed}, eval {ev}, sft {n_sft}")
        out["tokenizer_entries"] = {"tokenizers": True, "eval": ev, "sft_examples": n_sft}

    # (e) merge_lora, then lit -> HF -> lit, bit for bit; then the merge into an NF4 base
    merged, hf_dir, back = tmp / "merged", tmp / "hf_merged", tmp / "back"
    hf_dir.mkdir()
    steps = {}
    for name, fn in (
            ("merge_lora", lambda: merge_lora.main([
                "--checkpoint_dir", str(ckpt), "--lora_path", str(lora_file), "--out_dir",
                str(merged), "--precision", "bfloat16"])),
            ("convert_lit_checkpoint", lambda: convert_lit_checkpoint.main([
                "--checkpoint_path", str(merged), "--output_path",
                str(hf_dir / "model.safetensors")])),
            ("convert_hf_checkpoint", lambda: conv.main([
                "--checkpoint_dir", str(hf_dir), "--model_name", "Llama-2-7b-hf",
                "--out_dir", str(back)]))):
        with contextlib.redirect_stdout(io.StringIO()):
            _, launches, steps[name] = launched(torch, fn)
        add_counts(counts, launches)
    a_flat, b_flat = load_flat_checkpoint(merged), load_flat_checkpoint(back)
    nbytes = sum(t.numel() * t.element_size() for t in a_flat.values())
    same = sorted(a_flat) == sorted(b_flat) and all(
        a_flat[n].dtype == b_flat[n].dtype and torch.equal(a_flat[n], b_flat[n]) for n in a_flat)
    log(f"  (e) {nbytes / 1e9:.3f} GB: " + "; ".join(
        f"{n} {s:.2f} s ({nbytes / s / 1e9:.2f} GB/s)" for n, s in steps.items())
        + f"; the round trip equals the merged checkpoint bit for bit: {same} (file cache "
        f"warm)   [{card}]")
    if not same:
        raise AssertionError("merged -> HF -> lit does not give the merged checkpoint back")
    del a_flat, b_flat
    for d in (merged, hf_dir, back):
        shutil.rmtree(d)

    nf4_qkv = quant.quantize_model(
        {"blocks": {"attn": {"attn": {"kernel": base["blocks"]["attn"]["attn"]["kernel"]}}}},
        "bnb.nf4")["blocks"]["attn"]["attn"]

    def qlora_tree(device):
        """The QLoRA tree's qkv linear: its NF4 base and the delta's leaves (in bf16,
        as ``apply_finetuned`` sets them), on ``device``."""
        p = {k: v.to(device) for k, v in nf4_qkv.items()}
        for k in ("A", "B", "scale", "mask"):
            p[f"lora_{k}"] = delta[f"blocks.attn.attn.lora_{k}"].to(device=device,
                                                                    dtype=torch.bfloat16)
        return {"blocks": {"attn": {"attn": p}}}

    def both_merges(tree):
        """(the merge into the NF4 base, the dense merge of its dequantized kernel
        requantized)."""
        p = tree["blocks"]["attn"]["attn"]
        into = lora.merge_lora(tree)["blocks"]["attn"]["attn"]
        dq = quant.dequantize_model({"l": {k: v for k, v in p.items()
                                           if not k.startswith("lora_")}}, torch.float32)["l"]
        dq.update({k: v for k, v in p.items() if k.startswith("lora_")})
        dense = lora.merge_lora({"l": dq})["l"]
        return into, quant.quantize_model({"blocks": {"l": dense}}, "bnb.nf4")["blocks"]["l"]

    (into, dense_q), launches, merge_s = launched(torch, lambda: both_merges(qlora_tree("cuda")))
    add_counts(counts, launches)
    diff = (into["q4"] != dense_q["q4"]).nonzero().cpu()
    ties = None
    if diff.numel():  # the same positions must differ on the CPU
        cpu_into, cpu_dense = both_merges(qlora_tree("cpu"))
        ties = torch.equal((cpu_into["q4"] != cpu_dense["q4"]).nonzero(), diff)
    log(f"  (e) lora.merge_lora into the NF4 base of the QLoRA tree on the card in "
        f"{merge_s:.2f} s: q4 codes equal to the dense merge requantized: "
        f"{diff.numel() == 0} ({diff.shape[0]} bytes differ"
        + ("" if ties is None else f", at the CPU's positions: {ties}") + "); absmax equal: "
        f"{torch.equal(into['absmax'], dense_q['absmax'])}   [{card}]")
    if not ((diff.numel() == 0 or ties) and torch.equal(into["absmax"], dense_q["absmax"])):
        raise AssertionError("the NF4 merge differs from the dense merge requantized")
    out["merge_convert"] = {"bytes": nbytes, "steps_s": steps, "nf4_merge_s": merge_s,
                            "nf4_codes_differ": int(diff.shape[0]), "card": card}
    del base, into, dense_q, nf4_qkv
    gc.collect()
    torch.cuda.empty_cache()

    # (f) FastmaxLM on token ids, float32, batch_size 8: contexts of 64-1984 tokens
    cfg, f32 = load_model_params(ckpt, dtype=torch.float32, device="cuda")
    rng = np.random.default_rng(0)
    lens = np.linspace(64, 1984, EVAL_REQUESTS).astype(int)
    starts = rng.integers(0, tokens.size - 2048, EVAL_REQUESTS)
    reqs = [(tokens[s:s + n].tolist(), tokens[s + n:s + n + EVAL_CONT].tolist())
            for s, n in zip(starts, lens)]
    lm = harness.FastmaxLM(cfg, f32, None, batch_size=8)
    batched, launches, eval_s = launched(torch, lambda: lm.loglikelihood_tokens_batch(reqs))
    add_counts(counts, launches)
    serial = harness.FastmaxLM(cfg, f32, None, batch_size=1).loglikelihood_tokens_batch(reqs)
    plain = harness.FastmaxLM(cfg, f32, None, batch_size=8,
                              plain=True).loglikelihood_tokens_batch(reqs)
    b_rel = max(abs(x - y) / abs(y) for (x, _), (y, _) in zip(batched, serial))
    p_rel = max(abs(x - y) / abs(y) for (x, _), (y, _) in zip(batched, plain))
    idx = torch.as_tensor(np.stack([tokens[s:s + 2048] for s in starts[:8]]).astype(np.int32),
                          device="cuda")
    lp_k = lm._fwd(idx)
    lp_p = harness.FastmaxLM(cfg, f32, None, plain=True)._fwd(idx)
    lp_err = float((lp_k - lp_p).abs().max())
    del lp_k, lp_p
    ppl = harness.perplexity_on_tokens(lm, tokens[:EVAL_PPL_TOKENS], EVAL_PPL_STRIDE)
    log(f"  (f) FastmaxLM (f32, batch 8) over {EVAL_REQUESTS} requests, contexts {lens[0]}-"
        f"{lens[-1]} + {EVAL_CONT}: {eval_s:.2f} s, launches {launches}; batched vs serial "
        f"{b_rel:.3e}, kernels vs plain {p_rel:.3e} (relative, tolerance {EVAL_REL}); log-probs "
        f"at (8, 2048) kernels vs plain max|diff| {lp_err:.3e} (tolerance {EVAL_F32_ATOL}); "
        f"perplexity over {EVAL_PPL_TOKENS} tokens at stride {EVAL_PPL_STRIDE}: {ppl:.2f}   "
        f"[{card}]")
    if not (launches.get("flash_train_fwd") and b_rel <= EVAL_REL and p_rel <= EVAL_REL
            and lp_err <= EVAL_F32_ATOL and math.isfinite(ppl)
            and [g for _, g in batched] == [g for _, g in serial]):
        raise AssertionError(f"eval: launches {launches}, batched {b_rel}, plain {p_rel}, "
                             f"log-probs {lp_err}, perplexity {ppl}")
    out["eval"] = {"eval_s": eval_s, "launches": launches, "batched_rel": b_rel,
                   "plain_rel": p_rel, "logprob_err": lp_err, "perplexity": ppl, "card": card}
    del lm, f32
    gc.collect()
    torch.cuda.empty_cache()

    # (g) the pretraining out_dir of phase 12 (a) as a deployable directory
    with contextlib.redirect_stdout(io.StringIO()):
        convert_pretrained_checkpoint.main(["--checkpoint_dir", str(pt_out), "--output_dir",
                                            str(tmp / "pt_deploy")])
    _, deploy = load_model_params(tmp / "pt_deploy", device="cuda")
    _, final = load_model_params(pt_out / "final", device="cuda")
    same = trees_equal(torch, deploy, final)
    log(f"  (g) convert_pretrained_checkpoint on the pretraining out_dir (its state/): loads to "
        f"final/'s tree bit for bit: {same}")
    if not same:
        raise AssertionError("the converted pretraining state differs from final/")
    del deploy, final

    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  the phase in {out['phase_s']:.1f} s; launches {counts}")
    results["inference_commands"] = out
    return counts


# ----------------------------------------------------------------- phase 14
# The linear arms' serving path: the O(1) running state (ops/fastmax.py's state functions,
# gpt.forward_linear_cache, the engine, the batcher's slots and the command lines). The
# reference runs no Pallas kernel there (its state prefill calls the scan at every head size
# and its decode steps are plain XLA), so neither does the port: the path's one kernel is K1,
# the linears of the 4-bit 7B. K4 runs only in (b)'s reference, the no-cache forward
# recomputed at D = 64; its launches are held there and left out of the path's counts.
# (a) holds each state prefill (output and the entries its arm reads) and 16 decode steps
# against the same functions in float64 on the card at phase 9 (a)'s forward gate, and the
# fastmax steps also against the full masked fastmax() over the longer sequence (K4 at
# D = 64, the scan at D = 128) at LINSERVE_DECODE_REL of the largest output. (b) and (c)
# gate logits kernels against plain=True: (b) in float32 at LINSERVE_F32_LOGITS_REL of the
# largest (the two differ by their sums' order only), (c) as phase 10 does (float32
# activations at LOGITS_REL_TOL, bf16 reported), and hold every linear call of a prefill and
# a decode step (K1) against plain=True on the same input at phase 3's f32 INT4_RTOL of the
# largest output. Greedy tokens follow the near-tie rule. (c) also measures, for each arm,
# how far the model itself carries a change of the linears' size to the logits: plain=True
# against plain=True with every linear's output moved by noise of the largest relative
# difference the kernels showed (LINSERVE_PERTURB_SEEDS draws). performer's output is
# num / den with den floored at 0.05 |q| |sum k| and its sign kept, so a change of den near
# zero is passed on up to 20-fold, or flips the row's sign; its f32 logits kernels vs plain
# are gated at LINSERVE_PERTURB_FACTOR times that spread (never under LOGITS_REL_TOL), the
# other arms' at LOGITS_REL_TOL.
LINSERVE_OP_CASES = (("fastmax", (1, 8, 512, 64)), ("fastmax", (1, 32, 512, 128)),
                     ("linearmax", (1, 32, 512, 128)), ("performer", (1, 32, 512, 128)))
LINSERVE_STEPS = 16
LINSERVE_DECODE_REL = 1e-4
LINSERVE_F32_LOGITS_REL = 1e-4
LINSERVE_PERTURB_SEEDS, LINSERVE_PERTURB_FACTOR = (1, 2, 3), 2.0
LINSERVE_PROMPTS, LINSERVE_NEW = (64, 512), 32
# fastmax's p = 2 state is 8.59 GB a sequence at the 7B: 2 slots (the p = 1 arms take 8)
LINSERVE_SLOTS = {"fastmax": 2, "linearmax": N_SLOTS, "performer": N_SLOTS}
LINSERVE_BATCH_NEW = 16
LINSERVE_READS = {"fastmax": ("cnt", "s_v", "s_kv", "s_k", "s_kkv", "s_kk"),
                  "linearmax": ("cnt", "s_v", "s_kv", "s_k", "q_div", "k_div"),
                  "performer": ("s_kv", "s_k")}
# the reference's refusals (fastmax_tpu/inference/continuous.py:160-175)
LINSERVE_REFUSALS = (("fastmax", {"speculative_k": 4}, "speculative continuous batching "
                      "requires the KV-cache (quadratic) path"),
                     ("performer", {"prefix_cache_size": 2}, "prefix caching requires the "
                      "KV-cache (quadratic) path"),
                     ("linearmax", {"prefill_chunk": 64}, "chunked prefill requires the "
                      "KV-cache (quadratic) path"))


def linear_state_bytes(cfg, batch: int) -> int:
    """The reckoned bytes of ``init_linear_cache(cfg, batch)``: float32 entries of
    (L, B, H) x (1, D, D^2, D, D'D, D') with D' = D^2 at p = 2, else 1; linearmax adds
    two (L, B, H)."""
    d, p2 = cfg.head_size, cfg.attn_alg in ("fastmax", "fastmax_cuda")
    d2 = d * d if p2 else 1
    per_head = 1 + d + d * d + d + d2 * d + d2 + (2 if cfg.attn_alg == "linearmax" else 0)
    return 4 * cfg.n_layer * batch * cfg.n_head * per_head


def linear_state_case(torch, gen, arm, shape, card) -> dict:
    """(a) One arm's state prefill over N tokens and 16 decode steps (in place), float32
    against float64 on the card; fastmax's steps also against fastmax() over N + 16.
    Times: the prefill and one decode step (one layer's attention), by CUDA events."""
    from fastmax_tpu_torch.ops import fastmax as fm

    b, h, n, d = shape
    p = 2 if arm == "fastmax" else 1
    q, k, v, _ = fastmax_qkv(torch, gen, (b, h, n + LINSERVE_STEPS, d), p, torch.float32)
    z = 8.0 * math.sqrt(d)

    def prefill(dt):
        args = [x[:, :, :n].to(dt) for x in (q, k, v)]
        if arm == "fastmax":
            return fm.fastmax_prefill_state(*args, p=2)
        return (fm.linearmax_prefill_state if arm == "linearmax" else
                fm.performer_prefill_state)(*args)

    def step(state, t, dt):
        args = [x[:, :, t].to(dt) for x in (q, k, v)]
        if arm == "fastmax":
            return fm.linear_attn_decode_step(state, *args, z, 2)
        return (fm.linearmax_decode_step if arm == "linearmax" else
                fm.performer_decode_step)(state, *args)

    what = f"{arm} {tuple(shape)}"
    with torch.no_grad():
        got, ref = {}, {}
        for dt, into in ((torch.float32, got), (torch.float64, ref)):
            o, state = prefill(dt)
            into["prefill o"] = o
            into.update({f"prefill {name}": state[name].clone() for name in LINSERVE_READS[arm]})
            outs = []
            for t in range(n, n + LINSERVE_STEPS):
                state, o = step(state, t, dt)
                outs.append(o)
            into["decode o"] = torch.stack(outs, 2)
            into.update({f"decode {name}": state[name] for name in LINSERVE_READS[arm]})
        rel = {name: linear_rel(torch, f"{what} {name} vs float64", got[name], ref[name],
                                LINEAR_F32_REL["fwd"]) for name in got}
        if arm == "fastmax":
            full = fm.fastmax(q, k, v, mask=True, p=2)[:, :, n:]
            rel["decode o vs fastmax()"] = linear_rel(
                torch, f"{what} decode vs fastmax() over N + {LINSERVE_STEPS}", got["decode o"],
                full.double(), LINSERVE_DECODE_REL)
        del ref, got
        _, state = prefill(torch.float32)
        pre_ms = time_ms(lambda: prefill(torch.float32), 3, warmup=1)
        step_ms = time_ms(lambda: step(state, n, torch.float32), 20)
    d2 = d * d if p == 2 else 0
    # a step reads and writes the state it updates (s_kv, and at p = 2 s_kkv, s_kk) once
    step_bytes = 2 * 4 * b * h * (d * d + d2 * d + d2 + 3 * d + 1) + 4 * 4 * b * h * d
    row = {"arm": arm, "shape": list(shape), "rel": rel, "tolerance": {
        "vs float64": LINEAR_F32_REL["fwd"], "vs fastmax()": LINSERVE_DECODE_REL},
        "prefill_ms": pre_ms, "decode_step_ms": step_ms, "decode_step_bytes": step_bytes,
        "decode_step_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3, "card": card}
    log(f"  (a) {what}: max|f32 - f64| / max|f64| worst "
        f"{max(v_ for k_, v_ in rel.items() if 'fastmax()' not in k_):.3e} (tolerance "
        f"{LINEAR_F32_REL['fwd']})"
        + (f", {LINSERVE_STEPS} decode steps vs fastmax() {rel['decode o vs fastmax()']:.3e} "
           f"(tolerance {LINSERVE_DECODE_REL})" if arm == "fastmax" else "")
        + f"; prefill {pre_ms:.2f} ms, one decode step {step_ms:.3f} ms against a bytes bound "
        f"of {row['decode_step_bound_ms']:.3f} ms   [{card}]")
    return row


def linear_engine_small(torch, results, card) -> dict:
    """(b) ``InferenceEngine`` on easy-transformer-fastmax (random f32 weights): greedy 32
    tokens after a 64-token prompt against greedy decoding by recomputing the no-cache
    forward each step (K4, which must launch there); the state prefill's logits against
    that forward's, and the forward's with the kernels against plain=True. Returns the row
    and the engine's launch counts (the recompute's stay in the row)."""
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config

    cfg = Config.from_name("easy-transformer-fastmax")
    params = gpt.init_params(cfg, 0, torch.float32, "cuda")
    engine = InferenceEngine(cfg, params, max_seq_length=cfg.block_size)
    prompt = torch.as_tensor(np.random.default_rng(1).integers(1, cfg.vocab_size, 64),
                             dtype=torch.int32, device="cuda")
    n = 64 + LINSERVE_NEW
    out, launches_engine, engine_s = launched(torch, lambda: engine.generate(prompt, n))

    def recompute():
        seq = prompt[None].long()
        with torch.inference_mode():
            for _ in range(LINSERVE_NEW):
                logits, _ = gpt.forward(params, cfg, seq)
                seq = torch.cat([seq, logits[:, -1].argmax(-1, keepdim=True)], dim=1)
        return seq

    ref, launches_ref, ref_s = launched(torch, recompute)
    got, want = out[0, 64:].tolist(), ref[0, 64:].tolist()
    div = first_divergence(torch, engine, prompt.tolist(), got, want)
    with torch.inference_mode():
        state_logits, _ = engine.prefill(prompt[None], engine.new_cache())
        fwd = {plain: gpt.forward(params, cfg, prompt[None].long(), plain=plain)[0][:, -1]
               for plain in (False, True)}
    rel = {"state prefill vs no-cache forward": logits_rel(torch, state_logits, fwd[False]),
           "no-cache forward, kernels vs plain": logits_rel(torch, fwd[False], fwd[True])}
    row = {"model": "easy-transformer-fastmax (random f32 weights, seed 0)",
           "engine_launches": launches_engine, "recompute_launches": launches_ref,
           "engine_s": engine_s, "recompute_s": ref_s, "equal": got == want,
           "divergence": div, "logits_rel": rel, "tolerance": LINSERVE_F32_LOGITS_REL,
           "card": card}
    log(f"  (b) easy-transformer-fastmax engine: 64 + {LINSERVE_NEW} greedy in {engine_s:.2f} s "
        f"(launches {launches_engine}); recomputing the no-cache forward each step "
        f"{ref_s:.2f} s (launches {launches_ref}); tokens equal {got == want}"
        + (f", first divergence at step {div[0]}, top-2 margin {div[1]:.3e} of max|logit| "
           f"{div[2]:.3e}" if div else "")
        + "; logits max|diff|/max: " + ", ".join(f"{k_} {v_:.3e}" for k_, v_ in rel.items())
        + f" (tolerance {LINSERVE_F32_LOGITS_REL})   [{card}]")
    if not launches_ref.get("fastmax_fwd"):
        raise AssertionError(f"the no-cache forward at D = 64 launched no K4: {launches_ref}")
    if div and div[1] > NEAR_TIE_REL * div[2]:
        raise AssertionError(f"easy-transformer-fastmax: the state decode diverges from the "
                             f"recomputed forward at step {div[0]}, not a near-tie: {div}")
    if max(rel.values()) > LINSERVE_F32_LOGITS_REL:
        raise AssertionError(f"easy-transformer-fastmax logits: {rel}")
    del engine, params
    return row, launches_engine


def linears_vs_plain(torch, fn) -> tuple:
    """``fn()`` with every ``linear`` call of models/gpt.py also taken through plain=True
    on the same input: (the largest max|kernels - plain| / max|plain| of a call, calls)."""
    from fastmax_tpu_torch.models import gpt

    real, worst = gpt.linear, [0.0, 0]

    def both(p, x, layer=None, *, plain=False):
        y = real(p, x, layer, plain=plain)
        worst[0] = max(worst[0], logits_rel(torch, y.float(), real(p, x, layer, plain=True)
                                            .float()))
        worst[1] += 1
        return y

    gpt.linear = both
    try:
        fn()
    finally:
        gpt.linear = real
    return tuple(worst)


def perturbed_spread(torch, engine, prompt, step_token, rel) -> list:
    """How far the model carries a change of ``rel`` in its linears to the logits, with no
    kernel in either run: ``kernels_vs_plain``'s measures of plain=True against plain=True
    with every linear's output moved by clipped Gaussian noise of at most ``rel`` of its
    largest value, for each seed of LINSERVE_PERTURB_SEEDS: [({step: max|diff|/max|plain|},
    {step: mean|diff|/mean|plain|}), ...]."""
    from fastmax_tpu_torch.models import gpt

    real, out = gpt.linear, []
    for seed in LINSERVE_PERTURB_SEEDS:
        g = torch.Generator(device="cuda").manual_seed(seed)

        def moved(p, x, layer=None, *, plain=False):
            y = real(p, x, layer, plain=plain)
            noise = torch.randn(y.shape, generator=g, device=y.device).clamp_(-4.0, 4.0)
            return (y.float() + noise * (rel / 4.0) * y.float().abs().max()).to(y.dtype)

        out.append(kernels_vs_plain(torch, engine, prompt, step_token, moved=moved)[:2])
    return out


def timed_prompts(torch, engine, warm, prompts: dict, n_new: int) -> tuple:
    """``engine.generate`` on ``warm`` (a warm-up); then for each of ``prompts`` ({length:
    int32 tokens on the card}) the prefill's ms to its first token on the host, and
    ``n_new`` greedy tokens with their decode ms a token: ({length: {...}}, the last
    prompt's first token)."""
    from fastmax_tpu_torch.ops.sampling import sample

    engine.generate(warm, warm.numel() + 4)
    rows = {}
    for n, prompt in prompts.items():
        cache = engine.new_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = engine.prefill(prompt[None], cache)
        first = sample(logits)
        first.cpu()
        pre_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        gen, cache = engine.decode(cache, first, n, n_new)
        gen.cpu()
        rows[n] = {"prefill_ms": pre_ms, "tokens": gen[0].tolist(),
                   "decode_ms_a_token": (time.perf_counter() - t0) * 1e3 / (n_new - 1)}
        del cache
    return rows, first


def linear_engine_7b(torch, cfg, q4, arm, card) -> tuple:
    """(c) ``InferenceEngine`` on the 7B (rank-1 int4 linears, K1) with ``arm``: prompts
    of 64 and 512 tokens, 32 new tokens each (prefill ms, decode ms a token), a profile of
    the decode, peak memory, the state's bytes, logits kernels vs plain=True."""
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(cfg, q4, max_seq_length=cfg.block_size)
    rng = np.random.default_rng(2)
    warm = torch.as_tensor(rng.integers(1, 32000, 64), dtype=torch.int32)
    prompts = {n: torch.as_tensor(rng.integers(1, 32000, n), dtype=torch.int32, device="cuda")
               for n in LINSERVE_PROMPTS}
    row = {"arm": arm, "card": card}
    (row["prompts"], first), launches, wall = launched(
        torch, lambda: timed_prompts(torch, engine, warm, prompts, LINSERVE_NEW))
    row.update(launches=launches, wall_s=wall,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9,
               state_bytes=sum(x.numel() * x.element_size() for x in engine.new_cache().values()),
               state_bytes_reckoned=linear_state_bytes(cfg, 1))
    tok_s = 1e3 / row["prompts"][64]["decode_ms_a_token"]
    row["profile"] = profile_decode(torch, engine, first, tok_s, steps=4)
    prompt = torch.as_tensor(rng.integers(1, 32000, 64), dtype=torch.int32)
    rel, _, kern = kernels_vs_plain(torch, engine, prompt, None)
    saved, engine.params = engine.params, with_f32_activations(torch, engine.params)
    rel32, _, _ = kernels_vs_plain(torch, engine, prompt, kern[2])
    calls_rel, n_calls = linears_vs_plain(torch, lambda: kernels_vs_plain(
        torch, engine, prompt, kern[2]))
    spread = [r for r, _ in perturbed_spread(torch, engine, prompt, kern[2], calls_rel)]
    engine.params = saved
    widest = max(max(r.values()) for r in spread)
    limit = (max(LOGITS_REL_TOL, LINSERVE_PERTURB_FACTOR * widest) if arm == "performer"
             else LOGITS_REL_TOL)
    row["logits_kernels_vs_plain"] = {"bf16": rel, "f32": rel32, "f32_tolerance": limit}
    row["linear_calls_vs_plain"] = {"worst": calls_rel, "calls": n_calls,
                                    "tolerance": INT4_RTOL}
    row["plain_vs_perturbed_plain"] = {"f32": spread, "perturbation": calls_rel,
                                       "seeds": list(LINSERVE_PERTURB_SEEDS)}
    p = row["prompts"]
    log(f"  (c) Llama-2-7B {arm}: prefill {p[64]['prefill_ms']:.1f} ms (64 tokens), "
        f"{p[512]['prefill_ms']:.1f} ms (512); decode {p[64]['decode_ms_a_token']:.2f} ms a "
        f"token after 64, {p[512]['decode_ms_a_token']:.2f} after 512; device busy share "
        f"{row['profile'].get('busy_share', 'not measured')}; peak {row['peak_gb']:.3f} GB above "
        f"{base / 1e9:.3f} held; state {row['state_bytes'] / 1e9:.4f} GB a sequence (reckoned "
        f"{row['state_bytes_reckoned'] / 1e9:.4f}); launches {launches}; logits kernels vs "
        f"plain, max|diff|/max|plain|: f32 prefill {rel32['prefill']:.3e}, decode step "
        f"{rel32['decode_step']:.3e} (tolerance {limit:.3e}); bf16 {rel['prefill']:.3e}, "
        f"{rel['decode_step']:.3e}; each of the {n_calls} linear calls (f32 activations) "
        f"against plain on its input: at most {calls_rel:.3e} (tolerance {INT4_RTOL}); plain "
        f"vs plain with every linear moved by {calls_rel:.3e} of its largest, seeds "
        f"{list(LINSERVE_PERTURB_SEEDS)}: "
        + ", ".join(f"{r['prefill']:.3e}/{r['decode_step']:.3e}" for r in spread)
        + f" (prefill/decode step)   [{card}]")
    if not launches.get("int4_rank1_matmul") or row["state_bytes"] != row["state_bytes_reckoned"]:
        raise AssertionError(f"7B {arm}: launches {launches}, state bytes {row['state_bytes']} "
                             f"(reckoned {row['state_bytes_reckoned']})")
    if calls_rel > INT4_RTOL or max(rel32.values()) > limit:
        raise AssertionError(f"7B {arm}: f32 logits kernels vs plain {rel32} (tolerance "
                             f"{limit}; bf16 {rel}), linear calls {calls_rel}, plain vs "
                             f"perturbed plain {spread}")
    del engine
    return row, launches


def linear_batcher_7b(torch, cfg, q4, arm, card) -> tuple:
    """(d) A ``ContinuousBatcher`` on the 7B with ``arm``: one request a slot, prompts of
    different lengths inside one 128-token bucket (``n_valid``), 16 new tokens; each slot's
    tokens against the engine's solo run (near-tie rule). Float32 activations, as phase 10's
    batcher: in bf16 the random 32-layer model carries a linear's one-ulp difference (m = 8
    against m = 1) into the logits beyond the near-tie margin."""
    import numpy as np

    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine

    engine = InferenceEngine(cfg, q4, max_seq_length=cfg.block_size)
    slots = LINSERVE_SLOTS[arm]
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 32000, 100 + 3 * i).astype(np.int32) for i in range(slots)]
    solo = [engine.generate(torch.as_tensor(p), len(p) + LINSERVE_BATCH_NEW)[0, len(p):]
            .tolist() for p in prompts]
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def run():
        b = ContinuousBatcher(cfg, q4, n_slots=slots, max_seq_length=cfg.block_size)
        rids = [b.submit(p, LINSERVE_BATCH_NEW) for p in prompts]
        t0 = time.perf_counter()
        res = b.run_to_completion()
        return [res[r] for r in rids], time.perf_counter() - t0

    (got, dt), launches, _ = launched(torch, run)
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    rest = []
    for p, a, want in zip(prompts, got, solo):
        div = first_divergence(torch, engine, p.tolist(), a, want)
        if div is not None:
            rest.append(div)
            if div[1] > NEAR_TIE_REL * div[2]:
                raise AssertionError(f"7B batcher {arm}: slot tokens diverge from the engine's "
                                     f"at step {div[0]}, not a near-tie: {div}")
    row = {"arm": arm, "slots": slots, "prompt_lens": [len(p) for p in prompts],
           "new_tokens": LINSERVE_BATCH_NEW, "seconds": dt,
           "tok_s": slots * LINSERVE_BATCH_NEW / dt, "peak_gb": peak, "launches": launches,
           "equal": sum(a == w for a, w in zip(got, solo)), "near_ties": rest, "card": card}
    log(f"  (d) batcher, 7B {arm} (f32 activations): {slots} slots, prompts of "
        f"{row['prompt_lens'][0]}-{row['prompt_lens'][-1]} tokens in one 128 bucket, {LINSERVE_BATCH_NEW} new each in "
        f"{dt:.2f} s ({row['tok_s']:.1f} tok/s, prefill included); peak {peak:.3f} GB above "
        f"{base / 1e9:.3f} held; tokens == the engine's for {row['equal']} of {slots}; the "
        f"rest (step, top-2 margin, max|logit|): {rest}; launches {launches}   [{card}]")
    if not (launches.get("int4_rank1_matmul") and all(len(a) == LINSERVE_BATCH_NEW for a in got)):
        raise AssertionError(f"7B batcher {arm}: launches {launches}, tokens {got}")
    del engine
    return row, launches


def linear_commands(torch, card, ckpt) -> tuple:
    """(e) The command lines on phase 12's 2-layer checkpoint of the 7B's width with
    ``--attn_alg`` each arm: generate.main's text against the engine's tokens, a short
    bench_serving load (bnb.nf4, K1) and the eval harness's greedy_until; (f) the batcher's
    refusals with the reference's messages."""
    import importlib.util
    import io

    from fastmax_tpu_torch.eval import harness
    from fastmax_tpu_torch.inference import bench_serving, generate
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models.tokenizer import Tokenizer

    have_tok = importlib.util.find_spec("tokenizers") is not None
    rows, counts = {}, {}
    for arm in LINEAR_ARMS:
        row = {}
        if have_tok:
            tok = Tokenizer(ckpt)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
                _, launches, _ = launched(torch, lambda: generate.main(
                    prompt="def main", checkpoint_dir=ckpt, max_new_tokens=16, temperature=0.0,
                    attn_alg=arm))
            add_counts(counts, launches)
            cfg, params = generate.load_and_prepare(ckpt, attn_alg=arm)
            enc = tok.encode("def main")
            out = InferenceEngine(cfg, params, max_seq_length=len(enc) + 16).generate(
                torch.as_tensor(enc), len(enc) + 16, eos_id=tok.eos_id)
            want = tok.decode(out[0].cpu().numpy())
            lm = harness.FastmaxLM(cfg, params, tok, max_seq_length=256)
            until = lm.greedy_until("def main", 16)
            row.update(generate_main=buf.getvalue().strip() == want.strip(),
                       greedy_until=until == tok.decode(out[0, len(enc):].cpu().numpy()))
            del params, lm
        flags = ["--checkpoint_dir", str(ckpt), "--attn_alg", arm, "--quantize", "bnb.nf4",
                 "--n_slots", "4", "--n_requests", "8", "--prompt_len", "64",
                 "--max_new_tokens", "16"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            got, launches, wall = launched(torch, lambda: bench_serving.main(flags))
        add_counts(counts, launches)
        line = json.loads(buf.getvalue().strip().splitlines()[-1])
        row.update(bench=line, bench_launches=launches, bench_wall_s=wall)
        none = "(no tokenizers package)"
        log(f"  (e) {arm}: generate.main == the engine's text {row.get('generate_main', none)}; "
            f"greedy_until == the engine's {row.get('greedy_until', none)}; "
            f"bench_serving {' '.join(flags[2:])}: {line['generated_tokens']} tokens, "
            f"{line['aggregate_tok_s']} tok/s, TTFT p50 {line['ttft_p50_ms']} ms, {wall:.1f} s; "
            f"launches {launches}   [{card}]")
        if not (row.get("generate_main", True) and row.get("greedy_until", True)
                and line == got and line["generated_tokens"] == 8 * 16
                and launches.get("int4_rank1_matmul")):
            raise AssertionError(f"command lines with {arm}: {row}")
        rows[arm] = row
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.utils.checkpoint import load_model_params

    _, params = load_model_params(ckpt, dtype=torch.bfloat16, device="cuda")
    refused = {}
    for arm, kw, msg in LINSERVE_REFUSALS:
        try:
            ContinuousBatcher(Config.from_checkpoint(ckpt, attn_alg=arm), params, n_slots=1, **kw)
        except ValueError as e:
            refused[next(iter(kw))] = str(e)
            if msg not in str(e):
                raise AssertionError(f"{arm} with {kw}: {e!r}, not the reference's {msg!r}")
        else:
            raise AssertionError(f"the batcher took {kw} with {arm}")
    log(f"  (f) refused with the reference's ValueError: {refused}")
    return rows, refused, counts


def linear_serving_path(torch, results, card, tmp, ckpt) -> dict:
    """Phase 14: the linear arms' serving path (see above); returns the launch counts of
    its serving path ((b)-(e), the references that check it left out): K1's alone."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import quant

    log("[14] the linear arms' serving path: the O(1) state's functions vs float64, the "
        "engine on easy-transformer-fastmax and on Llama-2-7B with each arm, the batcher's "
        "slots, the command lines and the refusals")
    t_phase = time.perf_counter()
    out, counts = {}, {}
    gc.collect()
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(14)
    out["op_check"] = [linear_state_case(torch, gen, arm, shape, card)
                       for arm, shape in LINSERVE_OP_CASES]
    out["easy_transformer"], launches = linear_engine_small(torch, results, card)
    add_counts(counts, launches)

    cfg0 = Config.from_name("Llama-2-7b-hf", n_layer=LAYERS_7B)
    cfg0.block_size = 1024
    t0 = time.perf_counter()
    dense = gpt.init_params(cfg0, 0, torch.bfloat16, "cuda")
    nf4 = quant.quantize_model(dense, "bnb.nf4")
    del dense
    q4 = InferenceEngine.prepare_params(nf4, "preload_int4")
    del nf4
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  random bf16 Llama-2-7B (seed 0) at full width cut to {LAYERS_7B} of its 32 "
        f"layers -> bnb.nf4 -> preload_int4 (K1) on the card in {time.perf_counter() - t0:.2f} s;"
        f" {torch.cuda.memory_allocated() / 1e9:.3f} GB held")
    out["engine_7b"], out["batcher_7b"] = {}, {}
    q4_f32 = with_f32_activations(torch, q4)
    for arm in LINEAR_ARMS:
        cfg = Config.from_name("Llama-2-7b-hf", attn_alg=arm, n_layer=LAYERS_7B)
        cfg.block_size = 1024
        out["engine_7b"][arm], launches = linear_engine_7b(torch, cfg, q4, arm, card)
        add_counts(counts, launches)
        out["batcher_7b"][arm], launches = linear_batcher_7b(torch, cfg, q4_f32, arm, card)
        add_counts(counts, launches)
    del q4, q4_f32
    gc.collect()
    torch.cuda.empty_cache()
    out["commands"], out["refusals"], launches = linear_commands(torch, card, ckpt)
    add_counts(counts, launches)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  the phase in {out['phase_s']:.1f} s; launches of its serving path {counts} (the "
        f"K4 launches of (b)'s recomputed reference are not among them)")
    if set(counts) != {"int4_rank1_matmul"}:
        raise AssertionError(f"phase 14's serving path launched {counts}, not K1 alone")
    results["linear_serving"] = out
    return counts


# ----------------------------------------------------------------- phase 15
# Gemma's GeGLU and Mixtral's top-k MoE, the adapter methods and the optimizers of
# --train.optimizer. Gemma-7B serves at full width and depth (28 layers, 16 heads of
# 256, intermediate 24576, vocab 256000); Mixtral-8x7B at full width, cut to
# MIXTRAL_LAYERS of its 32 layers: its experts stay dense bf16 in every weights mode,
# as the reference keeps them (2.82 GB a layer; all 32 need 90 GB, more than the card
# holds). Kernels against plain are held, by gates fixed before the run, on a second
# engine over the same linears with float32 activations and a float32 cache; the path's
# own (int8 cache, bf16) logits are reported. The int8 cache is left out of the gates
# because it makes any difference chaotic: a code at a rounding edge flips by 1/127 of its
# row's absmax, so that every linear moved by 3e-6 moved Gemma-7B's logits by ~2e-2, and
# every linear moved by 3e-5 moved Mixtral's by up to 0.37 (an expert choice flips) (on
# an H100 80GB HBM3 at 700 W). (1) Each linear call against plain=True on its own input,
# at most FAMILY_CALL_REL of its largest output: ten times the largest the kernels showed
# (3.04e-06 over Gemma-7B's 452 calls, 1.67e-06 over Mixtral's 100, same card). (2) The
# logits at the longest prompt, max|diff| over max|plain| at LOGITS_REL_TOL and
# mean|diff| over mean|plain| at FAMILY_MEAN_REL. (3) FAMILY_CHECK_NEW greedy tokens of
# each prompt against plain=True's, and the batcher's slots (int8 cache, float32
# activations) against the plain engine's, by the near-tie rule (NEAR_TIE_REL). A
# finetuning run trains on copies of one example, so that its second step sees the first
# step's batch and a falling loss is the update's own doing; its learning rate is set so
# that one update moves the trained leaves by more than a bf16 step of the activations
# (LoRA 3e-3, the adapter's gates 1e-2, v2's scales 3e-3). v1 trains in float32: one step
# of its gates moves the bf16 loss by less than the loss's own rounding (11.08459 ->
# 11.08406 in one run, 11.08506 -> 11.08548 in another, on an H100 80GB HBM3 at 700 W), so
# only float32 shows that step's fall.
GEMMA, MIXTRAL = "Gemma-7b", "Mixtral-8x7B-v0.1"
GEMMA_SERVE_LAYERS = 14      # of Gemma-7B's 28 in (a) (all 28 before phase 20)
MIXTRAL_LAYERS = 8
FAMILY_PROMPTS = (64, 512)   # the 512-token prefill takes K3 at D = 256 over S = 4096
FAMILY_NEW = 32
FAMILY_SLOTS, FAMILY_CHECK_NEW = 4, 16
FAMILY_MEAN_REL = 1e-3
FAMILY_CALL_REL = 3e-5
FAMILY_FT_T = 1024           # K6/K7's fused route at D = 256 takes T * D <= 4096 * 64
FAMILY_FT_STEPS = 2
FAMILY_LR = {"lora": 3e-3, "adapter": 1e-2, "adapter_v2": 3e-3}
ADAPTER_T = 2048
OPT_STEPS = 10
# pretraining learning rates, no warmup: adamw8bit at adamw's; lion at a tenth (its
# updates are signs); adafactor on its own scale (it multiplies by each leaf's RMS)
OPT_LR = {"adamw8bit": 6e-4, "lion": 6e-5, "adafactor": 1e-2}


def one_example_npz(np, path: Path, length: int, copies: int = 8) -> Path:
    """``copies`` of one SFT example of exactly ``length`` tokens of the repository's
    text (Llama's byte-fallback ids), its first quarter of labels masked."""
    tokens, _ = repo_text_tokens(np)
    x = tokens[:length].astype(np.int64) + 3
    y = x.copy()
    y[: length // 4] = -1
    np.savez(path, examples=np.array([{"input_ids": x, "labels": y}] * copies, dtype=object))
    return path


def family_engine(torch, cfg, tree, name, card) -> tuple:
    """``InferenceEngine`` (int8 cache) on ``tree``: prompts of FAMILY_PROMPTS tokens (up
    to the block size), FAMILY_NEW new each (prefill ms, decode ms a token), the decode's
    device busy share, peak memory, the MoE layers' host reads; kernels against plain by
    the three gates above (on float32 activations and cache; the path's bf16 logits with
    the int8 cache reported): the linear calls and the logits at the longest prompt, the
    greedy tokens at each. Returns (the engine, the measures, the launches)."""
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import gpt

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(cfg, tree, max_seq_length=cfg.block_size, cache_dtype=torch.int8)
    rng = np.random.default_rng(15)
    lens = [n for n in FAMILY_PROMPTS if n + FAMILY_NEW <= cfg.block_size]
    prompts = {n: torch.as_tensor(rng.integers(1, cfg.vocab_size, n), dtype=torch.int32,
                                  device="cuda") for n in lens}
    row = {"model": name, "layers": cfg.n_layer, "block_size": cfg.block_size, "card": card}
    reads = gpt.MOE_HOST_READS[0]
    (row["prompts"], first), launches, wall = launched(
        torch, lambda: timed_prompts(torch, engine, prompts[lens[0]], prompts, FAMILY_NEW))
    forwards = 4 + len(lens) * FAMILY_NEW  # warm-up: a prefill, 3 steps; each prompt 1 + 31
    reads = gpt.MOE_HOST_READS[0] - reads
    row.update(launches=launches, wall_s=wall,
               peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9, held_gb=base / 1e9,
               moe_host_reads=reads, moe_reads_a_layer_a_forward=reads / (forwards * cfg.n_layer))
    tok_s = 1e3 / row["prompts"][lens[0]]["decode_ms_a_token"]
    row["profile"] = profile_decode(torch, engine, first, tok_s, steps=4)
    prompt = prompts[lens[-1]]
    bf16, bf16_mean, _ = kernels_vs_plain(torch, engine, prompt, None)
    check = InferenceEngine(cfg, with_f32_activations(torch, tree), max_seq_length=cfg.block_size)
    got = []
    calls_rel, n_calls = linears_vs_plain(
        torch, lambda: got.extend(kernels_vs_plain(torch, check, prompt, None)))
    rel, mean, _ = got
    row["tokens_f32"] = {}
    for n, p in prompts.items():
        a, b = (check.generate(p, n + FAMILY_CHECK_NEW, plain=plain)[0, n:].tolist()
                for plain in (False, True))
        div = first_divergence(torch, check, p.tolist(), a, b)
        row["tokens_f32"][n] = {"equal": div is None, "divergence": div}
    del check
    row.update(logits_f32={"max": rel, "mean": mean},
               f32_tolerance={"max": LOGITS_REL_TOL, "mean": FAMILY_MEAN_REL},
               logits_bf16_int8_cache={"max": bf16, "mean": bf16_mean},
               linear_calls_vs_plain={"worst": calls_rel, "calls": n_calls,
                                      "tolerance": FAMILY_CALL_REL})
    p = row["prompts"]
    log(f"  {name}, {cfg.n_layer} layers: " + "; ".join(
        f"prefill {p[n]['prefill_ms']:.1f} ms ({n} tokens), decode "
        f"{p[n]['decode_ms_a_token']:.2f} ms a token after it" for n in lens)
        + f"; device busy share {row['profile'].get('busy_share', 'not measured')}; peak "
        f"{row['peak_gb']:.3f} GB above {row['held_gb']:.3f} held; launches {launches}; MoE host "
        f"reads {reads} ({row['moe_reads_a_layer_a_forward']:.3f} a layer a forward); each of "
        f"the {n_calls} linear calls (f32) against plain on its input: at most {calls_rel:.3e} "
        f"(gate {FAMILY_CALL_REL}); logits kernels vs plain at {lens[-1]} tokens, "
        f"max|diff|/max|plain| (mean|diff|/mean|plain|), f32 with an f32 cache: "
        + ", ".join(f"{k} {rel[k]:.3e} ({mean[k]:.3e})" for k in rel)
        + f" (gates {LOGITS_REL_TOL}, {FAMILY_MEAN_REL}); the path's, bf16 with the int8 cache: "
        + ", ".join(f"{k} {bf16[k]:.3e} ({bf16_mean[k]:.3e})" for k in bf16)
        + f"; {FAMILY_CHECK_NEW} f32 greedy tokens kernels vs plain (step, top-2 margin, "
        f"max|logit|): " + ", ".join(f"{n}: {'equal' if t['equal'] else t['divergence']}"
                                     for n, t in row["tokens_f32"].items()) + f"   [{card}]")
    if (calls_rel > FAMILY_CALL_REL or max(rel.values()) > LOGITS_REL_TOL
            or max(mean.values()) > FAMILY_MEAN_REL):
        raise AssertionError(f"{name}: linear calls {calls_rel} (gate {FAMILY_CALL_REL}), f32 "
                             f"logits kernels vs plain {rel}, {mean} (gates {LOGITS_REL_TOL}, "
                             f"{FAMILY_MEAN_REL})")
    for n, t in row["tokens_f32"].items():
        div = t["divergence"]
        if div is not None and div[1] > NEAR_TIE_REL * div[2]:
            raise AssertionError(f"{name}: greedy tokens after {n}, kernels vs plain, diverge "
                                 f"at step {div[0]}, not a near-tie: {div}")
    if not launches.get("int4_rank1_matmul"):
        raise AssertionError(f"{name}: launches {launches}")
    return engine, row, launches


def family_batcher(torch, cfg, tree32, name, card) -> tuple:
    """A FAMILY_SLOTS-slot ``ContinuousBatcher`` (int8 cache, float32 activations, as
    phase 14's) on ``tree32``: prompts of 100-121 tokens, FAMILY_CHECK_NEW new each, every
    slot's tokens against the engine's plain=True run (near-tie rule)."""
    import numpy as np

    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.inference.engine import InferenceEngine

    engine = InferenceEngine(cfg, tree32, max_seq_length=cfg.block_size, cache_dtype=torch.int8)
    rng = np.random.default_rng(16)
    prompts = [rng.integers(1, cfg.vocab_size, 100 + 7 * i).astype(np.int32)
               for i in range(FAMILY_SLOTS)]
    solo = [engine.generate(torch.as_tensor(p), len(p) + FAMILY_CHECK_NEW,
                            plain=True)[0, len(p):].tolist() for p in prompts]

    def run():
        b = ContinuousBatcher(cfg, tree32, n_slots=FAMILY_SLOTS, max_seq_length=cfg.block_size,
                              cache_dtype=torch.int8)
        rids = [b.submit(p, FAMILY_CHECK_NEW) for p in prompts]
        t0 = time.perf_counter()
        res = b.run_to_completion()
        return [res[r] for r in rids], time.perf_counter() - t0

    (got, dt), launches, _ = launched(torch, run)
    rest = []
    for p, a, want in zip(prompts, got, solo):
        div = first_divergence(torch, engine, p.tolist(), a, want)
        if div is not None:
            rest.append(div)
            if div[1] > NEAR_TIE_REL * div[2]:
                raise AssertionError(f"{name} batcher: slot tokens diverge from plain's at step "
                                     f"{div[0]}, not a near-tie: {div}")
    row = {"slots": FAMILY_SLOTS, "new_tokens": FAMILY_CHECK_NEW, "seconds": dt,
           "tok_s": FAMILY_SLOTS * FAMILY_CHECK_NEW / dt, "launches": launches,
           "equal": sum(a == w for a, w in zip(got, solo)), "near_ties": rest, "card": card}
    log(f"  {name} batcher (f32 activations, int8 cache): {FAMILY_SLOTS} slots, "
        f"{FAMILY_CHECK_NEW} new tokens each in {dt:.2f} s ({row['tok_s']:.1f} tok/s, prefill "
        f"included); tokens == the engine's plain=True run's for {row['equal']} of "
        f"{FAMILY_SLOTS}; the rest (step, top-2 margin, max|logit|): "
        f"{rest}; launches {launches}   [{card}]")
    if not (launches.get("int4_rank1_matmul")
            and all(len(a) == FAMILY_CHECK_NEW for a in got)):
        raise AssertionError(f"{name} batcher: launches {launches}, tokens {got}")
    del engine
    return row, launches


def finetune_run(torch, model_name, data, out, card, method="lora", optimizer="adamw",
                 t=FAMILY_FT_T, micro=1, precision="bfloat16", **kw) -> tuple:
    """``finetune.setup`` on an NF4 base (quadratic) for FAMILY_FT_STEPS steps over
    ``data`` (copies of one example), one micro-batch a step: (state, the run's numbers);
    raises unless the loss is finite and falls, and K6 launched 2 a layer a micro-batch
    (under remat) and K7 1 a layer whose attention's input needs a gradient: every layer
    but, for ``adapter`` (v1), layer 0, below which nothing trains."""
    import csv

    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.training.quant_optim import state_nbytes
    from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs

    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    train = TrainArgs(global_batch_size=micro, micro_batch_size=micro,
                      max_iters=FAMILY_FT_STEPS, learning_rate=FAMILY_LR[method],
                      lr_warmup_steps=0, save_interval=1000, log_interval=1, max_seq_length=t,
                      optimizer=optimizer)
    state, launches, wall = launched(torch, lambda: finetune.setup(
        method=method, model_name=model_name, data_path=data, quantize="bnb.nf4",
        attn_alg="quadratic", precision=precision, train=train, io=IOArgs(out_dir=out), **kw))
    with open(out / "metrics.csv", newline="") as f:
        steps = {int(r["step"]): r for r in csv.DictReader(f)}
    losses = [float(steps[i]["loss"]) for i in sorted(steps)]
    n_layer = Config.from_name(model_name).n_layer
    want = {"flash_train_fwd": 2 * n_layer * FAMILY_FT_STEPS,
            "flash_train_bwd": (n_layer - (method == "adapter")) * FAMILY_FT_STEPS}
    run = {"model": model_name, "method": method, "optimizer": optimizer, "t": t,
           "precision": precision,
           "micro_batch": micro, "lr": FAMILY_LR[method], "wall_s": wall,
           "step_s": float(steps[FAMILY_FT_STEPS]["time"]) - float(steps[1]["time"]),
           "losses": losses, "peak_gb": (torch.cuda.max_memory_allocated() - held) / 1e9,
           "held_before_gb": held / 1e9, "launches": launches,
           "optimizer_state_bytes": state_nbytes(state.opt_state), "card": card, **kw}
    log(f"  {model_name} {method} ({optimizer}, {precision}), T {t}: {FAMILY_FT_STEPS} steps in "
        f"{wall:.2f} s "
        f"(setup included); step 2 {run['step_s']:.2f} s; loss {losses[0]:.5f} -> "
        f"{losses[-1]:.5f}; peak {run['peak_gb']:.3f} GB above {held / 1e9:.3f} held; optimizer "
        f"state {run['optimizer_state_bytes']} bytes; launches {launches}   [{card}]")
    if not (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]):
        raise AssertionError(f"{model_name} {method}: the loss did not fall: {losses}")
    if {k: launches.get(k, 0) for k in want} != want:
        raise AssertionError(f"{model_name} {method}: K6/K7 launches {launches} != {want}")
    return state, run


def moe_dispatch_check(torch, engine, prompt, card) -> dict:
    """The sorted route twice (the path's bf16 and int8 cache): the same bits; then sorted
    against dense on the prefill logits, on float32 activations and cache (the int8 cache
    would pass a code's rounding flip on)."""
    import functools

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import gpt

    def logits(eng):
        return eng.prefill(prompt[None], eng.new_cache())[0].float()

    a, b = logits(engine), logits(engine)
    same = bool(torch.equal(a, b))
    check = InferenceEngine(engine.cfg, with_f32_activations(torch, engine.params),
                            max_seq_length=engine.max_seq_length)
    real = gpt.apply_moe
    try:
        sorted32 = logits(check)
        gpt.apply_moe = functools.partial(real, sorted_dispatch=False)
        dense32 = logits(check)
    finally:
        gpt.apply_moe = real
    rel = logits_rel(torch, sorted32, dense32)
    log(f"  MoE dispatch: sorted route twice bit for bit {same}; sorted vs dense (f32 "
        f"activations and cache) prefill logits max|diff|/max|dense| {rel:.3e} (tolerance "
        f"{LOGITS_REL_TOL})   [{card}]")
    if not same or rel > LOGITS_REL_TOL:
        raise AssertionError(f"MoE dispatch: repeat {same}, sorted vs dense {rel}")
    return {"repeat_bitwise": same, "sorted_vs_dense_f32": rel}


# the device functions of K6 and K7 that bf16 at D = 256 must run (the FMA ones are
# flash_train_fwd_kernel and flash_train_bwd_kernel)
TC_ROUTE_256 = {"flash_train_fwd": "flash_train_fwd_tc_kernel",
                "flash_train_bwd": "flash_train_bwd_tc_pair_kernel"}
ROUTE_CALLS, ROUTE_PROFILES = 3, 3


def tc_route_256(prof, what, card):
    """The device functions of K6 and K7 in ``prof`` (profile_device's), or None where it
    recorded no device time; raises unless each kernel ran its TC_ROUTE_256 function and
    nothing else."""
    if not prof["device_us"]:
        return None
    ran = {kernel: sorted({n for n in prof["names"] if kernel in n}) for kernel in TC_ROUTE_256}
    log(f"  device functions of K6/K7 in {what}: " + "; ".join(
        f"{kernel}: {fns}" for kernel, fns in ran.items()) + f"   [{card}]")
    for kernel, fn in TC_ROUTE_256.items():
        if not ran[kernel] or not all(fn in n for n in ran[kernel]):
            raise AssertionError(f"{kernel} in {what} ran {ran[kernel]}, not {fn}")
    return ran


def flash_train_route(torch, gen, shape, card):
    """``tc_route_256`` of a profile of ROUTE_CALLS K6 and K7 calls at ``shape`` (bf16, D =
    256). A profile this short has come back empty late in a whole run of this script, so
    an empty one is taken again, up to ROUTE_PROFILES times; None if each was empty."""
    from fastmax_tpu_torch.ops import flash_attention as fa

    q, k, v, w = flash_train_inputs(torch, gen, shape, torch.bfloat16)
    scale, blk = shape[3] ** -0.5, fa._fused_block(shape[2])
    out, lse = fa._train_fwd(q, k, v, scale, blk, False)
    delta = torch.sum(w.float() * out.float(), dim=-1)

    def calls():
        for _ in range(ROUTE_CALLS):
            fa._train_fwd(q, k, v, scale, blk, False)
            fa._train_bwd(q, k, v, w, lse, delta, scale, False)

    what = f"{ROUTE_CALLS} K6 and K7 calls at {shape} bf16"
    for _ in range(ROUTE_PROFILES):
        prof = profile_device(torch, calls, what, per=ROUTE_CALLS)
        if prof["device_us"]:
            break
    return tc_route_256(prof, what, card)


def qlora_micro_batch_profile(torch, state, model_name, data, card) -> dict:
    """One micro-batch (forward and backward, the step's only one) of a finished QLoRA run
    on ``data``, profiled by kernel group: device us, and K6's and K7's share of it."""
    from fastmax_tpu_torch.data.lm_datasets import SFTDataset
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import finetune

    cfg = Config.from_name(model_name, attn_alg="quadratic")
    batch = tuple(torch.as_tensor(x, device="cuda")
                  for x in SFTDataset.load(data, 7).sample_batch(1, FAMILY_FT_T))
    loss_fn = finetune.sft_loss_fn(cfg)

    def micro_batch():
        loss_fn(state.params, batch).backward()

    micro_batch()
    prof = profile_device(torch, micro_batch, f"one {model_name} QLoRA micro-batch")
    if not prof["device_us"]:
        return prof
    groups = prof["by_group_us"]
    prof["k6_k7_us"] = groups["K6 flash_train_fwd"] + groups["K7 flash_train_bwd"]
    prof["k6_k7_share"] = prof["k6_k7_us"] / prof["device_us"]
    log(f"  {model_name} QLoRA micro-batch: device {prof['device_us'] / 1e3:.1f} ms, K6 "
        f"{groups['K6 flash_train_fwd'] / 1e3:.2f} + K7 {groups['K7 flash_train_bwd'] / 1e3:.2f}"
        f" ms = {prof['k6_k7_share']:.4f} of it   [{card}]")
    return prof


def families_path(torch, results, card) -> dict:
    """Phase 15 (a)-(e); (f) runs in phase 12's directory (``adapter_commands``).
    Returns the launch counts of its main paths."""
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.training.step import tree_leaves

    log("[15] Gemma-7B and Mixtral-8x7B serve and finetune; the adapter methods and the "
        "adamw8bit, adafactor and lion optimizers")
    t_phase = time.perf_counter()
    out, counts = {}, {}
    gen = torch.Generator(device="cuda").manual_seed(15)
    # the 4-bit backend is process-global: set here, so that K8 (training's NF4 matmuls
    # whose input needs no gradient) is on this phase's path whatever ran before it
    backend = quant.get_quant_backend()
    quant.set_quant_backend("pallas")

    # (a) Gemma-7B at full width cut to GEMMA_SERVE_LAYERS, bnb.nf4 -> preload_int4 (K1),
    # 4096 context
    cfg = Config.from_name(GEMMA, n_layer=GEMMA_SERVE_LAYERS)
    t0 = time.perf_counter()
    dense = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
    n_params = sum(x.numel() for x in tree_leaves(dense))
    nf4 = quant.quantize_model(dense, "bnb.nf4")
    del dense
    q4 = InferenceEngine.prepare_params(nf4, "preload_int4")
    del nf4
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  (a) random bf16 {GEMMA} ({n_params / 1e9:.3f} B parameters, seed 0) -> bnb.nf4 -> "
        f"preload_int4 on the card in {time.perf_counter() - t0:.2f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.3f} GB held")
    engine, row, launches = family_engine(torch, cfg, q4, GEMMA, card)
    add_counts(counts, launches)
    if not launches.get("flash_attention"):
        raise AssertionError(f"{GEMMA}: K3 did not launch at D = 256: {launches}")
    del engine
    q4_f32 = with_f32_activations(torch, q4)
    row["batcher"], launches = family_batcher(torch, cfg, q4_f32, GEMMA, card)
    add_counts(counts, launches)
    row["params"] = n_params
    out["gemma_serve"] = row
    # K3 at Gemma's prefill shape, and K6/K7 at its finetune shape, against plain and SDPA
    kc = flash_case(torch, gen, 1, 16, 16, 4096, 256, torch.bfloat16, 512, 0)
    out["k3_gemma"] = flash_times(torch, gen, ((torch.bfloat16, 256, 512, 0),), heads=16,
                                  label="Gemma-7B")[0]
    out["k3_gemma"]["max_abs_err"], out["k3_gemma"]["mean_err"] = kc["max_abs_err"], kc["mean_err"]
    shape = (1, 16, FAMILY_FT_T, 256)
    c = flash_train_case(torch, gen, "fused", shape, torch.bfloat16, f64=False)
    r = flash_train_times(torch, gen, torch.bfloat16, shape=shape)
    r["errors"] = c["errors"]
    out["k6_k7_gemma"] = r
    fb, bb = r["fwd_bound"], r["bwd_bound"]
    log(f"  K6/K7 at {shape} bf16: K6 {r['k6_ms'] * 1e3:.1f} us (plain {r['plain_fwd_ms'] * 1e3:.1f}, "
        f"SDPA ({r['sdpa_backend']}) {r['sdpa_fwd_ms'] * 1e3:.1f}, bound {fb['bound_ms'] * 1e3:.1f}, "
        f"{fb['bound_by']}); K7 {r['k7_ms'] * 1e3:.1f} us (plain {r['plain_bwd_ms'] * 1e3:.1f}, "
        f"SDPA backward {(r['sdpa_fwd_bwd_ms'] - r['sdpa_fwd_ms']) * 1e3:.1f}, bound "
        f"{bb['bound_ms'] * 1e3:.1f}, {bb['bound_by']}); errors "
        + ", ".join(f"{k} {a:.2e}" for k, (a, _, _) in c["errors"].items()) + f"   [{card}]")
    r["route"] = flash_train_route(torch, gen, shape, card)
    del q4, q4_f32

    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # (b) Gemma-7B QLoRA: LoRA on query, value and the GeGLU MLP, T = 1024 (K6/K7 at D = 256)
        data = one_example_npz(np, tmp / "t1024.npz", FAMILY_FT_T)
        state, run = finetune_run(torch, GEMMA, data, tmp / "gemma", card, lora_r=8,
                                  lora_alpha=16.0, lora_query=True, lora_value=True,
                                  lora_mlp=True)
        moved = float(state.params["blocks"]["mlp"]["fc_1"]["lora_B"].detach().float().abs()
                      .max())
        run["mlp_lora_b_max"] = moved
        if not moved > 0:
            raise AssertionError(f"{GEMMA} QLoRA: the MLP's lora_B did not move")
        run["micro_batch_profile"] = qlora_micro_batch_profile(torch, state, GEMMA, data, card)
        # the main path's own K6/K7 launches witness the route too; one witness must speak
        run["route"] = tc_route_256(run["micro_batch_profile"], f"one {GEMMA} QLoRA "
                                    "micro-batch", card)
        if run["route"] is None and out["k6_k7_gemma"]["route"] is None:
            raise AssertionError(f"K6/K7 at D = 256: no profile recorded device time, so "
                                 f"the route to {TC_ROUTE_256} is not shown")
        log(f"  {GEMMA} QLoRA step 2: {run['step_s'] * 1e3:.1f} ms (host clock, one micro-batch "
            f"and the update)   [{card}]")
        add_counts(counts, run["launches"])
        out["gemma_qlora"] = run
        del state

        # (c) Mixtral-8x7B, full width, MIXTRAL_LAYERS layers
        cut = cut_model(MIXTRAL, MIXTRAL_LAYERS)
        mcfg = Config.from_name(cut)
        mcfg.block_size = 1024
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        dense = gpt.init_params(mcfg, 0, torch.bfloat16, "cuda")
        m_params = sum(x.numel() for x in tree_leaves(dense))
        q4 = InferenceEngine.prepare_params(quant.quantize_model(dense, "bnb.nf4"), "preload_int4")
        del dense
        gc.collect()
        torch.cuda.empty_cache()
        log(f"  (c) random bf16 {MIXTRAL} cut to {MIXTRAL_LAYERS} layers ({m_params / 1e9:.3f} B "
            f"parameters) -> bnb.nf4 (attention and router; the experts stay bf16) -> "
            f"preload_int4 in {time.perf_counter() - t0:.2f} s; "
            f"{torch.cuda.memory_allocated() / 1e9:.3f} GB held")
        engine, row, launches = family_engine(torch, mcfg, q4, cut, card)
        add_counts(counts, launches)
        if row["moe_reads_a_layer_a_forward"] != 1.0:
            raise AssertionError(f"{cut}: MoE host reads {row['moe_host_reads']}")
        prompt = torch.as_tensor(np.random.default_rng(17).integers(1, 32000, 64),
                                 dtype=torch.int32, device="cuda")
        row["dispatch"] = moe_dispatch_check(torch, engine, prompt, card)
        row["params"] = m_params
        out["mixtral_serve"] = row
        del engine, q4
        state, run = finetune_run(torch, cut, data, tmp / "mixtral", card, lora_r=8,
                                  lora_alpha=16.0, lora_query=True, lora_value=True,
                                  lora_mlp=True)
        moved = float(state.params["blocks"]["mlp"]["gate"]["lora_B"].detach().float().abs()
                      .max())
        run["router_lora_b_max"] = moved
        if not moved > 0:
            raise AssertionError(f"{cut} QLoRA: the router's lora_B did not move")
        add_counts(counts, run["launches"])
        out["mixtral_qlora"] = run
        del state

        # (d) the adapter methods and adamw8bit on Llama-2-7B QLoRA, T = 2048
        data = one_example_npz(np, tmp / "t2048.npz", ADAPTER_T)
        out["adapters"] = {}
        for method, opt in (("adapter", "adamw"), ("adapter_v2", "adamw"),
                            ("adapter_v2", "adamw8bit")):
            state, run = finetune_run(torch, "Llama-2-7b-hf", data, tmp / f"{method}-{opt}",
                                      card, method=method, optimizer=opt, t=ADAPTER_T, micro=2,
                                      precision="float32" if method == "adapter" else "bfloat16")
            gate = state.params["blocks"]["attn"]["adapter"]["gating"]
            run["gating_max"] = float(gate.detach().float().abs().max())
            if not run["gating_max"] > 0:
                raise AssertionError(f"{method} ({opt}): the gates did not move")
            add_counts(counts, run["launches"])
            out["adapters"][f"{method}-{opt}"] = run
            del state
        a8, a32 = (out["adapters"][f"adapter_v2-{o}"] for o in ("adamw8bit", "adamw"))
        log(f"  adapter_v2 optimizer state: adamw8bit {a8['optimizer_state_bytes']} bytes, adamw "
            f"{a32['optimizer_state_bytes']} ({a8['optimizer_state_bytes'] / a32['optimizer_state_bytes']:.4f}); "
            f"peak {a8['peak_gb']:.3f} vs {a32['peak_gb']:.3f} GB   [{card}]")

        # (e) adafactor, lion and adamw8bit on phase 8's pretraining (K4/K5)
        tokens, _ = repo_text_tokens(np)
        pdata = tmp / "data"
        pdata.mkdir()
        tokens.tofile(pdata / "train.bin")
        (pdata / "meta.json").write_text('{"dtype": "uint16"}')
        out["optimizers"] = {}
        for name, lr in OPT_LR.items():
            train = dataclasses.replace(train_args(OPT_STEPS), learning_rate=lr,
                                        lr_warmup_steps=0, min_lr=lr / 10, optimizer=name)
            state, run = training_run(torch, pretrain, build, pdata, tmp / name,
                                      "easy-transformer-fastmax", card, train=train)
            run.update(optimizer=name, lr=lr)
            n_layer = Config.from_name("easy-transformer-fastmax").n_layer
            want = {"fastmax_fwd": 2 * n_layer * 2 * OPT_STEPS,  # 2 micro-batches a step
                    "fastmax_bwd": n_layer * 2 * OPT_STEPS}
            got = {k: run["launches"].get(k, 0) for k in want}
            log(f"    {name} (lr {lr}, no warmup): K4/K5 launches {got} (want {want})")
            if not (all(math.isfinite(x) for x in run["losses"])
                    and run["last_loss"] < run["first_loss"]) or got != want:
                raise AssertionError(f"{name}: losses {run['losses']}, launches {got}")
            add_counts(counts, {k: v for k, v in run["launches"].items() if v})
            out["optimizers"][name] = run
            del state
    quant.set_quant_backend(backend)
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  (a)-(e) in {out['phase_s']:.1f} s; launches {counts}")
    results["families"] = out
    return counts


def adapter_commands(torch, results, card, tmp, ckpt) -> dict:
    """Phase 15 (f), inside phase 12's directory: ``finetune`` main with ``--method
    adapter_v2`` on its 2-layer checkpoint of Llama-2-7B's width, then ``generate.main
    --method adapter_v2`` on the delta, whose text must equal the engine's on the tree
    ``generate.load_and_prepare`` gives (the base with the delta's leaves set)."""
    import importlib.util
    import io

    from fastmax_tpu_torch.inference import generate
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models.tokenizer import Tokenizer
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.utils.checkpoint import load_flat_checkpoint

    flags = ["--method", "adapter_v2", "--checkpoint_dir", str(ckpt), "--data_path",
             str(tmp / "sft.npz"), "--precision", "bfloat16", "--adapter_start_layer", "1",
             "--train.max_iters", "2", "--train.global_batch_size", "2",
             "--train.micro_batch_size", "2", "--train.max_seq_length", "512",
             "--train.lr_warmup_steps", "0", "--train.learning_rate", "3e-3",
             "--io.out_dir", str(tmp / "adapter_v2")] + CMD_LOG
    with contextlib.redirect_stdout(io.StringIO()):
        state, launches, wall = launched(torch, lambda: finetune.main(flags))
    delta = tmp / "adapter_v2" / "adapter_v2_weights.safetensors"
    written = load_flat_checkpoint(delta)
    row = {"flags": flags, "steps": state.step, "wall_s": wall, "launches": launches,
           "delta_tensors": len(written), "card": card}
    del state
    if importlib.util.find_spec("tokenizers") is not None:
        tok = Tokenizer(ckpt)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            _, gl, _ = launched(torch, lambda: generate.main(
                prompt="def main", checkpoint_dir=ckpt, max_new_tokens=16, temperature=0.0,
                method="adapter_v2", finetuned_path=delta))
        cfg, params = generate.load_and_prepare(ckpt, finetuned_path=delta, method="adapter_v2")
        enc = tok.encode("def main")
        outs = InferenceEngine(cfg, params, max_seq_length=len(enc) + 16).generate(
            torch.as_tensor(enc), len(enc) + 16, eos_id=tok.eos_id)
        want = tok.decode(outs[0].cpu().numpy())
        row.update(generate_main=buf.getvalue().strip() == want.strip(), generate_launches=gl,
                   text=want)
        del params
    log(f"  (f) finetune --method adapter_v2 on phase 12's 2-layer directory: {row['steps']} "
        f"steps in {wall:.2f} s, {len(written)} tensors in adapter_v2_weights.safetensors; "
        f"generate.main --method adapter_v2 == the engine's text on the loaded tree "
        f"{row.get('generate_main', '(no tokenizers package)')}; launches {launches}   [{card}]")
    if row["steps"] != 2 or not written or not row.get("generate_main", True):
        raise AssertionError(f"the adapter command lines: {row}")
    results.setdefault("families", {})["adapter_commands"] = row
    return row


# ----------------------------------------------------------------- phase 16
# The rest of training (no kernel of its own: the reference runs none of it in Pallas).
# (a) bench_mfu at the reference's own MFU shape (fastmax_tpu/ops/attention.py: TinyLlama
# bs8 T=2048), all 22 layers at full width, bf16, adamw, under every remat policy; one
# warm step and MFU_ITERS timed. K6 launches once a layer a step, twice where the layer's
# policy recomputes the attention forward in the backward; K7 once a layer a step. The
# gradients of one step under each policy against "none": bit for bit, or each leaf's
# mean |g - g_none| within the bf16 mean gate FLASH_TRAIN_BF16_MEAN of its mean |g_none|.
MFU_MODEL = "tiny-llama-1.1b"
MFU_BATCH, MFU_T, MFU_ITERS = 8, 2048, 2   # 3 timed steps before phase 20
REMAT_POLICIES = ("none", "full", "attn", "dots", "dots_attn", "dots@8:full")
RECOMPUTES_ATTENTION = ("full", "dots")
# (d) GPTQ at Llama-2-7B's width on 1 of its 32 layers (depth cut for time: ~27k columns a
# layer, each a few launches), calibrated on 512 tokens of the repository's text
GPTQ_LAYERS = 1   # 2 before phase 20
GPTQ_CALIB_T = 512
# (c) packed data: a few MB of the repository's printable text, tokenized by a BPE
# tokenizer trained here (vocabulary within easy-transformer-fastmax's 205), in chunks of
# 1024 blocks of 513 tokens; PACKED_STEPS pretraining steps on the native reader
PACKED_TEXT_BYTES = 4_000_000
PACKED_CHUNK = 513 * 1024
PACKED_STEPS = 20


def k6_per_step(gpt, policy, n_layer: int) -> int:
    layers = gpt._layer_policies(False if policy == "none" else policy, n_layer)
    return sum(2 if p in RECOMPUTES_ATTENTION else 1 for p in layers)


def mfu_batch(torch, np, cfg):
    return torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (MFU_BATCH, MFU_T + 1))).cuda()


def remat_grads_and_probe(torch, np, card) -> dict:
    """One step's loss and gradients under each policy against "none" (with K6/K7
    launches a step), then the auto probe at the model's attention shape and one step
    under it."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import attention as attn
    from fastmax_tpu_torch.training import bench_mfu
    from fastmax_tpu_torch.training.step import tree_leaves

    cfg = Config.from_name(MFU_MODEL)
    cfg.block_size = MFU_T
    params = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    batch = mfu_batch(torch, np, cfg)

    def one_step(remat):
        loss_fn = bench_mfu.make_bench_loss_fn(cfg, remat)
        for p in leaves:
            p.grad = None
        loss = loss_fn(params, batch)
        loss.backward()
        return loss.detach()

    out, ref = {"policies": []}, None
    for policy in REMAT_POLICIES:
        loss, launches, dt = launched(torch, lambda: one_step(False if policy == "none"
                                                              else policy))
        grads = [p.grad for p in leaves]
        row = {"policy": policy, "loss": float(loss), "s": dt, "launches": launches}
        if ref is None:
            ref = (loss, grads)
            row.update(bitwise=True, worst_mean_rel=0.0)
        else:
            row["bitwise"] = bool(torch.equal(loss, ref[0])) and all(
                torch.equal(a, b) for a, b in zip(grads, ref[1]))
            row["worst_mean_rel"] = max(
                float((a.float() - b.float()).abs().mean() / b.float().abs().mean().clamp_min(1e-30))
                for a, b in zip(grads, ref[1]))
        want = {"flash_train_fwd": k6_per_step(gpt, policy, cfg.n_layer),
                "flash_train_bwd": cfg.n_layer}
        got = {k: launches.get(k, 0) for k in want}
        log(f"  (a) {policy:12s} one step {dt:.3f} s: loss {row['loss']!r}, gradients "
            f"{'equal to none bit for bit' if row['bitwise'] else 'differ from none'} (worst "
            f"leaf mean |diff| {row['worst_mean_rel']:.3e} of its mean); K6/K7 {got}   [{card}]")
        if got != want or not (torch.equal(loss, ref[0]) and (
                row["bitwise"] or row["worst_mean_rel"] <= FLASH_TRAIN_BF16_MEAN)):
            raise AssertionError(f"remat {policy}: launches {got} != {want}, or the loss "
                                 f"{row['loss']} / gradients ({row['worst_mean_rel']}) moved")
        row["k6_k7"] = got
        out["policies"].append(row)
        del grads
    del ref

    # (b) the auto probe at (B, H, T, D) of this model's attention, then one step under it
    h, d = cfg.n_head, cfg.head_size
    key = f"{torch.cuda.get_device_name()}|{MFU_BATCH}x{h}x{MFU_T}x{d}"
    attn._probe_path().unlink(missing_ok=True)
    attn._PROBE_CACHE.pop(key, None)
    timer, calls = attn._time_fwd_bwd, []
    route = attn.TRAIN_ATTN

    def counted(*a):
        calls.append(1)
        return timer(*a)

    attn._time_fwd_bwd = counted
    try:
        attn.TRAIN_ATTN = "auto"
        t0 = time.perf_counter()
        winner = attn._probe_train_kernel(MFU_BATCH, h, MFU_T, d, "cuda")
        probe_s = time.perf_counter() - t0
        n_timed = len(calls)
        again = attn._probe_train_kernel(MFU_BATCH, h, MFU_T, d, "cuda")
        times = attn.PROBE_TIMES[key]
        disk = json.loads(attn._probe_path().read_text())
        _, launches, dt = launched(torch, lambda: one_step("full"))
    finally:
        attn.TRAIN_ATTN = route
        attn._time_fwd_bwd = timer
    k6 = launches.get("flash_train_fwd", 0)
    log(f"  (b) auto probe at ({MFU_BATCH}, {h}, {MFU_T}, {d}) bf16, one forward + backward "
        f"(dq, dk, dv), best of 2 after a warm call: blockwise "
        f"{times['blockwise'] * 1e3:.3f} ms, flash2 {times['flash2'] * 1e3:.3f} ms -> "
        f"{winner} ({probe_s:.2f} s, {n_timed} timings); a second call read the cache "
        f"({len(calls) - n_timed} timings), the disk record says {disk.get(key)}; a step "
        f"under auto ({dt:.3f} s) launched K6 {k6} times   [{card}]")
    if not (winner == min(times, key=times.get) and again == winner and n_timed == 2
            and len(calls) == 2 and disk.get(key) == winner
            and (k6 > 0) == (winner == "flash2")):
        raise AssertionError(f"auto probe: winner {winner}, again {again}, times {times}, "
                             f"timings {n_timed}/{len(calls)}, disk {disk}, K6 {k6}")
    out["probe"] = {"shape": [MFU_BATCH, h, MFU_T, d], "times_s": times, "winner": winner,
                    "probe_s": probe_s, "step_k6": k6, "card": card}
    return out


def mfu_runs(torch, card) -> tuple:
    """``bench_mfu.run`` under each policy, then the fastmax arm under "full"."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.training import bench_mfu

    n_layer = Config.from_name(MFU_MODEL).n_layer
    rows, counts = [], {}
    for policy in REMAT_POLICIES:
        gc.collect()
        torch.cuda.empty_cache()
        res, launches, wall = launched(torch, lambda: bench_mfu.run(
            model_name=MFU_MODEL, seq_len=MFU_T, micro_batch=MFU_BATCH, remat=policy,
            iters=MFU_ITERS))
        steps = MFU_ITERS + 1
        want = {"flash_train_fwd": steps * k6_per_step(gpt, policy, n_layer),
                "flash_train_bwd": steps * n_layer}
        got = {k: launches.get(k, 0) for k in want}
        log(f"  (a) {json.dumps(res)}")
        log(f"      {policy}: {wall:.1f} s in all; K6/K7 over {steps} steps {got}   [{card}]")
        if got != want or not math.isfinite(res["loss"]):
            raise AssertionError(f"bench_mfu {policy}: launches {got} != {want}, loss "
                                 f"{res['loss']}")
        add_counts(counts, launches)
        rows.append({**res, "launches": launches, "wall_s": wall, "card": card})
    gc.collect()
    torch.cuda.empty_cache()
    res, launches, wall = launched(torch, lambda: bench_mfu.run(
        model_name=MFU_MODEL, seq_len=MFU_T, micro_batch=MFU_BATCH, attn_alg="fastmax",
        remat="full", iters=1))
    log(f"  (a) {json.dumps(res)}")
    log(f"      fastmax arm: {wall:.1f} s in all; launches {launches}   [{card}]")
    if not (launches.get("fastmax_fwd", 0) > 0 and launches.get("fastmax_bwd", 0) > 0
            and math.isfinite(res["loss"])):
        raise AssertionError(f"bench_mfu fastmax: launches {launches}, loss {res['loss']}")
    add_counts(counts, launches)
    rows.append({**res, "launches": launches, "wall_s": wall, "card": card})
    return rows, counts


def train_bpe(d: Path, text: str, vocab_size: int, eos: str = "</s>") -> int:
    """A BPE tokenizer trained on ``text`` into ``d`` (tokenizer.json and its eos);
    returns its size."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    tok = HFTok(BPE(unk_token="<unk>"))
    tok.pre_tokenizer = Whitespace()
    tok.train_from_iterator(text.splitlines(), BpeTrainer(special_tokens=["<unk>", eos],
                                                          vocab_size=vocab_size))
    d.mkdir(parents=True, exist_ok=True)
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({"eos_token": eos}))
    return tok.get_vocab_size()


def logged_losses(out: Path) -> tuple:
    """(the losses a run logged, where from): the TensorBoard events, or the CSV the
    logger fell back to."""
    import csv

    events = sorted((out / "tb").glob("events.out.tfevents.*"))
    if events:
        from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

        acc = EventAccumulator(str(out / "tb"))
        acc.Reload()
        return [e.value for e in acc.Scalars("loss")], f"{len(events)} TensorBoard event file"
    with open(out / "metrics.csv", newline="") as f:
        return [float(r["loss"]) for r in csv.DictReader(f) if r.get("loss")], "metrics.csv"


def packed_path(torch, np, card, tmp: Path) -> tuple:
    """(c) prepare_packed, the native reader against PackedDataset, pretraining on the
    packed chunks with the TensorBoard logger; (e) the loggers' branches."""
    import importlib.util
    import io

    from fastmax_tpu_torch.data.packed_dataset import PackedDataset
    from fastmax_tpu_torch.native import loader
    from fastmax_tpu_torch.scripts import prepare_packed
    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.utils.args import EvalArgs, IOArgs, TrainArgs
    from fastmax_tpu_torch.utils.logging import choose_logger

    tokens, n_files = repo_text_tokens(np)
    keep = ((tokens >= 32) & (tokens < 127)) | (tokens == 10)
    text = bytes(tokens[keep].astype(np.uint8)).decode("ascii")
    text = (text * (PACKED_TEXT_BYTES // len(text) + 1))[:PACKED_TEXT_BYTES]
    tok = tmp / "packed_tok"
    vocab = train_bpe(tok, text[:400_000], 200)
    src = tmp / "corpus"
    src.mkdir()
    step = 4000
    with open(src / "repo.jsonl", "w") as f:
        for i in range(0, len(text), step):
            f.write(json.dumps({"text": text[i:i + step]}) + "\n")
    dest = tmp / "packed"
    t0 = time.perf_counter()
    prepare_packed.prepare(src, tok, dest, chunk_size=PACKED_CHUNK, prefix="repo")
    prep_s = time.perf_counter() - t0
    files = sorted(dest.glob("*.bin"))
    n_tokens = sum((f.stat().st_size - 24) // 2 for f in files)

    # the native reader, built here from the port's source, against the numpy reader; it
    # must not fall back to the numpy reader here (g++ is on this machine)
    t0 = time.perf_counter()
    lib = loader.build()
    build_s = time.perf_counter() - t0
    if not loader.native_available():
        raise AssertionError("native_available() is False: the C++ packed reader did not load")
    n_check = 256
    nat = loader.NativePackedDataset(files, 513, shuffle=False)
    it_n = iter(nat)
    it_p = iter(PackedDataset(files, n_chunks=1, block_size=513, shuffle=False))
    same = all(np.array_equal(next(it_n), next(it_p)) for _ in range(n_check))
    if nat.reader != "native":
        raise AssertionError(f"the packed reader ran {nat.reader!r}, not the C++ reader")
    rates = {}
    for name, ds in (("native", loader.NativePackedDataset(files, 513, seed=3)),
                     ("numpy", PackedDataset(files, n_chunks=min(8, len(files)),
                                             block_size=513, seed=3))):
        t0 = time.perf_counter()
        for _, _blk in zip(range(2048), ds):
            pass
        rates[name] = 2048 / (time.perf_counter() - t0)
    log(f"  (c) prepare_packed: {PACKED_TEXT_BYTES} bytes of the repository's text ({n_files} "
        f"files, repeated) as jsonl records -> {n_tokens} tokens of a {vocab}-token BPE in "
        f"{len(files)} chunks of {PACKED_CHUNK} in {prep_s:.2f} s; the native reader "
        f"({lib.name}) built in {build_s:.2f} s, native_available() True, the C++ reader "
        f"ran; its first {n_check} unshuffled blocks "
        f"{'equal' if same else 'DIFFER FROM'} PackedDataset's; shuffled, 513-token blocks a "
        f"second: native {rates['native']:.0f}, numpy {rates['numpy']:.0f} (warm file cache)")
    if not same or not files:
        raise AssertionError("the native reader's blocks differ from PackedDataset's")

    have_tb = importlib.util.find_spec("tensorboard") is not None
    train = TrainArgs(global_batch_size=8, micro_batch_size=4, max_iters=PACKED_STEPS,
                      learning_rate=3e-3, lr_warmup_steps=2, save_interval=1000,
                      log_interval=1)
    out = tmp / "packed_run"
    readers = []
    real_reader = pretrain.NativePackedDataset

    def recorded(*a, **kw):
        readers.append(real_reader(*a, **kw))
        return readers[-1]

    pretrain.NativePackedDataset = recorded
    try:
        state, launches, wall = launched(torch, lambda: pretrain.setup(
            model_name="easy-transformer-fastmax", data_format="packed",
            logger_name="tensorboard", train=train, eval=EvalArgs(interval=10, max_iters=2),
            io=IOArgs(train_data_dir=dest, val_data_dir=dest, out_dir=out)))
    finally:
        pretrain.NativePackedDataset = real_reader
    if [r.reader for r in readers] != ["native"]:
        raise AssertionError(f"pretraining's packed readers ran {[r.reader for r in readers]}, "
                             "not the C++ reader")
    losses, where = logged_losses(out)
    log(f"  (c) pretrain.setup(data_format='packed') on easy-transformer-fastmax: {state.step} "
        f"steps in {wall:.2f} s (setup included); losses {losses[0]:.4f} -> {losses[-1]:.4f} "
        f"read back from the {where} (tensorboard {'installed' if have_tb else 'absent: CSV'}); "
        f"launches {launches}   [{card}]")
    if not (state.step == PACKED_STEPS and len(losses) == PACKED_STEPS
            and all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
            and launches.get("fastmax_fwd", 0) > 0 and launches.get("fastmax_bwd", 0) > 0
            and (where != "metrics.csv") == have_tb):
        raise AssertionError(f"packed pretraining: {state.step} steps, losses {losses} from "
                             f"{where}, launches {launches}")

    # (e) the W&B logger: the package is imported when chosen; it never reaches a network
    # here (mode "disabled")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        lg = choose_logger("wandb", tmp / "wandb", project="fastmax-tpu", mode="disabled")
    lg.log_dict({"loss": 1.0}, 1)
    lg.finalize()
    branch = type(lg).__name__
    log(f"  (e) loggers: tensorboard {'wrote events' if have_tb else 'fell back to CSV'}; "
        f"wandb -> {branch} ({buf.getvalue().strip() or 'wandb imported, run disabled'})")
    if (branch == "WandbLogger") != (importlib.util.find_spec("wandb") is not None):
        raise AssertionError(f"the wandb choice gave {branch}")
    return {"tokens": n_tokens, "files": len(files), "prepare_s": prep_s, "build_s": build_s,
            "blocks_per_s": rates, "losses": losses, "logged_to": where, "wall_s": wall,
            "launches": launches, "wandb_branch": branch, "card": card}, launches


def hidden_error(torch, gpt, cfg, tree, calib, ref) -> float:
    with torch.no_grad():
        h = gpt.forward_hidden(tree, cfg, calib).float()
    return float(torch.linalg.vector_norm(h - ref) / torch.linalg.vector_norm(ref))


def gptq_path(torch, np, card) -> dict:
    """(d) GPTQ on the card at Llama-2-7B's width, GPTQ_LAYERS layers: the hidden
    states' error against the dense model below round-to-nearest's."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops.gptq import gptq_quantize_model
    from fastmax_tpu_torch.ops.quant import quantize_model

    cfg = Config.from_name("Llama-2-7b-hf", n_layer=GPTQ_LAYERS)
    dense = gpt.init_params(cfg, 0, torch.float32, "cuda")
    tokens, _ = repo_text_tokens(np)
    calib = torch.from_numpy(tokens[:GPTQ_CALIB_T].astype(np.int64) + 3)[None].cuda()
    with torch.no_grad():
        ref = gpt.forward_hidden(dense, cfg, calib).float()
    out = {}
    for mode, kind in (("gptq.int4", "int4"), ("bnb.nf4", "nf4")):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        q = gptq_quantize_model(dense, cfg, calib, kind=kind)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        err = hidden_error(torch, gpt, cfg, q, calib, ref)
        rtn = hidden_error(torch, gpt, cfg, quantize_model(dense, mode), calib, ref)
        log(f"  (d) GPTQ {kind} on the card, Llama-2-7B width, {GPTQ_LAYERS} of 32 layers (depth "
            f"cut for time), {GPTQ_CALIB_T} calibration tokens: {secs:.2f} s; hidden-state "
            f"error against the dense model {err:.4e}, round-to-nearest ({mode}) {rtn:.4e}   "
            f"[{card}]")
        if not err < rtn:
            raise AssertionError(f"GPTQ {kind}: error {err} not below round-to-nearest's {rtn}")
        out[kind] = {"s": secs, "error": err, "rtn_error": rtn, "card": card}
        del q
    return out


def gptq_commands(torch, results, card, tmp, ckpt) -> dict:
    """(d), inside phase 12's directory on its 2-layer Llama-2-7B-width checkpoint: one
    QLoRA step of ``finetune.setup(gptq_calib=True)`` and ``generate.main --gptq_calib``,
    both on the "pallas" 4-bit backend (K8 wherever x needs no gradient)."""
    import csv
    import io

    import numpy as np

    from fastmax_tpu_torch.inference import generate
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs

    if not (ckpt / "tokenizer.json").is_file():
        raise AssertionError("generate --gptq_calib needs the tokenizer phase 13 trains "
                             "(the tokenizers package)")
    backend = quant.get_quant_backend()
    quant.set_quant_backend("pallas")
    counts = {}
    try:
        examples, _ = sft_examples(np, n=8, seed=3)
        data = tmp / "gptq_sft.npz"
        np.savez(data, examples=np.array(examples, dtype=object))
        train = TrainArgs(global_batch_size=1, micro_batch_size=1, max_iters=1,
                          learning_rate=3e-3, lr_warmup_steps=0, save_interval=1000,
                          log_interval=1, max_seq_length=512)
        state, launches, wall = launched(torch, lambda: finetune.setup(
            method="lora", checkpoint_dir=ckpt, data_path=data, quantize="bnb.nf4",
            gptq_calib=True, attn_alg="quadratic", precision="bfloat16", train=train,
            io=IOArgs(out_dir=tmp / "gptq_qlora")))
        add_counts(counts, launches)
        with open(tmp / "gptq_qlora" / "metrics.csv", newline="") as f:
            losses = [float(r["loss"]) for r in csv.DictReader(f) if r.get("loss")]
        log(f"  [16] (d) finetune.setup(gptq_calib=True, quantize='bnb.nf4') on phase 12's "
            f"2-layer Llama-2-7B-width checkpoint: GPTQ on 4 of its examples, then {state.step} "
            f"QLoRA step, {wall:.2f} s in all; loss {losses}; launches {launches}   [{card}]")
        if not (state.step == 1 and all(math.isfinite(x) for x in losses) and losses
                and launches.get("nf4_matmul", 0) > 0):
            raise AssertionError(f"finetune gptq_calib: losses {losses}, launches {launches}")
        tokens, _ = repo_text_tokens(np)
        calib = tmp / "gptq_calib.txt"
        calib.write_text(bytes(tokens[:6000].astype(np.uint8)).decode("latin-1"))
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            _, glaunch, gwall = launched(torch, lambda: generate.main(
                prompt="def main", checkpoint_dir=ckpt, quantize="bnb.nf4", gptq_calib=calib,
                weights_mode="quantized", max_new_tokens=16, temperature=0.0))
        add_counts(counts, glaunch)
        text = buf.getvalue().strip()
        log(f"  [16] (d) generate.main --gptq_calib ({calib.stat().st_size} bytes of text) "
            f"--quantize bnb.nf4 --weights_mode quantized: {gwall:.2f} s (GPTQ included); "
            f"printed {text!r}; launches {glaunch}   [{card}]")
        if not (text and glaunch.get("nf4_matmul", 0) > 0):
            raise AssertionError(f"generate --gptq_calib printed {text!r}, launches {glaunch}")
    finally:
        quant.set_quant_backend(backend)
    results["gptq_commands"] = {"qlora_losses": losses, "qlora_launches": launches,
                                "generate_text": text, "generate_launches": glaunch,
                                "card": card}
    return counts


def rest_of_training_path(torch, results, card) -> dict:
    """Phase 16: (a) remat gradients, (b) the probe, (a) bench_mfu runs, (c)+(e) packed
    data and the loggers, (d) GPTQ; returns the launch counts of its main paths."""
    import tempfile

    import numpy as np

    t_phase = time.perf_counter()
    out = {}
    counts = {}
    out["remat"] = remat_grads_and_probe(torch, np, card)
    gc.collect()
    torch.cuda.empty_cache()
    out["bench_mfu"], mfu_counts = mfu_runs(torch, card)
    add_counts(counts, mfu_counts)
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        out["packed"], pk_counts = packed_path(torch, np, card, Path(tmp))
    add_counts(counts, pk_counts)
    gc.collect()
    torch.cuda.empty_cache()
    out["gptq"] = gptq_path(torch, np, card)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  the phase in {out['phase_s']:.1f} s; launches {counts}")
    results["rest_of_training"] = out
    return counts


# ----------------------------------------------------------------- phase 17
# Speculative decoding. (a) K3 at the verify's shapes: T = k+1 rows at pos0 over kv_len =
# pos0 + T keys; (b) the batch-1 prompt-lookup decoder on the random 7B of phases 5 and 7
# (LAYERS_7B layers, q4r1, int8 cache, an engine of 4096 positions: every verify is one K3
# call of T = k+1 ragged rows, and K1 at m = k+1 on the tensor cores); (c) the draft decoder
# with TinyLlama at full width drafting (its public pairing with Llama-2-7B: the same 32
# 000-token vocabulary); (d) the batcher's verify at 8 slots (K1 at m = 8 (k+1) = 72 on the FMA tile;
# the per-slot positions take the masked SDPA over the dequantized cache, as the reference
# does off its chip); (e) the command lines, inside phase 12's directory.
SPEC_K = 8
SPEC_T = (2, 5, 9)                 # T = k+1 at k = 1, 4, 8
SPEC_POS0 = (63, 2047, 4086)       # a verify near the start, the middle and the end of S
SPEC_PROMPT, SPEC_SEGMENT, SPEC_NEW = 512, 64, 128
SPEC_PLAIN_NEW = 32                # the plain=True run (every linear dequantized a call)
SPEC_DRAFT_MODEL, SPEC_DRAFT_K, SPEC_DRAFT_NEW = "tiny-llama-1.1b", 4, 32
SPEC_BATCH_NEW, SPEC_PREFIX, SPEC_CHUNK = 64, 1024, 256


@contextlib.contextmanager
def k1_paths():
    """K1's launches by path (gemv, tc, fma) while the block runs: ``int4_path`` is called
    once a launch, and nowhere else on this path."""
    from fastmax_tpu_torch.ops import quant_kernels as qk

    counts = {}
    real = qk.int4_path

    def counted(m, tk):
        path = real(m, tk)
        counts[path] = counts.get(path, 0) + 1
        return path

    qk.int4_path = counted
    try:
        yield counts
    finally:
        qk.int4_path = real


def near_tie(torch, engine, prompt, want, got, what) -> dict:
    """Two greedy token lists held by the near-tie rule: equal, or a first divergence
    where ``engine``'s top-2 margin is under NEAR_TIE_REL of its largest |logit|."""
    div = first_divergence(torch, engine, prompt, want, got)
    if div is None:
        log(f"  {what}: tokens equal")
        return {"equal": True}
    step, margin, top = div
    near = margin <= NEAR_TIE_REL * top
    log(f"  {what}: first divergence at generated token {step}, top-2 margin {margin:.4f} of "
        f"max |logit| {top:.3f}: {'a near-tie' if near else 'NOT a near-tie'}")
    if not near:
        raise AssertionError(f"{what}: a divergence beyond a near-tie: {div}")
    return {"equal": False, "step": step, "margin": margin, "max_logit": top}


def spec_prompt(np, n: int = SPEC_PROMPT, seg: int = SPEC_SEGMENT):
    """n tokens of the repository's text (bytes as Llama's byte ids, + 3) in which one
    seg-token segment appears twice."""
    tokens, _ = repo_text_tokens(np)
    p = tokens[10_000:10_000 + n].astype(np.int64) + 3
    p[n - 2 * seg - 16:n - seg - 16] = p[64:64 + seg]
    return p


def check_spec_kernels(torch, gen, card) -> dict:
    """(a) K3 at T = k+1 against its plain version under phase 6's gates, bf16 and f32,
    D = 128, S = 4096, and its times at T = 9; K1 at m = k+1 = 9 and m = 8 (k+1) = 72
    under phase 3's gates at the four 7B linears, and a layer's four timed."""
    checks = []
    for dt in (torch.bfloat16, torch.float32):
        for t in SPEC_T:
            for pos0 in SPEC_POS0:
                c = flash_case(torch, gen, 1, 32, 32, 4096, 128, dt, t, pos0)
                checks.append(c)
                log(f"  (a) {c['case']}: ok, max abs err {c['max_abs_err']:.3e}, mean err "
                    f"{c['mean_err']:.2e} of the mean")
    k3_rows = flash_times(torch, gen, [(torch.bfloat16, 128, SPEC_K + 1, pos0)
                                       for pos0 in SPEC_POS0[1:]], label="7B verify")
    int4 = []
    for name, k, n in LLAMA7B_LINEARS:
        p = int4_weights(torch, gen, k, n)
        for m in (SPEC_K + 1, N_SLOTS * (SPEC_K + 1)):
            err = int4_case(torch, gen, name, p, m)
            int4.append({"shape": name, "m": m, **err})
            log(f"  (a) int4 {name:9s} m={m:3d} ({err['path']}): ok, max abs err f32 "
                f"{err['f32']:.3e} bf16 {err['bf16']:.3e}")
        del p
    k1_rows = []
    for name, k, n in LLAMA7B_LINEARS:
        k1_rows += int4_times(torch, gen, name, k, n, (SPEC_K + 1, N_SLOTS * (SPEC_K + 1)))
    for m in (SPEC_K + 1, N_SLOTS * (SPEC_K + 1)):
        layer = [r for r in k1_rows if r["m"] == m]
        fma = (f" (FMA tile {sum(r['fma_ms'] for r in layer) * 1e3:.1f} us)"
               if layer[0]["fma_ms"] is not None else "")
        log(f"  (a) K1, a layer's 4 linears at m={m}: {layer[0]['path']} "
            f"{sum(r['ms'] for r in layer) * 1e3:.1f} us{fma}, plain "
            f"{sum(r['plain_ms'] for r in layer) * 1e3:.1f} us, bound "
            f"{sum(r['bound_ms'] for r in layer) * 1e3:.1f} us   [{card}]")
    return {"k3_checks": checks, "k3_times": k3_rows, "k1_checks": int4, "k1_times": k1_rows,
            "k3_max_abs_err": {str(dt)[6:]: max(c["max_abs_err"] for c in checks
                                                if c["case"].endswith(str(dt)[6:]))
                               for dt in (torch.bfloat16, torch.float32)},
            "k3_bf16_mean_err": max(c["mean_err"] for c in checks
                                    if c["case"].endswith("bfloat16"))}


def spec_engine_runs(torch, np, engine, card) -> tuple:
    """(b) The prompt-lookup decoder on the 7B engine, greedy and sampled, against
    ``engine.generate`` and its own plain=True run; returns (its row, launches)."""
    from fastmax_tpu_torch.inference.speculative import SpeculativeDecoder

    prompt = torch.as_tensor(spec_prompt(np), dtype=torch.int32)
    t, n_ret = SPEC_PROMPT, SPEC_PROMPT + SPEC_NEW
    spec = SpeculativeDecoder(engine, k=SPEC_K)
    # warm-up: the first calls of each shape, outside the measured runs
    engine.generate(prompt, t + 4)
    spec.generate(prompt, t + 4)
    out, plain_launches, plain_s = launched(torch, lambda: engine.generate(prompt, n_ret))
    want = out[0, t:].tolist()
    with k1_paths() as paths:
        out, launches, spec_s = launched(torch, lambda: spec.generate(prompt, n_ret))
    got = out[0, t:].tolist()
    steps, accepted = spec.last_steps, spec.last_accepted
    acceptance = accepted / (steps * SPEC_K)
    if len(got) != SPEC_NEW or sum(paths.values()) != launches.get("int4_rank1_matmul", 0):
        raise AssertionError(f"(b) {len(got)} tokens; K1 by path {paths}, launches {launches}")
    # K3 once a layer for the 512-token prefill and once a layer for every verify
    if launches.get("flash_attention", 0) != engine.cfg.n_layer * (1 + steps) or \
            paths.get("tc", 0) <= 0:
        raise AssertionError(f"(b) the verify did not take K3 and K1's tensor cores: {steps} "
                             f"verify forwards, launches {launches}, K1 by path {paths}")
    log(f"  (b) Llama-2-7B q4r1, int8 cache, 4096 positions; a {t}-token prompt whose "
        f"{SPEC_SEGMENT}-token segment repeats; {SPEC_NEW} new tokens greedy: engine.generate "
        f"{SPEC_NEW / plain_s:.2f} tok/s ({plain_s:.3f} s), SpeculativeDecoder k={SPEC_K} "
        f"{SPEC_NEW / spec_s:.2f} tok/s ({spec_s:.3f} s); {steps} verify forwards, "
        f"{accepted} drafts accepted of {steps * SPEC_K} ({acceptance:.3f}); K1 launches by "
        f"path {paths}; K3 launches {launches.get('flash_attention', 0)}; launches "
        f"{launches} (plain decode: {plain_launches})   [{card}]")
    div = near_tie(torch, engine, prompt.tolist(), want, got,
                   "(b) speculative greedy vs engine.generate")
    # kernels against plain versions, SPEC_PLAIN_NEW new tokens (each verify dequantizes
    # every linear in the plain run)
    plain_out = spec.generate(prompt, t + SPEC_PLAIN_NEW, plain=True)
    plain_steps = spec.last_steps
    div_plain = near_tie(torch, engine, prompt.tolist(), plain_out[0, t:].tolist(),
                         got[:SPEC_PLAIN_NEW], "(b) speculative greedy, kernels vs plain=True")
    sampled = spec.generate(prompt, n_ret, temperature=0.8, top_k=50,
                            generator=torch.Generator(device="cuda").manual_seed(5))
    s_toks = sampled[0, t:]
    ok = (s_toks.numel() == SPEC_NEW and bool((s_toks >= 0).all())
          and bool((s_toks < engine.cfg.padded_vocab_size).all())
          and torch.equal(sampled[0, :t], prompt.cuda()))
    log(f"  (b) sampled (temperature 0.8, top_k 50): {s_toks.numel()} tokens in the "
        f"vocabulary {ok}; {spec.last_steps} verify forwards, {spec.last_accepted} drafts "
        f"accepted")
    if not ok:
        raise AssertionError(f"(b) sampled speculation gave {sampled[0, t:].tolist()}")
    # where a verify step's time goes: one T = k+1 forward's device time against the
    # host-clock time of a step of the greedy run
    cache = engine.new_cache()
    with torch.inference_mode():
        _, cache = engine.prefill(prompt[None].cuda(), cache)
        x = torch.as_tensor(got[:SPEC_K + 1], dtype=torch.int32, device="cuda")[None]
        prof = profile_device(torch, lambda: engine._forward(x, cache, t), "one verify forward "
                              f"(T = {SPEC_K + 1}, pos0 {t})")
    step_ms = spec_s / steps * 1e3
    if prof["device_us"]:
        prof["busy_share"] = prof["device_us"] / 1e3 / step_ms
        log(f"  (b) a verify step {step_ms:.2f} ms on the host clock, its forward "
            f"{prof['device_us'] / 1e3:.2f} ms of device time: busy share "
            f"{prof['busy_share']:.3f}   [{card}]")
    del cache
    return {"engine_tok_s": SPEC_NEW / plain_s, "spec_tok_s": SPEC_NEW / spec_s,
            "engine_s": plain_s, "spec_s": spec_s, "verify_forwards": steps,
            "accepted": accepted, "acceptance": acceptance, "k1_by_path": paths,
            "launches": launches, "engine_launches": plain_launches, "vs_engine": div,
            "vs_plain": div_plain, "plain_verify_forwards": plain_steps,
            "sampled_tokens": s_toks.numel(), "verify_profile": prof,
            "verify_step_ms": step_ms, "card": card}, launches


def spec_draft_run(torch, np, engine, card) -> tuple:
    """(c) DraftSpeculativeDecoder: TinyLlama at full width, random bf16 weights, drafting
    k = 4 for the 7B; greedy against the target's greedy tokens."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.inference.speculative import DraftSpeculativeDecoder
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config

    dcfg = Config.from_name(SPEC_DRAFT_MODEL)
    dparams = gpt.init_params(dcfg, 1, torch.bfloat16, "cuda")
    draft = InferenceEngine(dcfg, dparams, max_seq_length=dcfg.block_size)
    spec = DraftSpeculativeDecoder(engine, draft, k=SPEC_DRAFT_K)
    prompt = torch.as_tensor(spec_prompt(np), dtype=torch.int32)
    t, n_ret = SPEC_PROMPT, SPEC_PROMPT + SPEC_DRAFT_NEW
    spec.generate(prompt, t + 4)  # warm-up
    want = engine.generate(prompt, n_ret)[0, t:].tolist()
    out, launches, wall = launched(torch, lambda: spec.generate(prompt, n_ret))
    got = out[0, t:].tolist()
    acceptance = spec.last_accepted / (spec.last_steps * SPEC_DRAFT_K)
    log(f"  (c) DraftSpeculativeDecoder: {SPEC_DRAFT_MODEL} ({dcfg.n_layer} layers, "
        f"{dcfg.n_embd} wide, vocab {dcfg.padded_vocab_size}; random bf16 weights, seed 1) "
        f"drafting k={SPEC_DRAFT_K} for the 7B: {SPEC_DRAFT_NEW} tokens in {wall:.3f} s "
        f"({SPEC_DRAFT_NEW / wall:.2f} tok/s), {spec.last_steps} verify forwards, "
        f"{spec.last_accepted} drafts accepted ({acceptance:.3f}: two random models, an "
        f"acceptance of chance); launches {launches}   [{card}]")
    div = near_tie(torch, engine, prompt.tolist(), want, got, "(c) draft-model greedy vs "
                   "the target's engine.generate")
    if len(got) != SPEC_DRAFT_NEW or launches.get("int4_rank1_matmul", 0) <= 0:
        raise AssertionError(f"(c) {len(got)} tokens, launches {launches}")
    row = {"draft_model": SPEC_DRAFT_MODEL, "k": SPEC_DRAFT_K, "wall_s": wall,
           "tok_s": SPEC_DRAFT_NEW / wall, "verify_forwards": spec.last_steps,
           "accepted": spec.last_accepted, "acceptance": acceptance, "launches": launches,
           "vs_target": div, "card": card}
    del draft, dparams, spec
    return row, launches


def spec_batcher_runs(torch, np, cfg, params, engine, card) -> tuple:
    """(d) The batcher at serving width with speculative_k 8 against the same batcher
    without it (near-tie rule), then a shared prefix with chunked prefill."""
    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.models import gpt

    rng = np.random.default_rng(17)
    base = spec_prompt(np)
    prompts = [np.concatenate([base[:int(n)], rng.integers(1, 32000, 16)]).astype(np.int32)
               for n in rng.integers(200, 497, N_SLOTS)]
    # 4 greedy, 2 at top_k 1 (the sampled verify on a point mass: greedy tokens), 2 hot;
    # the first 6 are held to the batcher without speculation
    settings = [{}] * 4 + [{"temperature": 0.9, "top_k": 1}] * 2 + \
        [{"temperature": 0.8}, {"temperature": 1.0, "top_k": 40}]
    common = dict(n_slots=N_SLOTS, max_seq_length=4096, weights_mode="quantized",
                  cache_dtype=torch.int8)

    def serve(batcher, reqs, settings, n_new):
        subs = [batcher.submit(p, n_new, return_request=True, **s)
                for p, s in zip(reqs, settings)]
        steps = 0
        while not all(r.done for r in subs):
            batcher.step()
            steps += 1
        return [r.generated for r in subs], steps

    runs, checks = {}, []
    for name, kw in (("speculative", {"speculative_k": SPEC_K}), ("plain decode", {})):
        batcher = ContinuousBatcher(cfg, params, **common, **kw)
        serve(batcher, prompts[:1], [{}], 4)  # warm-up
        with k1_paths() as paths:
            (toks, steps), launches, wall = launched(torch, lambda: serve(
                batcher, prompts, settings, SPEC_BATCH_NEW))
        acc = batcher.spec_accepted / batcher.spec_drafted if batcher.spec_drafted else None
        runs[name] = {"tokens": toks, "launches": launches, "k1_by_path": dict(paths),
                      "wall_s": wall, "tok_s": N_SLOTS * SPEC_BATCH_NEW / wall,
                      "steps": steps, "step_ms": wall / steps * 1e3, "spec_acceptance": acc}
        log(f"  (d) {N_SLOTS}-slot batcher, {name}: {N_SLOTS} requests of "
            f"{[len(p) for p in prompts]} tokens + {SPEC_BATCH_NEW} new (4 greedy, 2 top_k 1, "
            f"2 hot) in {wall:.2f} s, {runs[name]['tok_s']:.2f} tok/s, {steps} steps "
            f"({runs[name]['step_ms']:.1f} ms a step, admission included); spec_acceptance "
            f"{acc}; K1 launches by path {dict(paths)}; launches {launches}   [{card}]")
        if kw:
            # where a verify step's time goes: one (8, k+1) forward at the slots' positions
            with torch.inference_mode():
                x = torch.ones((N_SLOTS, SPEC_K + 1), dtype=torch.int32, device="cuda")
                pos = torch.full((N_SLOTS,), 500, dtype=torch.int32, device="cuda")

                def verify():
                    return gpt.forward(batcher.params, cfg, x, input_pos=pos,
                                       kv_cache=batcher.cache, rope_cache=batcher.rope)
                prof = profile_device(torch, verify, f"one verify forward at {N_SLOTS} slots "
                                      f"(T = {SPEC_K + 1}, positions 500)")
            if prof["device_us"]:
                prof["busy_share"] = prof["device_us"] / 1e3 / runs[name]["step_ms"]
                log(f"  (d) its verify forward {prof['device_us'] / 1e3:.2f} ms of device "
                    f"time against {runs[name]['step_ms']:.1f} ms a step on the host clock: "
                    f"busy share {prof['busy_share']:.3f}   [{card}]")
            runs[name]["verify_profile"] = prof
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
    spec_run = runs["speculative"]
    if not (spec_run["k1_by_path"].get("fma", 0) > 0 and spec_run["launches"].get(
            "int4_rank1_matmul", 0) == sum(spec_run["k1_by_path"].values())):
        raise AssertionError(f"(d) K1 at m = 72 never ran on the FMA tile: {spec_run}")
    for i, s in enumerate(settings):
        got = spec_run["tokens"][i]
        if len(got) != SPEC_BATCH_NEW or not all(0 <= x < cfg.padded_vocab_size for x in got):
            raise AssertionError(f"(d) request {i}: {len(got)} tokens")
        if i < 6:
            checks.append(near_tie(
                torch, engine, prompts[i].tolist(), runs["plain decode"]["tokens"][i], got,
                f"(d) request {i} {s or 'greedy'}: speculative vs plain decode batcher"))

    # a shared prefix registered in the prefix cache, prompts admitted in chunks
    shared = spec_prompt(np, SPEC_PREFIX).astype(np.int32)
    pp = [np.concatenate([shared, rng.integers(1, 32000, int(n))]).astype(np.int32)
          for n in rng.integers(64, 201, 4)]
    pref = {}
    for name, kw in (("speculative", {"speculative_k": SPEC_K}), ("plain decode", {})):
        batcher = ContinuousBatcher(cfg, params, **common, prefix_cache_size=2,
                                    prefill_chunk=SPEC_CHUNK, **kw)
        batcher.register_prefix(shared)
        (toks, _), launches, wall = launched(torch, lambda: serve(batcher, pp, [{}] * 4, 32))
        pref[name] = {"tokens": toks, "hits": batcher.prefix_cache_hits, "wall_s": wall,
                      "launches": launches, "spec_acceptance": (
                          batcher.spec_accepted / batcher.spec_drafted
                          if batcher.spec_drafted else None)}
        del batcher
        gc.collect()
        torch.cuda.empty_cache()
    log(f"  (d) shared {SPEC_PREFIX}-token prefix, prefill_chunk {SPEC_CHUNK}, 4 requests + 32 "
        f"new: speculative {pref['speculative']['wall_s']:.2f} s (acceptance "
        f"{pref['speculative']['spec_acceptance']}, {pref['speculative']['hits']} prompt tokens "
        f"reused), plain decode {pref['plain decode']['wall_s']:.2f} s   [{card}]")
    if not pref["speculative"]["hits"] == pref["plain decode"]["hits"] == 4 * SPEC_PREFIX:
        raise AssertionError(f"(d) the prefix cache reused {pref['speculative']['hits']}")
    for i in range(4):
        checks.append(near_tie(
            torch, engine, pp[i].tolist(), pref["plain decode"]["tokens"][i],
            pref["speculative"]["tokens"][i], f"(d) prefix request {i}: speculative vs plain"))
    counts = {}
    add_counts(counts, spec_run["launches"])
    add_counts(counts, pref["speculative"]["launches"])

    def untokened(rows):
        return {k: {kk: vv for kk, vv in v.items() if kk != "tokens"} for k, v in rows.items()}

    return {"runs": untokened(runs), "prefix": untokened(pref), "checks": checks,
            "card": card}, counts


def speculative_path(torch, results, card) -> dict:
    """Phase 17 (a)-(d); returns the launch counts of its main paths ((b)-(d))."""
    import numpy as np

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4

    t_phase = time.perf_counter()
    out = {"kernels": check_spec_kernels(torch, torch.Generator(device="cuda").manual_seed(17),
                                         card)}
    gc.collect()
    torch.cuda.empty_cache()
    cfg = Config.from_name("Llama-2-7b-hf", n_layer=LAYERS_7B)
    cfg.block_size = 4096
    params = build_fake_7b_int4(cfg, seed=0)
    engine = InferenceEngine(cfg, params, max_seq_length=4096, weights_mode="quantized",
                             cache_dtype=torch.int8)
    counts = {}
    out["engine"], c = spec_engine_runs(torch, np, engine, card)
    add_counts(counts, c)
    out["draft"], c = spec_draft_run(torch, np, engine, card)
    add_counts(counts, c)
    gc.collect()
    torch.cuda.empty_cache()
    out["batcher"], c = spec_batcher_runs(torch, np, cfg, params, engine, card)
    add_counts(counts, c)
    del engine, params
    gc.collect()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"  (a)-(d) in {out['phase_s']:.1f} s; launches {counts}")
    results["speculative"] = out
    return counts


def speculative_commands(torch, results, card, tmp, ckpt) -> dict:
    """(e), inside phase 12's directory on its 2-layer Llama-2-7B-width checkpoint with
    phase 13's tokenizer, bnb.nf4 -> preload_int4 (K1): ``generate.main --speculative_k``
    with prompt lookup and with ``--draft_checkpoint_dir`` (TinyLlama's width cut to 2
    layers, random bf16, written here), each printing the text of the same decoder run here
    and holding its tokens to the engine's greedy ones (near-tie rule); then the server
    with ``--speculative_k`` answering two requests over 127.0.0.1."""
    import io
    import urllib.request

    from fastmax_tpu_torch.inference import generate, server
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.inference.speculative import (DraftSpeculativeDecoder,
                                                          SpeculativeDecoder)
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.params import params_to_flat
    from fastmax_tpu_torch.models.tokenizer import Tokenizer
    from fastmax_tpu_torch.utils.checkpoint import save_flat_checkpoint

    if not (ckpt / "tokenizer.json").is_file():
        raise AssertionError("the speculative command lines need the tokenizer phase 13 "
                             "trains (the tokenizers package)")
    draft_dir = tmp / "spec_draft"
    dcfg = Config.from_name(cut_model(SPEC_DRAFT_MODEL, 2))
    save_flat_checkpoint(params_to_flat(gpt.init_params(dcfg, 2, torch.bfloat16, "cuda"), dcfg),
                         draft_dir)
    dcfg.to_json(draft_dir / "lit_config.json")
    tok = Tokenizer(ckpt)
    prompt, n_new, k = "def main", 24, 4
    enc = tok.encode(prompt)
    n_ret = len(enc) + n_new
    cfg, params = generate.load_and_prepare(ckpt, quantize="bnb.nf4")
    engine = InferenceEngine(cfg, params, max_seq_length=n_ret + k + 1)
    want = engine.generate(torch.as_tensor(enc), n_ret, eos_id=tok.eos_id)[0, len(enc):].tolist()
    rows, counts = {}, {}
    for name, extra in (("prompt lookup", []), ("draft model", [
            "--draft_checkpoint_dir", str(draft_dir)])):
        flags = ["--prompt", prompt, "--checkpoint_dir", str(ckpt), "--quantize", "bnb.nf4",
                 "--max_new_tokens", str(n_new), "--temperature", "0", "--speculative_k",
                 str(k)] + extra
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
            _, launches, wall = launched(torch, lambda: generate.cli(flags))
        add_counts(counts, launches)
        if extra:
            dc, dp = generate.load_and_prepare(draft_dir, quantize="bnb.nf4")
            spec = DraftSpeculativeDecoder(engine, InferenceEngine(
                dc, dp, max_seq_length=engine.max_seq_length), k=k)
        else:
            spec = SpeculativeDecoder(engine, k=k)
        out = spec.generate(torch.as_tensor(enc), n_ret, eos_id=tok.eos_id)
        got = out[0, len(enc):].tolist()
        same_text = buf.getvalue().strip() == tok.decode(out[0].cpu().numpy()).strip()
        log(f"  (e) generate {' '.join(flags[2:])}: {wall:.2f} s (load "
            f"included), printed the decoder's text {same_text}, {spec.last_steps} verify "
            f"forwards, {spec.last_accepted} drafts accepted; launches {launches}   [{card}]")
        rows[name] = {"wall_s": wall, "same_text": same_text, "launches": launches,
                      "verify_forwards": spec.last_steps, "accepted": spec.last_accepted,
                      "vs_engine": near_tie(torch, engine, enc.tolist(), want, got,
                                            f"(e) generate --speculative_k ({name}) vs the "
                                            "engine")}
        if not (same_text and launches.get("int4_rank1_matmul", 0) > 0):
            raise AssertionError(f"(e) generate --speculative_k ({name}): {rows[name]}")
        del spec

    made, answers = [], []
    real_server, real_sleep = server.Server, time.sleep

    class Recording(real_server):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def sleep(s):
        if s != 3600:  # the scheduler thread's idle wait
            return real_sleep(s)
        for p in (prompt, "import torch"):
            body = json.dumps({"prompt": p, "max_new_tokens": n_new}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{made[0].port}/v1/generate",
                                         data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as r:
                answers.append((p, json.loads(r.read())))
        raise KeyboardInterrupt

    server.Server, time.sleep = Recording, sleep
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            _, launches, wall = launched(torch, lambda: server.cli([
                "--checkpoint_dir", str(ckpt), "--host", "127.0.0.1", "--port", "0",
                "--n_slots", "2", "--quantize", "bnb.nf4", "--speculative_k", str(k)]))
    finally:
        server.Server, time.sleep = real_server, real_sleep
    add_counts(counts, launches)
    batcher = made[0].scheduler.batcher
    acc = batcher.spec_accepted / max(batcher.spec_drafted, 1)
    log(f"  (e) server --speculative_k {k}: 2 requests answered in {wall:.2f} s (load "
        f"included), spec_acceptance {acc:.3f}; launches {launches}   [{card}]")
    checks = []
    engine = InferenceEngine(cfg, params, max_seq_length=256)
    for p, answer in answers:
        e = tok.encode(p)
        ref = engine.generate(torch.as_tensor(e), len(e) + n_new, eos_id=tok.eos_id)
        checks.append(near_tie(torch, engine, e.tolist(), ref[0, len(e):].tolist(),
                               answer["tokens"], f"(e) server --speculative_k, {p!r}"))
    if made[0].scheduler._thread.is_alive() or not batcher.spec_drafted:
        raise AssertionError("(e) the speculative server did not serve and stop")
    rows["server"] = {"wall_s": wall, "spec_acceptance": acc, "launches": launches,
                      "checks": checks}
    del engine, params, batcher, made
    results["speculative_commands"] = {**rows, "card": card}
    return counts


# ----------------------------------------------------------------- phase 18
# Multi-GPU serving on the one card: two ranks (two processes, collectives.spawn_local) on
# the same H100, joined over gloo, since NCCL refuses two ranks on one GPU ("Duplicate GPU
# detected"); the collectives cross the host there. No time taken that way is a multi-GPU
# figure. Every hand-written kernel runs on a rank's shard at Llama-2-7B's full width and
# is held against the one-rank result: the tokens equal, or diverging at a near-tie
# (NEAR_TIE_REL); the first step's logits again with float32 activations and a float32
# cache at phase 15's fixed limits (LOGITS_REL_TOL max, FAMILY_MEAN_REL mean).
P18_MODEL = "Llama-2-7b-hf"
P18_BLOCK = 4096
P18_PROMPT, P18_NEW = 64, 16
P18_SLOTS, P18_QUANTUM, P18_REQUESTS = N_SLOTS, 8, 8
P18_MODES_LAYERS, P18_MODES_NEW = 4, 8     # (c): the NF4 modes on 4 of the 32 layers
P18_VOCAB = 32000                          # prompt ids are drawn below it


def p18_config(n_layer=None) -> dict:
    """The fields of the phase's model config (the ranks rebuild it from them)."""
    from fastmax_tpu_torch.models.config import Config

    cfg = Config.from_name(P18_MODEL)
    cfg.block_size = P18_BLOCK
    if n_layer:
        cfg.n_layer = n_layer
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "rope_n_elem"}


def p18_weights(torch, cfg, kind: str) -> dict:
    """The phase's random weights from seed 0, the same in every process on the card:
    the rank-1 int4 tree (``build_fake_7b_int4``: q4r1, fc_12 fused) or bnb.nf4."""
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.synthetic import build_fake_7b_int4
    from fastmax_tpu_torch.ops import quant

    if kind == "int4":
        return build_fake_7b_int4(cfg, device="cuda", seed=0)
    dense = gpt.init_params(cfg, 0, torch.bfloat16, "cuda")
    nf4 = quant.quantize_model(dense, "bnb.nf4")
    del dense
    return nf4


def p18_prompts(np, n: int, length: int) -> list:
    rng = np.random.default_rng(18)
    return [rng.integers(1, P18_VOCAB, length).tolist() for _ in range(n)]


def p18_engine(torch, cfg, params, mesh, mode, cache_dtype, prompt, n_new, check=None) -> dict:
    """One engine's greedy tokens with the launch counts of that call, its weight bytes and
    the linears it kept whole; then ``check(engine)``'s entries, whose launches are not
    counted."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.parallel.sharding import tree_bytes

    eng = InferenceEngine(cfg, params, max_seq_length=P18_BLOCK, cache_dtype=cache_dtype,
                          weights_mode=mode, device="cuda", mesh=mesh)
    if mode == "quantized":
        from fastmax_tpu_torch.ops import quant

        quant.set_quant_backend("pallas")  # K8 wherever it takes the shape
    p = torch.as_tensor(prompt, dtype=torch.int32)
    eng.generate(p, len(prompt) + 2)  # warm
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    out = eng.generate(p, len(prompt) + n_new)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.launch_counts().items() if v}
    row = {"tokens": out[0, len(prompt):].tolist(), "wall_s": wall, "launches": launches,
           "weight_bytes": tree_bytes(eng.params),
           "kept_whole": list(eng.shard.kept_whole) if eng.shard else []}
    if check is not None:
        row.update(check(eng))
    del eng
    return row


def p18_k2_check(torch, eng, prompt) -> dict:
    """K2 over the engine's query groups (a rank's 16 of the 32 on the mesh) against its
    plain version, on the int8 cache that the engine's prefill of ``prompt`` wrote, at the
    first and the last layer, bf16 and f32 q, under phase 4's gates (``attn_held``)."""
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import decode_attention as da

    p = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        _, cache = eng.prefill(p[None], eng.new_cache())
    kc, vc, ks, vs = cache["k"], cache["v"], cache["k_scale"], cache["v_scale"]
    n_layer, b, g, _, d = kc.shape
    hq = eng.cfg.n_head * g // eng.cfg.n_query_groups
    gen = torch.Generator(device="cuda").manual_seed(18)
    posv = torch.full((b,), len(prompt) - 1, dtype=torch.int32, device="cuda")
    worst = {}
    for qdt in (torch.bfloat16, torch.float32):
        q = torch.randn((b, hq, 1, d), generator=gen, device="cuda").to(qdt)
        for layer in (0, n_layer - 1):
            before = build.launch_counts().get("int8_decode_attention", 0)
            got = da.int8_decode_attention_stacked(q, kc, vc, ks, vs, layer, posv,
                                                   scale=d ** -0.5)
            if build.launch_counts().get("int8_decode_attention", 0) == before:
                raise AssertionError("K2 on the rank's cache ran its plain version")
            ref = da.int8_decode_attention_plain(q, kc[layer], vc[layer], ks[layer], vs[layer],
                                                 posv, scale=d ** -0.5)
            w, m = attn_held(torch, f"B={b} Hq={hq} G={g} layer {layer} {str(qdt)[6:]} on the "
                             "engine's cache", got, ref, qdt)
            key = str(qdt)[6:]
            worst[key] = max(worst.get(key, (0.0, 0.0)), (w, m))
    del cache
    return {"k2": {"groups": g, "heads": hq, "max_abs_err": {k: v[0] for k, v in worst.items()},
                   "mean_err": {k: v[1] for k, v in worst.items()}}}


def p18_linear_checks(torch, eng, mode) -> list:
    """K8 (``quantized``) or K9 (``preload_int4_block``) on each of layer 0's linears of
    the engine's weights (a rank's shard on the mesh) that the path sends to it, against
    the plain version on the same tensors, at the decode row (m = 1) and the prompt's
    (m = P18_PROMPT), f32 and bf16 x, under phase 14's gates."""
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.ops import quant_kernels as qk
    from fastmax_tpu_torch.parallel.sharding import linear_features

    gen = torch.Generator(device="cuda").manual_seed(18)
    if mode == "quantized":
        kern, atol, rtol = "nf4_matmul", NF4_ATOL, {torch.float32: NF4_RTOL}

        def call(x, p, plain):
            return qk.quantized_matmul_pallas(x, p, plain=plain)
    else:
        kern, atol, rtol = "int4_block_matmul", INT4_ATOL, {torch.float32: INT4_RTOL}

        def call(x, p, plain):
            return qk.int4_matmul_block(x, p, plain=plain)
    rtol[torch.bfloat16] = INT4_BF16_RTOL
    rows = []
    for name, mod, sub, _ in BLOCK_LINEARS:
        p = {key: v[0] for key, v in eng.params["blocks"][mod][sub].items()}
        k, n = linear_features(p)
        if mode == "quantized" and not qk.pallas_eligible(p, k, n):
            continue  # dequantize + matmul on this path, as on one rank
        for m in (1, P18_PROMPT):
            for dt in (torch.float32, torch.bfloat16):
                x = (torch.randn((m, k), generator=gen, device="cuda") + 0.5).to(dt)
                before = build.launch_counts().get(kern, 0)
                got = call(x, p, False)
                if build.launch_counts().get(kern, 0) == before:
                    raise AssertionError(f"{kern} on {name} (k={k}, n={n}) ran its plain version")
                ref = call(x, p, True)
                torch.cuda.synchronize()
                err = held(torch, f"{kern} on the engine's {name}, k={k} n={n} m={m} "
                           f"{str(dt)[6:]}", got, ref, atol, rtol[dt])
                rows.append({"linear": name, "k": k, "n": n, "m": m, "dtype": str(dt)[6:],
                             "max_abs_err": err})
    return rows


def p18_mode_check(torch, eng, mode, prompt, sharded: bool) -> dict:
    """(c)'s checks on an engine in an NF4 mode: the prefill and first decode step logits
    with float32 activations and a float32 cache, kernels against plain=True on the same
    weights (max and mean relative differences), and the kernels' logits themselves, for
    the caller to hold tp 2 against one rank; on the mesh, ``p18_linear_checks`` too."""
    p = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")
    saved = eng.params, eng.cache_dtype
    eng.params, eng.cache_dtype = with_f32_activations(torch, eng.params), torch.float32
    try:
        rel, mean, kern = kernels_vs_plain(torch, eng, p, p[:1])
    finally:
        eng.params, eng.cache_dtype = saved
    out = {"f32_rel": rel, "f32_mean": mean, "logits": (kern[0][0].cpu(), kern[1][0].cpu())}
    if sharded:
        out["linear_checks"] = p18_linear_checks(torch, eng, mode)
    return out


def p18_f32_logits(torch, cfg, params, mesh, prompt, token) -> tuple:
    """Prefill and first decode step logits with float32 activations and cache, the
    kernels on (the linears are the same tensors)."""
    from fastmax_tpu_torch.inference.engine import InferenceEngine

    eng = InferenceEngine(cfg, with_f32_activations(torch, params), max_seq_length=P18_BLOCK,
                          cache_dtype=torch.float32, weights_mode="auto", device="cuda",
                          mesh=mesh)
    p = torch.as_tensor(prompt, dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        logits, cache = eng.prefill(p[None], eng.new_cache())
        step, _ = eng._forward(torch.tensor([[token]], dtype=torch.int32, device="cuda"),
                               cache, len(prompt))
    out = (logits[0].float().cpu(), step[0, -1].float().cpu())
    del eng, cache
    return out


def p18_batcher(torch, cfg, params, mesh, prompts, n_new) -> dict:
    """The 8-slot batcher (int8 cache, decode quantum 8): every prompt greedy, drained;
    tokens, tok/s and launches. On a mesh rank 0 drives it and the other rank follows."""
    import numpy as np

    from fastmax_tpu_torch.inference.continuous import ContinuousBatcher
    from fastmax_tpu_torch.kernels import build

    b = ContinuousBatcher(cfg, params, n_slots=P18_SLOTS, max_seq_length=P18_BLOCK,
                          weights_mode="preload_int4", cache_dtype=torch.int8,
                          decode_quantum=P18_QUANTUM, device="cuda", mesh=mesh)
    if mesh is not None and not mesh.leader:
        build.reset_launch_counts()
        b.follow()
        return {"launches": {k: v for k, v in build.launch_counts().items() if v}}
    torch.cuda.synchronize()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [b.submit(np.asarray(p, np.int32), n_new) for p in prompts]
    res = b.run_to_completion()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b.close()
    toks = [res[r] for r in rids]
    return {"tokens": toks, "wall_s": wall, "tok_s": sum(len(t) for t in toks) / wall,
            "launches": {k: v for k, v in build.launch_counts().items() if v}}


def p18_rank(cfg_int4: dict, cfg_modes: dict, ckpt: str, cli_prompts: list) -> dict:
    """One of the two ranks on the card: (a) the 7B engine in preload_int4 with an int8
    cache, K2 on its cache, and its f32 twin's first-step logits; (b) the batcher; (c) the
    NF4 modes quantized (K8) and preload_int4_block (K9) with ``p18_mode_check``; (d)
    generate --tp 2, the server at --tp 2 and load_sharded_model_params on phase 12's
    directory (the bodies of ``tests/torch_rank_checks.py``)."""
    import numpy as np
    import torch
    import torch_rank_checks as rank_checks

    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel.sharding import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_mesh(1, 1, 2)
    out = {"rank": mesh.rank}
    cfg = Config(**cfg_int4)
    params = p18_weights(torch, cfg, "int4")
    prompt = p18_prompts(np, 1, P18_PROMPT)[0]
    out["engine"] = p18_engine(torch, cfg, params, mesh, "preload_int4", torch.int8, prompt,
                               P18_NEW, check=lambda eng: p18_k2_check(torch, eng, prompt))
    out["f32"] = p18_f32_logits(torch, cfg, params, mesh, prompt, out["engine"]["tokens"][0])
    out["batcher"] = p18_batcher(torch, cfg, params, mesh,
                                 p18_prompts(np, P18_REQUESTS, P18_PROMPT), P18_NEW)
    del params
    cfg = Config(**cfg_modes)
    nf4 = p18_weights(torch, cfg, "nf4")
    for mode in ("quantized", "preload_int4_block"):
        out[mode] = p18_engine(torch, cfg, nf4, mesh, mode, torch.int8, prompt, P18_MODES_NEW,
                               check=lambda eng, mode=mode: p18_mode_check(torch, eng, mode,
                                                                           prompt, True))
    del nf4
    if ckpt:
        from fastmax_tpu_torch.kernels import build

        flags = ["--checkpoint_dir", ckpt, "--precision", "float32", "--device", "cuda"]
        build.reset_launch_counts()
        out["generate"] = rank_checks.generate_cli(
            ["--prompt", cli_prompts[0], "--max_new_tokens", "16", "--temperature", "0",
             "--tp", "2"] + flags)
        out["server"] = rank_checks.server_cli(
            ["--host", "127.0.0.1", "--port", "0", "--n_slots", "2", "--tp", "2"] + flags,
            [{"prompt": p, "max_new_tokens": 16} for p in cli_prompts])
        out["cli_launches"] = {k: v for k, v in build.launch_counts().items() if v}
        out["load"] = rank_checks.sharded_load(ckpt, 2, 1, np.asarray([[1, 2, 3, 4]]),
                                               dtype="bfloat16", device="cuda")
    return out


def p18_nccl_rank(cfg_kw: dict) -> dict:
    """(e) One rank over NCCL: the (1, 1, 1) mesh's group initialises (one all-reduce on
    the card), and the mesh engine's greedy tokens are the no-mesh engine's bit for bit."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from fastmax_tpu_torch.inference.engine import InferenceEngine
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel.sharding import make_mesh

    torch.cuda.set_device(0)
    mesh = make_mesh(1, 1, 1)
    x = torch.ones(4, device="cuda")
    dist.all_reduce(x)
    torch.cuda.synchronize()
    cfg = Config(**cfg_kw)
    params = p18_weights(torch, cfg, "int4")
    prompt = torch.as_tensor(p18_prompts(np, 1, P18_PROMPT)[0], dtype=torch.int32)
    outs = []
    for m in (None, mesh):
        eng = InferenceEngine(cfg, params, max_seq_length=P18_BLOCK, cache_dtype=torch.int8,
                              device="cuda", mesh=m)
        outs.append(eng.generate(prompt, P18_PROMPT + P18_NEW)[0].tolist())
        del eng
    return {"backend": dist.get_backend(), "all_reduce": x.tolist(), "tokens": outs}


def tp_serving_path(torch, results, card, tmp, ckpt) -> dict:
    """Phase 18 (see the constants above); runs inside phase 12's directory for (d)."""
    import numpy as np

    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel import collectives as col

    log("[18] multi-GPU serving: two ranks on the one card over gloo (the collectives cross "
        "the host: no figure here is a multi-GPU one), held against one rank")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg_int4, cfg_modes = p18_config(LAYERS_7B), p18_config(P18_MODES_LAYERS)
    prompt = p18_prompts(np, 1, P18_PROMPT)[0]
    prompts = p18_prompts(np, P18_REQUESTS, P18_PROMPT)
    counts, out = {}, {"card": card}

    # the one-rank references, on the idle card
    cfg = Config(**cfg_int4)
    params = p18_weights(torch, cfg, "int4")
    one = {"engine": p18_engine(torch, cfg, params, None, "preload_int4", torch.int8, prompt,
                                P18_NEW)}
    one["f32"] = p18_f32_logits(torch, cfg, params, None, prompt, one["engine"]["tokens"][0])
    one["batcher"] = p18_batcher(torch, cfg, params, None, prompts, P18_NEW)
    from fastmax_tpu_torch.inference.engine import InferenceEngine

    ref_engine = InferenceEngine(cfg, params, max_seq_length=P18_BLOCK, cache_dtype=torch.int8)
    cfgm = Config(**cfg_modes)
    nf4 = p18_weights(torch, cfgm, "nf4")
    for mode in ("quantized", "preload_int4_block"):
        one[mode] = p18_engine(torch, cfgm, nf4, None, mode, torch.int8, prompt, P18_MODES_NEW,
                               check=lambda eng, mode=mode: p18_mode_check(torch, eng, mode,
                                                                           prompt, False))
    mode_engines = {mode: InferenceEngine(cfgm, nf4, max_seq_length=P18_BLOCK,
                                          cache_dtype=torch.int8, weights_mode=mode)
                    for mode in ("quantized", "preload_int4_block")}
    from fastmax_tpu_torch.ops import quant

    quant.set_quant_backend("xla")
    cli_prompts = ["def main", "import torch"]
    gc.collect()
    torch.cuda.empty_cache()

    if str(REPO / "tests") not in sys.path:  # the ranks import torch_rank_checks from there
        sys.path.insert(0, str(REPO / "tests"))
    t0 = time.perf_counter()
    ranks = col.spawn_local(p18_rank, 2, backend="gloo",
                            args=(cfg_int4, cfg_modes, str(ckpt), cli_prompts), timeout=600)
    ranks_s = time.perf_counter() - t0
    r0 = ranks[0]

    # (a) the engine
    for r in ranks:
        e = r["engine"]
        log(f"  (a) rank {r['rank']}: {e['weight_bytes'] / 1e9:.3f} GB of weights, kept whole: "
            f"{e['kept_whole'] or 'none'}; launches {e['launches']}   [{card}]")
        for k in ("int4_rank1_matmul", "int8_decode_attention", "flash_attention"):
            if not e["launches"].get(k):
                raise AssertionError(f"(a) rank {r['rank']} never launched {k}: {e['launches']}")
        if e["kept_whole"]:
            raise AssertionError(f"(a) the 7B kept linears whole at tp 2: {e['kept_whole']}")
        log(f"  (a) rank {r['rank']}: K2 on the engine's int8 cache, {e['k2']['groups']} groups "
            f"and {e['k2']['heads']} heads, against its plain version: max abs err "
            f"{e['k2']['max_abs_err']}, mean err {e['k2']['mean_err']} of the mean")
    e1 = one["engine"]
    log(f"  (a) one rank: {e1['weight_bytes'] / 1e9:.3f} GB of weights; "
        f"{P18_NEW} tokens in {e1['wall_s']:.3f} s; two ranks: {r0['engine']['wall_s']:.3f} s "
        f"(two ranks on one card over gloo, not a multi-GPU figure)   [{card}]")
    out["engine"] = {"one": {k: v for k, v in e1.items() if k != "tokens"},
                     "ranks": [{k: v for k, v in r["engine"].items() if k != "tokens"}
                               for r in ranks],
                     "tokens": near_tie(torch, ref_engine, prompt, e1["tokens"],
                                        r0["engine"]["tokens"], "(a) tp 2 engine vs one rank")}
    if ranks[1]["engine"]["tokens"] != r0["engine"]["tokens"]:
        raise AssertionError("(a) the two ranks generated different tokens")
    rel = {n: logits_rel(torch, a, b) for n, a, b in zip(("prefill", "decode_step"),
                                                          r0["f32"], one["f32"])}
    mean = {n: float((a - b).abs().mean() / b.abs().mean())
            for n, a, b in zip(("prefill", "decode_step"), r0["f32"], one["f32"])}
    log(f"  (a) f32 activations and cache, tp 2 vs one rank: logits max|diff|/max {rel}, "
        f"mean {mean} (gates {LOGITS_REL_TOL}, {FAMILY_MEAN_REL})")
    out["engine"]["f32"] = {"rel": rel, "mean": mean}
    if max(rel.values()) > LOGITS_REL_TOL or max(mean.values()) > FAMILY_MEAN_REL:
        raise AssertionError(f"(a) f32 logits beyond the gates: {rel} {mean}")

    # (b) the batcher
    b1, b2 = one["batcher"], r0["batcher"]
    checks = [near_tie(torch, ref_engine, p, w, g, f"(b) request {i}")
              for i, (p, w, g) in enumerate(zip(prompts, b1["tokens"], b2["tokens"]))]
    log(f"  (b) batcher, {P18_SLOTS} slots, quantum {P18_QUANTUM}, {P18_REQUESTS} x {P18_NEW} "
        f"tokens: one rank {b1['tok_s']:.1f} tok/s, tp 2 {b2['tok_s']:.1f} tok/s (two ranks on "
        f"one card over gloo, not a multi-GPU figure); launches rank 0 {b2['launches']}, "
        f"rank 1 {ranks[1]['batcher']['launches']}   [{card}]")
    for r in ranks:
        if not r["batcher"]["launches"].get("int4_rank1_matmul"):
            raise AssertionError(f"(b) rank {r['rank']} never launched K1")
    out["batcher"] = {"one_tok_s": b1["tok_s"], "tp2_tok_s": b2["tok_s"], "checks": checks,
                      "launches": [r["batcher"]["launches"] for r in ranks]}

    # (c) the NF4 modes
    out["modes"] = {}
    for mode, kern in (("quantized", "nf4_matmul"), ("preload_int4_block", "int4_block_matmul")):
        m1, m2 = one[mode], r0[mode]
        chk = near_tie(torch, mode_engines[mode], prompt, m1["tokens"], m2["tokens"],
                       f"(c) {mode} tp 2 vs one rank")
        log(f"  (c) {mode}: rank weights {[r[mode]['weight_bytes'] / 1e9 for r in ranks]} GB "
            f"(one rank {m1['weight_bytes'] / 1e9:.3f}), kept whole {m2['kept_whole'] or 'none'}"
            f"; launches {[r[mode]['launches'] for r in ranks]}, one rank {m1['launches']}"
            f"   [{card}]")
        # every linear that the kernel takes on one rank it takes on a rank's shard
        per = QSERVE_KERNELS[mode][1]
        want = per * cfgm.n_layer * P18_MODES_NEW
        for label, row in [("one rank", m1)] + [(f"rank {r['rank']}", r[mode]) for r in ranks]:
            if row["launches"].get(kern) != want:
                raise AssertionError(f"(c) {mode}: {label} launched {kern} "
                                     f"{row['launches'].get(kern)} times, not {want} ({per} a "
                                     "layer and token)")
        for label, row in [("one rank", m1)] + [(f"rank {r['rank']}", r[mode]) for r in ranks]:
            log(f"  (c) {mode}, {label}: f32 logits kernels vs plain=True, max|diff|/max "
                f"{row['f32_rel']}, mean {row['f32_mean']}")
            if max(row["f32_rel"].values()) > LOGITS_REL_TOL or \
                    max(row["f32_mean"].values()) > FAMILY_MEAN_REL:
                raise AssertionError(f"(c) {mode}, {label}: f32 logits kernels vs plain beyond "
                                     f"the gates: {row['f32_rel']} {row['f32_mean']}")
        names = ("prefill", "decode_step")
        rel = {n: logits_rel(torch, a, b) for n, a, b in zip(names, m2["logits"], m1["logits"])}
        mean = {n: float((a - b).abs().mean() / b.abs().mean())
                for n, a, b in zip(names, m2["logits"], m1["logits"])}
        log(f"  (c) {mode}: f32 logits, tp 2 vs one rank: max|diff|/max {rel}, mean {mean} "
            f"(gates {LOGITS_REL_TOL}, {FAMILY_MEAN_REL})")
        if max(rel.values()) > LOGITS_REL_TOL or max(mean.values()) > FAMILY_MEAN_REL:
            raise AssertionError(f"(c) {mode}: f32 logits tp 2 vs one rank beyond the gates: "
                                 f"{rel} {mean}")
        lin = [c for r in ranks for c in r[mode]["linear_checks"]]
        shapes = sorted({(c["linear"], c["k"], c["n"]) for c in lin})
        log(f"  (c) {mode}: {kern} on the ranks' layer-0 shards {shapes} against its plain "
            f"version at m = 1 and {P18_PROMPT}, f32 and bf16 x: max abs err "
            f"{max(c['max_abs_err'] for c in lin):.3e}")
        out["modes"][mode] = {"check": chk, "launches": [r[mode]["launches"] for r in ranks],
                              "one_rank_launches": m1["launches"], "per_layer_token": per,
                              "kept_whole": m2["kept_whole"],
                              "f32_kernels_vs_plain": [row["f32_rel"] for row in
                                                       [m1] + [r[mode] for r in ranks]],
                              "f32_tp2_vs_one": {"rel": rel, "mean": mean},
                              "linear_checks": lin}
    del ref_engine, mode_engines, params, nf4

    # (d) the command lines on phase 12's directory
    from fastmax_tpu_torch.inference import generate
    from fastmax_tpu_torch.models.tokenizer import Tokenizer

    buf = io.StringIO()
    flags = ["--checkpoint_dir", str(ckpt), "--precision", "float32", "--device", "cuda"]
    with contextlib.redirect_stdout(buf), contextlib.redirect_stderr(io.StringIO()):
        generate.cli(["--prompt", cli_prompts[0], "--max_new_tokens", "16", "--temperature",
                      "0"] + flags)
    same_text = buf.getvalue().strip() == r0["generate"].strip()
    cfg_d, params_d = generate.load_and_prepare(ckpt, precision="float32", device="cuda")
    eng_d = InferenceEngine(cfg_d, params_d, max_seq_length=256, device="cuda")
    tok = Tokenizer(ckpt)
    server_checks = []
    for p, answer in zip(cli_prompts, r0["server"]):
        e = tok.encode(p)
        ref = eng_d.generate(torch.as_tensor(e), len(e) + 16, eos_id=tok.eos_id)
        server_checks.append(near_tie(torch, eng_d, e.tolist(), ref[0, len(e):].tolist(),
                                      answer["tokens"], f"(d) server --tp 2, {p!r}"))
    load = r0["load"]
    worst = max(load["diffs"].values())
    reads = load["read_bytes"]
    total = sum(p.stat().st_size for p in Path(ckpt).rglob("*") if p.is_file()
                and p.suffix in (".npy", ".safetensors", ".pth"))
    log(f"  (d) generate --tp 2 printed the one-rank text: {same_text}; the server at --tp 2 "
        f"answered {len(r0['server'])} requests; load_sharded_model_params: each rank's "
        f"leaves vs the same cut of the whole load, max|diff| {worst}; bytes read by each "
        f"rank {reads} of the checkpoint's {total}; launches {r0['cli_launches']}   [{card}]")
    if not same_text or worst != 0.0:
        raise AssertionError(f"(d) generate text {same_text}, load max|diff| {worst}")
    out["commands"] = {"generate_same_text": same_text, "server": server_checks,
                       "load_max_diff": worst, "read_bytes": reads, "checkpoint_bytes": total,
                       "launches": [r["cli_launches"] for r in ranks]}
    del eng_d, params_d

    # (e) one rank over NCCL
    e = col.spawn_local(p18_nccl_rank, 1, backend="nccl", args=(p18_config(CMD_DEPTH),),
                        timeout=300)[0]
    bit = e["tokens"][0] == e["tokens"][1]
    log(f"  (e) one rank over {e['backend']}: all_reduce {e['all_reduce']}; the (1, 1, 1) mesh "
        f"engine's tokens equal the no-mesh engine's bit for bit: {bit}   [{card}]")
    if e["backend"] != "nccl" or not bit or e["all_reduce"] != [1.0] * 4:
        raise AssertionError(f"(e) {e}")
    out["nccl"] = {"backend": e["backend"], "bit_for_bit": bit}

    for r in ranks:
        for part in ("engine", "quantized", "preload_int4_block"):
            add_counts(counts, r[part]["launches"])
        add_counts(counts, r["batcher"]["launches"])
        add_counts(counts, r["cli_launches"])
    out["ranks_s"] = ranks_s
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  phase 18 in {out['phase_s']:.1f} s (the ranks {ranks_s:.1f} s); launches over both "
        f"ranks {counts}")
    results["tp_serving"] = out
    return counts


def tp_serving_alone() -> dict:
    """Phase 18 by itself, outside the script's run: the kernels built, a 2-layer
    Llama-2-7B-width directory (random bf16, seed 0) with a BPE tokenizer trained on
    README.md written to a temporary directory, then ``tp_serving_path`` on it; the
    results to ``chiprun_out/tp_serving.json``. Run as ``python3 -c "import chip_smoke;
    chip_smoke.tp_serving_alone()"`` (a script that calls it needs a main guard: each
    spawned rank imports the launching script again)."""
    import tempfile

    import torch
    from tokenizers import Tokenizer as HFTok
    from tokenizers.models import BPE
    from tokenizers.pre_tokenizers import Whitespace
    from tokenizers.trainers import BpeTrainer

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.models.params import params_to_flat
    from fastmax_tpu_torch.utils.checkpoint import save_flat_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build.build_all()
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "ckpt"
        cfg = Config.from_name(P18_MODEL)
        cfg.n_layer = CMD_DEPTH
        save_flat_checkpoint(params_to_flat(gpt.init_params(cfg, 0, torch.bfloat16, "cuda"),
                                            cfg), ckpt)
        cfg.to_json(ckpt / "lit_config.json")
        tok = HFTok(BPE(unk_token="<unk>"))
        tok.pre_tokenizer = Whitespace()
        tok.train_from_iterator([(REPO / "README.md").read_text()],
                                BpeTrainer(special_tokens=["<unk>", "<s>", "</s>"],
                                           vocab_size=4000))
        tok.save(str(ckpt / "tokenizer.json"))
        (ckpt / "tokenizer_config.json").write_text(json.dumps({"eos_token": "</s>"}))
        gc.collect()
        torch.cuda.empty_cache()
        tp_serving_path(torch, results, card, Path(tmp), ckpt)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "tp_serving.json").write_text(json.dumps(results, indent=1, default=str))
    return results


# ----------------------------------------------------------------- phase 19
# Multi-GPU training on the one card: two ranks (collectives.spawn_local) on the same H100
# over gloo, as in phase 18 (NCCL takes no two ranks on one GPU); the collectives and their
# backwards cross the host. No time or rate here is a multi-GPU figure. Each trainer's
# entry point runs on the (dp, fsdp, tp) mesh and is held against one rank's run on the
# same seed and batches: (a) pretraining in f32, every step's loss within P19_PT_REL;
# (b) QLoRA in bf16, under the rule that needs no guess: the sharded run's loss and LoRA
# gradients stay within twice the distance between two one-rank runs that split the same
# micro-batch differently (a micro-batch of 2 against two accumulated micro-batches of 1;
# the examples carry equal label counts, so both are the same function; the loss's
# distance is at least one float32 step of it); (c) bench_mfu
# at fsdp 2; (d) sequence parallelism in f32 against one rank's dense loss; (e) (a) at
# one rank over NCCL, bit for bit against the run with no mesh.
# (a) 2 steps and (b) 4 layers (4 and 8 before phase 20)
P19_PT_MODEL, P19_PT_STEPS, P19_PT_BATCH = "easy-transformer-fastmax", 2, 16  # 16 x 512
P19_PT_MESHES = ((2, 1, 1), (1, 2, 1), (1, 1, 2))
P19_PT_REL = 1e-4
P19_FT_LAYERS, P19_FT_T, P19_FT_MESHES = 4, 2048, ((2, 1, 1), (1, 2, 1))
# (c) at 11 of TinyLlama's 22 layers: the script's time limit forces the cut (at 22 a
# step took 7.3 s, most of it the gathers and reduce-scatters through gloo)
P19_MFU_MODEL, P19_MFU_LAYERS = "tiny-llama-1.1b", 11
P19_MFU = dict(seq_len=2048, micro_batch=8, iters=2, remat="full", fsdp=2)
P19_SP_MODEL, P19_SP_LAYERS, P19_SP_T = "tiny-llama-1.1b", 2, 2048
P19_SP_LOSS_REL, P19_SP_GRAD_REL = 1e-5, 1e-4


def p19_sft(np, n: int = 8) -> list:
    """SFT examples of exactly P19_FT_T tokens of the repository's text, every label kept
    (equal label counts: a micro-batch of 2 and two of 1 are one function)."""
    tokens, _ = repo_text_tokens(np)
    ids = tokens.astype(np.int64) + 3
    return [{"input_ids": ids[i * P19_FT_T:(i + 1) * P19_FT_T],
             "labels": ids[i * P19_FT_T:(i + 1) * P19_FT_T]} for i in range(n)]


def p19_digest(torch, tree) -> str:
    import hashlib

    from fastmax_tpu_torch.training.step import tree_leaves

    h = hashlib.sha256()
    for x in tree_leaves(tree):
        h.update(x.detach().contiguous().cpu().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def p19_metrics(out) -> list:
    import csv

    with open(Path(out) / "metrics.csv", newline="") as f:
        return [float(r["loss"]) for r in csv.DictReader(f)]


def p19_pretrain(torch, data, out, mesh=(1, 1, 1)) -> dict:
    """``pretrain.setup`` on easy-transformer-fastmax, 16 x 512, f32, P19_PT_STEPS steps at
    ``mesh`` (every rank calls it): the logged losses (rank 0), this rank's K4/K5 launches,
    parameter and optimizer-state bytes, the whole final parameters' digest, the wall time."""
    import torch.distributed as dist

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.parallel.sharding import tree_bytes
    from fastmax_tpu_torch.training import pretrain
    from fastmax_tpu_torch.training.fit import whole_params
    from fastmax_tpu_torch.training.quant_optim import state_nbytes
    from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs

    dp, fsdp, tp = mesh
    build.reset_launch_counts()
    t0 = time.perf_counter()
    state = pretrain.setup(model_name=P19_PT_MODEL, data_format="openwebtext", dp=dp, fsdp=fsdp,
                           tp=tp, train=TrainArgs(
                               global_batch_size=P19_PT_BATCH, micro_batch_size=P19_PT_BATCH,
                               max_iters=P19_PT_STEPS, learning_rate=6e-4, save_interval=1000,
                               log_interval=1), io=IOArgs(train_data_dir=data, out_dir=out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    leader = not dist.is_initialized() or dist.get_rank() == 0
    return {"losses": p19_metrics(out) if leader else None, "wall_s": wall,
            "launches": {k: v for k, v in build.launch_counts().items() if v},
            "param_bytes": tree_bytes(dict(state.params)),
            "opt_bytes": state_nbytes(state.opt_state),
            "digest": p19_digest(torch, whole_params(state.params))}


def p19_qlora(torch, data, out, mesh=(1, 1, 1), micro_batch: int = 2) -> dict:
    """``finetune.setup`` QLoRA (bnb.nf4, bf16, LoRA r 8, alpha 16 on query and value) on
    Llama-2-7B at full width cut to P19_FT_LAYERS layers, one step of a global micro-batch
    of 2 at T = P19_FT_T (``micro_batch`` 1: two accumulated): the logged loss (rank 0),
    the step's whole LoRA gradients (float32, on the host), this rank's launches and peak
    memory."""
    import torch.distributed as dist

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.parallel.sharding import tree_paths
    from fastmax_tpu_torch.training import finetune
    from fastmax_tpu_torch.training.step import tree_leaves
    from fastmax_tpu_torch.utils.args import IOArgs, TrainArgs

    dp, fsdp, tp = mesh
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    train = TrainArgs(global_batch_size=2, micro_batch_size=micro_batch, max_iters=1,
                      learning_rate=3e-4, save_interval=1000, log_interval=1,
                      max_seq_length=P19_FT_T)
    state = finetune.setup(method="lora", model_name=cut_model("Llama-2-7b-hf", P19_FT_LAYERS),
                           data_path=data, quantize="bnb.nf4", attn_alg="quadratic",
                           precision="bfloat16", lora_r=8, lora_alpha=16.0, lora_query=True,
                           lora_value=True, dp=dp, fsdp=fsdp, tp=tp, train=train,
                           io=IOArgs(out_dir=out))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in build.launch_counts().items() if v}
    leaves = tree_leaves(state.params)
    paths = tree_paths(dict(state.params))
    # the step's gradient: .grad holds the micro-batches' sum (this rank's share on a mesh)
    accum = train.gradient_accumulation_iters()
    grads = [None if x.grad is None else x.grad / accum for x in leaves]
    plan = getattr(state.params, "plan", None)
    if plan is not None:
        grads = plan.sync_grads(leaves, grads)
    out_g = {}
    with torch.no_grad():
        for path, x, g in zip(paths, leaves, grads):
            if g is not None:
                whole = g if plan is None else plan.leaf_split(path, x).gather(g)
                out_g[".".join(path)] = whole.float().cpu()
    leader = not dist.is_initialized() or dist.get_rank() == 0
    return {"loss": p19_metrics(out)[0] if leader else None, "grads": out_g, "wall_s": wall,
            "launches": counts, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "kept_whole": list(plan.kept_whole) if plan is not None else []}


def p19_sp(torch, mesh) -> dict:
    """(d) on a rank of the (1, 1, 2) mesh: TinyLlama's width, P19_SP_LAYERS layers, f32,
    T = P19_SP_T split over the two ranks: ``make_sp_loss_fn``'s loss and gradients (summed
    over the ranks), one rank's dense loss and gradients (rank 0, the model's own forward),
    one ``make_sp_train_step`` step, and ``make_sp_tp_fsdp_loss_fn``'s loss at (1, 1, 2) and
    (1, 2, 1)."""
    import numpy as np

    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel import collectives as col
    from fastmax_tpu_torch.parallel import sequence_parallel as sp
    from fastmax_tpu_torch.parallel.sharding import make_mesh, shard_params
    from fastmax_tpu_torch.training.step import AdamW, tree_leaves
    from fastmax_tpu_torch.utils.loss import cross_entropy

    cfg = Config.from_name(P19_SP_MODEL)
    cfg.n_layer, cfg.block_size = P19_SP_LAYERS, P19_SP_T
    params = gpt.init_params(cfg, 19, torch.float32, "cuda")
    batch = torch.as_tensor(np.random.default_rng(19).integers(0, cfg.vocab_size,
                                                               (1, P19_SP_T + 1)), device="cuda")
    leaves = tree_leaves(params)
    out = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x in leaves:
        x.requires_grad_(True)
    loss = sp.make_sp_loss_fn(cfg, mesh, axis="model")(params, batch)
    loss.backward()
    grads = [col.all_reduce(x.grad, mesh.group("model")) for x in leaves]
    torch.cuda.synchronize()
    out["sp_s"] = time.perf_counter() - t0
    out["sp_loss"] = float(loss.detach())
    if mesh.leader:  # one rank's dense loss over the same stream
        for x in leaves:
            x.grad = None
        stream = batch[:, :-1]
        logits, _ = gpt.forward(params, cfg, stream)
        dense = cross_entropy(logits[:, :-1], stream[:, 1:])
        dense.backward()
        out["dense_loss"] = float(dense)
        out["grad_rel"] = max(float((g - x.grad).abs().max() / x.grad.abs().max())
                              for g, x in zip(grads, leaves))
    for x in leaves:
        x.grad = None
    opt = AdamW(lambda c: 1e-4, weight_decay=0.0)
    state = opt.init(params)
    step = sp.make_sp_train_step(cfg, mesh, opt, axis="model")
    out["step_losses"] = [float(step(params, state, batch)[2]) for _ in range(2)]
    del state, grads
    for m in ((1, 1, 2), (1, 2, 1)):
        m3 = make_mesh(*m)
        base = gpt.init_params(cfg, 19, torch.float32, "cuda")
        loss_fn, _ = sp.make_sp_tp_fsdp_loss_fn(cfg, m3, base)
        local = shard_params(base, m3, cfg, train=True)
        with torch.no_grad():
            out[f"three_way_{m}"] = float(loss_fn(local, batch))
        del base, local
    return out


def p19_rank(data: str, sft: str, out: str) -> dict:
    """One of the two ranks on the card: the gloo probe, (a) pretraining at each mesh,
    (b) QLoRA at dp 2 and fsdp 2 (the 4-bit backend set to "pallas" on rank 0 alone: the
    trainer gives every rank rank 0's choice), (c) bench_mfu at fsdp 2, (d) sequence
    parallelism."""
    import torch
    import torch.distributed as dist

    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.parallel import collectives as col
    from fastmax_tpu_torch.parallel.sharding import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    rank = dist.get_rank()
    res = {"rank": rank}
    # gloo's reduce-scatter on CUDA tensors, which the fsdp gathers' backward calls
    x = torch.arange(4, dtype=torch.float32, device="cuda") * (rank + 1)
    y = col.reduce_scatter(x, 0, dist.group.WORLD)
    res["reduce_scatter"] = y.tolist()
    res["pretrain"] = {m: p19_pretrain(torch, data, f"{out}/pt_{'x'.join(map(str, m))}", m)
                       for m in P19_PT_MESHES}
    if rank == 0:
        quant.set_quant_backend("pallas")
    res["qlora"] = {m: p19_qlora(torch, sft, f"{out}/ft_{'x'.join(map(str, m))}", m)
                    for m in P19_FT_MESHES}
    res["backend"] = quant.get_quant_backend()
    quant.set_quant_backend("xla")
    from fastmax_tpu_torch.training import bench_mfu

    gc.collect()
    torch.cuda.empty_cache()
    res["bench"] = bench_mfu.run(model_name=cut_model(P19_MFU_MODEL, P19_MFU_LAYERS),
                                 **P19_MFU, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    res["sp"] = p19_sp(torch, make_mesh(1, 1, 2))
    return res


def p19_nccl_rank(data: str, out: str) -> dict:
    """(e) One rank over NCCL: (a)'s pretraining on the (1, 1, 1) mesh of the group (every
    collective wrapper called, each a group of one)."""
    import torch
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    run = p19_pretrain(torch, data, out)
    return {**run, "backend": dist.get_backend()}


def train_mesh_path(torch, results, card) -> dict:
    """Phase 19 (see the constants above)."""
    import tempfile

    import numpy as np

    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.ops import quant
    from fastmax_tpu_torch.parallel import collectives as col

    log("[19] multi-GPU training: two ranks on the one card over gloo (the collectives and "
        "their backwards cross the host: no figure here is a multi-GPU one), held against one "
        "rank")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out, counts = {"card": card}, {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        data = tmp / "data"
        data.mkdir()
        repo_text_tokens(np)[0].tofile(data / "train.bin")
        (data / "meta.json").write_text('{"dtype": "uint16"}')
        sft = tmp / "sft.npz"
        np.savez(sft, examples=np.array(p19_sft(np), dtype=object))

        # the one-rank references, on the idle card
        one = p19_pretrain(torch, data, tmp / "pt_one")
        quant.set_quant_backend("pallas")
        ft_a = p19_qlora(torch, sft, tmp / "ft_one")
        ft_b = p19_qlora(torch, sft, tmp / "ft_accum", micro_batch=1)
        quant.set_quant_backend("xla")
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = col.spawn_local(p19_rank, 2, backend="gloo",
                                args=(str(data), str(sft), str(tmp)), timeout=600)
        ranks_s = time.perf_counter() - t0
        nccl = col.spawn_local(p19_nccl_rank, 1, backend="nccl",
                               args=(str(data), str(tmp / "pt_nccl")), timeout=300)[0]
    r0 = ranks[0]
    rs = [r["reduce_scatter"] for r in ranks]
    log(f"  gloo's reduce-scatter on CUDA tensors: {rs} (want [[0, 3], [6, 9]]); the ring shift "
        "under gloo is an all-gather and a pick (gloo's send of a CUDA tensor aborts)")
    if rs != [[0.0, 3.0], [6.0, 9.0]]:
        raise AssertionError(f"reduce_scatter over gloo on CUDA tensors gave {rs}")

    # (a) pretraining
    cfg = Config.from_name(P19_PT_MODEL)
    want = {"fastmax_fwd": 2 * cfg.n_layer * P19_PT_STEPS, "fastmax_bwd": cfg.n_layer * P19_PT_STEPS}
    log(f"  (a) one rank: {P19_PT_MODEL} {P19_PT_BATCH} x 512 f32, {P19_PT_STEPS} steps in "
        f"{one['wall_s']:.2f} s, losses {one['losses']}; params {one['param_bytes'] / 1e6:.1f} MB,"
        f" optimizer state {one['opt_bytes'] / 1e6:.1f} MB; launches {one['launches']}   [{card}]")
    out["pretrain"] = {"one": {k: v for k, v in one.items() if k != "digest"}, "meshes": {}}
    for label, run in [("one rank", one)] + [(f"{m} rank {r['rank']}", r["pretrain"][m])
                                             for m in P19_PT_MESHES for r in ranks]:
        got = {k: run["launches"].get(k) for k in want}
        if got != want:
            raise AssertionError(f"(a) {label}: K4/K5 launches {got} != {want} (2 and 1 a "
                                 "layer and micro-batch)")
    for m in P19_PT_MESHES:
        runs = [r["pretrain"][m] for r in ranks]
        rel = max(abs(a - b) / abs(b) for a, b in zip(runs[0]["losses"], one["losses"]))
        log(f"  (a) (dp, fsdp, tp) = {m}: {P19_PT_STEPS} steps in {runs[0]['wall_s']:.2f} s (two "
            f"ranks on one card over gloo, not a multi-GPU figure); losses {runs[0]['losses']}, "
            f"worst step vs one rank {rel:.2e} (gate {P19_PT_REL}); per rank params "
            f"{[r['param_bytes'] / 1e6 for r in runs]} MB, optimizer state "
            f"{[r['opt_bytes'] / 1e6 for r in runs]} MB; K4/K5 a rank {want}   [{card}]")
        if not rel <= P19_PT_REL:
            raise AssertionError(f"(a) {m}: losses {runs[0]['losses']} vs {one['losses']}")
        if runs[0]["digest"] != runs[1]["digest"]:
            raise AssertionError(f"(a) {m}: the ranks' whole parameters differ")
        out["pretrain"]["meshes"][str(m)] = {
            "losses": runs[0]["losses"], "worst_rel": rel, "wall_s": runs[0]["wall_s"],
            "param_bytes": [r["param_bytes"] for r in runs],
            "opt_bytes": [r["opt_bytes"] for r in runs]}
        for r in runs:
            add_counts(counts, r["launches"])
    fs = [r["pretrain"][(1, 2, 1)] for r in ranks]
    if not all(r["param_bytes"] * 2 <= one["param_bytes"] * 1.01 for r in fs):
        raise AssertionError(f"(a) fsdp 2: a rank holds {[r['param_bytes'] for r in fs]} of "
                             f"{one['param_bytes']} parameter bytes")

    # (b) QLoRA
    def gdiff(a, b):
        return max(float((a["grads"][n] - b["grads"][n]).abs().max()) for n in b["grads"])

    # the distance counted at least one float32 step of the loss: two runs that round
    # alike are that close, and no closer difference can be written
    d_loss = max(abs(ft_b["loss"] - ft_a["loss"]), float(np.spacing(np.float32(ft_a["loss"]))))
    d_grad = gdiff(ft_b, ft_a)
    ft_want = {"flash_train_fwd": 2 * P19_FT_LAYERS, "flash_train_bwd": P19_FT_LAYERS}
    log(f"  (b) one rank: QLoRA Llama-2-7B (full width, {P19_FT_LAYERS} of 32 layers), bnb.nf4, "
        f"bf16, T {P19_FT_T}, micro-batch 2: loss {ft_a['loss']:.6f} in {ft_a['wall_s']:.2f} s, "
        f"peak {ft_a['peak_gb']:.2f} GB, launches {ft_a['launches']}; two accumulated "
        f"micro-batches of 1: loss {ft_b['loss']:.6f}; the reorder distance: loss {d_loss:.3e}, "
        f"LoRA gradients max|diff| {d_grad:.3e}   [{card}]")
    out["qlora"] = {"one": {"loss": ft_a["loss"], "launches": ft_a["launches"],
                            "peak_gb": ft_a["peak_gb"], "wall_s": ft_a["wall_s"]},
                    "accum_loss": ft_b["loss"], "d_loss": d_loss, "d_grad": d_grad, "meshes": {}}
    for m in P19_FT_MESHES:
        runs = [r["qlora"][m] for r in ranks]
        lo, gd = abs(runs[0]["loss"] - ft_a["loss"]), gdiff(runs[0], ft_a)
        log(f"  (b) (dp, fsdp, tp) = {m}: loss {runs[0]['loss']:.6f} (|diff| {lo:.3e}, gate "
            f"{2 * d_loss:.3e}), LoRA gradients max|diff| {gd:.3e} (gate {2 * d_grad:.3e}); one "
            f"step in {runs[0]['wall_s']:.2f} s (two ranks on one card over gloo, not a "
            f"multi-GPU figure); peak a rank {[round(r['peak_gb'], 2) for r in runs]} GB; "
            f"launches a rank {[r['launches'] for r in runs]}   [{card}]")
        if not (lo <= 2 * d_loss and gd <= 2 * d_grad):
            raise AssertionError(f"(b) {m}: loss |diff| {lo} (gate {2 * d_loss}), gradients "
                                 f"{gd} (gate {2 * d_grad})")
        for r in runs:
            got = {k: r["launches"].get(k) for k in ft_want}
            if got != ft_want or r["launches"].get("nf4_matmul") != \
                    ft_a["launches"].get("nf4_matmul"):
                raise AssertionError(f"(b) {m} rank launches {r['launches']}: K6/K7 {ft_want}, "
                                     f"K8 as one rank's {ft_a['launches'].get('nf4_matmul')}")
            add_counts(counts, r["launches"])
        out["qlora"]["meshes"][str(m)] = {"loss": runs[0]["loss"], "loss_diff": lo,
                                          "grad_diff": gd, "wall_s": runs[0]["wall_s"],
                                          "peak_gb": [r["peak_gb"] for r in runs],
                                          "launches": [r["launches"] for r in runs]}
    if ranks[1]["backend"] != "pallas":
        raise AssertionError("(b) rank 1 did not take rank 0's 4-bit backend")

    # (c) bench_mfu
    b = r0["bench"]
    log(f"  (c) bench_mfu {P19_MFU_MODEL} ({P19_MFU_LAYERS} of 22 layers) at fsdp 2 (data 1), "
        f"micro-batch "
        f"{P19_MFU['micro_batch']} x {P19_MFU['seq_len']}, remat {P19_MFU['remat']}: step "
        f"{b['step_time_ms']} ms, {b['tokens_per_sec']} tokens/s, MFU {b['mfu']} of two cards' "
        f"bf16 peak, loss {b['loss']}, peak a rank {[r['bench']['peak_hbm_gb'] for r in ranks]} GB"
        f" (two ranks on one card over gloo, not a multi-GPU figure)   [{card}]")
    if not (b["devices"] == 2 and math.isfinite(b["loss"])):
        raise AssertionError(f"(c) {b}")
    out["bench"] = {**b, "peak_hbm_gb_ranks": [r["bench"]["peak_hbm_gb"] for r in ranks]}

    # (d) sequence parallelism
    s = r0["sp"]
    loss_rel = abs(s["sp_loss"] - s["dense_loss"]) / abs(s["dense_loss"])
    three = {k: v for k, v in s.items() if k.startswith("three_way")}
    three_rel = {k: abs(v - s["dense_loss"]) / abs(s["dense_loss"]) for k, v in three.items()}
    log(f"  (d) ring attention, {P19_SP_MODEL} width, {P19_SP_LAYERS} layers, f32, T {P19_SP_T} "
        f"over 2 ranks: sp loss {s['sp_loss']:.7f} vs one rank's dense {s['dense_loss']:.7f} "
        f"(rel {loss_rel:.2e}, gate {P19_SP_LOSS_REL}); gradients max|diff|/max {s['grad_rel']:.2e}"
        f" (gate {P19_SP_GRAD_REL}); loss and backward in {s['sp_s']:.2f} s; two sp train steps "
        f"{s['step_losses']}; make_sp_tp_fsdp_loss_fn rel to dense {three_rel}   [{card}]")
    if not (loss_rel <= P19_SP_LOSS_REL and s["grad_rel"] <= P19_SP_GRAD_REL
            and max(three_rel.values()) <= P19_SP_LOSS_REL
            and s["step_losses"][1] < s["step_losses"][0]):
        raise AssertionError(f"(d) {s}")
    out["sp"] = {**s, "loss_rel": loss_rel, "three_way_rel": three_rel}

    # (e) one rank over NCCL
    bit = nccl["losses"] == one["losses"] and nccl["digest"] == one["digest"]
    log(f"  (e) one rank over {nccl['backend']}: (a) on the (1, 1, 1) mesh, losses and final "
        f"parameters equal to the run with no mesh bit for bit: {bit}   [{card}]")
    if nccl["backend"] != "nccl" or not bit:
        raise AssertionError(f"(e) {nccl['losses']} vs {one['losses']}")
    out["nccl"] = {"backend": nccl["backend"], "bit_for_bit": bit}
    add_counts(counts, nccl["launches"])

    out["ranks_s"] = ranks_s
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  phase 19 in {out['phase_s']:.1f} s (the ranks {ranks_s:.1f} s); launches over the "
        f"ranks' and (e)'s runs {counts}")
    results["train_mesh"] = out
    return counts


def train_mesh_alone() -> dict:
    """Phase 19 by itself, outside the script's run: the kernels built, then
    ``train_mesh_path``; the results to ``chiprun_out/train_mesh.json``. Run as ``python3
    -c "import chip_smoke; chip_smoke.train_mesh_alone()"``."""
    import torch

    from fastmax_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build.build_all()
    results = {}
    train_mesh_path(torch, results, card)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "train_mesh.json").write_text(json.dumps(results, indent=1, default=str))
    return results


# ----------------------------------------------------------------- phase 20
# The last modules of the JAX package, on two ranks on the one card over gloo, as in phases
# 18-19 (NCCL takes no two ranks on one GPU): no time or rate here is a multi-GPU figure.
# (a) GPipe: easy-transformer-fastmax at full width and depth (16 layers, f32, K4/K5) as two
# stages of 8 on the (1, 1, 2) mesh, batch 8 x 513, n_micro 2 and 4: the loss and every gradient
# against one rank's dense make_loss_fn on the same parameters and batch (the kernels in both),
# the loss within P20_PP_REL, the gradients within tests/test_pipeline.py's atol and rtol; K4/K5
# exactly (M + P - 1) x 8 x (2, 1) a rank under full remat (every stage runs every tick: the
# bubble's ticks launch too). (b) TinyLlama-1.1B at full width and depth (22 layers, bf16,
# random weights) as two stages of 11, batch 4 x 2049, n_micro 4, make_pp_train_step with AdamW
# for P20_TL_STEPS steps: the loss falls; step ms; a rank's parameter and optimizer bytes against
# one rank's whole tree; peak memory a rank; K6/K7 exactly (M + P - 1) x 11 x (2, 1) a step.
# (c) the eight-mode dry run at 4 ranks (modes 1-4, 7 and 8; 5 and 6 need data >= 2), mode 8
# launching K8. (d) the scaling bench at 1 and 2 ranks. (e) the flagship entry's forward.
P20_PP_MODEL, P20_PP_BATCH, P20_PP_MICRO = "easy-transformer-fastmax", 8, (2, 4)
P20_PP_REL = P19_PT_REL
P20_GRAD_ATOL, P20_GRAD_RTOL = 3e-4, 2e-3
P20_TL_MODEL, P20_TL_BATCH, P20_TL_MICRO, P20_TL_STEPS = "tiny-llama-1.1b", 4, 4, 3
P20_STAGES = 2
P20_SCALING = dict(model_name="pythia-160m", seq_len=256, per_device_batch=4, max_devices=2,
                   backend="gloo", iters=1)


def p20_parity(torch, mesh, conf: dict) -> dict:
    """(a) on a rank: rank 0's dense loss and gradients (kernels on), then the pipeline's at
    each n_micro of P20_PP_MICRO: loss, whole gradients (rank 0 compares them), this rank's
    launches and seconds."""
    import numpy as np

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel import collectives as col
    from fastmax_tpu_torch.parallel import pipeline as pp
    from fastmax_tpu_torch.parallel.sharding import tree_paths
    from fastmax_tpu_torch.training.step import make_loss_fn, tree_leaves

    cfg = Config(**conf)
    whole = gpt.init_params(cfg, 20, torch.float32, "cuda")
    batch = torch.as_tensor(np.random.default_rng(20).integers(
        0, cfg.vocab_size, (P20_PP_BATCH, cfg.block_size + 1)), device="cuda")
    out, dense = {}, {}
    if mesh.leader:
        leaves = tree_leaves(whole)
        for x in leaves:
            x.requires_grad_(True)
        loss = make_loss_fn(cfg, remat=True)(whole, batch)
        loss.backward()
        out["dense_loss"] = float(loss.detach())
        dense = {".".join(p): x.grad for p, x in zip(tree_paths(whole), leaves)}
        for x in leaves:
            x.grad = None
            x.requires_grad_(False)
    specs = pp.pp_param_specs(cfg, whole)
    for m in P20_PP_MICRO:
        local = pp.local_params(whole, mesh, specs)
        leaves = tree_leaves(local)
        for x in leaves:
            x.requires_grad_(True)
        loss_fn = pp.make_pp_loss_fn(cfg, mesh, n_micro=m)
        torch.cuda.synchronize()
        build.reset_launch_counts()
        t0 = time.perf_counter()
        loss = loss_fn(local, batch)
        loss.backward()
        grads = pp.sync_pp_grads(local, [x.grad for x in leaves], mesh)
        torch.cuda.synchronize()
        row = {"loss": float(loss.detach()), "s": time.perf_counter() - t0,
               "launches": {k: v for k, v in build.launch_counts().items() if v}}
        rel, worst, over = 0.0, 0.0, -1.0
        for path, g in zip(tree_paths(local), grads):
            if path[0] == "blocks":
                g = col.all_gather(g, 0, mesh.group("model"))
            if mesh.leader:
                d = dense[".".join(path)]
                err = (g - d).abs()
                worst = max(worst, float(err.max()))
                rel = max(rel, float(err.max() / d.abs().max()))
                over = max(over, float((err - (P20_GRAD_ATOL + P20_GRAD_RTOL * d.abs())).max()))
        if mesh.leader:
            row.update(grad_max_abs=worst, grad_rel=rel, grad_within=over <= 0)
        out[m] = row
        del local, leaves, grads
    return out


def p20_train(torch, mesh, conf: dict) -> dict:
    """(b) on a rank: P20_TL_STEPS pipeline AdamW steps of the model; losses, step seconds,
    this rank's parameter and optimizer bytes beside the whole tree's, peak, launches."""
    import numpy as np

    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models import gpt
    from fastmax_tpu_torch.models.config import Config
    from fastmax_tpu_torch.parallel import pipeline as pp
    from fastmax_tpu_torch.parallel.sharding import tree_bytes
    from fastmax_tpu_torch.training.quant_optim import state_nbytes
    from fastmax_tpu_torch.training.step import AdamW

    cfg = Config(**conf)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    whole = gpt.init_params(cfg, 21, torch.bfloat16, "cuda")
    whole_bytes = tree_bytes(whole)
    local = pp.local_params(whole, mesh, pp.pp_param_specs(cfg, whole))
    del whole
    optimizer = AdamW(lambda count: 1e-3)
    state = optimizer.init(local)
    step = pp.make_pp_train_step(cfg, mesh, optimizer, n_micro=P20_TL_MICRO)
    batch = torch.as_tensor(np.random.default_rng(21).integers(
        0, cfg.vocab_size, (P20_TL_BATCH, cfg.block_size + 1)), device="cuda")
    losses, times = [], []
    build.reset_launch_counts()
    for _ in range(P20_TL_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(float(step(local, state, batch)[2]))
        times.append(time.perf_counter() - t0)
    return {"losses": losses, "step_s": times, "param_bytes": tree_bytes(local),
            "opt_bytes": state_nbytes(state), "whole_bytes": whole_bytes,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "launches": {k: v for k, v in build.launch_counts().items() if v}}


def p20_rank(pp_conf: dict, tl_conf: dict) -> dict:
    """One of the two ranks: (a) and (b) on the (1, 1, P20_STAGES) mesh."""
    import torch
    import torch.distributed as dist

    from fastmax_tpu_torch.parallel.sharding import make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    mesh = make_mesh(1, 1, P20_STAGES)
    return {"rank": dist.get_rank(), "parity": p20_parity(torch, mesh, pp_conf),
            "train": p20_train(torch, mesh, tl_conf)}


def pipeline_path(torch, results, card) -> dict:
    """Phase 20 (see the constants above)."""
    import numpy as np

    from fastmax_tpu_torch import graft_entry
    from fastmax_tpu_torch.kernels import build
    from fastmax_tpu_torch.models.config import registry
    from fastmax_tpu_torch.parallel import collectives as col
    from fastmax_tpu_torch.parallel import scaling_bench

    log("[20] the last of the JAX package: GPipe pipeline parallelism, the eight-mode dry run, "
        "the scaling bench and the flagship entry; two ranks (four in the dry run) on the one "
        "card over gloo (no figure here is a multi-GPU one)")
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out, counts = {"card": card}, {}
    pp_conf, tl_conf = dict(registry()[P20_PP_MODEL]), dict(registry()[P20_TL_MODEL])
    t0 = time.perf_counter()
    ranks = col.spawn_local(p20_rank, P20_STAGES, backend="gloo", args=(pp_conf, tl_conf),
                            timeout=600)
    ranks_s = time.perf_counter() - t0
    per = pp_conf["n_layer"] // P20_STAGES

    # (a) pipeline parity
    dense = ranks[0]["parity"]["dense_loss"]
    out["parity"] = {"dense_loss": dense}
    for m in P20_PP_MICRO:
        row = ranks[0]["parity"][m]
        ticks = m + P20_STAGES - 1
        want = {"fastmax_fwd": 2 * ticks * per, "fastmax_bwd": ticks * per}
        got = [{k: r["parity"][m]["launches"].get(k) for k in want} for r in ranks]
        rel = abs(row["loss"] - dense) / abs(dense)
        secs = [round(r["parity"][m]["s"], 3) for r in ranks]
        log(f"  (a) {P20_PP_MODEL} f32 as {P20_STAGES} stages of {per} layers, batch "
            f"{P20_PP_BATCH} x {pp_conf['block_size'] + 1}, n_micro {m} ({ticks} ticks): loss "
            f"{row['loss']:.7f} vs one rank's dense {dense:.7f} (rel {rel:.2e}, gate "
            f"{P20_PP_REL}); gradients max|diff| {row['grad_max_abs']:.3e}, max|diff|/max|g| "
            f"{row['grad_rel']:.3e}, within atol {P20_GRAD_ATOL} rtol {P20_GRAD_RTOL}: "
            f"{row['grad_within']}; loss and backward {secs} s a rank; K4/K5 a rank {got} "
            f"(want {want})   [{card}]")
        if not (rel <= P20_PP_REL and row["grad_within"] and all(g == want for g in got)):
            raise AssertionError(f"(a) n_micro {m}: {row}, launches {got} vs {want}")
        out["parity"][m] = {**row, "loss_rel": rel, "launches": got}
        for r in ranks:
            add_counts(counts, r["parity"][m]["launches"])

    # (b) pipeline training
    tl = [r["train"] for r in ranks]
    per_tl = tl_conf["n_layer"] // P20_STAGES
    ticks = P20_TL_MICRO + P20_STAGES - 1
    want = {"flash_train_fwd": 2 * ticks * per_tl * P20_TL_STEPS,
            "flash_train_bwd": ticks * per_tl * P20_TL_STEPS}
    got = [{k: t["launches"].get(k) for k in want} for t in tl]
    step_ms = [1e3 * float(np.mean(t["step_s"][1:])) for t in tl]
    whole = tl[0]["whole_bytes"]
    log(f"  (b) {P20_TL_MODEL} bf16 (random weights) as {P20_STAGES} stages of {per_tl}, batch "
        f"{P20_TL_BATCH} x {tl_conf['block_size'] + 1}, n_micro {P20_TL_MICRO}, AdamW 1e-3: "
        f"losses {[round(x, 4) for x in tl[0]['losses']]}; steps 2-{P20_TL_STEPS} "
        f"{[round(x, 1) for x in step_ms]} ms a rank (two ranks on one card over gloo, not a "
        f"multi-GPU figure); parameters {[t['param_bytes'] / 1e9 for t in tl]} GB and AdamW "
        f"state {[t['opt_bytes'] / 1e9 for t in tl]} GB a rank against one rank's whole tree "
        f"{whole / 1e9:.3f} GB and {2 * whole / 1e9:.3f} GB; peak a rank "
        f"{[round(t['peak_gb'], 2) for t in tl]} GB; K6/K7 a rank {got} (want {want})   [{card}]")
    if not (tl[0]["losses"][-1] < tl[0]["losses"][0] and all(g == want for g in got)
            and all(t["param_bytes"] < 0.6 * whole for t in tl)):
        raise AssertionError(f"(b) {tl[0]['losses']}, launches {got} vs {want}, parameter bytes "
                             f"{[t['param_bytes'] for t in tl]} of {whole}")
    out["train"] = {"losses": tl[0]["losses"], "step_ms": step_ms, "whole_bytes": whole,
                    "param_bytes": [t["param_bytes"] for t in tl],
                    "opt_bytes": [t["opt_bytes"] for t in tl],
                    "peak_gb": [t["peak_gb"] for t in tl], "launches": got}
    for t in tl:
        add_counts(counts, t["launches"])

    # (c) the eight-mode dry run on four ranks
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        dry = graft_entry.dryrun_multichip(4, backend="gloo")
    dry_s = time.perf_counter() - t0
    for line in printed.getvalue().splitlines():
        log(f"  (c) {line.strip()}")
    k8 = [r.get("nf4_matmul", 0) for r in dry["launches"]]
    log(f"  (c) dryrun_multichip(4) over gloo in {dry_s:.1f} s: mesh {dry['mesh']}, modes "
        f"{sorted(dry['modes'])}; K8 launches a rank {k8} (mode 8's decode on rank 0: "
        f"{dry['modes']['tp int4 decode']['launches']})   [{card}]")
    if not (len(dry["modes"]) == 6 and min(k8) > 0):
        raise AssertionError(f"(c) modes {sorted(dry['modes'])}, K8 launches {k8}")
    out["dryrun"] = {"mesh": dry["mesh"], "modes": dry["modes"], "launches": dry["launches"],
                     "s": dry_s}
    for r in dry["launches"]:
        add_counts(counts, r)

    # (d) the scaling bench at 1 and 2 ranks
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        sb = scaling_bench.run(**P20_SCALING)
    sb_s = time.perf_counter() - t0
    log(f"  (d) scaling_bench.run({P20_SCALING}) in {sb_s:.1f} s: "
        f"{json.dumps({str(k): v for k, v in sb.items()})} -- the two ranks share one card over "
        f"gloo, so the efficiency is no scaling figure   [{card}]")
    if not (sorted(sb) == [1, 2] and sb[1]["efficiency"] == 1.0
            and all(r["tokens_per_sec"] > 0 for r in sb.values())):
        raise AssertionError(f"(d) {sb}")
    out["scaling"] = {**{str(k): v for k, v in sb.items()}, "s": sb_s}

    # (e) the flagship entry's forward
    fn, (params, idx) = graft_entry.entry()
    build.reset_launch_counts()
    with torch.no_grad():
        logits = fn(params, idx)
    torch.cuda.synchronize()
    e_counts = {k: v for k, v in build.launch_counts().items() if v}
    ok = tuple(logits.shape) == (1, 32, 32000) and bool(torch.isfinite(logits.float()).all())
    log(f"  (e) graft_entry.entry() on the card: logits {tuple(logits.shape)} "
        f"{str(logits.dtype)[6:]}, finite {ok}; launches {e_counts}   [{card}]")
    if not ok:
        raise AssertionError(f"(e) logits {tuple(logits.shape)}")
    out["entry"] = {"shape": list(logits.shape), "launches": e_counts}
    add_counts(counts, e_counts)
    del fn, params, idx, logits

    out["ranks_s"] = ranks_s
    out["phase_s"] = time.perf_counter() - t_phase
    out["launches"] = counts
    log(f"  phase 20 in {out['phase_s']:.1f} s (the pipeline ranks {ranks_s:.1f} s, the dry run "
        f"{dry_s:.1f} s, the scaling bench {sb_s:.1f} s); launches {counts}")
    results["pipeline"] = out
    return counts


def pipeline_alone() -> dict:
    """Phase 20 by itself, outside the script's run: the kernels built, then
    ``pipeline_path``; the results to ``chiprun_out/pipeline.json``. Run as ``python3 -c
    "import chip_smoke; chip_smoke.pipeline_alone()"``."""
    import torch

    from fastmax_tpu_torch.kernels import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    build.build_all()
    results = {}
    pipeline_path(torch, results, card)
    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "pipeline.json").write_text(json.dumps(results, indent=1, default=str))
    return results


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not (REPO / "fastmax_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no fastmax_tpu_torch package beside {Path(__file__).name}; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from fastmax_tpu_torch.kernels import build

    t_start = time.perf_counter()
    results = {}
    card = card_line()
    marks = []  # (phase, start): the top-level phases' seconds, logged at the end
    marks.append(("1", time.perf_counter()))
    log(f"[1] card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    t0 = time.perf_counter()
    logs = build.build_all()
    build_s = time.perf_counter() - t0
    marks.append(("2", time.perf_counter()))
    log(f"[2] built {sorted(logs)} in {build_s:.1f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {name}: {line.strip()}")
    results["build_s"] = build_s

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    marks.append(("3", time.perf_counter()))
    log("[3] int4 rank-1 matmul kernel vs plain")
    int4_err, int4_rows = check_int4(torch, gen, results)
    marks.append(("4", time.perf_counter()))
    log("[4] int8 decode attention kernel vs plain")
    attn_err, attn_mean, attn_rows = check_attention(torch, gen, results)
    marks.append(("5", time.perf_counter()))
    log("[5] batch-1 path: Llama-2-7B int4, int8 KV cache, block_size 1024, generate")
    counts_b1 = main_path(torch, results, card)
    marks.append(("6", time.perf_counter()))
    log("[6] flash prefill attention kernel vs plain")
    flash_err, flash_mean, flash_rows = check_flash(torch, gen, results)
    marks.append(("7", time.perf_counter()))
    log(f"[7] serving path: Llama-2-7B int4 at 4096 context, {N_SLOTS}-slot batcher, HTTP")
    counts = serving_path(torch, results, card)
    marks.append(("8", time.perf_counter()))
    log("[8] training: fastmax kernels vs plain, then pretrain.setup on easy-transformer-fastmax")
    fm_err, fm_rows = check_fastmax(torch, gen, results)
    counts_train = training_path(torch, results, card)
    marks.append(("9", time.perf_counter()))
    log("[9] finetuning: trainable flash kernels K6/K7 vs plain, then finetune.setup on a QLoRA "
        "Llama-2-7B")
    ft_err, ft_rows = check_flash_train(torch, gen, results)
    counts_ft = finetune_path(torch, results, card)
    log("  the linear arms at D = 128: (a) masked fastmax's reversible scan at the finetune "
        "shape vs float64, (b) QLoRA Llama-2-7B with fastmax, linearmax and performer")
    linear_finetune_path(torch, results, card, linear_op_check(torch, gen, results, card))
    marks.append(("10", time.perf_counter()))
    log("[10] quantized serving: K8/K9 kernels vs plain, then an NF4 Llama-2-7B in every "
        "weights mode (engine and batcher)")
    q_err, q_rows = check_quant_kernels(torch, gen, results)
    counts_q = quant_serving_path(torch, results, card)
    marks.append(("11", time.perf_counter()))
    log("[11] int4/NF4 kernel labs: K10-K13 vs plain at the 7B shapes, the probes' read rates, "
        "the routes onto K1/K8/K9, then the three lab mains")
    lab_err, lab_rows, counts_lab = lab_path(torch, results, card)
    marks.append(("12", time.perf_counter()))
    log("[12] the training command lines of launch_scripts/ through the port's main(): "
        "pretraining, an HF checkpoint at Llama-2-7B's width converted, QLoRA and full "
        "finetuning from it")
    counts_cmd, (counts_inf, counts_lin, _, counts_gptq, counts_spec_cmd,
                 counts_p18) = command_path(
        torch, results, card, lambda tmp, ckpt, *a: (
            inference_path(torch, results, card, tmp, ckpt, *a),
            linear_serving_path(torch, results, card, tmp, ckpt),
            adapter_commands(torch, results, card, tmp, ckpt),
            gptq_commands(torch, results, card, tmp, ckpt),
            speculative_commands(torch, results, card, tmp, ckpt),
            tp_serving_path(torch, results, card, tmp, ckpt)))
    marks.append(("15", time.perf_counter()))
    counts_fam = families_path(torch, results, card)
    marks.append(("16", time.perf_counter()))
    log("[16] the rest of training: bench_mfu on TinyLlama at full width under every remat "
        "policy, the auto probe, packed data with the native reader, the loggers, GPTQ at "
        "Llama-2-7B's width (its QLoRA step and generate ran inside phase 12's directory)")
    counts_p16 = rest_of_training_path(torch, results, card)
    add_counts(counts_p16, counts_gptq)
    marks.append(("17", time.perf_counter()))
    log("[17] speculative decoding: K3 at T = k+1 and K1 at m = k+1 and 8 (k+1) vs plain, the "
        "prompt-lookup and draft-model decoders on the 7B, the batcher's verify at 8 slots "
        "(the command lines ran inside phase 12's directory)")
    counts_p17 = speculative_path(torch, results, card)
    add_counts(counts_p17, counts_spec_cmd)
    marks.append(("19", time.perf_counter()))
    counts_p19 = train_mesh_path(torch, results, card)
    marks.append(("20", time.perf_counter()))
    counts_p20 = pipeline_path(torch, results, card)
    results["launches"] = {"batch1_path": counts_b1, "serving_path": counts,
                           "training_path": counts_train, "finetune_path": counts_ft,
                           "quant_serving_path": counts_q, "lab_path": counts_lab,
                           "command_path": counts_cmd, "inference_path": counts_inf,
                           "linear_serving_path": counts_lin, "families_path": counts_fam,
                           "rest_of_training_path": counts_p16, "speculative_path": counts_p17,
                           "tp_serving_path": counts_p18, "train_mesh_path": counts_p19,
                           "pipeline_path": counts_p20}
    # the main paths of phases 15 to 20, added to the earlier phases' counts below
    counts_later = {}
    add_counts(counts_later, counts_fam)
    add_counts(counts_later, counts_p16)
    add_counts(counts_later, counts_p17)
    add_counts(counts_later, counts_p18)
    add_counts(counts_later, counts_p19)
    add_counts(counts_later, counts_p20)

    # K1: one decode step of one layer at m=1 (the four linears), and by path at
    # each timed m (the serving decode step is m = 8); K2: pos 191 on decode_splits' route,
    # and by route (one-block, split) at pos 191, 1023 and the serving shape;
    # K3: the five timed 7B calls of phase 6; K4, K5: one call at the training
    # shape (p=2, f32), with each one's own max abs error there (K4: o, K5: dq,
    # dk, dv); K6, K7: one call at the finetune shape (bf16, the path's type), with their
    # own max abs errors there (K6: out, lse; K7: dq, dk, dv); their library time is SDPA's
    # causal forward, and for K7 its forward + backward less that forward. Launches: the
    # serving path (K1-K3), the training path (K4, K5), the finetune path (K6, K7), with the
    # linear arms' serving path (phase 14, K1 alone) added to K1, phase 15's main paths
    # (Gemma-7B and Mixtral serving and finetuning, the adapters, the optimizers) added to
    # K1, K3, K4, K5, K6, K7 and K8, phase 16's (bench_mfu under every remat policy,
    # packed pretraining, the GPTQ QLoRA step and generate) to K4, K5, K6, K7 and K8, and
    # phase 17's (the speculative decoders, the speculative batcher and command lines) to
    # K1 and K3, and phase 18's (both ranks of the tp 2 engine, batcher and NF4 modes on the
    # card) to K1, K2, K3, K8 and K9, phase 19's (both ranks of the sharded pretraining
    # and QLoRA runs, and the NCCL rank's pretraining) to K4, K5, K6, K7 and K8, and phase
    # 20's (both pipeline ranks' parity runs and training steps, the dry run's four ranks) to
    # K4, K5, K6, K7 and K8.
    # The bound of several calls is the sum of theirs, bound by the term that
    # bounds most of it.
    dec = [r for r in int4_rows if r["m"] == 1]
    att = next(r for r in attn_rows if r["pos"] == 191 and r["call_ms"] is not None)
    k1, k2 = build.KERNELS["int4_rank1_matmul"], build.KERNELS["int8_decode_attention"]
    k3 = build.KERNELS["flash_attention"]

    def bound_by(rows):
        by = {"bytes": 0.0, "operations": 0.0}
        for r in rows:
            by[r["bound_by"]] += r["bound_ms"]
        return max(by, key=by.get)
    k1_paths = []
    for m in INT4_TIMED_M:
        layer = [r for r in int4_rows if r["m"] == m]
        k1_paths.append({"path": layer[0]["path"], "m": m, "ms": sum(r["ms"] for r in layer),
                         "bound_ms": sum(r["bound_ms"] for r in layer),
                         "plain_ms": sum(r["plain_ms"] for r in layer)})
        if layer[0]["fma_ms"] is not None:
            k1_paths.append({**k1_paths[-1], "path": "fma",
                             "ms": sum(r["fma_ms"] for r in layer)})
    kernels = [
        {"name": k1.name, "route": "cuda", "source": str(k1.source.relative_to(REPO)),
         "replaces": k1.replaces,
         "launches": counts[k1.name] + counts_lin.get(k1.name, 0) + counts_later.get(k1.name, 0),
         "max_abs_err": int4_err,
         "ms": sum(r["ms"] for r in dec), "plain_ms": sum(r["plain_ms"] for r in dec),
         "bound_ms": sum(r["bound_ms"] for r in dec), "bound_by": bound_by(dec),
         "library_ms": None, "by_path": k1_paths},
        {"name": k2.name, "route": "cuda", "source": str(k2.source.relative_to(REPO)),
         "replaces": k2.replaces, "launches": counts[k2.name] + counts_later.get(k2.name, 0),
         "max_abs_err": attn_err,
         "mean_err": attn_mean, "ms": att["ms"], "plain_ms": att["plain_ms"],
         "bound_ms": att["bound_ms"], "bound_by": att["bound_by"], "library_ms": None,
         "by_path": [{"path": r["route"], "shape": r["shape"], "pos": r["pos"],
                      "nsplit": r["nsplit"], "ms": r["ms"], "bound_ms": r["bound_ms"],
                      "plain_ms": r["plain_ms"]} for r in attn_rows]},
        {"name": k3.name, "route": "cuda", "source": str(k3.source.relative_to(REPO)),
         "replaces": k3.replaces, "launches": counts[k3.name] + counts_later.get(k3.name, 0),
         "max_abs_err": flash_err,
         "mean_err": flash_mean,
         "ms": sum(r["ms"] for r in flash_rows), "plain_ms": sum(r["plain_ms"] for r in flash_rows),
         "bound_ms": sum(r["bound_ms"] for r in flash_rows),
         "bound_by": bound_by(flash_rows),
         "library_ms": sum(r["library_ms"] for r in flash_rows)},
    ]
    train_row = next(r for r in fm_rows if r["p"] == 2 and r["dtype"] == "float32")
    for kern, ms, plain_ms, (bound_ms, by) in (
            (build.KERNELS["fastmax_fwd"], train_row["k4_ms"], train_row["plain_fwd_ms"],
             k4_bound(train_row, train_row["k4_path"])),
            (build.KERNELS["fastmax_bwd"], train_row["k5_ms"], train_row["plain_bwd_ms"],
             k5_bound(train_row, train_row["k5_path"]))):
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_train[kern.name] + counts_later.get(kern.name, 0),
                        "max_abs_err": fm_err[kern.name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
                        "library_ms": None})
    # K4 and K5 at p = 2 by kernel, type and chunk, each with its kernel's bound and both
    # f32 ones
    kernels[-2]["bound_f32_ms"] = train_row["fwd_bound"]["bound_f32_ms"]
    kernels[-2]["by_path"] = [
        {"path": path, "dtype": r["dtype"], "n": r["n"], "chunk": r["chunk"], "ms": r[key],
         "bound_ms": k4_bound(r, path)[0], "bound_f32_ms": r["fwd_bound"]["bound_f32_ms"],
         "bound_tc_f32_ms": r["fwd_bound"]["bound_tc_f32_ms"]}
        for r in fm_rows if r["p"] == 2
        for path, key in ((r["k4_path"], "k4_ms"), ("fma", "k4_fma_ms"))]
    kernels[-1]["bound_f32_ms"] = train_row["bwd_bound"]["bound_f32_ms"]
    kernels[-1]["by_path"] = [
        {"path": path, "dtype": r["dtype"], "n": r["n"], "chunk": r["chunk"], "ms": r[key],
         "bound_ms": k5_bound(r, path)[0], "bound_f32_ms": r["bwd_bound"]["bound_f32_ms"],
         "bound_tc_f32_ms": r["bwd_bound"]["bound_tc_f32_ms"]}
        for r in fm_rows if r["p"] == 2
        for path, key in ((r["k5_path"], "k5_ms"), ("fma", "k5_fma_ms"))]
    ft = next(r for r in ft_rows if r["dtype"] == "bfloat16")
    for kern, ms, plain_ms, bnd, lib in (
            (build.KERNELS["flash_train_fwd"], ft["k6_ms"], ft["plain_fwd_ms"], ft["fwd_bound"],
             ft["sdpa_fwd_ms"]),
            (build.KERNELS["flash_train_bwd"], ft["k7_ms"], ft["plain_bwd_ms"], ft["bwd_bound"],
             ft["sdpa_fwd_bwd_ms"] - ft["sdpa_fwd_ms"])):
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_ft[kern.name] + counts_later.get(kern.name, 0),
                        "max_abs_err": ft_err[kern.name],
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": bnd["bound_ms"],
                        "bound_by": bnd["bound_by"], "library_ms": lib})
    # K8, K9: one decode step of one layer at m=1, bf16 x (K8: qkv, attn.proj and fc_12,
    # since mlp.proj dequantizes; K9: the four linears); launches over phase 10's paths
    for kern in (build.KERNELS["nf4_matmul"], build.KERNELS["int4_block_matmul"]):
        dec = [r for r in q_rows if r["m"] == 1 and r["kernel"] == (
            "K8" if kern.name == "nf4_matmul" else "K9")]
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_q[kern.name] + counts_later.get(kern.name, 0),
                        "max_abs_err": q_err[kern.name],
                        "ms": sum(r["ms"] for r in dec), "plain_ms": sum(r["plain_ms"] for r in dec),
                        "bound_ms": sum(r["bound_ms"] for r in dec), "bound_by": bound_by(dec),
                        "library_ms": None})
    # K8 and K9 by path: their linears (K8: qkv, attn.proj and fc_12; K9: all four) at each
    # timed m and x type; the tensor-core path also on the earlier route (K9: the FMA tile;
    # K8: the gemv at m = 8, the FMA tile above), read at the f32 units' rate it computes at
    for kern, kind, times in ((kernels[-2], "K8", K8_LAYER_TIMES),
                              (kernels[-1], "K9", K9_LAYER_TIMES)):
        paths = []
        for m, xdt in times:
            layer = [r for r in q_rows
                     if r["kernel"] == kind and r["m"] == m and r["x_dtype"] == xdt]
            paths.append({"path": layer[0]["path"], "m": m, "x_dtype": xdt,
                          "ms": sum(r["ms"] for r in layer),
                          "bound_ms": sum(r["bound_ms"] for r in layer),
                          "bound_f32_ms": sum(r["bound_f32_ms"] for r in layer),
                          "plain_ms": sum(r["plain_ms"] for r in layer)})
            if layer[0]["earlier_ms"] is not None:
                paths.append({**paths[-1], "path": layer[0]["earlier_path"],
                              "ms": sum(r["earlier_ms"] for r in layer),
                              "bound_ms": paths[-1]["bound_f32_ms"]})
        kern["by_path"] = paths
    # K10-K13: one call at each of the four 7B linears at m = 1 (K12 the three whose n is whole
    # 1024-column tiles) in their first mode (K10 raw bf16, K11 v1, K12 v8, K13 stream_ref);
    # launches over the three lab mains; no single PyTorch call computes a packed-format product
    for short, modes in LAB_MODES.items():
        kern = build.TOOL_KERNELS[LAB_KERNEL[short]]
        dec = [r for r in lab_rows if r["kernel"] == short and r["variant"] == modes[0]
               and r["m"] == 1]
        kernels.append({"name": kern.name, "route": "cuda",
                        "source": str(kern.source.relative_to(REPO)), "replaces": kern.replaces,
                        "launches": counts_lab[kern.name], "max_abs_err": lab_err[kern.name],
                        "ms": sum(r["ms"] for r in dec),
                        "plain_ms": sum(r["plain_ms"] for r in dec),
                        "bound_ms": sum(r["bound_ms"] for r in dec), "bound_by": bound_by(dec),
                        "library_ms": None})
        if short == "K13":  # torch.sum over the same bytes: reads them, computes another function
            kernels[-1]["read_yardstick_ms"] = sum(r["yardstick_ms"] for r in dec)
    # K11 and K12 by path: each mode's linears at m = 1 (gemv) and m = 8 (tensor cores; f32
    # operands read at three TF32 products a multiply), with the gemv timed at m = 8 in turns
    # with them (the earlier route), read at the f32 units' rate it computes at
    for short in ("K11", "K12"):
        kern = next(e for e in kernels if e["name"] == LAB_KERNEL[short])
        paths = []
        for v in LAB_MODES[short]:
            for m in (1, N_SLOTS):
                layer = [r for r in lab_rows
                         if r["kernel"] == short and r["variant"] == v and r["m"] == m]
                paths.append({"path": layer[0]["path"], "variant": v, "m": m,
                              "ms": sum(r["ms"] for r in layer),
                              "bound_ms": sum(r["bound_ms"] for r in layer),
                              "bound_f32_ms": sum(r["bound_f32_ms"] for r in layer),
                              "plain_ms": sum(r["plain_ms"] for r in layer)
                              if "plain_ms" in layer[0] else None})
                if layer[0]["earlier_ms"] is not None:
                    paths.append({**paths[-1], "path": layer[0]["earlier_path"],
                                  "ms": sum(r["earlier_ms"] for r in layer),
                                  "bound_ms": paths[-1]["bound_f32_ms"]})
        kern["by_path"] = paths
    results["kernels"] = kernels
    results["total_s"] = time.perf_counter() - t_start
    ends = [t for _, t in marks[1:]] + [time.perf_counter()]
    results["phase_s"] = {name: round(end - t, 1) for (name, t), end in zip(marks, ends)}
    log(f"seconds by top-level phase (12 holds 13, 14, 15 (f), 16 (d), 17 (e) and 18; 9 the "
        f"linear arms; 2 the build): "
        f"{results['phase_s']}")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    log(f"total {results['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                              "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
