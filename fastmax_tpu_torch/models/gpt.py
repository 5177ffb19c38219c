"""Cached decoder forward for the LLaMA family (counterpart of the KV-cache
path of ``fastmax_tpu/models/gpt.py``).

Parameters are a dict tree with the JAX package's keys and layouts: dense
kernels are (in, out), every block leaf carries a leading (n_layer,) axis,
and the layer loop is a Python loop that indexes layer ``l`` (a view, or a
pointer into the stack for the int4 kernel). The KV cache is one
(L, B, G, S, D) tensor per leaf, written in place, layer by layer.

Ported here: a scalar ``input_pos`` (a Python int) or per-slot positions
(a (B,) device tensor, continuous batching) with a dense or int8 cache,
fused-QKV grouped attention with (partial) RoPE, the flash prefill route
over the cache (``ops/flash_attention.py``), ``logits_at``, the LLaMA
SwiGLU and Gemma GeGLU MLPs (split or fused ``fc_12``), Mixtral's top-k MoE
(``apply_moe``), sequential and parallel residual, and the LLaMA-Adapter
prefix attention (``models/adapter.py``) on the quadratic arm.

The no-cache forward (``kv_cache=None``: training and evaluation; and
``forward_hidden``, the same without the lm_head) runs every block over the
whole sequence with ``ops/attention.attention``, so
``attn_alg="fastmax"``/``"fastmax_cuda"`` goes through the fastmax kernels K4
(forward) and K5 (backward) at head sizes up to 64 and through the
reversible float32 scan above, ``linearmax`` and ``performer`` through
their chunked scans (ops/fastmax.py), and ``quadratic`` at T >= 1024 through
the trainable flash kernels K6 (forward) and K7 (backward). ``remat`` takes
the reference's policies: True/"full" recomputes each block in the backward
(``torch.utils.checkpoint``); "attn", "dots" and "dots_attn" recompute it
except what a selective-checkpoint policy keeps (``_remat_wrap``); the mixed
form "<light>@<N>:<heavy>" gives the first N layers the light policy.
``init_params`` gives the GPT-NeoX initialisation from a seed; the GPT-NeoX
MLP (exact or tanh GELU) and bias leaves are ported.

The cached forward with a linear arm reads the dense cache as the reference
does (``ops/attention.attention(..., is_decode=True)``: unmasked over the
padded cache). The serving path of the linear arms is the running state
instead: ``init_linear_cache`` gives one stacked (L, B, H, ...) float32 state
(``ops/fastmax.STATE_NAMES``, and linearmax's frozen ``q_div``/``k_div``)
whose size does not grow with the sequence, and ``forward_linear_cache``
prefills a prompt into it or advances it by one token, updating it in place.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..ops import fastmax as fm
from ..ops.attention import (attention, int8_cache_attention, repeat_kv_heads,
                             scaled_dot_product_attention)
from ..ops.decode_attention import int8_decode_attention_stacked, int8_decode_eligible
from ..ops.flash_attention import BLOCK_Q as FLASH_BLOCK_Q
from ..ops.flash_attention import flash_attention, flash_eligible
from ..ops.linear import embedding, linear
from ..ops.norms import apply_norm
from ..ops.rope import apply_rope, build_rope_cache
from .adapter import apply_adapter_attention
from .config import Config


def _init_linear(gen, n_in, n_out, bias, dtype, std=0.02):
    dev = gen.device
    p = {"kernel": (torch.randn((n_in, n_out), generator=gen, device=dev) * std).to(dtype)}
    if bias:
        p["bias"] = torch.zeros((n_out,), dtype=dtype, device=dev)
    return p


def _init_norm(cfg: Config, dtype, dev):
    p = {"weight": torch.ones((cfg.n_embd,), dtype=dtype, device=dev)}
    if cfg.norm_class_name == "LayerNorm":
        p["bias"] = torch.zeros((cfg.n_embd,), dtype=dtype, device=dev)
    return p


def _init_glu(gen, e, i, bias, dtype) -> dict:
    return {"fc_1": _init_linear(gen, e, i, bias, dtype),
            "fc_2": _init_linear(gen, e, i, bias, dtype),
            "proj": _init_linear(gen, i, e, bias, dtype)}


def _init_block(gen, cfg: Config, dtype) -> dict:
    e, i = cfg.n_embd, cfg.intermediate_size
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": _init_linear(gen, e, i, cfg.bias, dtype),
               "proj": _init_linear(gen, i, e, cfg.bias, dtype)}
    elif cfg.mlp_class_name in ("LLaMAMLP", "GemmaMLP"):
        mlp = _init_glu(gen, e, i, cfg.bias, dtype)
    elif cfg.mlp_class_name == "LLaMAMoE":
        # a bias-free router (E outputs) and the experts stacked on (E, ...)
        mlp = {"gate": _init_linear(gen, e, cfg.n_expert, False, dtype),
               "experts": _stack([_init_glu(gen, e, i, cfg.bias, dtype)
                                  for _ in range(cfg.n_expert)])}
    else:
        raise ValueError(cfg.mlp_class_name)
    block = {
        "norm_1": _init_norm(cfg, dtype, gen.device),
        "attn": {"attn": _init_linear(gen, e, cfg.qkv_shape, cfg.bias, dtype),
                 "proj": _init_linear(gen, cfg.head_size * cfg.n_head, e, cfg.bias, dtype)},
        "mlp": mlp,
    }
    if not cfg.shared_attention_norm:
        block["norm_2"] = _init_norm(cfg, dtype, gen.device)
    return block


def _stack(trees: list) -> dict:
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def init_params(cfg: Config, seed: int = 0, dtype=torch.float32, device=None) -> dict:
    """GPT-NeoX initialisation (normal, std 0.02; zero biases, unit norms) from
    a ``torch.Generator`` seeded with ``seed`` on ``device`` (default: the
    card), drawn there (a 7B model is drawn in seconds on the card, minutes on
    the host), with the block leaves stacked on a leading (n_layer,) axis. The
    numbers differ from the JAX package's (another generator), and between
    devices; the layout is the same."""
    from ..inference.engine import default_device

    device = default_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    wte = (torch.randn((cfg.padded_vocab_size, cfg.n_embd), generator=gen, device=device)
           * 0.02).to(dtype)
    return {
        "wte": wte,
        "lm_head": _init_linear(gen, cfg.n_embd, cfg.padded_vocab_size, cfg.lm_head_bias, dtype),
        "ln_f": _init_norm(cfg, dtype, device),
        "blocks": _stack([_init_block(gen, cfg, dtype) for _ in range(cfg.n_layer)]),
    }


def init_kv_cache(cfg: Config, batch_size: int, max_seq_length: int,
                  dtype=torch.float32, device=None, n_groups: Optional[int] = None) -> dict:
    """Grouped KV cache (L, B, n_query_groups, S, head_size). dtype int8
    selects the quantized cache: int8 codes with a per-token-per-group f32
    absmax scale. ``n_groups``: a rank's share of the query groups when the
    attention is split over the mesh's ``model`` axis."""
    shape = (cfg.n_layer, batch_size, n_groups or cfg.n_query_groups, max_seq_length,
             cfg.head_size)
    if dtype == torch.int8:
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            "v_scale": torch.zeros(shape[:-1], dtype=torch.float32, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor):
    """Per-token-per-group symmetric int8: x (B, G, T, hs) -> (codes, scale).
    As in the reference, the scale is computed and applied in x's dtype and
    only stored as f32."""
    absmax = torch.amax(torch.abs(x), dim=-1)
    scale = (absmax / 127.0).float()
    safe = torch.where(scale == 0, torch.ones_like(absmax), scale.to(x.dtype))
    codes = torch.clamp(torch.round(x / safe[..., None]), -127, 127).to(torch.int8)
    return codes, scale


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return codes.to(dtype) * scale.to(dtype)[..., None]


def _rope(x, cos, sin, nre):
    if nre < x.shape[-1]:
        return torch.cat([apply_rope(x[..., :nre], cos, sin), x[..., nre:]], dim=-1)
    return apply_rope(x, cos, sin)


def apply_mlp(p: dict, x: torch.Tensor, cfg: Config, layer=None, *, plain: bool = False,
              shard=None):
    """``layer`` selects the stacked-weights mode (see ops/linear.linear);
    ``shard`` (a ``parallel.sharding.ShardPlan``): the MLP holds this rank's
    share of a split over the mesh's ``model`` axis, summed here."""
    if shard is not None:
        part = "experts" if cfg.mlp_class_name == "LLaMAMoE" else "mlp"
        experts = shard.experts if part == "experts" else None
        x = shard.enter(x, part)
        bias = None
        if shard.train and shard.splits(part):
            if part == "experts":
                # the router is whole on every rank, but its gradient comes only
                # through the rank's experts: summed over model
                p = {**p, "gate": {k: shard.enter(v, part) for k, v in p["gate"].items()}}
            elif "bias" in p["proj"]:
                bias = p["proj"]["bias"] if layer is None else p["proj"]["bias"][layer]
                p = {**p, "proj": {k: v for k, v in p["proj"].items() if k != "bias"}}
        y = shard.reduce(_apply_mlp(p, x, cfg, layer, plain, experts), part)
        return y if bias is None else y + bias.to(y.dtype)
    return _apply_mlp(p, x, cfg, layer, plain)


def _apply_mlp(p: dict, x: torch.Tensor, cfg: Config, layer, plain: bool, experts=None):
    name = cfg.mlp_class_name
    if name == "GptNeoxMLP":
        h = linear(p["fc"], x, layer, plain=plain)
        h = torch.nn.functional.gelu(h, approximate="tanh" if cfg.gelu_approximate == "tanh"
                                     else "none")
        return linear(p["proj"], h, layer, plain=plain)
    if name == "LLaMAMoE":
        if layer is not None:
            p = _slice_tree(p, layer)
        return apply_moe(p, x, cfg, plain=plain, experts=experts)
    if name == "LLaMAMLP":
        act = torch.nn.functional.silu
    elif name == "GemmaMLP":
        def act(h):  # exact GELU, as the reference's approximate=False
            return torch.nn.functional.gelu(h, approximate="none")
    else:
        raise ValueError(name)
    if "fc_12" in p:
        h = linear(p["fc_12"], x, layer, plain=plain)
        h1, h2 = torch.chunk(h, 2, dim=-1)
        return linear(p["proj"], act(h1) * h2, layer, plain=plain)
    return linear(p["proj"], act(linear(p["fc_1"], x, layer, plain=plain))
                  * linear(p["fc_2"], x, layer, plain=plain), layer, plain=plain)


def _slice_tree(tree: dict, layer: int) -> dict:
    return {k: _slice_tree(v, layer) if isinstance(v, dict) else v[layer]
            for k, v in tree.items()}


# The sorted MoE route reads the per-expert segment sizes back to the host,
# once a layer a forward; this counts those reads (reset it to 0 to count a run).
MOE_HOST_READS = [0]


def apply_moe(p: dict, x: torch.Tensor, cfg: Config, sorted_dispatch: bool = True, *,
              plain: bool = False, experts: Optional[tuple] = None) -> torch.Tensor:
    """Mixtral's top-k MoE, dropless, with the reference's two routes: the
    router's top k, a float32 softmax over those k cast to x's dtype; then

    * sorted (default, bias-free experts): the N*k token-expert rows put in
      order of expert by a stable argsort, one ``torch.matmul`` per expert
      over its contiguous segment (the counterpart of ``lax.ragged_dot``;
      the segment sizes are read to the host, ``MOE_HOST_READS``), SiLU(fc_1)
      * fc_2, then proj, weighted by the router, put back in token order by
      the inverse permutation and summed over k in order (no atomics: the
      card's runs repeat bit for bit);
    * dense (experts with biases, or ``sorted_dispatch=False``): every expert
      over every token, combined by the sparse router weights.

    ``p`` holds one layer: {"gate": linear (C, E), "experts": {fc_1, fc_2,
    proj} stacked on (E, ...)}. ``experts`` = (first, end): ``p`` holds only
    those experts (a rank's share over the mesh's ``model`` axis); the others'
    rows add zeros, and the caller sums the ranks' outputs."""
    b, t, c = x.shape
    xf = x.reshape(-1, c)
    n = xf.shape[0]
    k, e = cfg.n_expert_per_token, cfg.n_expert
    router = linear(p["gate"], xf, plain=plain)  # (N, E)
    probs, indices = torch.topk(router, k, dim=-1)
    probs = torch.softmax(probs.float(), dim=-1).to(x.dtype)
    ex = p["experts"]
    e0, e1 = experts if experts is not None else (0, e)
    silu = torch.nn.functional.silu

    if sorted_dispatch and "bias" not in ex["fc_1"]:
        flat = indices.reshape(-1)  # (N*k,): row i belongs to token i // k
        order = torch.argsort(flat, stable=True)
        # a permutation of the k-fold repeated rows: its backward has no duplicate index
        xs = xf.repeat_interleave(k, dim=0)[order]
        sizes = torch.bincount(flat, minlength=e).tolist()
        MOE_HOST_READS[0] += 1
        segs = []
        for j, seg in enumerate(torch.split(xs, sizes)):
            if not e0 <= j < e1:
                segs.append(torch.zeros_like(seg))
                continue
            h = silu(seg @ ex["fc_1"]["kernel"][j - e0].to(x.dtype)) \
                * (seg @ ex["fc_2"]["kernel"][j - e0].to(x.dtype))
            segs.append(h @ ex["proj"]["kernel"][j - e0].to(x.dtype))
        ys = torch.cat(segs) * probs.reshape(-1)[order][:, None]
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        y = ys[inv].reshape(n, k, c)
        out = y[:, 0]
        for j in range(1, k):
            out = out + y[:, j]
        return out.reshape(b, t, c)

    one_hot = torch.nn.functional.one_hot(indices, e).to(x.dtype)  # (N, k, E)
    combine = torch.einsum("nk,nke->ne", probs, one_hot)[:, e0:e1]
    h1 = torch.einsum("nc,eci->eni", xf, ex["fc_1"]["kernel"].to(x.dtype))
    h2 = torch.einsum("nc,eci->eni", xf, ex["fc_2"]["kernel"].to(x.dtype))
    if "bias" in ex["fc_1"]:
        h1 = h1 + ex["fc_1"]["bias"][:, None, :]
        h2 = h2 + ex["fc_2"]["bias"][:, None, :]
    y = torch.einsum("eni,eic->enc", silu(h1) * h2, ex["proj"]["kernel"].to(x.dtype))
    if "bias" in ex["proj"]:
        y = y + ex["proj"]["bias"][:, None, :]
    return torch.einsum("ne,enc->nc", combine, y).reshape(b, t, c)


def _write(cache: torch.Tensor, new: torch.Tensor, layer: int, input_pos) -> None:
    """Write new (B, G, T[, D]) into layer ``layer`` of cache (L, B, G, S[, D])
    at each row's position. A vector input_pos writes row b at input_pos[b]
    onwards by one indexed store on the device; as the reference's
    dynamic_update_slice does, a start past S - T is clamped to S - T."""
    t = new.shape[2]
    if isinstance(input_pos, int):
        cache[layer, :, :, input_pos:input_pos + t] = new
        return
    b, s = new.shape[0], cache.shape[3]
    start = torch.clamp(input_pos.to(torch.int64), 0, s - t)
    pos = start[:, None] + torch.arange(t, device=new.device)  # (B, T)
    rows = torch.arange(b, device=new.device)[:, None].expand(b, t)
    cache[layer][rows, :, pos] = new.transpose(1, 2).to(cache.dtype)  # values (B, T, G[, D])


def _project_qkv(p: dict, x: torch.Tensor, cfg: Config, cos, sin, layer, plain: bool):
    """The fused QKV projection, split into q (B, n_head, T, hs) and grouped
    k, v (B, G, T, hs), with (partial) RoPE on q and k."""
    b, t, _ = x.shape
    hs, q_per_kv = cfg.head_size, cfg.n_head // cfg.n_query_groups
    # the local groups: all of them, or a rank's share under a split over ``model``
    qkv = linear(p["attn"], x, layer, plain=plain).reshape(b, t, -1, q_per_kv + 2, hs)
    q = qkv[..., :q_per_kv, :].reshape(b, t, -1, hs).permute(0, 2, 1, 3)
    k = qkv[..., q_per_kv, :].permute(0, 2, 1, 3)
    v = qkv[..., q_per_kv + 1, :].permute(0, 2, 1, 3)
    return _rope(q, cos, sin, cfg.rope_n_elem), _rope(k, cos, sin, cfg.rope_n_elem), v


def apply_attn(p: dict, x: torch.Tensor, cfg: Config, cos, sin, mask, kv_cache: dict,
               input_pos, layer: int, posv: torch.Tensor, *, plain: bool = False,
               shard=None, wlayer: Optional[int] = None):
    """Fused-QKV grouped attention over layer ``layer`` of the stacked cache,
    which is updated in place. ``input_pos`` is a Python int or a (B,)
    tensor of per-row positions; ``posv`` (B,) int32 holds the position of
    the last token (the decode kernel's mask frontier). ``wlayer``: the
    index of this layer in ``p``'s stack when it differs from ``layer`` (one
    layer gathered over fsdp); ``shard``: see ``apply_mlp``."""
    b, t, _ = x.shape
    hs, q_per_kv = cfg.head_size, cfg.n_head // cfg.n_query_groups
    wl = layer if wlayer is None else wlayer
    q, k, v = _project_qkv(p, x, cfg, cos, sin, wl, plain)

    act_dtype = k.dtype
    if "k_scale" in kv_cache:
        k_new, k_new_scale = _quantize_kv(k)
        v_new, v_new_scale = _quantize_kv(v)
        for name, new in (("k", k_new), ("v", v_new), ("k_scale", k_new_scale),
                          ("v_scale", v_new_scale)):
            _write(kv_cache[name], new, layer, input_pos)
        kc, vc = kv_cache["k"], kv_cache["v"]
        ks, vs = kv_cache["k_scale"], kv_cache["v_scale"]
        if cfg.attn_alg == "quadratic" and t == 1:
            # decode: attend over the int8 codes directly
            if int8_decode_eligible(t, hs, kc.shape[3], q_per_kv):
                y = int8_decode_attention_stacked(q, kc, vc, ks, vs, layer, posv,
                                                  scale=hs ** -0.5, plain=plain)
            else:
                y = int8_cache_attention(q, kc[layer], vc[layer], ks[layer], vs[layer],
                                         mask=mask, scale=hs ** -0.5)
            return _finish_attn(p, y, x, q, cfg, b, t, hs, wl, plain, shard)
        # prefill reads a dense cache: dequantize once
        k = _dequantize_kv(kc[layer], ks[layer], act_dtype)
        v = _dequantize_kv(vc[layer], vs[layer], act_dtype)
    else:
        _write(kv_cache["k"], k.to(kv_cache["k"].dtype), layer, input_pos)
        _write(kv_cache["v"], v.to(kv_cache["v"].dtype), layer, input_pos)
        k, v = kv_cache["k"][layer], kv_cache["v"][layer]
    if cfg.attn_alg != "quadratic":
        y = attention(q, k, v, attn_alg=cfg.attn_alg, head_size=hs, is_decode=True, plain=plain)
        return _finish_attn(p, y, x, q, cfg, b, t, hs, wl, plain, shard)
    s_len = k.shape[2]
    if t > 1 and isinstance(input_pos, int) and \
            flash_eligible(t + (-t) % FLASH_BLOCK_Q, s_len, hs):
        # KV-cache prefill: flash attention over the cache layer, the invalid
        # tail masked by kv_len; the kernel masks the ragged query rows itself
        y = flash_attention(q, k, v, scale=1.0 / hs ** 0.5, pos0=input_pos,
                            kv_len=input_pos + t, plain=plain)
    else:
        y = scaled_dot_product_attention(q, k, v, mask=mask, scale=1.0 / hs ** 0.5)
    return _finish_attn(p, y, x, q, cfg, b, t, hs, wl, plain, shard)


def _finish_attn(p, y, x, q, cfg, b, t, hs, layer, plain, shard=None):
    """The adapter's prefix attention (quadratic arm only, as in the
    reference), then head merge + output projection in the activation dtype
    (summed over the ranks of a split attention)."""
    if "adapter" in p and cfg.attn_alg == "quadratic":
        ap = p["adapter"] if layer is None else _slice_tree(p["adapter"], layer)
        y = y + apply_adapter_attention(ap, p["attn"], q, cfg, hs ** -0.5, layer, plain=plain)
    y = y.permute(0, 2, 1, 3).reshape(b, t, -1).to(x.dtype)
    proj, bias = p["proj"], None
    if shard is not None and shard.train and shard.attn and "bias" in proj:
        # a rowwise bias, whole on every rank in training: added once, after the sum
        bias = proj["bias"] if layer is None else proj["bias"][layer]
        proj = {k: v for k, v in proj.items() if k != "bias"}
    out = linear(proj, y, layer, plain=plain)
    if shard is not None:
        out = shard.reduce(out, "attn")
    return out if bias is None else out + bias.to(out.dtype)


def apply_block(bp, x, cfg, layer, attn_fn, *, plain: bool = False, shard=None):
    """One transformer block over layer ``layer`` of the stacked weights (or,
    with ``layer=None``, over one layer's weights); ``attn_fn(attn_params, n1)``
    computes the attention part; ``shard``: see ``apply_mlp``."""
    def norm(name, h):
        p = bp[name] if layer is None else {k: a[layer] for k, a in bp[name].items()}
        return apply_norm(h, p, cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)

    n1 = norm("norm_1", x)
    h = attn_fn(bp["attn"], n1)
    if cfg.parallel_residual:
        n2 = n1 if cfg.shared_attention_norm else norm("norm_2", x)
        return apply_mlp(bp["mlp"], n2, cfg, layer, plain=plain, shard=shard) + h + x
    x = h + x
    return apply_mlp(bp["mlp"], norm("norm_2", x), cfg, layer, plain=plain, shard=shard) + x


def apply_attn_nocache(p: dict, x: torch.Tensor, cfg: Config, cos, sin, *,
                       plain: bool = False, shard=None):
    """Fused-QKV attention over the whole sequence (training and evaluation),
    dispatched on ``cfg.attn_alg``; ``p`` holds one layer's weights."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x if shard is None else shard.enter(x, "attn"), cfg, cos, sin,
                           None, plain)
    y = attention(q, k, v, attn_alg=cfg.attn_alg, head_size=cfg.head_size, plain=plain)
    return _finish_attn(p, y, x, q, cfg, b, t, cfg.head_size, None, plain, shard)


def _unstack(tree, n: int) -> list:
    """Per-layer views of the stacked block leaves: one ``unbind`` a leaf, so
    the backward stacks each leaf's layer gradients once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


# The operators whose outputs the remat policies keep. "attn": the trainable
# attention forwards' (out, lse), the reference's named residuals attn_out and
# attn_lse (custom operators, ops/flash_attention.py and ops/blockwise_attention.py).
# "dots": the matmuls without batch dimensions, the weight products (JAX's
# dots_with_no_batch_dims_saveable); the batched attention products (bmm) and
# everything else are recomputed.
ATTN_RESIDUAL_OPS = ("fastmax_tpu_torch::flash_train_fwd", "fastmax_tpu_torch::blockwise_fwd")
DOT_OPS = ("aten::mm", "aten::addmm")
REMAT_SAVES = {"attn": ATTN_RESIDUAL_OPS, "dots": DOT_OPS,
               "dots_attn": DOT_OPS + ATTN_RESIDUAL_OPS}


def _remat_wrap(body, remat):
    """Per-block rematerialization (counterpart of the reference's
    ``_remat_wrap``, ``fastmax_tpu/models/gpt.py:528-577``).

    False: every block activation is kept. True/"full": only the block's
    input; the whole block is recomputed in the backward
    (``torch.utils.checkpoint``). "attn", "dots", "dots_attn": the block is
    recomputed except the outputs of the operators in ``REMAT_SAVES``, which a
    selective-checkpoint policy keeps from the forward; under "attn" and
    "dots_attn" the backward re-runs no attention forward. No policy changes
    a value."""
    if remat is True or remat == "full":
        return lambda x: checkpoint(body, x, use_reentrant=False)
    if isinstance(remat, str) and remat in REMAT_SAVES:
        saved = REMAT_SAVES[remat]

        def policy(ctx, op, *args, **kwargs):
            return (CheckpointPolicy.MUST_SAVE if op.name() in saved
                    else CheckpointPolicy.PREFER_RECOMPUTE)

        context_fn = functools.partial(create_selective_checkpoint_contexts, policy)
        return lambda x: checkpoint(body, x, use_reentrant=False, context_fn=context_fn)
    if remat:
        raise ValueError(f"unknown remat policy {remat!r}")
    return body


def _layer_policies(remat, n_layer: int) -> list:
    """The policy of each layer: ``remat`` for all, or for the mixed form
    ``"<light>@<N>:<heavy>"`` (e.g. ``"dots@8:full"``) the light policy on
    the first N layers and the heavy one on the rest."""
    if not (isinstance(remat, str) and "@" in remat):
        return [remat] * n_layer
    light, rest = remat.split("@", 1)
    if ":" not in rest:
        raise ValueError(f"mixed remat policy {remat!r}: expected '<light>@<N>:<heavy>'")
    n_s, heavy = rest.split(":", 1)
    n_light = int(n_s)
    layers = range(n_layer)  # sliced as the reference slices the stacked blocks
    return [light] * len(layers[:n_light]) + [heavy] * len(layers[n_light:])


def forward_hidden(params: dict, cfg: Config, idx: torch.Tensor, *, remat=False,
                   unroll: int = 1, rope_cache: Optional[tuple] = None,
                   plain: bool = False, shard=None) -> torch.Tensor:
    """Full-sequence forward to the final hidden states (after ``ln_f``),
    without the lm_head: the training forward that ``utils/loss.
    chunked_cross_entropy`` pairs with. ``remat`` is a policy of
    ``_remat_wrap`` (False, True, "full", "attn", "dots", "dots_attn") or the
    mixed form ``"<light>@<N>:<heavy>"`` (``_layer_policies``). ``unroll``,
    the reference's layer-scan unroll factor, is accepted and changes
    nothing: the layers are a Python loop here, not a scan. The RoPE cache
    defaults to ``cfg.block_size`` rows, as the reference's. ``shard`` (a
    ``parallel.sharding.ShardPlan``): ``params`` is a rank's local tree; each
    layer's leaves are gathered over fsdp inside its remat body, so that a
    recompute gathers them again (every rank recomputes in the same order)."""
    t = idx.shape[1]
    if rope_cache is None:
        rope_cache = build_rope_cache(cfg.block_size, cfg.rope_n_elem, cfg.rope_base,
                                      cfg.rope_condense_ratio, device=idx.device)
    cos, sin = rope_cache[0][:t], rope_cache[1][:t]
    if shard is not None:
        params = shard.top(params, ("wte", "ln_f"))
    x = embedding(params["wte"], idx)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)

    def attn_fn(ap, n1):
        return apply_attn_nocache(ap, n1, cfg, cos, sin, plain=plain, shard=shard)

    def body(get):
        return lambda h: apply_block(get(), h, cfg, None, attn_fn, plain=plain, shard=shard)

    layers = [lambda bp=bp: bp for bp in _unstack(params["blocks"], cfg.n_layer)] \
        if shard is None else shard.layers(params["blocks"], cfg.n_layer)
    steps = [_remat_wrap(body(get), policy) for get, policy in
             zip(layers, _layer_policies(remat, cfg.n_layer))]
    for step in steps:
        x = step(x)
    return apply_norm(x, params["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)


def lm_head_fn(params: dict, shard=None):
    """The lm_head as a function of hidden states, giving the whole
    vocabulary's logits: on a mesh the head is gathered over fsdp, and a
    vocab-split head's logits are gathered over ``model``."""
    if shard is None:
        return lambda h: linear(params["lm_head"], h)
    head = shard.top(params, ("lm_head",))["lm_head"]
    return lambda h: shard.logits(linear(head, shard.enter(h, "lm_head")))


def _forward_nocache(params, cfg, idx, rope_cache, remat, unroll, plain, shard=None):
    h = forward_hidden(params, cfg, idx, remat=remat, unroll=unroll, rope_cache=rope_cache,
                       plain=plain, shard=shard)
    return lm_head_fn(params, shard)(h)


def forward(
    params: dict,
    cfg: Config,
    idx: torch.Tensor,
    *,
    input_pos=None,
    kv_cache: Optional[dict] = None,
    rope_cache: Optional[tuple] = None,
    max_seq_length: Optional[int] = None,
    logits_at: Optional[torch.Tensor] = None,
    remat=False,
    unroll: int = 1,
    plain: bool = False,
    shard=None,
):
    """Run the model. Without ``kv_cache`` (and ``input_pos``): the full-sequence
    training/evaluation forward under the remat policy ``remat`` (see
    ``forward_hidden``; ``unroll`` changes nothing); returns (logits (B, T,
    padded_vocab), None).

    Cached forward. idx: (B, T) token ids; input_pos: the position of
    idx[:, 0], a Python int, or a (B,) integer tensor of per-row positions
    (continuous batching: token i of row b sits at input_pos[b] + i; the
    positions stay on the device). Writes the T new tokens into
    ``kv_cache`` in place. ``logits_at`` (B,) picks one row of T per batch
    row for the lm_head, which then returns (B, 1, padded_vocab).
    ``plain=True`` sends every kernel call to its plain PyTorch version (a
    test hook for comparing the two on the card). ``shard`` (a
    ``parallel.sharding.ShardPlan``): ``params`` and ``kv_cache`` are a
    rank's local shards on a mesh; the rowwise sums, the fsdp gathers and the
    logits' gather over the vocab run here (every rank of the mesh calls it).

    Returns (logits (B, T or 1, padded_vocab), kv_cache).
    """
    b, t = idx.shape
    device = idx.device
    if rope_cache is None:
        n = max_seq_length or cfg.block_size
        rope_cache = build_rope_cache(n, cfg.rope_n_elem, cfg.rope_base,
                                      cfg.rope_condense_ratio, device=device)
    if kv_cache is None:
        if input_pos is not None:
            raise ValueError("input_pos requires a kv_cache (call init_kv_cache)")
        return _forward_nocache(params, cfg, idx, rope_cache, remat, unroll, plain, shard), None
    s = kv_cache["k"].shape[3]
    if isinstance(input_pos, torch.Tensor) and input_pos.ndim == 1:
        input_pos = input_pos.to(device=device, dtype=torch.int32)
        qpos = input_pos[:, None] + torch.arange(t, device=device, dtype=torch.int32)  # (B, T)
        # an out-of-range gather clamps in the reference; garbage rows of idle slots only
        rows = torch.clamp(qpos, 0, rope_cache[0].shape[0] - 1).long()
        cos, sin = rope_cache[0][rows][:, None], rope_cache[1][rows][:, None]  # (B, 1, T, n)
        mask = torch.arange(s, device=device)[None, None, None, :] <= qpos[:, None, :, None]
        posv = qpos[:, -1]
    else:
        input_pos = int(input_pos)
        cos = rope_cache[0][input_pos:input_pos + t]
        sin = rope_cache[1][input_pos:input_pos + t]
        # mask[i, j]: the query at position input_pos + i attends to slot j <= input_pos + i
        qpos = input_pos + torch.arange(t, device=device)[:, None]
        mask = (torch.arange(s, device=device)[None, :] <= qpos)[None, None]
        posv = torch.full((b,), input_pos + t - 1, dtype=torch.int32, device=device)

    if shard is not None:
        params = shard.top(params)
    x = embedding(params["wte"], idx)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)
    for layer in range(cfg.n_layer):
        bp, wl = (params["blocks"], layer) if shard is None else \
            shard.layer(params["blocks"], layer)

        def attn_fn(ap, n1, layer=layer, wl=wl):
            return apply_attn(ap, n1, cfg, cos, sin, mask, kv_cache, input_pos, layer, posv,
                              plain=plain, shard=shard, wlayer=wl)
        x = apply_block(bp, x, cfg, wl, attn_fn, plain=plain, shard=shard)
    x = apply_norm(x, params["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)
    if logits_at is not None:
        x = x[torch.arange(b, device=device), logits_at.to(device).long()][:, None]
    logits = linear(params["lm_head"], x)
    return (logits if shard is None else shard.logits(logits)), kv_cache


# ------------------------------------------------------- the linear-attention state cache
# O(1)-per-token decode for the linear arms (counterpart of the reference's
# init_linear_cache, _attn_linear_state and forward_linear_cache).

LINEAR_ALGS = ("fastmax", "fastmax_cuda", "linearmax", "performer")


def _degree(attn_alg: str) -> int:
    return 2 if attn_alg in ("fastmax", "fastmax_cuda") else 1


def init_linear_cache(cfg: Config, batch_size: int, device=None) -> dict:
    """The stacked running state (L, B, n_head, ...) in float32, for the full
    head count (the linear arms run on repeated KV heads). At p = 2 ``s_kkv``
    is (L, B, H, D^2, D): 8.59 GB a sequence at Llama-2-7B's 32 layers, 32
    heads and D = 128."""
    n = cfg.n_layer
    flat = fm.linear_attn_state_init(n * batch_size, cfg.n_head, cfg.head_size,
                                     _degree(cfg.attn_alg), device=device)
    state = {name: x.view(n, batch_size, *x.shape[1:]) for name, x in flat.items()}
    if cfg.attn_alg == "linearmax":
        for name in ("q_div", "k_div"):
            state[name] = torch.ones(state["cnt"].shape, dtype=torch.float32, device=device)
    return state


def _attn_linear_state(p: dict, x: torch.Tensor, cfg: Config, cos, sin, state: dict, layer: int,
                       is_prefill: bool, n_valid, plain: bool, wl: Optional[int] = None):
    """Attention of layer ``layer`` through the running state, which it
    updates in place. With ``n_valid`` (prefill only) the rows at or past it
    are padding: their q, k and v are zeroed after RoPE, so that they add
    nothing to the sums but a count, which the caller overwrites."""
    b, t, _ = x.shape
    hs = cfg.head_size
    wl = layer if wl is None else wl
    q, k, v = _project_qkv(p, x, cfg, cos, sin, wl, plain)
    k, v = repeat_kv_heads(k, cfg.n_head), repeat_kv_heads(v, cfg.n_head)
    if n_valid is not None:
        keep = (torch.arange(t, device=x.device) < n_valid)[:, None]
        q, k, v = (torch.where(keep, a, 0.0) for a in (q, k, v))
    st = {name: a[layer] for name, a in state.items()}
    alg = cfg.attn_alg
    if is_prefill:
        if alg == "linearmax":
            y, new = fm.linearmax_prefill_state(q, k, v, p=1)
        elif alg == "performer":
            y, new = fm.performer_prefill_state(q, k, v)
        else:
            y, new = fm.fastmax_prefill_state(q, k, v, p=_degree(alg))
        for name, val in new.items():
            st[name].copy_(val)
    else:
        q1, k1, v1 = q[:, :, 0], k[:, :, 0], v[:, :, 0]
        if alg == "linearmax":
            _, o = fm.linearmax_decode_step(st, q1, k1, v1, p=1)
        elif alg == "performer":
            _, o = fm.performer_decode_step(st, q1, k1, v1)
        else:
            _, o = fm.linear_attn_decode_step(st, q1, k1, v1, 8.0 * hs ** 0.5, _degree(alg))
        y = o[:, :, None, :]
    return _finish_attn(p, y, x, q, cfg, b, t, hs, wl, plain)


def forward_linear_cache(
    params: dict,
    cfg: Config,
    idx: torch.Tensor,
    *,
    state: dict,
    input_pos,
    rope_cache: Optional[tuple] = None,
    max_seq_length: Optional[int] = None,
    is_prefill: Optional[bool] = None,
    n_valid: Optional[int] = None,
    plain: bool = False,
    shard=None,
):
    """The forward through the linear-attention state (``init_linear_cache``),
    updated in place. ``is_prefill=True`` runs the T tokens of idx (B, T) and
    overwrites every entry of the state that the arm reads (the engine passes
    it, so that a one-token prompt prefills too; the default is T > 1);
    ``is_prefill=False`` is one decode step
    (T = 1). ``input_pos``: the position of idx[:, 0], a Python int, or a (B,)
    tensor of per-slot positions at T = 1. ``n_valid`` (prefill): the prompt's
    true length inside a padded bucket; the count is set to it after the
    layers. ``plain=True`` sends the linears' kernel calls to their plain
    versions. ``shard``: see ``forward`` (the attention and its state stay
    whole on every rank). Returns (logits (B, T, padded_vocab), state)."""
    b, t = idx.shape
    device = idx.device
    if rope_cache is None:
        n = max_seq_length or cfg.block_size
        rope_cache = build_rope_cache(n, cfg.rope_n_elem, cfg.rope_base,
                                      cfg.rope_condense_ratio, device=device)
    n_rope = rope_cache[0].shape[0]
    if isinstance(input_pos, torch.Tensor) and input_pos.ndim == 1:
        if t != 1:
            raise ValueError("vector input_pos requires single-token decode")
        # an out-of-range gather clamps in the reference; garbage rows of idle slots only
        rows = torch.clamp(input_pos.to(device).long(), 0, n_rope - 1)
        cos, sin = rope_cache[0][rows][:, None, None], rope_cache[1][rows][:, None, None]
        if is_prefill is None:
            is_prefill = False
    else:
        start = min(max(int(input_pos), 0), n_rope - t)  # the reference's dynamic_slice clamp
        cos, sin = rope_cache[0][start:start + t], rope_cache[1][start:start + t]
    if is_prefill is None:
        is_prefill = t > 1
    if not is_prefill:
        n_valid = None

    if shard is not None:
        params = shard.top(params)
    x = embedding(params["wte"], idx)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)
    for layer in range(cfg.n_layer):
        bp, wl = (params["blocks"], layer) if shard is None else \
            shard.layer(params["blocks"], layer)

        def attn_fn(ap, n1, layer=layer, wl=wl):
            return _attn_linear_state(ap, n1, cfg, cos, sin, state, layer, is_prefill, n_valid,
                                      plain, wl)
        x = apply_block(bp, x, cfg, wl, attn_fn, plain=plain, shard=shard)
    if n_valid is not None:
        # the padded rows counted in the scan: the true length
        state["cnt"].fill_(float(n_valid))
    x = apply_norm(x, params["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)
    logits = linear(params["lm_head"], x)
    return (logits if shard is None else shard.logits(logits)), state
