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
SwiGLU MLP (split or fused ``fc_12``), sequential and parallel residual.

The no-cache forward (``kv_cache=None``: training and evaluation; and
``forward_hidden``, the same without the lm_head) runs every block over the
whole sequence with ``ops/attention.attention``, so
``attn_alg="fastmax"``/``"fastmax_cuda"`` goes through the fastmax kernels K4
(forward) and K5 (backward) and ``quadratic`` at T >= 1024 through the
trainable flash kernels K6 (forward) and K7 (backward); ``remat=True``
recomputes each block in the backward (``torch.utils.checkpoint``).
``init_params`` gives the GPT-NeoX initialisation from a seed; the GPT-NeoX
MLP (exact or tanh GELU) and bias leaves are ported. The linear-attention
cache, MoE and the XLA remat policies come in later slices.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..ops.attention import attention, int8_cache_attention, scaled_dot_product_attention
from ..ops.decode_attention import int8_decode_attention_stacked, int8_decode_eligible
from ..ops.flash_attention import BLOCK_Q as FLASH_BLOCK_Q
from ..ops.flash_attention import flash_attention, flash_eligible
from ..ops.linear import embedding, linear
from ..ops.norms import apply_norm
from ..ops.rope import apply_rope, build_rope_cache
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


def _init_block(gen, cfg: Config, dtype) -> dict:
    e, i = cfg.n_embd, cfg.intermediate_size
    if cfg.mlp_class_name == "GptNeoxMLP":
        mlp = {"fc": _init_linear(gen, e, i, cfg.bias, dtype),
               "proj": _init_linear(gen, i, e, cfg.bias, dtype)}
    elif cfg.mlp_class_name == "LLaMAMLP":
        mlp = {"fc_1": _init_linear(gen, e, i, cfg.bias, dtype),
               "fc_2": _init_linear(gen, e, i, cfg.bias, dtype),
               "proj": _init_linear(gen, i, e, cfg.bias, dtype)}
    else:
        raise NotImplementedError(f"{cfg.mlp_class_name} is not ported yet")
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
                  dtype=torch.float32, device=None) -> dict:
    """Grouped KV cache (L, B, n_query_groups, S, head_size). dtype int8
    selects the quantized cache: int8 codes with a per-token-per-group f32
    absmax scale."""
    shape = (cfg.n_layer, batch_size, cfg.n_query_groups, max_seq_length, cfg.head_size)
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


def apply_mlp(p: dict, x: torch.Tensor, cfg: Config, layer=None, *, plain: bool = False):
    if cfg.mlp_class_name == "GptNeoxMLP":
        h = linear(p["fc"], x, layer, plain=plain)
        h = torch.nn.functional.gelu(h, approximate="tanh" if cfg.gelu_approximate == "tanh"
                                     else "none")
        return linear(p["proj"], h, layer, plain=plain)
    if cfg.mlp_class_name != "LLaMAMLP":
        raise NotImplementedError(f"{cfg.mlp_class_name} is not ported yet "
                                  "(GptNeoxMLP and LLaMAMLP)")
    silu = torch.nn.functional.silu
    if "fc_12" in p:
        h = linear(p["fc_12"], x, layer, plain=plain)
        h1, h2 = torch.chunk(h, 2, dim=-1)
        return linear(p["proj"], silu(h1) * h2, layer, plain=plain)
    return linear(p["proj"], silu(linear(p["fc_1"], x, layer, plain=plain))
                  * linear(p["fc_2"], x, layer, plain=plain), layer, plain=plain)


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
    hs, g = cfg.head_size, cfg.n_query_groups
    q_per_kv = cfg.n_head // g
    qkv = linear(p["attn"], x, layer, plain=plain).reshape(b, t, g, q_per_kv + 2, hs)
    q = qkv[..., :q_per_kv, :].reshape(b, t, cfg.n_head, hs).permute(0, 2, 1, 3)
    k = qkv[..., q_per_kv, :].permute(0, 2, 1, 3)
    v = qkv[..., q_per_kv + 1, :].permute(0, 2, 1, 3)
    return _rope(q, cos, sin, cfg.rope_n_elem), _rope(k, cos, sin, cfg.rope_n_elem), v


def apply_attn(p: dict, x: torch.Tensor, cfg: Config, cos, sin, mask, kv_cache: dict,
               input_pos, layer: int, posv: torch.Tensor, *, plain: bool = False):
    """Fused-QKV grouped attention over layer ``layer`` of the stacked cache,
    which is updated in place. ``input_pos`` is a Python int or a (B,)
    tensor of per-row positions; ``posv`` (B,) int32 holds the position of
    the last token (the decode kernel's mask frontier)."""
    b, t, _ = x.shape
    hs, q_per_kv = cfg.head_size, cfg.n_head // cfg.n_query_groups
    q, k, v = _project_qkv(p, x, cfg, cos, sin, layer, plain)

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
            return _finish_attn(p, y, x, cfg, b, t, hs, layer, plain)
        # prefill reads a dense cache: dequantize once
        k = _dequantize_kv(kc[layer], ks[layer], act_dtype)
        v = _dequantize_kv(vc[layer], vs[layer], act_dtype)
    else:
        _write(kv_cache["k"], k.to(kv_cache["k"].dtype), layer, input_pos)
        _write(kv_cache["v"], v.to(kv_cache["v"].dtype), layer, input_pos)
        k, v = kv_cache["k"][layer], kv_cache["v"][layer]
    if cfg.attn_alg != "quadratic":
        raise NotImplementedError(f"attn_alg {cfg.attn_alg!r} is not ported yet")
    s_len = k.shape[2]
    if t > 1 and isinstance(input_pos, int) and \
            flash_eligible(t + (-t) % FLASH_BLOCK_Q, s_len, hs):
        # KV-cache prefill: flash attention over the cache layer, the invalid
        # tail masked by kv_len; the kernel masks the ragged query rows itself
        y = flash_attention(q, k, v, scale=1.0 / hs ** 0.5, pos0=input_pos,
                            kv_len=input_pos + t, plain=plain)
    else:
        y = scaled_dot_product_attention(q, k, v, mask=mask, scale=1.0 / hs ** 0.5)
    return _finish_attn(p, y, x, cfg, b, t, hs, layer, plain)


def _finish_attn(p, y, x, cfg, b, t, hs, layer, plain):
    """Head merge + output projection, in the activation dtype."""
    y = y.permute(0, 2, 1, 3).reshape(b, t, hs * cfg.n_head).to(x.dtype)
    return linear(p["proj"], y, layer, plain=plain)


def apply_block(bp, x, cfg, layer, attn_fn, *, plain: bool = False):
    """One transformer block over layer ``layer`` of the stacked weights (or,
    with ``layer=None``, over one layer's weights); ``attn_fn(attn_params, n1)``
    computes the attention part."""
    def norm(name, h):
        p = bp[name] if layer is None else {k: a[layer] for k, a in bp[name].items()}
        return apply_norm(h, p, cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)

    n1 = norm("norm_1", x)
    h = attn_fn(bp["attn"], n1)
    if cfg.parallel_residual:
        n2 = n1 if cfg.shared_attention_norm else norm("norm_2", x)
        return apply_mlp(bp["mlp"], n2, cfg, layer, plain=plain) + h + x
    x = h + x
    return apply_mlp(bp["mlp"], norm("norm_2", x), cfg, layer, plain=plain) + x


def apply_attn_nocache(p: dict, x: torch.Tensor, cfg: Config, cos, sin, *,
                       plain: bool = False):
    """Fused-QKV attention over the whole sequence (training and evaluation),
    dispatched on ``cfg.attn_alg``; ``p`` holds one layer's weights."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, cos, sin, None, plain)
    y = attention(q, k, v, attn_alg=cfg.attn_alg, head_size=cfg.head_size, plain=plain)
    return _finish_attn(p, y, x, cfg, b, t, cfg.head_size, None, plain)


def _unstack(tree, n: int) -> list:
    """Per-layer views of the stacked block leaves: one ``unbind`` a leaf, so
    the backward stacks each leaf's layer gradients once."""
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(tree.unbind(0))


def _check_remat(remat) -> bool:
    if remat is True or remat == "full":
        return True
    if not remat:
        return False
    if isinstance(remat, str):
        raise NotImplementedError(
            f"remat policy {remat!r} is one of the reference's XLA checkpoint policies; the port "
            "has True/'full' (each block recomputed in the backward) and False")
    raise ValueError(f"unknown remat policy {remat!r}")


def forward_hidden(params: dict, cfg: Config, idx: torch.Tensor, *, remat=False,
                   rope_cache: Optional[tuple] = None, plain: bool = False) -> torch.Tensor:
    """Full-sequence forward to the final hidden states (after ``ln_f``),
    without the lm_head: the training forward that ``utils/loss.
    chunked_cross_entropy`` pairs with. ``remat`` True or "full" recomputes
    each block in the backward. The RoPE cache defaults to ``cfg.block_size``
    rows, as the reference's."""
    t = idx.shape[1]
    if rope_cache is None:
        rope_cache = build_rope_cache(cfg.block_size, cfg.rope_n_elem, cfg.rope_base,
                                      cfg.rope_condense_ratio, device=idx.device)
    cos, sin = rope_cache[0][:t], rope_cache[1][:t]
    x = embedding(params["wte"], idx)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)
    use_remat = _check_remat(remat)

    def attn_fn(ap, n1):
        return apply_attn_nocache(ap, n1, cfg, cos, sin, plain=plain)

    for bp in _unstack(params["blocks"], cfg.n_layer):
        def body(h, bp=bp):
            return apply_block(bp, h, cfg, None, attn_fn, plain=plain)
        x = checkpoint(body, x, use_reentrant=False) if use_remat else body(x)
    return apply_norm(x, params["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)


def _forward_nocache(params, cfg, idx, rope_cache, remat, plain):
    return linear(params["lm_head"], forward_hidden(params, cfg, idx, remat=remat,
                                                    rope_cache=rope_cache, plain=plain))


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
    plain: bool = False,
):
    """Run the model. Without ``kv_cache`` (and ``input_pos``): the full-sequence
    training/evaluation forward, each block recomputed in the backward when
    ``remat`` is True or "full"; returns (logits (B, T, padded_vocab), None).

    Cached forward. idx: (B, T) token ids; input_pos: the position of
    idx[:, 0], a Python int, or a (B,) integer tensor of per-row positions
    (continuous batching: token i of row b sits at input_pos[b] + i; the
    positions stay on the device). Writes the T new tokens into
    ``kv_cache`` in place. ``logits_at`` (B,) picks one row of T per batch
    row for the lm_head, which then returns (B, 1, padded_vocab).
    ``plain=True`` sends every kernel call to its plain PyTorch version (a
    test hook for comparing the two on the card).

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
        return _forward_nocache(params, cfg, idx, rope_cache, remat, plain), None
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

    x = embedding(params["wte"], idx)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)
    for layer in range(cfg.n_layer):
        def attn_fn(ap, n1, layer=layer):
            return apply_attn(ap, n1, cfg, cos, sin, mask, kv_cache, input_pos, layer, posv,
                              plain=plain)
        x = apply_block(params["blocks"], x, cfg, layer, attn_fn, plain=plain)
    x = apply_norm(x, params["ln_f"], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)
    if logits_at is not None:
        x = x[torch.arange(b, device=device), logits_at.to(device).long()][:, None]
    return linear(params["lm_head"], x), kv_cache
