"""GPTQ: error-compensated one-shot weight quantization (Frantar et al. 2022),
counterpart of ``fastmax_tpu/ops/gptq.py``.

Instead of rounding each weight on its own, GPTQ quantizes the input
dimension column by column and folds each column's rounding error back into
the columns not yet quantized, weighted by the inverse Hessian of the
layer's calibration inputs, in the fixed column order with a blocked lazy
update. The arithmetic is the reference's, float64 throughout, the same
column order, the same group scales (taken from the updated weights when the
sweep reaches a group) and the same packed output as ``quant.quantize_4bit``
(q4/code/absmax, or the double-quantized scales), so every 4-bit path of the
port serves it. The reference runs it in numpy on the host; here it runs in
torch float64 on the device of the inputs, the card by default for
``gptq_quantize_model``: at Llama-2-7B's width the lazy update of one
``mlp.proj`` alone is ~5e11 float64 operations.

* ``gptq_quantize_kernel(kernel, H, kind=...)``: one (in, out) kernel
  against the Hessian ``H = X^T X`` of its calibration inputs;
* ``gptq_quantize_model(params, cfg, calib_tokens)``: the sequential
  procedure. The blocks are walked in order, each linear quantized against
  its actual inputs (through the port's ``apply_attn_nocache`` and
  ``apply_block``), and the activations propagated through the *quantized*
  block. MoE experts stay dense, as ``quant.quantize_model`` keeps them.
"""

from __future__ import annotations

import numpy as np
import torch

from . import quant
from .norms import apply_norm


# the quantize modes GPTQ serves (the 4-bit ones) and their codebook kinds
FOUR_BIT_KINDS = {"gptq.int4": "int4", "bnb.nf4": "nf4", "bnb.nf4-dq": "nf4",
                  "bnb.fp4": "fp4", "bnb.fp4-dq": "fp4"}


def hessian(x: torch.Tensor) -> torch.Tensor:
    """H = X^T X in float64 over calibration activations x (..., in)."""
    x2 = x.to(torch.float64).reshape(-1, x.shape[-1])
    return x2.T @ x2


def _quantize_column(w: torch.Tensor, scale: torch.Tensor, code: torch.Tensor,
                     mids: torch.Tensor):
    """Round one weight column (out,) to the sorted codebook ``code`` at the
    group scale: (values, sorted-code indices). ``mids`` are the midpoints of
    ``code``; a tie goes to the lower code, as ``quant._nearest_code``."""
    safe = torch.where(scale == 0, torch.ones_like(scale), scale)
    idx = torch.searchsorted(mids, (w / safe).contiguous(), right=False)
    return code[idx] * scale, idx


def gptq_quantize_kernel(
    kernel: torch.Tensor,
    H: torch.Tensor,
    kind: str = "int4",
    block_size: int = quant.DEFAULT_BLOCK,
    percdamp: float = 0.01,
    double_quant: bool = False,
) -> dict:
    """Quantize an (in, out) kernel with GPTQ error compensation, on its
    device. H: the (in, in) Hessian of its calibration inputs (``hessian``).
    Returns the ``quant.quantize_4bit`` packed dict."""
    device = kernel.device
    native = np.asarray(quant.CODEBOOKS[kind], np.float32)
    sorted_code = np.sort(native.astype(np.float64))
    code = torch.from_numpy(sorted_code).to(device)
    mids = torch.from_numpy((sorted_code[1:] + sorted_code[:-1]) / 2).to(device)
    k_in, k_out = kernel.shape
    if k_in % block_size:
        raise ValueError(f"in-dim {k_in} not divisible by block_size {block_size}")
    W = kernel.float().to(torch.float64).T.contiguous()  # (out, in): the paper's layout
    H = H.to(device=device, dtype=torch.float64).clone()

    diag = torch.diagonal(H)
    dead = diag == 0
    diag.masked_fill_(dead, 1.0)
    W[:, dead] = 0.0
    diag += percdamp * torch.mean(diag)

    # upper Cholesky factor U of H^-1 (H^-1 = U^T U); U[j, j:] carries the
    # error-propagation weights of column j
    Hinv = torch.linalg.inv(H)
    Hinv = (Hinv + Hinv.T) / 2.0  # symmetric against the inversion's round-off
    U = torch.linalg.cholesky(Hinv).T

    codes = torch.zeros((k_out, k_in), dtype=torch.uint8, device=device)
    absmax = torch.zeros((k_in // block_size, k_out), dtype=torch.float32, device=device)

    for g0 in range(0, k_in, block_size):
        g1 = g0 + block_size
        scale = torch.amax(torch.abs(W[:, g0:g1]), dim=1)  # (out,) from the updated weights
        absmax[g0 // block_size] = torch.where(scale == 0, torch.ones_like(scale), scale)
        err_blk = torch.zeros((k_out, block_size), dtype=torch.float64, device=device)
        for j in range(g0, g1):
            w = W[:, j]
            qv, idx = _quantize_column(w, scale, code, mids)
            codes[:, j] = idx.to(torch.uint8)
            err = (w - qv) / U[j, j]
            # eager update inside the group; the current column keeps its
            # quantized value implicitly (the codes are the output)
            W[:, j + 1:g1] -= err[:, None] * U[j, j + 1:g1][None, :]
            err_blk[:, j - g0] = err
        # lazy update of everything past the group
        W[:, g1:] -= err_blk @ U[g0:g1, g1:]

    # sorted-codebook indices back to the codebook's own order, packed as
    # quant.quantize_4bit packs them (pairs along the input dim)
    order = torch.from_numpy(np.argsort(native).astype(np.uint8)).to(device)
    codes = order[codes.long()].T.contiguous()  # (in, out), native-order codes
    out = {"q4": ((codes[0::2] << 4) | codes[1::2]).contiguous(),  # the kernels' layout
           "code": torch.from_numpy(native.copy()).to(device)}
    if double_quant:
        out.update(quant._quantize_scales(absmax))
    else:
        out["absmax"] = absmax
    return out


# ---------------------------------------------------------------------------
# Sequential model quantization
# ---------------------------------------------------------------------------


def _gptq_linear(p: dict, x: torch.Tensor, kind: str, double_quant: bool) -> dict:
    """Quantize one linear param dict against its calibration inputs x."""
    if "kernel" not in p:
        return p
    q = gptq_quantize_kernel(p["kernel"], hessian(x), kind=kind, double_quant=double_quant)
    if "bias" in p:
        q["bias"] = p["bias"]
    return q


def gptq_quantize_model(
    params: dict,
    cfg,
    calib_tokens,
    kind: str = "int4",
    double_quant: bool = False,
    skip=("lm_head", "wte"),
    device=None,
) -> dict:
    """Sequentially GPTQ-quantize every block linear of a GPT param tree, on
    ``device`` (default: the card; raises without CUDA).

    calib_tokens: (B, T) token ids (a few hundred to a few thousand tokens of
    representative text). Activations run in float32 and are propagated
    through each block *after* it is quantized, so later Hessians see the
    quantization error of earlier layers. MoE expert kernels stay dense."""
    from ..inference.engine import _to_device, default_device
    from ..models import gpt
    from ..ops.linear import embedding, linear
    from ..ops.rope import build_rope_cache

    device = default_device(device)
    params = _to_device(params, device)
    calib = (calib_tokens if isinstance(calib_tokens, torch.Tensor)
             else torch.from_numpy(np.asarray(calib_tokens))).to(device=device, dtype=torch.long)
    t = calib.shape[1]
    cos, sin = build_rope_cache(t, cfg.rope_n_elem, cfg.rope_base, cfg.rope_condense_ratio,
                                device=device)
    cos, sin = cos[:t], sin[:t]

    x = embedding(params["wte"], calib)
    if cfg.scale_embeddings:
        x = x * (cfg.n_embd ** 0.5)
    x = x.float()

    def norm(v, bp, name):
        return apply_norm(v, bp[name], cfg.norm_class_name, cfg.norm_eps, cfg.add_unit_offset)

    n_hd = cfg.head_size * cfg.n_head
    eye_proj = {"kernel": torch.eye(n_hd, dtype=torch.float32, device=device)}

    def attn_fn(ap, n1):
        return gpt.apply_attn_nocache(ap, n1, cfg, cos, sin)

    new_blocks = []
    with torch.no_grad():
        for layer in range(cfg.n_layer):
            bp = gpt._slice_tree(params["blocks"], layer)

            n1 = norm(x, bp, "norm_1")
            attn = dict(bp["attn"])
            attn["attn"] = _gptq_linear(attn["attn"], n1, kind, double_quant)
            # the pre-proj activations through the QUANTIZED qkv: an identity proj tap
            y_pre = gpt.apply_attn_nocache({**attn, "proj": eye_proj}, n1, cfg, cos, sin)
            attn["proj"] = _gptq_linear(attn["proj"], y_pre, kind, double_quant)
            nb = dict(bp)
            nb["attn"] = attn

            h = linear(attn["proj"], y_pre)
            if cfg.parallel_residual:
                n2 = n1 if cfg.shared_attention_norm else norm(x, bp, "norm_2")
            else:
                n2 = norm(h + x, nb, "norm_2")

            mlp = dict(bp["mlp"])
            if "experts" in mlp:  # MoE: experts stay dense (see quant.quantize_model)
                if "gate" in mlp:
                    mlp["gate"] = _gptq_linear(mlp["gate"], n2, kind, double_quant)
            elif "fc" in mlp:  # GptNeoxMLP
                mlp["fc"] = _gptq_linear(mlp["fc"], n2, kind, double_quant)
                mid = torch.nn.functional.gelu(
                    linear(mlp["fc"], n2),
                    approximate="tanh" if cfg.gelu_approximate == "tanh" else "none")
                mlp["proj"] = _gptq_linear(mlp["proj"], mid, kind, double_quant)
            else:  # LLaMAMLP / GemmaMLP
                mlp["fc_1"] = _gptq_linear(mlp["fc_1"], n2, kind, double_quant)
                mlp["fc_2"] = _gptq_linear(mlp["fc_2"], n2, kind, double_quant)
                h1 = linear(mlp["fc_1"], n2)
                h2 = linear(mlp["fc_2"], n2)
                act = (torch.nn.functional.silu(h1) if cfg.mlp_class_name == "LLaMAMLP"
                       else torch.nn.functional.gelu(h1, approximate="none"))
                mlp["proj"] = _gptq_linear(mlp["proj"], act * h2, kind, double_quant)
            nb["mlp"] = mlp

            # propagate through the quantized block
            x = gpt.apply_block(nb, x, cfg, None, attn_fn)
            new_blocks.append(nb)

        out = {k: v for k, v in params.items() if k != "blocks"}
        out["blocks"] = gpt._stack(new_blocks)
        # the linears outside the blocks follow quantize_model's skip policy
        if "lm_head" not in skip:
            xf = norm(x, params, "ln_f")
            out["lm_head"] = _gptq_linear(dict(params["lm_head"]), xf, kind, double_quant)
    return out
