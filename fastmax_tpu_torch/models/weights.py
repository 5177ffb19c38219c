"""Bring a parameter tree of the JAX package into the port, and back.

``from_numpy_params`` takes the tree as numpy arrays (for example
``jax.tree.map(np.asarray, params)``) and returns the same keys and layouts
as torch tensors: dense kernels stay (in, out), biases and norm weights stay
vectors, stacked block leaves keep their leading (n_layer,) axis, and the
other leaves keep their dtype, bits and shape: q4r1 and q4b int32 words,
4-bit uint8 codes (``q4``), int8 codes (``q8``) and double-quantized scales
(``absmax_q``), f32 ``absmax``/``code``/``scale8``/``scale4``, the zero-size
uint8 ``n4``/``k4`` markers, whose shapes carry a linear's true widths, and
the LoRA leaves. ``to_numpy_params`` gives a port tree back as numpy arrays
in the same layout (bfloat16 leaves as float32 values).
"""

from __future__ import annotations

import numpy as np
import torch

from ..inference.engine import default_device


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a)  # a writable copy: torch takes it over
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16: move the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_numpy_params(tree: dict, device=None) -> dict:
    """Numpy parameter tree -> torch tensors on ``device`` (default: the card)."""
    device = default_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, device)

    return walk(tree)


def from_numpy_state(state: dict, device=None) -> dict:
    """A linear-attention running state of the JAX package (``init_linear_cache``
    or a prefill's, as numpy arrays) -> float32 tensors on ``device``, writable
    copies that a decode step may update in place. Entries keep their shapes:
    the reference's p = 1 placeholders ``s_kkv`` (..., 1, 1) and ``s_kk``
    (..., 1), which no p = 1 step reads, stay as they are."""
    device = default_device(device)
    return {name: _tensor(np.asarray(a, np.float32), device) for name, a in state.items()}


def to_numpy_params(tree: dict) -> dict:
    """Torch parameter tree -> numpy arrays on the host."""
    if isinstance(tree, dict):
        return {k: to_numpy_params(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
