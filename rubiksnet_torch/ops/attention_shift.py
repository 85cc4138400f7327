"""Attention-weighted temporal shift (the "AQ" temporal op), plain PyTorch.

Counterpart of ``rubiksnet_tpu/ops/attention_shift.py``, where it is an XLA
composition and no kernel: a per-channel 3-tap kernel along T whose taps
are softmax-normalized attention weights. Inside the fused block kernel
(``ops/fused_block.py`` with ``aq=True``) the same mix runs in the CUDA
kernel's first loader.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

TEMPERATURE = 2.0


def attention_shift_weights(weight, temperature=TEMPERATURE):
    """Raw (C, 3) weights -> taps: each row divided by its Bessel-corrected
    standard deviation plus 1e-6, then by the temperature, then softmax."""
    std = weight.std(dim=1, keepdim=True, correction=1)
    return torch.softmax(weight / (std + 1e-6) / temperature, dim=1)


def attention_shift(x, weight, temperature=TEMPERATURE):
    """``out[t] = w0 * x[t-1] + w1 * x[t] + w2 * x[t+1]`` along T of x
    (N, T, H, W, C), zero boundary frames; weight: raw (C, 3) logits, taken
    in x's dtype."""
    w = attention_shift_weights(weight.to(x.dtype), temperature)
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))
    t = x.shape[1]
    return (w[:, 0] * xp[:, 0:t] + w[:, 1] * x + w[:, 2] * xp[:, 2:t + 2])
