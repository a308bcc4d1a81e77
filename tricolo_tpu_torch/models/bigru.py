"""Bidirectional GRU text encoder.

Port of ``tricolo_tpu.models.bigru``: Embedding(vocab, 256) → 1-layer
bidirectional GRU(256 → 128) from a zero state over the full padded
sequence → concat(final forward, final backward) → Linear → tanh → L2.

The JAX package realises ``padding_idx=0`` by multiplying the embedding
output with ``tokens != 0``; a converted embedding row 0 need not be zero,
so the same mask is applied here (``padding_idx`` alone would differ). In
training the mask zeroes row 0's gradient, and weight decay still moves
the row, as in the JAX package. The cuDNN GRU (and its backward) is a
library call, as the JAX package leaves the GRU to XLA. Gate
order (r, z, n) and the candidate ``n = tanh(x_n + r·(W_hn h + b_hn))`` are
torch's own GRU formula.

Parameters are created in ``param_dtype``. The embedding comes out in it
and enters the GRU in the compute dtype (``common.in_compute``), as the
JAX ``GRULayer`` casts its input and weights to ``dtype``. The GRU is the
one ``torch._VF.gru`` call that ``nn.GRU.forward`` makes (cuDNN on the
card), on its weights through ``in_compute``: as they are under bf16
autocast or at f32 parameters, widened to f32 at f32 compute with bf16
parameters.
"""

from __future__ import annotations

import torch
from torch import nn

from .common import Linear, in_compute, l2_normalize


class BiGRUEncoder(nn.Module):
    """tokens (B, T) int → L2-normalized (B, out_dim) float32."""

    def __init__(self, vocab_size: int, out_dim: int = 512, embed_dim: int = 256,
                 hidden_dim: int = 128, param_dtype=torch.float32):
        super().__init__()
        self.embedding = nn.Embedding(vocab_size, embed_dim, dtype=param_dtype)
        self.gru = nn.GRU(embed_dim, hidden_dim, batch_first=True, bidirectional=True,
                          dtype=param_dtype)
        self.fc = Linear(2 * hidden_dim, out_dim, dtype=param_dtype)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x = in_compute(self.embedding(tokens))
        x = x * (tokens != 0)[..., None].to(x.dtype)
        _, h_n = self._gru(x)  # (2, B, H): final forward, final backward
        h = torch.cat([h_n[0], h_n[1]], dim=-1)
        return l2_normalize(torch.tanh(self.fc(h).float()))

    def _gru(self, x: torch.Tensor):
        """``nn.GRU.forward``'s own call (batch-first input, zero state) on
        the weights as the compute dtype uses them."""
        gru = self.gru
        gru._update_flat_weights()
        h0 = x.new_zeros(2, x.shape[0], gru.hidden_size)
        weights = [in_compute(w) for w in gru._flat_weights]
        return torch._VF.gru(x, h0, weights, gru.bias, gru.num_layers, gru.dropout,
                             gru.training, gru.bidirectional, gru.batch_first)
