"""Plain two-layer MLP of the encoder (``src/repro/models/mlp.py``,
non-gated path): y = w2(act(w1(x)))."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Dense, gelu


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str = "gelu",
                 gated: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        if gated or act != "gelu":
            raise NotImplementedError(
                "only the non-gated GELU MLP is ported (ROADMAP queue 1)")
        self.w1 = Dense(d_model, d_ff, False, device, dtype)
        self.w2 = Dense(d_ff, d_model, False, device, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(gelu(self.w1(x)))
