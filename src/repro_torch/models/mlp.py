"""Dense FFN (``src/repro/models/mlp.py``): the gated (SwiGLU-style)
``w2(act(w1 x) * w3 x)`` of the LM trunks, or the plain two-layer
``w2(act(w1 x))`` of the ColBERT encoder; the hidden activations
annotated ``ff`` and the output ``dmodel`` (the reference's
``constrain`` sites)."""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models.layers import Dense, act_fn
from repro_torch.sharding.api import constrain


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, act: str = "gelu",
                 gated: bool = False, device=None, dtype=torch.float32):
        super().__init__()
        self.act = act_fn(act)
        self.w1 = Dense(d_model, d_ff, False, device, dtype)
        self.w2 = Dense(d_ff, d_model, False, device, dtype)
        self.w3 = Dense(d_model, d_ff, False, device, dtype) if gated else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.act(constrain(self.w1(x), "batch", "seq", "ff"))
        if self.w3 is not None:
            h = h * constrain(self.w3(x), "batch", "seq", "ff")
        return constrain(self.w2(h), "batch", "seq", "dmodel")
