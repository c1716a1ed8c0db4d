"""The encoder's weights, made from the run's seed on the device.

One ``torch.randn`` call on a generator of the card fills every random
leaf at once; each leaf is a view of that buffer, scaled: embeddings
(tokens and positions) normal(0, 0.02) clipped to two deviations, dense
weights ``[d_in, d_out]`` normal(0, 1 / sqrt(d_in)), norm scales one and
biases zero. The names are the state names of ``repro_torch``'s
``ColBERT``, so the program loads the dict as it is; the reference
reads the same tensors.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def leaves(model: dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every weight; kind is ``embed``, ``dense``,
    ``ones`` or ``zeros``."""
    d, ff = model["d_model"], model["d_ff"]
    out = [("trunk.embed.table", (model["vocab_size"], d), "embed"),
           ("trunk.pos_embed.table", (model["max_seq_len"], d), "embed")]
    for i in range(model["n_layers"]):
        p = f"trunk.layers.{i}."
        out += [(p + "attn_norm.scale", (d,), "ones"),
                (p + "attn_norm.bias", (d,), "zeros")]
        out += [(p + f"attn.{n}.w", (d, d), "dense")
                for n in ("wq", "wk", "wv", "wo")]
        out += [(p + "mlp_norm.scale", (d,), "ones"),
                (p + "mlp_norm.bias", (d,), "zeros"),
                (p + "mlp.w1.w", (d, ff), "dense"),
                (p + "mlp.w2.w", (ff, d), "dense")]
    out += [("trunk.final_norm.scale", (d,), "ones"),
            ("trunk.final_norm.bias", (d,), "zeros"),
            ("proj.w", (d, model["proj_dim"]), "dense")]
    return out


@torch.no_grad()
def make_weights(model: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """f32 weights (the configurations' parameter type) on ``device``."""
    spec = leaves(model)
    n = sum(math.prod(s) for _, s, k in spec if k in ("embed", "dense"))
    g = torch.Generator(device=device).manual_seed(int(seed))
    buf = torch.randn(n, generator=g, device=device)
    out, at = {}, 0
    for name, shape, kind in spec:
        if kind == "ones":
            out[name] = torch.ones(shape, device=device)
            continue
        if kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
            continue
        size = math.prod(shape)
        t = buf[at:at + size].view(shape)
        at += size
        if kind == "embed":
            t.clamp_(-2.0, 2.0).mul_(0.02)
        else:
            t.mul_(1.0 / math.sqrt(shape[0]))
        out[name] = t
    return out
