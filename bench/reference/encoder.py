"""ColBERT's encoder in plain PyTorch (f32, or the fp8 control).

The trunk as ``bench/configs/*.json`` states it: learned positions,
pre-norm blocks (LayerNorm, then bidirectional softmax attention over
the unpadded tokens, then LayerNorm and a GELU (tanh form) MLP, each
added to the residual stream), a final LayerNorm, a linear projection
to ``proj_dim`` and L2 normalisation (ColBERT, arXiv:2004.12832, with
the pre-norm trunk of the configurations; the published BERT is
post-norm, see ``PERF.md``). Documents are ``[CLS][D]`` + body, padded
positions masked out of attention and not emitted, punctuation ids
(8..23) not emitted; queries are ``[CLS][Q]`` + body with every pad
turned into ``[MASK]``, all positions attended and emitted.

Weights are a dict of tensors under the benchmark's names
(``bench/weights.py``), dense weights laid out ``[d_in, d_out]``.
"""
from __future__ import annotations

import math
from typing import Dict

import torch

PAD, CLS, MASK, Q_MARK, D_MARK = 0, 1, 3, 4, 5
PUNCT_LO, PUNCT_HI = 8, 24


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude onto e4m3's 448), back in f32."""
    s = torch.clamp(t.abs().amax(), min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class Precision:
    """The encoder's products in f32, or with fp8 operands (``"fp8"``);
    ``"tf32"`` leaves the encoder in f32 and rounds the index stages'
    products (``reference/index.py``)."""

    def __init__(self, name: str):
        if name not in ("f32", "fp8", "tf32"):
            raise ValueError(f"unknown precision {name!r}")
        self.fp8 = name == "fp8"
        self.tf32 = name == "tf32"

    def op(self, t: torch.Tensor) -> torch.Tensor:
        return fp8_round(t) if self.fp8 else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return self.op(x) @ self.op(w)


def _layernorm(x, g, b, eps):
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * g + b


def _gelu(x):
    return 0.5 * x * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi)
                                       * (x + 0.044715 * x ** 3)))


def trunk(w: Dict[str, torch.Tensor], model: dict, ids: torch.Tensor,
          attend: torch.Tensor, prec: Precision) -> torch.Tensor:
    """ids [B, L] int64, attend [B, L] bool (keys a token may attend to)
    -> unit vectors [B, L, proj_dim] f32."""
    B, L = ids.shape
    H = model["n_heads"]
    d = model["d_model"]
    dh = d // H
    eps = model["norm_eps"]
    x = w["trunk.embed.table"][ids] + w["trunk.pos_embed.table"][:L][None]
    neg = torch.zeros((B, 1, 1, L), device=ids.device)
    neg = neg.masked_fill(~attend[:, None, None, :], float("-inf"))
    for i in range(model["n_layers"]):
        p = f"trunk.layers.{i}."
        h = _layernorm(x, w[p + "attn_norm.scale"], w[p + "attn_norm.bias"],
                       eps)
        q = prec.mm(h, w[p + "attn.wq.w"]).view(B, L, H, dh).transpose(1, 2)
        k = prec.mm(h, w[p + "attn.wk.w"]).view(B, L, H, dh).transpose(1, 2)
        v = prec.mm(h, w[p + "attn.wv.w"]).view(B, L, H, dh).transpose(1, 2)
        s = prec.op(q) @ prec.op(k).transpose(-1, -2) / math.sqrt(dh) + neg
        a = torch.softmax(s, dim=-1)
        o = (prec.op(a) @ prec.op(v)).transpose(1, 2).reshape(B, L, d)
        x = x + prec.mm(o, w[p + "attn.wo.w"])
        h = _layernorm(x, w[p + "mlp_norm.scale"], w[p + "mlp_norm.bias"],
                       eps)
        x = x + prec.mm(_gelu(prec.mm(h, w[p + "mlp.w1.w"])),
                        w[p + "mlp.w2.w"])
    x = _layernorm(x, w["trunk.final_norm.scale"], w["trunk.final_norm.bias"],
                   eps)
    y = prec.mm(x, w["proj.w"])
    return y / torch.clamp(y.norm(dim=-1, keepdim=True), min=1e-9)


def doc_inputs(tokens: torch.Tensor, doc_maxlen: int):
    """Raw ids [B, L0] -> (ids [B, doc_maxlen], attend, emit)."""
    body = tokens[:, :doc_maxlen - 2].long()
    body = torch.nn.functional.pad(body, (0, doc_maxlen - 2 - body.shape[1]))
    head = torch.tensor([CLS, D_MARK], device=tokens.device)
    ids = torch.cat([head.expand(len(body), 2), body], 1)
    attend = ids != PAD
    emit = attend & ~((ids >= PUNCT_LO) & (ids < PUNCT_HI))
    return ids, attend, emit


def query_inputs(tokens: torch.Tensor, query_maxlen: int):
    """Raw ids [B, L0] -> ids [B, query_maxlen] ([MASK] for pads)."""
    body = tokens[:, :query_maxlen - 2].long()
    body = torch.nn.functional.pad(body,
                                   (0, query_maxlen - 2 - body.shape[1]))
    body = torch.where(body == PAD, torch.full_like(body, MASK), body)
    head = torch.tensor([CLS, Q_MARK], device=tokens.device)
    return torch.cat([head.expand(len(body), 2), body], 1)


@torch.no_grad()
def encode_queries(w, model: dict, tokens: torch.Tensor, prec: Precision,
                   batch: int = 256) -> torch.Tensor:
    """Raw query ids [N, L0] -> [N, query_maxlen, proj_dim] unit vectors."""
    out = []
    for lo in range(0, len(tokens), batch):
        ids = query_inputs(tokens[lo:lo + batch], model["query_maxlen"])
        out.append(trunk(w, model, ids, torch.ones_like(ids, dtype=torch.bool),
                         prec))
    return torch.cat(out)


@torch.no_grad()
def encode_docs(w, model: dict, tokens: torch.Tensor, prec: Precision,
                batch: int = 128):
    """Raw doc ids [N, L0] -> (vectors [N, doc_maxlen, dim] with zero
    rows where nothing is emitted, emit [N, doc_maxlen] bool). Batches
    of documents of similar length are cut to their longest document:
    attention is masked to the real tokens, so trailing pads change no
    emitted vector."""
    ids, attend, emit = doc_inputs(tokens, model["doc_maxlen"])
    N, L = ids.shape
    out = torch.zeros((N, L, model["proj_dim"]), device=ids.device)
    lens = attend.sum(1)
    order = torch.argsort(lens, descending=True)
    for lo in range(0, N, batch):
        sel = order[lo:lo + batch]
        n = int(lens[sel].max())
        v = trunk(w, model, ids[sel, :n], attend[sel, :n], prec)
        out[sel, :n] = v * emit[sel, :n, None]
    return out, emit
