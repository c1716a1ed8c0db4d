"""Layer substrate of the trunks: dense, RMSNorm / LayerNorm, embedding,
activations.

Counterparts of ``src/repro/models/layers.py``. Parameters keep the JAX
package's layout (a dense weight ``w`` is ``[d_in, d_out]``) so
``params_from_jax`` is a rename. Parameters stay in their param dtype;
activations are cast on entry, as in the reference:

  * ``dense`` casts weight (and bias) to the input's dtype, then ``@``;
    over a mesh a weight's FSDP shards are gathered first
    (``gather_fsdp``);
  * ``RMSNorm`` and ``LayerNorm`` compute in f32 and cast back to the
    input's dtype; ``norm`` picks one by the config's name;
  * ``embed`` casts the table first, then gathers (``F.embedding``,
    whose backward on the card sums each row's gradient by sorting the
    ids, not by atomics: a train step is deterministic);
  * GELU is the tanh form (``jax.nn.gelu``'s default); ``act_fn`` maps
    the reference's activation names (silu, gelu, relu, tanh).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}


def dt(name: str) -> torch.dtype:
    return DTYPES[name]


def trunc_normal_(t: torch.Tensor, std: float,
                  generator: torch.Generator) -> torch.Tensor:
    """In place: normal(0, std) truncated to [-2 std, 2 std] by inverse
    CDF (the distribution of ``jax.random.truncated_normal(-2, 2) * std``)."""
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    hi = 0.5 * (1.0 + math.erf(2.0 / math.sqrt(2.0)))
    with torch.no_grad():
        u = torch.empty_like(t).uniform_(2 * lo - 1, 2 * hi - 1,
                                         generator=generator)
        t.copy_(torch.erfinv(u) * (math.sqrt(2.0) * std))
    return t


class Dense(nn.Module):
    """y = x @ w (+ b), w [d_in, d_out], computed in x's dtype."""

    def __init__(self, d_in: int, d_out: int, bias: bool = False,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.w = nn.Parameter(torch.empty(d_in, d_out, device=device,
                                          dtype=dtype))
        self.b = (nn.Parameter(torch.zeros(d_out, device=device, dtype=dtype))
                  if bias else None)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """normal(0, 1/sqrt(d_in)) weight, zero bias (``init_dense``)."""
        with torch.no_grad():
            self.w.normal_(0.0, 1.0 / math.sqrt(self.w.shape[0]),
                           generator=generator)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = gather_fsdp(self.w.to(x.dtype))
        y = _batched(x, w) if _folds_shards(x) else x @ w
        if self.b is not None:
            y = y + self.b.to(y.dtype)
        return y


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * scale in f32, cast back to x's dtype."""

    def __init__(self, d: int, eps: float, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """LayerNorm in f32, cast back to the input's dtype."""

    def __init__(self, d: int, eps: float, device=None, dtype=torch.float32):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(d, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(d, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.scale.float() + self.bias.float()).to(x.dtype)


class Embed(nn.Module):
    """Lookup table; ``forward`` casts the table, then gathers."""

    def __init__(self, vocab: int, d: int, device=None, dtype=torch.float32):
        super().__init__()
        self.table = nn.Parameter(torch.empty(vocab, d, device=device,
                                              dtype=dtype))

    def reset_parameters(self, generator: torch.Generator) -> None:
        trunc_normal_(self.table, 0.02, generator)

    def forward(self, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.embedding(ids, gather_fsdp(self.table.to(dtype)))


def _folds_shards(x: torch.Tensor) -> bool:
    """Whether ``x @ w`` would fold a sharded dim of ``x`` other than its
    first into the product's rows (a ``DTensor`` split on a middle dim:
    sequence parallelism's [batch, seq] activations), which not every
    torch's sharding rules can do."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor) and any(
        p.is_shard() and 0 < p.dim < x.ndim - 1 for p in x.placements)


def _batched(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, ..., d_in] @ w [d_in, d_out] as one batched product over B
    (the weight broadcast), the other leading dims kept apart."""
    lead = x.shape[1:-1]
    x3 = x.reshape(x.shape[0], -1, x.shape[-1]) if len(lead) != 1 else x
    y = torch.bmm(x3, w.expand(x.shape[0], *w.shape))
    return y if len(lead) == 1 else y.reshape(*x.shape[:-1], w.shape[-1])


def gather_fsdp(w: torch.Tensor) -> torch.Tensor:
    """A weight laid out over a mesh gathered over its FSDP shards (every
    mesh axis but ``model``, ``sharding/params.py``) before use, its
    tensor-parallel shards kept; its gradient comes back reduce-scattered
    to the FSDP shard. A plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    names = w.device_mesh.mesh_dim_names
    place = [Replicate() if p.is_shard() and names[i] != "model" else p
             for i, p in enumerate(w.placements)]
    if place == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, place)


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def norm(kind: str, d: int, eps: float, device=None,
         dtype=torch.float32) -> nn.Module:
    """The norm a config names: ``"rmsnorm"`` or ``"layernorm"``."""
    if kind == "rmsnorm":
        return RMSNorm(d, eps, device, dtype)
    if kind == "layernorm":
        return LayerNorm(d, eps, device, dtype)
    raise ValueError(f"unknown norm {kind!r}")


ACTS = {"silu": F.silu, "gelu": gelu, "relu": F.relu, "tanh": torch.tanh}


def act_fn(name: str):
    return ACTS[name]
