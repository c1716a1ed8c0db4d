"""RecSys architectures: Wide&Deep, DeepFM, FM, DLRM-RM2
(``src/repro/models/recsys/models.py``).

Shared anatomy: huge sparse embedding tables (``embedding.py``) ->
feature interaction (dot | FM sum-square | concat) -> small dense MLP ->
CTR logit.

FM 2-way interactions use the O(n*k) sum-square identity (Rendle, ICDM'10):
    sum_{i<j} <v_i, v_j> x_i x_j = 1/2 * [ (sum_i v_i)^2 - sum_i v_i^2 ]
so the pairwise term never materializes the [F, F] matrix.

``score_candidates`` is the retrieval_cand cell: one user's vector (the
mean of its embedding bags) against C candidate embeddings, one
[B, D] x [D, C] product and a top-k with ties to the lower candidate id
(``lax.top_k``'s order).

``Recsys`` holds the reference's tree: ``tables`` [F, V, D], ``wide``
[F, V, 1], ``bias`` (a scalar), ``bot_mlp`` / ``top_mlp`` (dlrm) or
``deep_mlp`` (wide_deep, deepfm) as lists of dense layers with biases,
``dense_lin`` where the model has dense features.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from repro_torch.core.maxsim import stable_topk
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models.layers import Dense, act_fn, dt
from repro_torch.models.recsys.embedding import embedding_bag, init_tables
from repro_torch.sharding.api import constrain
from repro_torch.train.params import from_tree, group, to_tree


def _mlp_stack(d_in: int, dims, device, dtype) -> nn.ModuleList:
    layers = []
    for d_out in dims:
        layers.append(Dense(d_in, d_out, True, device, dtype))
        d_in = d_out
    return nn.ModuleList(layers)


def _run_mlp(layers, x, act: str = "relu", last_linear: bool = True):
    a = act_fn(act)
    for i, layer in enumerate(layers):
        x = layer(x)
        if i < len(layers) - 1 or not last_linear:
            x = a(x)
    return x


class Recsys(nn.Module):
    def __init__(self, cfg, device: DeviceLike = None):
        super().__init__()
        device = resolve_device(device)
        pdt = dt(cfg.param_dtype)
        self.cfg = cfg
        F_, V, D = cfg.n_sparse, max(cfg.vocab_sizes), cfg.embed_dim
        self.tables = nn.Parameter(torch.empty(F_, V, D, device=device,
                                               dtype=pdt))
        # linear (1st-order / wide) weights: one scalar weight per row
        self.wide = nn.Parameter(torch.empty(F_, V, 1, device=device,
                                             dtype=pdt))
        self.bias = nn.Parameter(torch.zeros((), device=device, dtype=pdt))
        self.bot_mlp = self.top_mlp = self.deep_mlp = None
        self.dense_lin = None
        if cfg.kind == "dlrm":
            self.bot_mlp = _mlp_stack(cfg.n_dense, cfg.bot_mlp_dims, device,
                                      pdt)
            n_emb = cfg.n_sparse + 1                   # + bottom-MLP vector
            d_top = n_emb * (n_emb - 1) // 2 + cfg.bot_mlp_dims[-1]
            self.top_mlp = _mlp_stack(d_top, cfg.top_mlp_dims, device, pdt)
        elif cfg.kind in ("wide_deep", "deepfm", "fm"):
            if cfg.kind != "fm":
                self.deep_mlp = _mlp_stack(F_ * D + cfg.n_dense,
                                           cfg.mlp_dims + (1,), device, pdt)
            if cfg.n_dense:
                self.dense_lin = Dense(cfg.n_dense, 1, False, device, pdt)
        else:
            raise ValueError(cfg.kind)

    @property
    def device(self) -> torch.device:
        return self.tables.device

    def reset_parameters(self, generator: torch.Generator) -> None:
        """The tables truncated-normal(1/sqrt(D)), the wide tables
        truncated-normal(1), the bias 0 (``init_recsys``)."""
        init_tables(self.tables, generator)
        init_tables(self.wide, generator)
        with torch.no_grad():
            self.bias.zero_()

    def load_params(self, state: Dict[str, np.ndarray]) -> "Recsys":
        """Load a ``params_from_jax`` state (numpy arrays) in place."""
        self.load_state_dict({k: torch.as_tensor(np.array(v))
                              for k, v in state.items()}, strict=True)
        return self


def init_recsys(cfg, generator: Optional[torch.Generator] = None, *,
                seed: int = 0, device: DeviceLike = None) -> Recsys:
    """Random weights with the reference initializers' laws."""
    model = Recsys(cfg, device)
    if model.device.type == "meta":     # shapes only: nothing to draw
        return model
    if generator is None:
        generator = torch.Generator(device=model.device).manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (Recsys, Dense)):
            m.reset_parameters(generator)
    return model


def params_from_jax(tree) -> Dict[str, np.ndarray]:
    """The reference's ``init_recsys`` tree -> a ``Recsys`` state (the
    MLP lists as ``bot_mlp.<i>`` etc.)."""
    return from_tree(tree)


def params_to_jax(state) -> Dict:
    """A ``Recsys`` state -> the reference's tree of host arrays."""
    return to_tree(group(state.items()))


def _fm_second_order(emb: torch.Tensor) -> torch.Tensor:
    """emb: [B, F, D] -> [B] via the sum-square trick (O(F*D))."""
    s = emb.sum(dim=1)                                # [B, D]
    ss = (emb * emb).sum(dim=1)                       # [B, D]
    return 0.5 * (s * s - ss).sum(dim=-1)


def _dot_interaction(vecs: torch.Tensor) -> torch.Tensor:
    """vecs: [B, n, D] -> lower-triangle pairwise dots [B, n(n-1)/2];
    over a mesh (a ``DTensor`` split by batch rows) each rank's own rows,
    a sample's dots being its own."""
    from torch.distributed.tensor import DTensor
    if isinstance(vecs, DTensor):
        from repro_torch.sharding.api import from_local
        if any(p.is_shard() and p.dim != 0 for p in vecs.placements):
            raise ValueError(f"interaction over {vecs.placements}")
        out = _dot_interaction(vecs.to_local())
        return from_local(out, vecs.device_mesh, vecs.placements,
                          (vecs.shape[0], out.shape[1]))
    n = vecs.shape[1]
    g = torch.einsum("bnd,bmd->bnm", vecs, vecs)      # [B, n, n]
    iu = torch.triu_indices(n, n, 1, device=vecs.device)
    return g[:, iu[0], iu[1]]


def _batch(model: Recsys, batch) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=model.device)
            for k, v in batch.items()}


def recsys_forward(model: Recsys, batch, cfg=None) -> torch.Tensor:
    """batch: {sparse_ids [B, F, M] int, dense [B, n_dense] f32 (opt)}
    (tensors or host arrays) -> CTR logits [B] f32."""
    cfg = cfg or model.cfg
    cdt = dt(cfg.dtype)
    b = _batch(model, batch)
    ids = b["sparse_ids"]
    B = ids.shape[0]
    emb = constrain(embedding_bag(model.tables, ids, dtype=cdt),
                    "batch", None, "embed")           # [B, F, D]
    # first-order term (all models)
    wide = embedding_bag(model.wide, ids, dtype=cdt)
    logit = wide.sum(dim=(1, 2)) + model.bias.to(cdt)

    dense_x = b.get("dense")
    if dense_x is not None:
        dense_x = dense_x.to(cdt)

    if cfg.kind == "fm":
        logit = logit + _fm_second_order(emb)
        if dense_x is not None and model.dense_lin is not None:
            logit = logit + model.dense_lin(dense_x)[:, 0]
    elif cfg.kind == "deepfm":
        logit = logit + _fm_second_order(emb)
        flat = emb.reshape(B, -1)
        if dense_x is not None:
            flat = torch.cat([flat, dense_x], -1)
        logit = logit + _run_mlp(model.deep_mlp, flat)[:, 0]
    elif cfg.kind == "wide_deep":
        flat = emb.reshape(B, -1)                     # interaction=concat
        if dense_x is not None:
            flat = torch.cat([flat, dense_x], -1)
        logit = logit + _run_mlp(model.deep_mlp, flat)[:, 0]
    elif cfg.kind == "dlrm":
        bot = _run_mlp(model.bot_mlp, dense_x, last_linear=False)
        vecs = torch.cat([bot[:, None, :], emb], dim=1)
        top_in = torch.cat([bot, _dot_interaction(vecs)], -1)
        logit = logit + _run_mlp(model.top_mlp, top_in)[:, 0]
    return constrain(logit.float(), "batch")


def recsys_loss(model: Recsys, batch, cfg=None):
    """Binary cross-entropy on CTR labels [B] in {0, 1} -> (loss,
    {"loss", "auc_proxy"})."""
    logits = recsys_forward(model, batch, cfg)
    y = torch.as_tensor(batch["label"], device=logits.device).float()
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-logits.abs())))
    return loss, {"loss": loss,
                  "auc_proxy": ((logits > 0) == (y > 0.5)).float().mean()}


def score_candidates(model: Recsys, batch, candidates, cfg=None,
                     k: int = 100):
    """retrieval_cand: the user vector (the mean over fields of its
    embedding bags) against candidates [C, D] -> (scores [B, k] f32,
    ids [B, k]), ties to the lower candidate id."""
    cfg = cfg or model.cfg
    cdt = dt(cfg.dtype)
    ids = torch.as_tensor(batch["sparse_ids"], device=model.device)
    user = embedding_bag(model.tables, ids, dtype=cdt).mean(dim=1)  # [B, D]
    cand = constrain(torch.as_tensor(candidates, device=model.device).to(cdt),
                     "candidates", None)
    scores = constrain(user @ cand.T, "batch", "candidates")
    return stable_topk(scores.float(), k)
