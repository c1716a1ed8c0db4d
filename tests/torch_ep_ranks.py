"""One rank of ``tests/test_torch_moe_ep.py``'s expert-parallel run:
``python tests/torch_ep_ranks.py IN.npz OUT_DIR RANK WORLD STORE``.

It imports the port only (no JAX). The rank joins a gloo group over a
``FileStore`` at STORE, builds the (2, 2) ("data", "model") mesh, loads
the MoE layer the JAX package drew (IN.npz: its parameter tree flattened
with "/", the batch ``x`` and the capacities), and runs ``moe_ep`` on
its data shard of ``x``:

* with the whole weights on every rank, at each capacity: y, aux and
  the two keep masks (``stats``), then the gradient of sum(y) in ``w1``;
* with the weights as DTensors laid out by ``lm_param_rules("data")``
  (``distribute_params``: experts over ``model``, their FSDP dim over
  ``data``): y and the gradient in ``w1`` and the router;
* ``constrain`` of a [4, 6] tensor to ("batch", "ff") under ``lm_rules``.

It writes OUT_DIR/rank<RANK>.npz.
"""
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))


def main(inp, out_dir, rank, world, store_path):
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch.mesh import make_mesh, process_group
    from repro_torch.models import moe
    from repro_torch.sharding.api import constrain, lm_rules, mesh_context
    from repro_torch.sharding.params import (distribute_params,
                                             lm_param_rules)
    z = np.load(inp)
    cfg = get_smoke_config(str(z["arch"]))
    state = {k[len("p/"):].replace("/", "."): torch.from_numpy(z[k])
             for k in z.files if k.startswith("p/")}
    x = torch.from_numpy(z["x"])
    out = {}
    store = dist.FileStore(store_path, world)
    with process_group("cpu", world_size=world, rank=rank, store=store):
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        d = mesh.get_local_rank("data")
        rows = x.shape[0] // 2
        xl = x[d * rows:(d + 1) * rows]
        layer = moe.MoE(cfg)
        layer.load_state_dict(state)
        with mesh_context(mesh, lm_rules("data")):
            for cap in z["capacities"]:
                st = {}
                y, aux = moe.moe_ep(layer, xl, cfg, capacity=int(cap),
                                    stats=st)
                out[f"y{cap}"] = y.detach().numpy()
                out[f"aux{cap}"] = float(aux)
                out[f"keep{cap}"] = st["keep"].numpy()
                out[f"keep2_{cap}"] = st["keep2"].numpy()
                out[f"caps{cap}"] = np.array([st["cap_send"], st["C_loc"]])
            y, _ = moe.moe_ep(layer, xl, cfg, capacity=int(z["capacities"][0]))
            y.sum().backward()
            out["w1_grad"] = layer.w1.grad.numpy()

            sharded = moe.MoE(cfg)
            sharded.load_state_dict(state)
            distribute_params(sharded, mesh, lm_param_rules("data"),
                              prefix="moe/")
            y2, aux2 = moe.moe_ep(sharded, xl, cfg,
                                  capacity=int(z["capacities"][0]))
            y2.sum().backward()
            out["y_dtensor"] = y2.detach().numpy()
            out["aux_dtensor"] = float(aux2)
            out["w1_local_shape"] = np.array(
                sharded.w1.to_local().shape)
            out["w1_grad_dtensor"] = sharded.w1.grad.full_tensor().numpy()
            out["router_grad_dtensor"] = \
                sharded.router.w.grad.full_tensor().numpy()
            c = constrain(torch.arange(24.0).reshape(4, 6), "batch", "ff")
            out["constrain_local"] = c.to_local().numpy()
            out["coords"] = np.array([d, mesh.get_local_rank("model")])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         sys.argv[5])
