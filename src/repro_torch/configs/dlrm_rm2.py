"""DLRM RM2 [arXiv:1906.00091]: n_dense=13 n_sparse=26 embed_dim=64
bot_mlp=13-512-256-64 top_mlp=512-512-256-1 interaction=dot.
Copy of ``src/repro/configs/dlrm_rm2.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="dlrm-rm2",
    kind="dlrm",
    n_dense=13,
    n_sparse=26,
    embed_dim=64,
    bot_mlp_dims=(512, 256, 64),
    top_mlp_dims=(512, 512, 256, 1),
    interaction="dot",
    vocab_sizes=tuple([1_000_000] * 26),
)

SMOKE = RecsysConfig(
    name="dlrm-smoke",
    kind="dlrm",
    n_dense=4,
    n_sparse=5,
    embed_dim=8,
    bot_mlp_dims=(16, 8),
    top_mlp_dims=(16, 8, 1),
    interaction="dot",
    vocab_sizes=tuple([100] * 5),
)
