"""Wide & Deep [arXiv:1606.07792]: n_sparse=40 embed_dim=32
mlp=1024-512-256 interaction=concat.
Copy of ``src/repro/configs/wide_deep.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="wide-deep",
    kind="wide_deep",
    n_sparse=40,
    embed_dim=32,
    mlp_dims=(1024, 512, 256),
    interaction="concat",
    vocab_sizes=tuple([1_000_000] * 40),
)

SMOKE = RecsysConfig(
    name="wide-deep-smoke",
    kind="wide_deep",
    n_sparse=6,
    embed_dim=8,
    mlp_dims=(32, 16),
    interaction="concat",
    vocab_sizes=tuple([100] * 6),
)
