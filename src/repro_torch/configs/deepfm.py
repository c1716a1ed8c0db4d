"""DeepFM [arXiv:1703.04247]: n_sparse=39 embed_dim=10 mlp=400-400-400
interaction=fm.
Copy of ``src/repro/configs/deepfm.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="deepfm",
    kind="deepfm",
    n_sparse=39,
    embed_dim=10,
    mlp_dims=(400, 400, 400),
    interaction="fm",
    vocab_sizes=tuple([1_000_000] * 39),
)

SMOKE = RecsysConfig(
    name="deepfm-smoke",
    kind="deepfm",
    n_sparse=5,
    embed_dim=6,
    mlp_dims=(24, 24),
    interaction="fm",
    vocab_sizes=tuple([100] * 5),
)
