"""Factorization Machine [ICDM'10 Rendle]: n_sparse=39 embed_dim=10,
pairwise <v_i, v_j> x_i x_j via the O(nk) sum-square trick.
Copy of ``src/repro/configs/fm.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import RecsysConfig

CONFIG = RecsysConfig(
    name="fm",
    kind="fm",
    n_sparse=39,
    embed_dim=10,
    interaction="fm-2way",
    vocab_sizes=tuple([1_000_000] * 39),
)

SMOKE = RecsysConfig(
    name="fm-smoke",
    kind="fm",
    n_sparse=5,
    embed_dim=6,
    interaction="fm-2way",
    vocab_sizes=tuple([100] * 5),
)
