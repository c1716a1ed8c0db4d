"""DimeNet [arXiv:2003.03123]: n_blocks=6 d_hidden=128 n_bilinear=8
n_spherical=7 n_radial=6.
Copy of ``src/repro/configs/dimenet.py``
(``CONFIG`` and the test-size ``SMOKE``).
"""
from repro_torch.configs.base import DimeNetConfig

CONFIG = DimeNetConfig(
    name="dimenet",
    n_blocks=6,
    d_hidden=128,
    n_bilinear=8,
    n_spherical=7,
    n_radial=6,
)

SMOKE = DimeNetConfig(
    name="dimenet-smoke",
    n_blocks=2,
    d_hidden=32,
    n_bilinear=4,
    n_spherical=3,
    n_radial=4,
    triplet_cap=4,
)
