"""The benchmark's roofline counts and FLOP counts at known shapes."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from bench import roofline  # noqa: E402
from bench.metrics import idle_percent, mfu_percent  # noqa: E402


def test_ward_pool_counts():
    x = torch.zeros(2, 8, 4)
    mask = torch.zeros(2, 8, dtype=torch.bool)
    mask[0, :6] = True               # n 6: k 4, 2 merges
    mask[1, :3] = True               # n 3: k 2, 1 merge
    products, other, n_bytes = roofline.ward_pool_counts(x, mask, 2)
    assert int(products) == (6 * 5 + 3 * 2) * 4
    assert int(other) == (2 * 6 + 1 * 3) * 12
    assert n_bytes == 2 * 8 * 4 * 4 + 2 * 8 + 2 * 8 * 4


def test_plaid_probe_counts():
    Nq, Lq, dim, K, C, L = 2, 4, 8, 16, 3, 5
    q = torch.zeros(Nq, Lq, dim)
    qm = torch.ones(Nq, Lq, dtype=torch.bool)
    qm[1, 3] = False                                     # 4 + 3 tokens
    cand = torch.tensor([[True, True, False], [True, False, False]])
    code_mask = torch.ones(Nq, C, L, dtype=torch.bool)
    code_mask[0, 1, 4] = False                           # 9 and 5 tokens
    p, o, b = roofline.plaid_probe_counts(q, qm, torch.zeros(K, dim),
                                          torch.zeros(Nq, C, L), code_mask,
                                          cand)
    assert int(p) == 7 * K * dim * 2
    assert int(o) == (9 * 4 + 5 * 3) * 2
    assert int(b) == (Nq * Lq * (dim * 4 + 1) + K * dim * 4 + Nq * C
                      + 3 * L * 5 + Nq * C * 4)


def test_maxsim_packed_counts():
    Nq, Lq, dim, S, Ld, W = 2, 3, 16, 4, 5, 1
    qm = torch.ones(Nq, Lq, dtype=torch.bool)
    dm = torch.zeros(Nq, S, Ld, dtype=torch.bool)
    dm[0, 0, :2] = True                                  # 2 tokens
    dm[1, :, 0] = True                                   # 4 tokens
    p, o, b = roofline.maxsim_packed_counts(
        torch.zeros(Nq, Lq, dim), qm, torch.zeros(Nq, S, Ld, W),
        torch.zeros(Nq, S, Ld), dm, torch.zeros(7, dim), torch.zeros(dim, 4))
    pairs = 3 * 2 + 3 * 4
    assert int(p) == pairs * dim * 2
    assert int(o) == 6 * dim * 4 + pairs
    assert int(b) == (Nq * Lq * (dim * 4 + 1) + Nq * S * Ld + 7 * dim * 4
                      + dim * 4 * 4 + 6 * (4 * W + 4) + Nq * S * 4)


def test_bound_takes_the_larger_term():
    assert roofline.bound_s(494.7e12, 0, 0) == pytest.approx(1.0)
    assert roofline.bound_s(0, 67e12, 0) == pytest.approx(1.0)
    assert roofline.bound_s(494.7e12, 0, 3.35e12 * 2) == pytest.approx(2.0)


def test_encoder_flops_bert_base():
    m = dict(n_layers=12, d_model=768, d_ff=3072, proj_dim=128)
    per_layer = 2 * 32 * (4 * 768 * 768 + 2 * 768 * 3072) + 4 * 32 * 32 * 768
    assert roofline.encoder_flops(m, [32]) == 12 * per_layer + 2 * 32 * 768 * 128
    assert roofline.encoder_flops(m, [32, 32]) == 2 * roofline.encoder_flops(
        m, [32])


def test_share_and_readers():
    ctx = {"counts": {"ward_pool": (1, 494.7e12 * 1e-3, 0.0, 0.0)},
           "kernel_s": {"void ward_pool_kernel<false>(...)": 4e-3},
           "busy_s": 3.0, "trace_window_s": 4.0, "window_s": 2.0,
           "flops_bf16": 989e12 * 0.1}
    assert roofline.share(ctx, "ward_pool") == pytest.approx(25.0)
    assert roofline.share(ctx, "plaid_probe") is None
    assert idle_percent(ctx) == pytest.approx(25.0)
    assert mfu_percent(ctx) == pytest.approx(5.0)
