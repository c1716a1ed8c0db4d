"""The port's ``flash_attention`` (``repro_torch.kernels.flash_attention``)
against the JAX package's (``repro.kernels.flash_attention.ops``), whose
Pallas kernel runs in interpret mode on the CPU, as ``test_kernels.py``
runs it. On CPU tensors the port's wrapper runs its plain version, which
follows the TPU kernel's contract (f32-scaled q, bottom-right causal
anchor, p cast to v's dtype, zero-mass rows 0).

Tolerances: f32 1e-5 (the same f32 arithmetic; the Pallas kernel's
online softmax rescales by the running max, the plain version by the
row max); bf16 ``test_kernels.py``'s: rtol 2e-2, atol 8e-2 (p and the
output are rounded to bf16 at different scales on the two sides).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro_torch.kernels import launch_counts
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_bh)
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

TOL = {"float32": dict(rtol=1e-5, atol=1e-5),
       "bfloat16": dict(rtol=2e-2, atol=8e-2)}
J_DT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
T_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(b, h, kv, sq, skv, dh, dtype, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=(b, n, s, dh)).astype(np.float32)
            for n, s in ((h, sq), (kv, skv), (kv, skv))]
    jx = [jnp.asarray(a, J_DT[dtype]) for a in arrs]
    # the bf16 values JAX sees, carried over exactly through f32
    tx = [torch.from_numpy(np.array(a.astype(jnp.float32))).to(T_DT[dtype])
          for a in jx]
    return jx, tx


def _both(b, h, kv, sq, skv, dh, causal, dtype, seed):
    (jq, jk, jv), (tq, tk, tv) = _inputs(b, h, kv, sq, skv, dh, dtype, seed)
    jo = j_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64)
    before = launch_counts()["flash_attention"]
    to = flash_attention(tq, tk, tv, causal=causal)
    assert launch_counts()["flash_attention"] == before    # CPU: no launch
    assert to.dtype == T_DT[dtype] and tuple(to.shape) == (b, h, sq, dh)
    return np.asarray(jo.astype(jnp.float32)), to.float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,sq,skv,dh,causal", [
    (2, 4, 2, 128, 128, 64, True),      # GQA group 2
    (1, 8, 8, 256, 256, 128, True),     # MHA, dh 128
    (2, 4, 1, 128, 512, 64, False),     # group 4, non-causal
    (1, 4, 2, 128, 512, 64, True),      # Sq < Skv: bottom-right anchor
    (1, 2, 2, 64, 64, 128, True),
    (1, 16, 2, 128, 192, 112, True),    # Kimi K2's dh 112, group 8
])
def test_matches_reference_kernel(b, h, kv, sq, skv, dh, causal, dtype):
    jo, to = _both(b, h, kv, sq, skv, dh, causal, dtype, sq + skv)
    np.testing.assert_allclose(to, jo, **TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sq_above_skv_rows_are_exact_zeros(dtype):
    """Sq > Skv: the first Sq - Skv rows see no column; both give 0."""
    jo, to = _both(1, 4, 2, 128, 64, 64, True, dtype, 7)
    assert (jo[:, :, :64] == 0).all() and (to[:, :, :64] == 0).all()
    np.testing.assert_allclose(to, jo, **TOL[dtype])


def test_plain_version_is_the_kernel_contract():
    """[B*H, S, dh] layout, program bh reading kv row bh // group, and
    the plain version's arithmetic written out."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.normal(size=(6, 10, 64)).astype(np.float32))
    k = torch.from_numpy(rng.normal(size=(2, 13, 64)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(2, 13, 64)).astype(np.float32))
    got = flash_attention_bh(q, k, v, causal=True)
    assert torch.equal(got, flash_attention_ref(q, k, v, causal=True))
    for bh in range(6):
        kv = bh // 3
        s = (q[bh] * np.float32(0.125)) @ k[kv].T
        vis = torch.arange(10)[:, None] + 3 >= torch.arange(13)[None, :]
        w = torch.softmax(s.masked_fill(~vis, float("-inf")), dim=-1)
        torch.testing.assert_close(got[bh], w @ v[kv], rtol=1e-5, atol=1e-5)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    q = torch.zeros(4, 8, 64)
    with pytest.raises(ValueError):
        flash_attention_bh(q, torch.zeros(3, 8, 64), torch.zeros(3, 8, 64))
    with pytest.raises(ValueError):
        flash_attention_bh(q, torch.zeros(2, 8, 32), torch.zeros(2, 8, 32))
    with pytest.raises(ValueError):
        flash_attention_bh(q, q, q, impl="kernel")
