"""K4's plain version and the port's attention ops against the JAX
package (CPU).

Inputs are drawn with numpy from a seed and go through both packages in
float32.  Tolerance 2e-5 max abs on N(0, 1) inputs: the same online
softmax in both, with sums taken in other orders (XLA's dot vs torch's
matmul) — the bound the reference's own kernel sweep uses for float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention.ref import attention_ref as jattention_ref
from repro_torch.kernels.flash_attention import kernel, ops, ref

TOL = 2e-5


def _qkv(seed, b, hq, hkv, sq, skv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, hq, sq, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32),
            rng.normal(size=(b, hkv, skv, d)).astype(np.float32))


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("softcap", [0.0, 20.0])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 64])
@pytest.mark.parametrize("s", [64, 200])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (4, 1)])
def test_plain_flash_matches_pallas_interpret(hq, hkv, s, d, causal, softcap):
    """At sq == skv the Pallas path (padded to 128-row blocks, kv_len
    masking the pad) and the port's blockwise plain version agree."""
    q, k, v = _qkv(s + d + hkv, 2, hq, hkv, s, s, d)
    want = jops.attention(*_j(q, k, v), causal=causal, softcap=softcap,
                          backend="interpret")
    got = kernel.flash_attention(*_t(q, k, v), causal=causal,
                                 softcap=softcap)
    assert got.dtype == torch.float32 and got.shape == (2, hq, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_offset_alignment_matches_oracle(causal):
    """sq=100 against skv=200: the port aligns the causal diagonal on the
    unpadded skv - sq, as ``attention_ref`` and ``mea_attention`` do; the
    reference's Pallas path (padded lengths) differs there when causal."""
    q, k, v = _qkv(7, 1, 2, 1, 100, 200, 16)
    want = np.asarray(jattention_ref(*_j(q, k, v), causal=causal))
    got = ops.attention(*_t(q, k, v), causal=causal).numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    xla = np.asarray(jops.attention(*_j(q, k, v), causal=causal,
                                    backend="xla"))
    np.testing.assert_allclose(got, xla, atol=TOL, rtol=0)
    interp = np.asarray(jops.attention(*_j(q, k, v), causal=causal,
                                       backend="interpret"))
    gap = np.abs(interp - want).max()
    if causal:
        assert gap > 0.1, gap         # the reference's padded q_offset
    else:
        assert gap <= TOL, gap


@pytest.mark.parametrize("kv_len,q_offset", [(50, 0), (200, 90), (0, 0),
                                             (120, -40)])
def test_plain_flash_masks_match_quadratic(kv_len, q_offset):
    """kv_len and q_offset as arguments (the kernel's interface): the
    blockwise online softmax equals a quadratic softmax over the same
    mask; fully masked rows give 0."""
    q, k, v = _qkv(11, 1, 4, 2, 100, 200, 16)
    qt, kt, vt = _t(q, k, v)
    got = ref.flash_attention_ref(qt, kt, vt, causal=True, softcap=5.0,
                                  kv_len=kv_len, q_offset=q_offset)
    s = torch.einsum("bhgqd,bhkd->bhgqk",
                     qt.reshape(1, 2, 2, 100, 16) / 4.0, kt)
    s = 5.0 * torch.tanh(s / 5.0)
    kpos = torch.arange(200)
    mask = (kpos < kv_len) & (kpos <= torch.arange(100)[:, None] + q_offset)
    s = torch.where(mask, s, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)
    want = torch.einsum("bhgqk,bhkd->bhgqd", p, vt).reshape(1, 4, 100, 16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL, rtol=0)
    dead = ~mask.any(dim=-1)
    assert (got[:, :, dead] == 0).all()


def test_attention_bf16_returns_bf16():
    q, k, v = _qkv(3, 1, 4, 2, 64, 64, 16)
    qt, kt, vt = (t.to(torch.bfloat16) for t in _t(q, k, v))
    got = ops.attention(qt, kt, vt)
    want = ref.attention_ref(qt, kt, vt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               atol=1e-2, rtol=0)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_decode_attention_matches_reference(softcap):
    q, k, v = _qkv(5, 2, 8, 2, 1, 48, 32)
    want = jops.decode_attention(*_j(q, k, v), cache_len=37, softcap=softcap)
    got = ops.decode_attention(*_t(q, k, v), cache_len=37, softcap=softcap)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)
    oracle = ref.decode_attention_ref(*_t(q, k, v), kv_len=37,
                                      softcap=softcap)
    np.testing.assert_allclose(got.numpy(), oracle.numpy(), atol=TOL, rtol=0)


def test_attention_refuses_grad():
    q, k, v = _t(*_qkv(1, 1, 2, 2, 8, 8, 16))
    with pytest.raises(NotImplementedError, match="backward"):
        ops.attention(q.requires_grad_(), k, v)
    with torch.no_grad():
        assert ops.attention(q, k, v).shape == (1, 2, 8, 16)
