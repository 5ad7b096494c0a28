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
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

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


# The card's bf16 tolerance for K4 against ``ref.flash_attention_ref``, per
# element: |got - want| <= 2^-7 |want| + 2^-8 A + 2e-5, with A the plain
# version on |v| (the same weights applied to |v|).  The bf16 kernel rounds
# P to bf16 before P V (relative error <= 2^-9 per weight), so an output
# moves by at most 2^-9 (sum_j p_j |v_j|) / l = 2^-9 A; the limit takes
# twice that, one bf16 ulp of the output and the f32 limit.  A one-ulp
# limit alone (no A term) does not hold near zero outputs.
def _bf16_limit(want, a, with_v_term=True):
    return (2.0 ** -7 * want.abs() + (2.0 ** -8 * a if with_v_term else 0.0)
            + TOL)


def _bf16_p_attention(q, k, v, causal=True, softcap=0.0, q_offset=0,
                      block_k=64):
    """An emulation of the bf16 kernel's arithmetic on the CPU: 64-key
    tiles, the scale applied to S in f32 after the product, f32 (m, l),
    P rounded to bf16 before P V, the output rounded to bf16."""
    b, hq, sq, d = q.shape
    hkv, skv = k.shape[1], k.shape[2]
    neg = float("-inf")
    qf = q.float().reshape(b, hkv, hq // hkv, sq, d)
    acc = torch.zeros(qf.shape)
    m = torch.full(qf.shape[:-1], neg)
    l = torch.zeros(qf.shape[:-1])
    qpos = torch.arange(sq)[:, None] + q_offset
    for k0 in range(0, skv, block_k):
        kb, vb = k[:, :, k0:k0 + block_k].float(), v[:, :, k0:k0 + block_k]
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) / d ** 0.5
        if softcap:
            s = softcap * torch.tanh(s / softcap)
        mask = torch.ones_like(s, dtype=torch.bool)
        if causal:
            mask = torch.arange(k0, k0 + kb.shape[2])[None, :] <= qpos
        s = torch.where(mask, s, neg)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(m_new == neg, 0.0, m_new)
        alpha = torch.exp(torch.where(m == neg, neg, m - m_safe))
        p = torch.exp(torch.where(mask, s - m_safe[..., None], neg))
        l = alpha * l + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bhkd->bhgqd", p.to(torch.bfloat16).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.reshape(b, hq, sq, d).to(torch.bfloat16)


@pytest.mark.parametrize("causal,softcap", [(True, 0.0), (False, 30.0)])
@pytest.mark.parametrize("d,hq,hkv,sq,skv", [(64, 4, 4, 192, 192),
                                             (128, 8, 1, 100, 300)])
def test_bf16_p_rounding_meets_the_card_tolerance(d, hq, hkv, sq, skv,
                                                  causal, softcap):
    """Seed 15: N(0, 1) inputs in bf16; the emulated kernel against the
    plain version within the stated tolerance."""
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(15, 2, hq, hkv, sq, skv, d))
    kw = dict(causal=causal, softcap=softcap, q_offset=skv - sq)
    got = _bf16_p_attention(q, k, v, **kw).float()
    want = ref.flash_attention_ref(q, k, v, **kw).float()
    a = ref.flash_attention_ref(q, k, v.abs(), **kw).float()
    assert bool(((got - want).abs() <= _bf16_limit(want, a)).all())


def test_bf16_p_rounding_needs_the_v_term():
    """Seed 15: near-flat softmax weights (q scaled by 0.05) over values of
    alternating sign put outputs near zero, where the P rounding error is
    set by the |v| averaged and not by the output: the emulated kernel
    breaks the one-ulp limit (no A term) and meets the stated one."""
    rng = np.random.default_rng(15)
    q = torch.from_numpy(rng.normal(size=(1, 4, 256, 64)).astype(np.float32)
                         * 0.05).to(torch.bfloat16)
    k = torch.from_numpy(rng.normal(size=(1, 2, 256, 64)).astype(
        np.float32)).to(torch.bfloat16)
    sign = torch.where(torch.arange(256) % 2 == 0, 1.0, -1.0)
    mag = torch.from_numpy(1 + 0.1 * rng.random((1, 2, 256, 64)).astype(
        np.float32))
    v = (sign[None, None, :, None] * mag).to(torch.bfloat16)
    for causal in (True, False):
        got = _bf16_p_attention(q, k, v, causal=causal).float()
        want = ref.flash_attention_ref(q, k, v, causal=causal).float()
        a = ref.flash_attention_ref(q, k, v.abs(), causal=causal).float()
        diff = (got - want).abs()
        assert float(want.abs().median()) < 1e-2       # outputs near zero
        assert not bool((diff <= _bf16_limit(want, a, False)).all())
        assert bool((diff <= _bf16_limit(want, a)).all())
