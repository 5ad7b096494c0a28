"""The gradient of the port's ``attention`` (K4's plain version forward,
the reference's ``_pallas_bwd`` backward: chunked recompute + two-pass
backward in ``xla_flash.py``) against the JAX package's on the CPU.

* against ``jax.grad`` through ``repro.kernels.flash_attention.ops.
  attention(backend="interpret")``, the TPU path (the Pallas forward in
  interpret mode and ``_pallas_bwd``), at S <= 512 (one chunk);
* against ``backend="xla"`` (``mea_attention`` and its VJP) at S = 1024,
  two chunks of 512;
* the chunked forward's ``out`` and ``lse`` against ``_mea_fwd``'s.

float32 throughout.  Tolerance 2e-5 abs + 2e-5 of the largest |grad|
(f32 products over up to 1024 keys and the group's heads, summed in other
orders by XLA and torch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import xla_flash as jxla
from repro_torch.kernels.flash_attention import ops, ref, xla_flash
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

ATOL, RTOL_OF_MAX = 2e-5, 2e-5


def _inputs(seed, b, hq, hkv, s, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, d)).astype(np.float32)
    dout = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    return q, k, v, dout


def _jax_grads(q, k, v, dout, **kw):
    def f(q_, k_, v_):
        return jnp.sum(jops.attention(q_, k_, v_, **kw) * dout)
    return jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


def _port_grads(q, k, v, dout, causal, softcap):
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.attention(qt, kt, vt, causal=causal, softcap=softcap)
    out.backward(torch.from_numpy(dout))
    return out, (qt.grad, kt.grad, vt.grad)


def _close(got, want, name):
    want = np.asarray(want)
    tol = ATOL + RTOL_OF_MAX * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("groups", [1, 4])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_the_pallas_path(causal, softcap, groups, d):
    q, k, v, dout = _inputs(d + groups, 1, 2 * groups, 2, 256, d)
    want = _jax_grads(q, k, v, dout, causal=causal, softcap=softcap,
                      backend="interpret")
    _, got = _port_grads(q, k, v, dout, causal, softcap)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_the_xla_path_over_two_chunks(causal, softcap):
    q, k, v, dout = _inputs(11, 1, 4, 2, 1024, 64)
    want = _jax_grads(q, k, v, dout, causal=causal, softcap=softcap,
                      backend="xla")
    out, got = _port_grads(q, k, v, dout, causal, softcap)
    np.testing.assert_allclose(
        out.detach().numpy(),
        np.asarray(jops.attention(*map(jnp.asarray, (q, k, v)),
                                  causal=causal, softcap=softcap,
                                  backend="xla")), atol=2e-5, rtol=0)
    for name, g, w in zip("qkv", got, want):
        _close(g, w, f"d{name}")


@pytest.mark.parametrize("chunk", [128, 512])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_forward_matches_mea_fwd(causal, softcap, chunk):
    q, k, v, _ = _inputs(chunk, 2, 8, 2, 512, 64)
    # queries shorter than keys: the causal diagonal at skv - sq
    q = q[:, :, -200:]
    jout, (_, _, _, _, jlse) = jxla._mea_fwd(
        *map(jnp.asarray, (q, k, v)), causal, softcap, chunk, 400)
    out, lse = xla_flash.mea_fwd(*map(torch.from_numpy, (q, k, v)), causal,
                                 softcap, chunk, kv_len=400)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=2e-5,
                               rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=0)


def test_backward_matches_autograd_through_the_plain_version():
    """The port's two chunks at S = 1024 against autograd through
    ``flash_attention_ref`` (what phase 4h of ``chip_smoke.py`` holds the
    card to), softcap and GQA on."""
    q, k, v, dout = _inputs(13, 1, 8, 2, 1024, 64)
    _, got = _port_grads(q, k, v, dout, True, 30.0)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    ref.flash_attention_ref(qt, kt, vt, causal=True, softcap=30.0).backward(
        torch.from_numpy(dout))
    for name, g, w in zip("qkv", got, (qt.grad, kt.grad, vt.grad)):
        _close(g, w.numpy(), f"d{name}")


def test_kv_length_must_divide_the_chunk():
    q, k, v, dout = _inputs(17, 1, 2, 2, 600, 64)
    with pytest.raises(ValueError, match="chunk"):
        xla_flash.mea_fwd(*map(torch.from_numpy, (q, k, v)), chunk=512)
    qt = torch.from_numpy(q).requires_grad_()
    out = ops.attention(qt, torch.from_numpy(k), torch.from_numpy(v))
    with pytest.raises(ValueError, match="chunk"):
        out.backward(torch.from_numpy(dout))
    # below 512 keys the chunk is the whole length
    q, k, v, dout = _inputs(19, 1, 2, 2, 300, 64)
    _, got = _port_grads(q, k, v, dout, True, 0.0)
    assert all(bool(torch.isfinite(g).all()) for g in got)


def test_forward_without_grad_is_unchanged():
    q, k, v, _ = _inputs(23, 1, 4, 2, 64, 64)
    t = [torch.from_numpy(a) for a in (q, k, v)]
    with torch.no_grad():
        plain = ops.attention(*t)
    np.testing.assert_array_equal(
        plain.numpy(),
        ref.flash_attention_ref(*t, causal=True).numpy())
