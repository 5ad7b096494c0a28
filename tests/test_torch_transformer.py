"""The port's LM (``repro_torch.models.transformer``) against the JAX
package's at the smoke configurations (CPU, float32).

Weights come from the reference's ``init_params``, with every norm scale
and qkv bias (zero at init) redrawn with numpy so those paths count, and
go to the port through ``params_from_numpy``.  Tolerance 1e-4 max abs on
logits of order 1: two layers of float32 matmuls and attention summed in
other orders by XLA and torch.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen2_7b as jqwen, tinyllama_1_1b as jtiny
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.models import transformer as tf

TOL = 1e-4
ARCHS = [("tinyllama-1.1b", jtiny), ("qwen2-7b", jqwen)]


def _params(jmod, seed=0):
    """(jax cfg, port cfg, jax params, port params) with random norm
    scales and biases."""
    jcfg = jmod.smoke_config()
    tree = jax.tree_util.tree_map(np.asarray,
                                  jtf.init_params(jax.random.PRNGKey(seed),
                                                  jcfg))
    rng = np.random.default_rng(seed)

    def redraw(path, a):
        name = str(path[-1])
        if "scale" in name or "'b" in name:
            return (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        return a
    tree = jax.tree_util.tree_map_with_path(redraw, tree)
    cfg = registry.get_module(jcfg.name.removesuffix("-smoke")).smoke_config()
    return (jcfg, cfg, jax.tree_util.tree_map(jnp.asarray, tree),
            tf.params_from_numpy(tree, cfg, device="cpu"))


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL,
                               rtol=0)


def test_configs_mirror_the_reference():
    for arch, jmod in ARCHS:
        mod = registry.get_module(arch)
        for make in ("make_config", "smoke_config"):
            j, p = getattr(jmod, make)(), getattr(mod, make)()
            for f in dataclasses.fields(p):
                if f.name != "dtype":
                    assert getattr(p, f.name) == getattr(j, f.name), f.name
        assert mod.make_config().dtype == torch.bfloat16
        assert mod.make_config().param_count() == \
            jmod.make_config().param_count()


def test_registry_names_what_is_not_ported():
    with pytest.raises(NotImplementedError, match="MoE"):
        registry.get_module("grok-1-314b")
    with pytest.raises(KeyError):
        registry.get_module("no-such-arch")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.TransformerConfig(moe=object())
    with pytest.raises(NotImplementedError, match="int8"):
        tf.TransformerConfig(kv_quant=True)


@pytest.mark.parametrize("arch,jmod", ARCHS)
def test_prefill_and_cache_match_reference(arch, jmod):
    jcfg, cfg, jp, tp = _params(jmod)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 12))
    jl, jc = jtf.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len=16)
    tl, tc = tf.prefill(tp, torch.from_numpy(toks), cfg, max_len=16)
    assert tuple(tl.shape) == (2, 1, cfg.vocab)
    _close(tl, jl)
    for kv in ("k", "v"):
        assert tuple(tc[kv].shape) == jc[kv].shape
        _close(tc[kv], jc[kv])


@pytest.mark.parametrize("variant", [{}, {"parallel_block": True,
                                         "norm": "layernorm"}])
@pytest.mark.parametrize("arch,jmod", ARCHS)
def test_decode_step_and_forward_match_reference(arch, jmod, variant):
    """Also with the command-r style block (attention || FFN, LayerNorm)
    the config copies from the reference."""
    jcfg = dataclasses.replace(jmod.smoke_config(), **variant)
    tree = jax.tree_util.tree_map(
        np.asarray, jtf.init_params(jax.random.PRNGKey(2), jcfg))
    rng = np.random.default_rng(2)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: (0.1 * rng.normal(size=a.shape)).astype(np.float32)
        if str(path[-1]) in ("['scale']", "['bias']", "['bq']", "['bk']",
                             "['bv']") else a, tree)
    cfg = dataclasses.replace(registry.get_module(arch).smoke_config(),
                              **variant)
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    tp = tf.params_from_numpy(tree, cfg, device="cpu")
    # a logit softcap so decode/forward (which apply it) are checked too
    jcfg = dataclasses.replace(jcfg, logit_softcap=30.0)
    cfg = dataclasses.replace(cfg, logit_softcap=30.0)
    toks = np.random.default_rng(3).integers(0, cfg.vocab, (2, 12))
    _, jc = jtf.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len=16)
    _, tc = tf.prefill(tp, torch.from_numpy(toks), cfg, max_len=16)
    nxt = np.array([[5], [9]])
    jl, jc2 = jtf.decode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                              jnp.int32(12), jcfg)
    tl, tc2 = tf.decode_step(tp, torch.from_numpy(nxt), tc, 12, cfg)
    _close(tl, jl)
    for kv in ("k", "v"):
        _close(tc2[kv], jc2[kv])
    full = np.concatenate([toks, nxt], 1)
    jf, _ = jtf.forward(jp, jnp.asarray(full, jnp.int32), jcfg)
    tf_logits, aux = tf.forward(tp, torch.from_numpy(full), cfg)
    assert aux is None
    _close(tf_logits, jf)


@pytest.mark.parametrize("arch,jmod", ARCHS)
def test_decode_matches_forward_inside_the_port(arch, jmod):
    """As ``tests/test_models.py`` checks the reference: the decode logits
    at position p equal the forward's at p, and the prefill's last logits
    the forward's at p - 1 (no logit softcap: prefill applies none)."""
    _, cfg, _, tp = _params(jmod, seed=4)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab,
                                                             (2, 12)))
    pre, cache = tf.prefill(tp, toks, cfg, max_len=16)
    nxt = toks[:, -1:] * 0 + 5
    dec, _ = tf.decode_step(tp, nxt, cache, 12, cfg)
    full, _ = tf.forward(tp, torch.cat([toks, nxt], 1), cfg)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(pre[:, 0].numpy(), full[:, -2].numpy(),
                               atol=2e-5, rtol=0)


def test_init_params_shapes_match_reference_tree():
    jcfg = jqwen.smoke_config()
    cfg = registry.get_module("qwen2-7b").smoke_config()
    jtree = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    port = tf.init_params(cfg, seed=0, device="cpu")
    flat = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_leaves_with_path(jtree)}
    n = 0
    for name, p in port.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            key = "".join(f"['{x}']" for x in ["layers"] + parts[2:])
            assert flat[key][1:] == tuple(p.shape), name
        else:
            key = "".join(f"['{x}']" for x in parts)
            assert flat[key] == tuple(p.shape), name
        assert not p.requires_grad
        n += p.numel()
    assert n == cfg.param_count() + sum(
        p.numel() for name, p in port.named_parameters()
        if "scale" in name or ".b" in name)
    # the reference's init statistics: N(0, 0.02) embeddings, fan-in std
    big_cfg = dataclasses.replace(registry.get_module(
        "tinyllama-1.1b").make_config(dtype=torch.float32), n_layers=1)
    big = tf.init_params(big_cfg, seed=1, device="cpu")
    assert abs(float(big["embed"].std()) - 0.02) < 1e-3
    wq = big.layers[0]["attn"]["wq"]
    assert float(wq.abs().max()) <= 2.0 / 2048 ** 0.5 + 1e-6
    assert abs(float(wq.std()) - 0.88 / 2048 ** 0.5) < 2e-3


def test_common_blocks_match_reference():
    from repro.models import common as jc
    from repro_torch.models import common as tc

    rng = np.random.default_rng(6)
    x = rng.normal(size=(2, 3, 5, 16)).astype(np.float32)
    logits = rng.normal(size=(4, 7, 11)).astype(np.float32)
    labels = rng.integers(0, 11, (4, 7))
    np.testing.assert_allclose(
        float(tc.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels), z_loss=1e-4)),
        float(jc.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                               z_loss=1e-4)), atol=1e-6, rtol=0)
    for name in jc.ACTIVATIONS:
        _close(tc.ACTIVATIONS[name](torch.from_numpy(x)),
               jc.ACTIVATIONS[name](jnp.asarray(x)))
    pos = rng.integers(0, 50, (2, 5))
    _close(tc.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jc.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))
