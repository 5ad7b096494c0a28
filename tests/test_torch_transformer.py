"""The port's LM (``repro_torch.models.transformer``) against the JAX
package's at the smoke configurations (CPU, float32): the dense LMs
(command-r-plus-104b's parallel block, LayerNorm, logit_scale and tied
embeddings among them) and the MoE LMs (grok-1, phi3.5-moe), the int8 KV
cache, and the registry against the reference's.

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

from repro.configs import command_r_plus_104b as jcmdr
from repro.configs import grok_1_314b as jgrok
from repro.configs import registry as jregistry
from repro.configs import phi3_5_moe_42b as jphi
from repro.configs import qwen2_7b as jqwen, tinyllama_1_1b as jtiny
from repro.models import transformer as jtf
from repro_torch.configs import registry
from repro_torch.models import transformer as tf
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

TOL = 1e-4
ARCHS = [("tinyllama-1.1b", jtiny), ("qwen2-7b", jqwen),
         ("grok-1-314b", jgrok), ("phi3.5-moe-42b-a6.6b", jphi),
         ("command-r-plus-104b", jcmdr)]


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
                got, want = getattr(p, f.name), getattr(j, f.name)
                if f.name == "moe" and want is not None:
                    # the port's MoEConfig beside the reference's
                    assert dataclasses.asdict(got) == \
                        dataclasses.asdict(want), arch
                elif f.name != "dtype":
                    assert got == want, f.name
        assert mod.make_config().dtype == torch.bfloat16
        assert mod.make_config().param_count() == \
            jmod.make_config().param_count()
        assert mod.make_config().active_param_count() == \
            jmod.make_config().active_param_count()


def test_registry_names_what_is_not_ported():
    """Nothing is left unported: the registry holds the reference's
    architectures (in its order, each of its family), ``cells()`` yields
    the reference's (arch, shape, reason) triples with and without the
    skipped ones, and an unknown architecture raises ``KeyError``."""
    assert list(registry.ARCHS) == list(jregistry.ARCHS)
    assert not hasattr(registry, "NOT_PORTED")
    for arch, mod in registry.ARCHS.items():
        assert mod.FAMILY == jregistry.ARCHS[arch].FAMILY
    for skipped in (False, True):
        assert list(registry.cells(skipped)) == list(
            jregistry.cells(skipped))
    assert registry.SKIPPED_CELLS == jregistry.SKIPPED_CELLS
    with pytest.raises(KeyError):
        registry.get_module("no-such-arch")


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
    jf, jaux = jtf.forward(jp, jnp.asarray(full, jnp.int32), jcfg)
    tf_logits, aux = tf.forward(tp, torch.from_numpy(full), cfg)
    _close(tf_logits, jf)
    if cfg.moe is None:
        assert aux is None and jaux is None
    else:
        # the router statistics averaged over the layers
        assert set(aux) == set(jaux)
        for k in jaux:
            np.testing.assert_allclose(aux[k].numpy(), np.asarray(jaux[k]),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("arch,jmod", ARCHS)
def test_decode_matches_forward_inside_the_port(arch, jmod):
    """As ``tests/test_models.py`` checks the reference: the decode logits
    at position p equal the forward's at p, and the prefill's last logits
    the forward's at p - 1 once capped (prefill applies no logit softcap,
    forward does: grok-1 caps at 30)."""
    _, cfg, _, tp = _params(jmod, seed=4)
    toks = torch.from_numpy(np.random.default_rng(5).integers(0, cfg.vocab,
                                                             (2, 12)))
    pre, cache = tf.prefill(tp, toks, cfg, max_len=16)
    nxt = toks[:, -1:] * 0 + 5
    dec, _ = tf.decode_step(tp, nxt, cache, 12, cfg)
    full, _ = tf.forward(tp, torch.cat([toks, nxt], 1), cfg)
    np.testing.assert_allclose(dec[:, 0].numpy(), full[:, -1].numpy(),
                               atol=2e-5, rtol=0)
    if cfg.logit_softcap:
        pre = cfg.logit_softcap * torch.tanh(pre / cfg.logit_softcap)
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
        key = "".join(f"['{x}']" for x in name.split("."))
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
    wq = big.layers["attn"]["wq"][0]
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


# --------------------------------------------------------------------------
# the int8 KV cache
# --------------------------------------------------------------------------

def test_kv_quantize_is_bitwise_the_reference():
    """int8 values and f32 scales bitwise JAX's, rounding half to even
    (exact halves planted), on rows with zeros and a near-zero row."""
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 3, 17, 32)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, 1] *= 1e-9
    x[1, 2, 3, :4] = [127.0, 0.5, 1.5, -2.5]    # scale 1: halves
    x[1, 2, 3, 4:] = 0.0
    jq, js = jtf.kv_quantize(jnp.asarray(x))
    tq, ts = tf.kv_quantize(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    assert tq[1, 2, 3, :4].tolist() == [127, 0, 2, -2]
    deq = tf.kv_dequantize(tq, ts, torch.float32)
    np.testing.assert_array_equal(
        deq.numpy(), np.asarray(jtf.kv_dequantize(jq, js, jnp.float32)))
    xb = torch.from_numpy(x).to(torch.bfloat16)
    jqb, jsb = jtf.kv_quantize(jnp.asarray(xb.float().numpy(), jnp.bfloat16))
    tqb, tsb = tf.kv_quantize(xb)
    np.testing.assert_array_equal(tqb.numpy(), np.asarray(jqb))
    np.testing.assert_array_equal(tsb.numpy(), np.asarray(jsb))


def _int8_setup(jmod, seed=8):
    """Reference weights, a prefill, and the int8 cache made from it by
    ``kv_quantize`` on each side (the reference test's recipe)."""
    jcfg, cfg, jp, tp = _params(jmod, seed=seed)
    toks = np.random.default_rng(seed + 1).integers(0, cfg.vocab, (2, 12))
    _, jc = jtf.prefill(jp, jnp.asarray(toks, jnp.int32), jcfg, max_len=16)
    _, tc = tf.prefill(tp, torch.from_numpy(toks), cfg, max_len=16)

    def quant(q, c):
        k, sk = q.kv_quantize(c["k"])
        v, sv = q.kv_quantize(c["v"])
        return {"k": k, "v": v, "k_scale": sk, "v_scale": sv}
    return (jcfg, cfg, jp, tp, toks, quant(jtf, jc), quant(tf, tc))


@pytest.mark.parametrize("arch,jmod", ARCHS)
def test_int8_decode_step_matches_reference(arch, jmod):
    jcfg, cfg, jp, tp, _, jq, tq = _int8_setup(jmod)
    for kv in ("k", "v"):
        np.testing.assert_array_equal(tq[kv].numpy(), np.asarray(jq[kv]))
    jcfg = dataclasses.replace(jcfg, kv_quant=True)
    cfg = dataclasses.replace(cfg, kv_quant=True)
    nxt = np.array([[5], [9]])
    jl, jc2 = jtf.decode_step(jp, jnp.asarray(nxt, jnp.int32), jq,
                              jnp.int32(12), jcfg)
    tl, tc2 = tf.decode_step(tp, torch.from_numpy(nxt), tq, 12, cfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)
    assert set(tc2) == set(jc2) == {"k", "v", "k_scale", "v_scale"}
    assert tc2["k"].dtype == torch.int8
    for name in ("k", "v"):
        # the new row: quantized from k/v within 2e-5 of the reference's,
        # so an int8 value may sit one step away at a rounding boundary
        diff = np.abs(tc2[name].numpy().astype(np.int32)
                      - np.asarray(jc2[name]).astype(np.int32))
        assert diff.max() <= 1
        np.testing.assert_allclose(tc2[name + "_scale"].numpy(),
                                   np.asarray(jc2[name + "_scale"]),
                                   atol=1e-6, rtol=1e-5)


def test_int8_kv_cache_decode_accuracy():
    """``tests/test_models.py``'s int8 test of the reference, in the port:
    int8 decode logits within 5 % of the full-precision forward and the
    same argmax; ``init_cache`` makes the int8 structure."""
    cfg = tf.TransformerConfig(n_layers=3, d_model=64, n_heads=4,
                               n_kv_heads=2, d_ff=128, vocab=97)
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    params = tf.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(1).integers(0, 97,
                                                              (2, 16)))
    _, cache = tf.prefill(params, toks, cfg, max_len=24)
    qk, sk = tf.kv_quantize(cache["k"])
    qv, sv = tf.kv_quantize(cache["v"])
    qcache = {"k": qk, "v": qv, "k_scale": sk, "v_scale": sv}
    nxt = toks[:, -1:] * 0 + 5
    lg_q, qc2 = tf.decode_step(params, nxt, qcache, 16, cfgq)
    assert qc2["k"].dtype == torch.int8
    full, _ = tf.forward(params, torch.cat([toks, nxt], 1), cfg)
    err = float((lg_q[:, 0] - full[:, -1]).abs().max())
    scale = float(full[:, -1].abs().max())
    assert err / scale < 0.05
    assert bool((lg_q[:, 0].argmax(-1) == full[:, -1].argmax(-1)).all())
    c0 = tf.init_cache(cfgq, 2, 24, device="cpu")
    assert set(c0) == {"k", "v", "k_scale", "v_scale"}
    assert c0["k"].dtype == torch.int8 and c0["k_scale"].dtype == \
        torch.float32 and tuple(c0["k_scale"].shape) == (3, 2, 2, 24, 1)
    # prefill returns the unquantized cache, as the reference's does
    _, pc = tf.prefill(params, toks, cfgq, max_len=24)
    assert set(pc) == {"k", "v"} and pc["k"].dtype == torch.float32


@pytest.mark.parametrize("arch", ["grok-1-314b", "phi3.5-moe-42b-a6.6b"])
def test_moe_init_params_match_reference_tree(arch):
    """The MoE layers' tree: shapes as the reference's, the router f32
    under bf16, and ``params_from_numpy`` keeps it f32."""
    jmod = dict(ARCHS)[arch]
    jcfg = jmod.smoke_config()
    cfg = registry.get_module(arch).smoke_config(dtype=torch.bfloat16)
    jtree = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    port = tf.init_params(cfg, seed=0, device="cpu")
    flat = {jax.tree_util.keystr(k): v.shape
            for k, v in jax.tree_util.tree_leaves_with_path(jtree)}
    names = set()
    for name, p in port.named_parameters():
        parts = name.split(".")
        key = "".join(f"['{x}']" for x in parts)
        names.add(key)
        assert flat[key] == tuple(p.shape), name
        assert p.dtype == (torch.float32 if parts[-1] == "router"
                           else torch.bfloat16), name
    assert names == set(flat)
    tp = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                              cfg, device="cpu")
    assert tp.layers["moe"]["router"].dtype == torch.float32
    assert tp.layers["moe"]["w_gate"].dtype == torch.bfloat16
