"""The port's MoE layer (``repro_torch.models.moe``) against the JAX
package's (CPU, float32).

The same weights (the reference's ``init_moe``, as numpy) and tokens (a
numpy seed) go through both.  Routing is compared exactly: the top-k
experts of every token, the group sizes and which rows the capacity drops
(from each side's stable sort by expert).  Outputs within ``atol=1e-5``
(a few f32 products summed in other orders), the router statistics and
``router_aux_loss`` within ``1e-6``.  Capacity factors 4.0 and 1.25 keep
every row; 0.25 drops rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)

T, D = 256, 16
FACTORS = [4.0, 1.25, 0.25]
IMPLS = ["sliced", "ragged"]


def _case(cf, impl="sliced", seed=0, act="silu"):
    """(jax cfg, port cfg, jax params, port params, x as numpy)."""
    jcfg = jmoe.MoEConfig(n_experts=4, top_k=2, d_ff=32, capacity_factor=cf,
                          impl=impl, act=act)
    cfg = moe.MoEConfig(**dataclasses.asdict(jcfg))
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    x = np.random.default_rng(seed + 1).normal(size=(T, D)).astype(
        np.float32)
    return jcfg, cfg, jp, tp, x


def _kept(expert_ids, n_experts, cap, sort):
    """[T*k] bool: which (token, slot) messages the capacity keeps, from
    the stable sort ``sort`` of the flat expert ids."""
    flat = np.asarray(expert_ids).reshape(-1)
    order = np.asarray(sort(flat))
    sizes = np.bincount(flat, minlength=n_experts)
    rank = np.empty(flat.shape[0], np.int64)
    start = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    rank[order] = np.arange(flat.shape[0]) - start[flat[order]]
    return rank < cap


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("cf", FACTORS)
def test_moe_ffn_matches_reference(cf, impl):
    jcfg, cfg, jp, tp, x = _case(cf, impl)
    jy, jaux = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    assert ty.dtype == torch.float32 and tuple(ty.shape) == (T, D)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    assert set(taux) == set(jaux)
    for k in jaux:
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        float(moe.router_aux_loss(taux, cfg)),
        float(jmoe.router_aux_loss(jaux, jcfg)), atol=1e-6, rtol=0)


@pytest.mark.parametrize("cf", FACTORS)
def test_routing_and_capacity_drop_match_reference(cf):
    """Expert ids, group sizes and the dropped rows are the reference's:
    its router (``jax.lax.top_k`` of the softmax) and its stable
    ``jnp.argsort`` against the port's ``route`` and
    ``torch.argsort(stable=True)``."""
    jcfg, cfg, jp, tp, x = _case(cf)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    _, jidx = jax.lax.top_k(probs, jcfg.top_k)
    _, _, gates, tidx, sizes = moe.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(
        sizes.numpy(), np.bincount(np.asarray(jidx).reshape(-1),
                                   minlength=cfg.n_experts))
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, atol=1e-6)
    cap = moe.capacity(cfg, T)
    assert cap == max(128, -(-int(cf * T * 2 / 4) // 128) * 128)
    jkept = _kept(jidx, cfg.n_experts, cap,
                  lambda f: jnp.argsort(jnp.asarray(f), stable=True))
    tkept = _kept(tidx.numpy(), cfg.n_experts, cap,
                  lambda f: torch.argsort(torch.from_numpy(f), stable=True))
    np.testing.assert_array_equal(tkept, jkept)
    if cf == 0.25:
        assert (~tkept).sum() > 0, "the smallest capacity drops no row"
    else:
        assert tkept.all()


def test_token_conservation_and_impl_equivalence():
    """``tests/test_models.py``'s check of the reference, in the port:
    sliced == ragged where nothing is dropped, and the routing fractions
    sum to one."""
    _, cfg, _, tp, x = _case(4.0)
    xt = torch.from_numpy(x[:64])
    y1, aux = moe.moe_ffn(tp, xt, cfg)
    y2, _ = moe.moe_ffn(tp, xt, dataclasses.replace(cfg, impl="ragged"))
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), atol=1e-5, rtol=0)
    assert abs(float(aux["router_frac"].sum()) - 1.0) < 1e-5
    assert abs(float(aux["router_probs_mean"].sum()) - 1.0) < 1e-5


def test_capacity_drops_tokens_gracefully():
    """Tiny capacity: the output stays finite and bounded, and differs
    from the dropless output only on tokens that lost a row."""
    _, cfg, _, tp, x = _case(0.25)
    xt = torch.from_numpy(x)
    y, _ = moe.moe_ffn(tp, xt, cfg)
    y_all, _ = moe.moe_ffn(tp, xt, dataclasses.replace(cfg, impl="ragged"))
    assert bool(torch.isfinite(y).all())
    assert float(y.abs().max()) <= float(y_all.abs().max()) * 4
    _, _, _, idx, _ = moe.route(tp, xt, cfg)
    kept = _kept(idx.numpy(), cfg.n_experts, moe.capacity(cfg, T),
                 lambda f: torch.argsort(torch.from_numpy(f), stable=True))
    whole = kept.reshape(T, 2).all(1)
    np.testing.assert_allclose(y[whole].numpy(), y_all[whole].numpy(),
                               atol=1e-5, rtol=0)
    assert not np.allclose(y[~whole].numpy(), y_all[~whole].numpy())


@pytest.mark.parametrize("impl", IMPLS)
def test_gelu_experts_match_reference(impl):
    """grok-1's activation."""
    jcfg, cfg, jp, tp, x = _case(1.25, impl, seed=3, act="gelu")
    jy, _ = jmoe.moe_ffn(jp, jnp.asarray(x), jcfg)
    ty, _ = moe.moe_ffn(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=1e-5, rtol=0)


@pytest.mark.parametrize("impl", IMPLS)
def test_bf16_layer_keeps_dtypes(impl):
    """A bf16 layer returns bf16 and routes on its f32 router as the f32
    layer does on the same weights."""
    _, cfg, _, tp, x = _case(1.25, impl)
    bf = {k: v if k == "router" else v.to(torch.bfloat16)
          for k, v in tp.items()}
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, aux = moe.moe_ffn(bf, xb, cfg)
    assert y.dtype == torch.bfloat16 and tuple(y.shape) == (T, D)
    assert aux["router_probs_mean"].dtype == torch.float32
    y32, _ = moe.moe_ffn(tp, xb.float(), cfg)
    np.testing.assert_allclose(y.float().numpy(), y32.numpy(), atol=0.05,
                               rtol=0.05)


def test_init_moe_shapes_and_router_dtype():
    jcfg = jmoe.MoEConfig(n_experts=4, top_k=2, d_ff=32)
    cfg = moe.MoEConfig(n_experts=4, top_k=2, d_ff=32)
    want = jmoe.init_moe(jax.random.PRNGKey(0), D, jcfg,
                         dtype=jnp.bfloat16)
    gen = torch.Generator().manual_seed(0)
    got = moe.init_moe(gen, D, cfg, dtype=torch.bfloat16)
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert (got[k].dtype == torch.float32) == (want[k].dtype ==
                                                   jnp.float32), k
    assert got["router"].dtype == torch.float32
    assert got["w_gate"].dtype == torch.bfloat16
    # fan-in axis 1 (d_model) for the experts: |w| <= 2 / sqrt(d)
    big = moe.init_moe(gen, 256, moe.MoEConfig(4, 2, 512))
    assert float(big["w_up"].abs().max()) <= 2.0 / 16 + 1e-6
    assert float(big["w_down"].abs().max()) <= 2.0 / 512 ** 0.5 + 1e-6
