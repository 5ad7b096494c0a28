"""The port's ``DecodeServer`` against the JAX package's (CPU, float32):
tinyllama-1.1b and command-r-plus-104b (the parallel block, LayerNorm,
logit_scale) at their smoke configs.

Same weights (the reference's init, carried by ``params_from_numpy``), two
slots with equal-length prompts (the reference's ``step`` shares one
``cache_len`` across slots), eight greedy decode steps: the tokens must be
identical, and the logits behind them agree to 1e-4 (see
test_torch_transformer.py).
"""

import jax
import numpy as np
import pytest

from repro.configs import command_r_plus_104b as jcmdr
from repro.configs import phi3_5_moe_42b as jphi
from repro.configs import tinyllama_1_1b as jtiny
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.configs import (command_r_plus_104b, phi3_5_moe_42b,
                                 tinyllama_1_1b)
from repro_torch.launch import serve
from repro_torch.models import transformer as tf
from torch_jax_cleanup import free_jax_executables  # noqa: F401 (autouse)


def _servers(jmod, mod):
    jcfg = jmod.smoke_config()
    cfg = mod.smoke_config()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    return (jserve.DecodeServer(jcfg, jp, batch_slots=2, max_len=24),
            serve.DecodeServer(cfg, tp, batch_slots=2, max_len=24))


@pytest.fixture(scope="module")
def servers():
    return _servers(jtiny, tinyllama_1_1b)


def test_greedy_tokens_match_reference(servers):
    _greedy_tokens_match(*servers)


def test_command_r_plus_greedy_tokens_match_reference():
    _greedy_tokens_match(*_servers(jcmdr, command_r_plus_104b))


def _greedy_tokens_match(js, ts):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, size=6).astype(np.int32)
               for _ in range(2)]
    for p in prompts:
        assert js.admit(p) == ts.admit(p)
    assert ts.admit(prompts[0]) is None            # both slots busy
    np.testing.assert_array_equal(ts.tokens, js.tokens)
    for _ in range(8):
        js.step()
        ts.step()
        np.testing.assert_array_equal(ts.lens, js.lens)
        np.testing.assert_array_equal(ts.tokens, js.tokens)
    for kv in ("k", "v"):
        np.testing.assert_allclose(ts.cache[kv].numpy(),
                                   np.asarray(js.cache[kv]), atol=1e-4,
                                   rtol=0)
    for slot in (0, 1):
        out = ts.retire(slot)
        np.testing.assert_array_equal(out, js.retire(slot))
        assert out.shape == (6 + 1 + 8,)
    assert not ts.active.any()


def test_main_runs_on_the_cpu(capsys):
    serve.main(["--smoke", "--device", "cpu", "--requests", "2",
                "--gen-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 2 requests, 24 total tokens" in out
    assert "on cpu" in out


def test_step_stops_at_max_len():
    cfg = tinyllama_1_1b.smoke_config()
    srv = serve.DecodeServer(cfg, tf.init_params(cfg, device="cpu"),
                             batch_slots=1, max_len=8)
    srv.admit(np.arange(5, dtype=np.int32))
    for _ in range(6):
        srv.step()
    assert int(srv.lens[0]) == 8 and not srv.active[0]


def test_moe_greedy_tokens_match_reference():
    """An MoE LM (phi3.5-moe's smoke config: 4 experts, top 2, LayerNorm,
    qkv bias) served by both: the same greedy tokens."""
    jcfg = jphi.smoke_config()
    cfg = phi3_5_moe_42b.smoke_config()
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    tp = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    js = jserve.DecodeServer(jcfg, jp, batch_slots=2, max_len=24)
    ts = serve.DecodeServer(cfg, tp, batch_slots=2, max_len=24)
    rng = np.random.default_rng(1)
    for _ in range(2):
        p = rng.integers(0, 256, size=7).astype(np.int32)
        assert js.admit(p) == ts.admit(p)
    for _ in range(6):
        js.step()
        ts.step()
    np.testing.assert_array_equal(ts.lens, js.lens)
    np.testing.assert_array_equal(ts.tokens, js.tokens)


def test_refuses_the_int8_cache():
    """The reference's ``admit`` writes unquantized k/v into an int8
    cache and never sets its scales: the port refuses such a config."""
    import dataclasses

    cfg = dataclasses.replace(tinyllama_1_1b.smoke_config(), kv_quant=True)
    with pytest.raises(ValueError, match="admit"):
        serve.DecodeServer(cfg, tf.init_params(cfg, device="cpu"),
                           batch_slots=1, max_len=8)


@pytest.mark.parametrize("arch", ["grok-1-314b", "phi3.5-moe-42b-a6.6b"])
def test_main_serves_an_moe_arch_on_the_cpu(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests",
                "2", "--gen-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 2 requests, 24 total tokens" in out and "on cpu" in out
