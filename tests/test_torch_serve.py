"""The port's ``DecodeServer`` against the JAX package's (CPU, float32).

Same weights (the reference's init, carried by ``params_from_numpy``), two
slots with equal-length prompts (the reference's ``step`` shares one
``cache_len`` across slots), eight greedy decode steps: the tokens must be
identical, and the logits behind them agree to 1e-4 (see
test_torch_transformer.py).
"""

import jax
import numpy as np
import pytest

from repro.configs import tinyllama_1_1b as jtiny
from repro.launch import serve as jserve
from repro.models import transformer as jtf
from repro_torch.configs import tinyllama_1_1b
from repro_torch.launch import serve
from repro_torch.models import transformer as tf


@pytest.fixture(scope="module")
def servers():
    jcfg = jtiny.smoke_config()
    cfg = tinyllama_1_1b.smoke_config()
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg)
    tp = tf.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg,
                              device="cpu")
    return (jserve.DecodeServer(jcfg, jp, batch_slots=2, max_len=24),
            serve.DecodeServer(cfg, tp, batch_slots=2, max_len=24))


def test_greedy_tokens_match_reference(servers):
    js, ts = servers
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
