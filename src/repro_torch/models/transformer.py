"""Decoder-only LM: GQA + RoPE + {RMS,Layer}Norm + dense SwiGLU FFN.

The port of ``repro/models/transformer.py`` for the dense configurations
(tinyllama-1.1b, qwen2-7b).  Parameters keep the JAX package's tree and
layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, the KV cache
``[L, B, Hkv, M, hd]``), held by a :class:`Transformer` module with one
submodule per layer instead of arrays stacked on a leading L axis: eager
PyTorch runs the layers as a Python loop, where JAX scans them.
``init_params``, ``forward``, ``prefill``, ``decode_step`` and
``init_cache`` keep the JAX names and arguments, with the module in place
of the params tree (``loss_fn`` waits for the training slice).  Attention over a whole sequence runs on the K4
kernel (``kernels/flash_attention``); single-token decode, projections,
the FFN and the unembedding are plain PyTorch, as they are plain XLA in
JAX.  The module is for inference: its parameters do not require grad
(the training slice brings K4's backward).

Not ported here (each raises ``NotImplementedError``): MoE layers, the
int8 KV cache and sharded execution (``logical_constraint`` is a no-op on
one device and is dropped).
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch
from torch import nn

from ..kernels.flash_attention.ops import attention, decode_attention
from .common import (
    ACTIVATIONS,
    apply_rope,
    dense_init,
    embed_init,
    layernorm,
    rmsnorm,
)

__all__ = ["TransformerConfig", "Transformer", "init_params", "forward",
           "prefill", "decode_step", "init_cache", "params_from_numpy"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 2
    d_ff: int = 1024
    vocab: int = 1024
    head_dim: int | None = None
    qkv_bias: bool = False
    norm: str = "rmsnorm"            # "rmsnorm" | "layernorm"
    parallel_block: bool = False     # command-r style attn || ffn
    act: str = "silu"
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    moe: Any = None                  # MoE layers: not ported yet
    tie_embeddings: bool = True
    emb_scale: float = 1.0
    logit_scale: float = 1.0
    dtype: torch.dtype = torch.float32
    kv_quant: bool = False           # int8 KV cache: not ported yet

    def __post_init__(self):
        if self.moe is not None:
            raise NotImplementedError(
                "MoE layers (models/moe.py) are not ported yet: ROADMAP "
                "queue 1, MoE LMs")
        if self.kv_quant:
            raise NotImplementedError(
                "the int8 KV cache is not ported yet: ROADMAP queue 1, MoE "
                "LMs and the serving options")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        d, f, v, l = self.d_model, self.d_ff, self.vocab, self.n_layers
        h, hkv, hd = self.n_heads, self.n_kv_heads, self.hd
        attn = d * h * hd + 2 * d * hkv * hd + h * hd * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * (attn + 3 * d * f) + emb


class _Tree(nn.Module):
    """A nested dict of tensors as a module: each leaf a parameter that
    does not require grad, read back as ``tree["attn"]["wq"]``."""

    def __init__(self, leaves: dict):
        super().__init__()
        for key, val in leaves.items():
            if isinstance(val, dict):
                self.add_module(key, _Tree(val))
            else:
                self.register_parameter(key, nn.Parameter(
                    val, requires_grad=False))

    def __getitem__(self, key):
        return getattr(self, key)

    def __contains__(self, key) -> bool:
        return key in self._parameters or key in self._modules


class Transformer(_Tree):
    """The parameters: ``embed``, ``layers`` (a ``ModuleList``, one
    :class:`_Tree` per layer), ``final_norm`` and, untied, ``unembed``."""

    def __init__(self, tree: dict):
        layers = tree["layers"]
        super().__init__({k: v for k, v in tree.items() if k != "layers"})
        self.layers = nn.ModuleList(_Tree(p) for p in layers)


def _layer_tree(gen, cfg: TransformerConfig) -> dict:
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt, dev = cfg.dtype, gen.device
    attn = {
        "wq": dense_init(gen, (d, h, hd), 0, dtype=dt),
        "wk": dense_init(gen, (d, hkv, hd), 0, dtype=dt),
        "wv": dense_init(gen, (d, hkv, hd), 0, dtype=dt),
        "wo": dense_init(gen, (h, hd, d), (0, 1), dtype=dt),
    }
    if cfg.qkv_bias:
        attn["bq"] = torch.zeros((h, hd), dtype=dt, device=dev)
        attn["bk"] = torch.zeros((hkv, hd), dtype=dt, device=dev)
        attn["bv"] = torch.zeros((hkv, hd), dtype=dt, device=dev)

    def norm():
        p = {"scale": torch.zeros((d,), dtype=dt, device=dev)}
        if cfg.norm == "layernorm":
            p["bias"] = torch.zeros((d,), dtype=dt, device=dev)
        return p

    layer = {"attn": attn, "ln1": norm()}
    if not cfg.parallel_block:
        layer["ln2"] = norm()
    layer["mlp"] = {
        "w_gate": dense_init(gen, (d, cfg.d_ff), 0, dtype=dt),
        "w_up": dense_init(gen, (d, cfg.d_ff), 0, dtype=dt),
        "w_down": dense_init(gen, (cfg.d_ff, d), 0, dtype=dt),
    }
    return layer


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """Random weights with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    tree = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=dt),
            "layers": [_layer_tree(gen, cfg) for _ in range(cfg.n_layers)],
            "final_norm": {"scale": torch.zeros((cfg.d_model,), dtype=dt,
                                                device=gen.device)}}
    if cfg.norm == "layernorm":
        tree["final_norm"]["bias"] = torch.zeros((cfg.d_model,), dtype=dt,
                                                 device=gen.device)
    if not cfg.tie_embeddings:
        tree["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), 0,
                                     dtype=dt)
    return Transformer(tree)


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cuda") -> Transformer:
    """The JAX package's params tree (leaves as numpy arrays, layers
    stacked on a leading L axis) as the port's module, in ``cfg.dtype``."""
    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=cfg.dtype)

    def walk(node, pick=None):
        if isinstance(node, dict):
            return {k: walk(v, pick) for k, v in node.items()}
        return conv(node if pick is None else np.asarray(node)[pick])

    out = {k: walk(v) for k, v in tree.items() if k != "layers"}
    out["layers"] = [walk(tree["layers"], i) for i in range(cfg.n_layers)]
    return Transformer(out)


def _norm(cfg, x, p):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"] if "bias" in p else None)


def _ffn_dense(cfg, p, x):
    act = ACTIVATIONS[cfg.act]
    return (act(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _attention_block(cfg, p, h, positions, kv_cache=None, cache_len=None):
    """h [B, S, d] (pre-normed) -> (attn_out [B, S, d], (k, v)).  With a
    cache, k/v are written into it in place at ``cache_len`` (JAX's
    ``dynamic_update_slice`` on a donated buffer does the same) and the
    query attends to the first ``cache_len + S`` positions."""
    q = torch.einsum("bsd,dhk->bhsk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    if kv_cache is None:
        o = attention(q, k, v, causal=True, softcap=cfg.attn_softcap)
        new_kv = (k, v)
    else:
        ck, cv = kv_cache
        s = q.shape[2]
        if cache_len + s > ck.shape[2]:
            raise ValueError(f"cache of {ck.shape[2]} positions is full at "
                             f"{cache_len} + {s}")
        ck[:, :, cache_len:cache_len + s] = k.to(ck.dtype)
        cv[:, :, cache_len:cache_len + s] = v.to(cv.dtype)
        o = decode_attention(q, ck, cv, cache_len + s,
                             softcap=cfg.attn_softcap)
        new_kv = (ck, cv)
    out = torch.einsum("bhsk,hkd->bsd", o.to(h.dtype), p["wo"])
    return out, new_kv


def _layer_apply(cfg, p, x, positions, kv_cache=None, cache_len=None):
    h = _norm(cfg, x, p["ln1"])
    attn_out, new_kv = _attention_block(cfg, p["attn"], h, positions,
                                        kv_cache, cache_len)
    if cfg.parallel_block:
        return x + attn_out + _ffn_dense(cfg, p["mlp"], h), new_kv
    x = x + attn_out
    return x + _ffn_dense(cfg, p["mlp"], _norm(cfg, x, p["ln2"])), new_kv


def _unembed(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w.to(cfg.dtype)) * cfg.logit_scale


def _softcap_logits(cfg, logits):
    if cfg.logit_softcap:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


@torch.no_grad()
def forward(params: Transformer, tokens, cfg: TransformerConfig):
    """Full-sequence forward.  tokens [B, S] -> (logits [B, S, V], aux);
    aux is None (dense FFN)."""
    x = params["embed"][tokens.long()].to(cfg.dtype) * cfg.emb_scale
    positions = torch.arange(tokens.shape[1], device=x.device)
    for p in params.layers:
        x, _ = _layer_apply(cfg, p, x, positions)
    x = _norm(cfg, x, params["final_norm"])
    return _softcap_logits(cfg, _unembed(params, cfg, x)), None


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device="cuda") -> dict:
    """Zeroed KV cache {"k", "v"}, each [L, B, Hkv, max_len, hd]."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def prefill(params: Transformer, tokens, cfg: TransformerConfig,
            max_len: int):
    """Prefill: (last-position logits [B, 1, V], the KV cache filled at
    positions < S and zero after).  No ``logit_softcap``, as in the
    reference's prefill (its ``decode_step`` and ``forward`` apply it)."""
    b, s = tokens.shape
    x = params["embed"][tokens.long()].to(cfg.dtype) * cfg.emb_scale
    positions = torch.arange(s, device=x.device)
    cache = init_cache(cfg, b, max_len, device=x.device)
    for i, p in enumerate(params.layers):
        h = _norm(cfg, x, p["ln1"])
        attn_out, (k, v) = _attention_block(cfg, p["attn"], h, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
        if cfg.parallel_block:
            x = x + attn_out + _ffn_dense(cfg, p["mlp"], h)
        else:
            x = x + attn_out
            x = x + _ffn_dense(cfg, p["mlp"], _norm(cfg, x, p["ln2"]))
    x = _norm(cfg, x[:, -1:, :], params["final_norm"])
    return _unembed(params, cfg, x), cache


@torch.no_grad()
def decode_step(params: Transformer, token, cache: dict, cache_len: int,
                cfg: TransformerConfig):
    """One-token decode.  token [B, 1]; cache leaves [L, B, Hkv, M, hd],
    updated in place at position ``cache_len``.  Returns (logits [B, 1, V],
    cache)."""
    x = params["embed"][token.long()].to(cfg.dtype) * cfg.emb_scale
    positions = torch.full((token.shape[0], 1), int(cache_len),
                           dtype=torch.int32, device=x.device)
    for i, p in enumerate(params.layers):
        x, _ = _layer_apply(cfg, p, x, positions,
                            kv_cache=(cache["k"][i], cache["v"][i]),
                            cache_len=int(cache_len))
    x = _norm(cfg, x, params["final_norm"])
    return _softcap_logits(cfg, _unembed(params, cfg, x)), cache
