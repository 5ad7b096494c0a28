"""Decoder-only LM: GQA + RoPE + {RMS,Layer}Norm + {dense, MoE} FFN.

The port of ``repro/models/transformer.py`` for the single-card
configurations (tinyllama-1.1b, qwen2-7b, and the MoE LMs grok-1-314b and
phi3.5-moe-42b-a6.6b at a cut depth).  Parameters keep the JAX package's
tree and layouts (``wq [d, H, hd]``, ``wo [H, hd, d]``, ``moe.w_gate [E,
d, f]``, the KV cache ``[L, B, Hkv, M, hd]``), each layer leaf one ``[L,
...]`` parameter as JAX stacks it, held by a :class:`Transformer` module
(:meth:`~Transformer.tree` is the reference's params tree of the module's
own tensors).  Eager PyTorch runs the layers as a Python loop over views
of the stacked leaves, where JAX scans them.  ``init_params``,
``forward``, ``prefill``, ``decode_step``, ``init_cache``,
``kv_quantize``, ``kv_dequantize`` and ``loss_fn`` keep the JAX names and
arguments, with the module in place of the params tree.  Attention over a
whole sequence runs on the K4 kernel (``kernels/flash_attention``, whose
backward is the reference's chunked XLA one in PyTorch); single-token
decode, projections, the FFN, the MoE layer (``moe.py``) and the
unembedding are plain PyTorch, as they are plain XLA in JAX.

Training: ``forward`` and ``loss_fn`` carry gradients once the parameters
require them (``init_params`` makes them without: serving keeps
``requires_grad=False``; ``launch/steps.py``'s train step turns them on).
A layer leaf's gradient is its ``[L, ...]`` stack, the reference's leaf
that the optimizer and the snapshots see.  With ``cfg.remat`` each layer
runs under ``torch.utils.checkpoint`` (non-reentrant;
``remat_policy="dots"`` keeps the 2-D matrix products, as JAX's
``dots_with_no_batch_dims_saveable``), where JAX wraps the scanned body in
``jax.checkpoint``.

The int8 KV cache (``kv_quant``) holds int8 values and float32 scales per
position and head, ``{k, v, k_scale, v_scale}``; ``prefill`` still
returns the unquantized cache, which ``kv_quantize`` turns into one, as in
the reference.

Sharded: the reference's ``logical_constraint`` and ``moe_apply`` calls
stand at the same points (``dist/sharding.py``).  With the parameters
DTensors (placed by ``launch/steps.py``'s ``Cell.param_shardings``) and
the tokens a DTensor (``Cell.batch_spec_fn``), under ``cell.context(mesh)``
every function here runs the global computation on the ranks' shards:
the constraints redistribute the activations, attention runs K4 on each
rank's local heads, ``moe_ffn`` routes the whole batch, and the embedding
is looked up on each rank's vocab block (``_lookup``).  The
int8 cache runs unsharded.  With no context and plain tensors every path
is what it was.
"""

from __future__ import annotations

import dataclasses
from functools import partial

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..dist.sharding import (current_context, logical_constraint,
                             moe_apply, shard_index, sharding_context)
from ..kernels.flash_attention.ops import attention, decode_attention
from .common import (
    ACTIVATIONS,
    apply_rope,
    cross_entropy,
    dense_init,
    embed_init,
    layernorm,
    rmsnorm,
)
from .moe import MoEConfig, init_moe, moe_ffn, router_aux_loss

__all__ = ["TransformerConfig", "Transformer", "init_params", "forward",
           "prefill", "decode_step", "init_cache", "params_from_numpy",
           "params_to_numpy", "param_shapes", "loss_fn", "kv_quantize",
           "kv_dequantize"]


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
    moe: MoEConfig | None = None
    tie_embeddings: bool = True
    emb_scale: float = 1.0
    logit_scale: float = 1.0
    dtype: torch.dtype = torch.float32
    remat: bool = True
    # remat policy: None = full recompute; "dots" = save the 2-D matrix
    # products (less backward recompute, more live memory)
    remat_policy: str | None = None
    # int8 KV cache with per-position-per-head f32 scales: decode is
    # KV-bandwidth-bound, so int8 halves the dominant term against bf16
    kv_quant: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def _attn_params(self) -> int:
        d, h, hkv, hd = self.d_model, self.n_heads, self.n_kv_heads, self.hd
        return d * h * hd + 2 * d * hkv * hd + h * hd * d

    def _emb_params(self) -> int:
        return self.vocab * self.d_model * (1 if self.tie_embeddings else 2)

    def param_count(self) -> int:
        d = self.d_model
        if self.moe is not None:
            e = self.moe.n_experts
            ffn = d * e + 3 * e * d * self.moe.d_ff
        else:
            ffn = 3 * d * self.d_ff
        return self.n_layers * (self._attn_params() + ffn) + \
            self._emb_params()

    def active_param_count(self) -> int:
        """Parameters one token reads (the 6 N_active D convention of MoE
        rooflines): the router and ``top_k`` experts a layer."""
        if self.moe is None:
            return self.param_count()
        d, m = self.d_model, self.moe
        ffn = d * m.n_experts + 3 * m.top_k * d * m.d_ff
        return self.n_layers * (self._attn_params() + ffn) + \
            self._emb_params()


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

    def tree(self) -> dict:
        """The leaves as a nested dict of the module's own parameters."""
        return {key: (child.tree() if isinstance(child, _Tree) else child)
                for key, child in [*self._parameters.items(),
                                   *self._modules.items()]}


class Transformer(_Tree):
    """The parameters: ``embed``, ``layers`` (each leaf stacked ``[L,
    ...]``), ``final_norm`` and, untied, ``unembed``."""

    def layer_params(self) -> list:
        """Layer ``i``'s parameters as a nested dict of views ``[i]`` of
        the stacked leaves: one ``unbind`` a leaf, whose backward stacks
        the L gradients in one write."""
        def walk(node):
            if isinstance(node, dict):
                subs = {k: walk(v) for k, v in node.items()}
                return [{k: sub[i] for k, sub in subs.items()}
                        for i in range(n)]
            return node.unbind(0)
        n = self.layers["ln1"]["scale"].shape[0]
        return walk(self.layers.tree())


def _layer_tree(gen, cfg: TransformerConfig, out=None) -> dict:
    """One layer's leaves drawn from ``gen``; ``gen=None``: their shapes as
    meta tensors; ``out``: a zeroed tree of the same leaves to draw
    into (the zero leaves stay)."""
    d, h, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    dt = cfg.dtype
    dev = gen.device if gen is not None else torch.device("meta")
    o = out or {}

    def w(group, key, shape, in_axis):
        return dense_init(gen, shape, in_axis, dtype=dt,
                          out=o[group][key] if o else None)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    attn = {
        "wq": w("attn", "wq", (d, h, hd), 0),
        "wk": w("attn", "wk", (d, hkv, hd), 0),
        "wv": w("attn", "wv", (d, hkv, hd), 0),
        "wo": w("attn", "wo", (h, hd, d), (0, 1)),
    }
    if cfg.qkv_bias:
        attn["bq"] = zeros((h, hd))
        attn["bk"] = zeros((hkv, hd))
        attn["bv"] = zeros((hkv, hd))

    def norm():
        p = {"scale": zeros((d,))}
        if cfg.norm == "layernorm":
            p["bias"] = zeros((d,))
        return p

    layer = {"attn": attn, "ln1": norm()}
    if not cfg.parallel_block:
        layer["ln2"] = norm()
    if cfg.moe is not None:
        layer["moe"] = init_moe(gen, d, cfg.moe, dtype=dt, out=o.get("moe"))
    else:
        layer["mlp"] = {
            "w_gate": w("mlp", "w_gate", (d, cfg.d_ff), 0),
            "w_up": w("mlp", "w_up", (d, cfg.d_ff), 0),
            "w_down": w("mlp", "w_down", (cfg.d_ff, d), 0),
        }
    return layer


def _map(fn, tree, *rest):
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def init_params(cfg: TransformerConfig, seed: int = 0,
                device="cuda") -> Transformer:
    """Random weights with the reference's distributions, drawn on
    ``device`` from a generator seeded with ``seed``, layer after layer,
    straight into the stacked leaves (no layer is held twice)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    dt = cfg.dtype
    tree = {"embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype=dt),
            "layers": _map(lambda t: torch.zeros(
                (cfg.n_layers, *t.shape), dtype=t.dtype, device=gen.device),
                _layer_tree(None, cfg))}
    for i in range(cfg.n_layers):
        _layer_tree(gen, cfg, out=_map(lambda t: t[i], tree["layers"]))
    tree["final_norm"] = {"scale": torch.zeros((cfg.d_model,), dtype=dt,
                                               device=gen.device)}
    if cfg.norm == "layernorm":
        tree["final_norm"]["bias"] = torch.zeros((cfg.d_model,), dtype=dt,
                                                 device=gen.device)
    if not cfg.tie_embeddings:
        tree["unembed"] = dense_init(gen, (cfg.d_model, cfg.vocab), 0,
                                     dtype=dt)
    return Transformer(tree)


def param_shapes(cfg: TransformerConfig) -> dict:
    """The parameter tree as meta tensors (shapes and dtypes, no storage:
    ``jax.eval_shape`` of the reference's ``init_params``)."""
    def meta(*shape, dtype=cfg.dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    tree = {"embed": meta(cfg.vocab, cfg.d_model),
            "layers": _map(lambda t: meta(cfg.n_layers, *t.shape,
                                          dtype=t.dtype),
                           _layer_tree(None, cfg)),
            "final_norm": {"scale": meta(cfg.d_model)}}
    if cfg.norm == "layernorm":
        tree["final_norm"]["bias"] = meta(cfg.d_model)
    if not cfg.tie_embeddings:
        tree["unembed"] = meta(cfg.d_model, cfg.vocab)
    return tree


def params_from_numpy(tree: dict, cfg: TransformerConfig,
                      device="cuda") -> Transformer:
    """The JAX package's params tree (leaves as numpy arrays, layers
    stacked on a leading L axis) as the port's module, in ``cfg.dtype``
    but the MoE ``router``, which stays float32 as ``init_moe`` makes
    it."""
    def walk(node, name=None):
        if isinstance(node, dict):
            return {k: walk(v, k) for k, v in node.items()}
        dt = torch.float32 if name == "router" else cfg.dtype
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(
            device=device, dtype=dt)

    return Transformer(walk(tree))


def params_to_numpy(params: Transformer, cfg: TransformerConfig) -> dict:
    """The inverse of :func:`params_from_numpy`: the JAX package's params
    tree with numpy leaves (bfloat16 leaves widened to float32, which
    numpy holds)."""
    n = params.layers["ln1"]["scale"].shape[0]
    if n != cfg.n_layers:
        raise ValueError(f"{n} layers for a config of {cfg.n_layers}")

    def conv(t):
        t = t.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    return _map(conv, params.tree())


def _norm(cfg, x, p):
    if cfg.norm == "rmsnorm":
        return rmsnorm(x, p["scale"])
    return layernorm(x, p["scale"], p["bias"] if "bias" in p else None)


def _ffn_dense(cfg, p, x):
    act = ACTIVATIONS[cfg.act]
    h = act(x @ p["w_gate"]) * (x @ p["w_up"])
    h = logical_constraint(h, "batch", "seq", "ffn")
    return h @ p["w_down"]


def _ffn(cfg, p, x):
    """The layer's FFN on [B, S, d] -> ([B, S, d], the MoE router
    statistics or None): ``moe_ffn`` on the [B*S, d] tokens, or the dense
    SwiGLU."""
    if cfg.moe is None:
        return _ffn_dense(cfg, p["mlp"], x), None
    b, s, d = x.shape
    y, aux = moe_apply(partial(moe_ffn, cfg=cfg.moe), p["moe"],
                       x.reshape(b * s, d))
    return y.reshape(b, s, d), aux


def kv_quantize(x):
    """[..., D] -> (int8 values, per-row scale [..., 1] f32).  Rounds half
    to even, as ``jnp.round`` does.  The scale stays f32: a bf16 scale
    adds ~0.4 % relative error to every dequantized row."""
    xf = x.float()
    s = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-6) / 127.0
    q = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return q, s


def kv_dequantize(q, s, dtype):
    return (q.float() * s.float()).to(dtype)


def _write_cache(cache, at: int, new) -> None:
    """Write ``new`` [B, Hkv, S, X] into ``cache`` at position ``at``, in
    place (JAX's ``dynamic_update_slice`` on a donated buffer does the
    same).  A DTensor cache is written shard by shard: each rank writes
    the positions its block holds."""
    s = new.shape[2]
    if at + s > cache.shape[2]:
        raise ValueError(f"cache of {cache.shape[2]} positions is full at "
                         f"{at} + {s}")
    if isinstance(cache, DTensor):
        _write_cache_sharded(cache, at, new)
        return
    cache[:, :, at:at + s] = new.to(cache.dtype)


def _write_cache_sharded(cache, at: int, new) -> None:
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    if not isinstance(new, DTensor) or new.device_mesh != mesh:
        raise TypeError("a DTensor cache takes a DTensor on its mesh")
    if any(p.is_partial() or (p.is_shard() and p.dim == 3)
           for p in cache.placements):
        raise ValueError(f"a cache laid out {cache.placements}")
    seq_dims = [i for i, p in enumerate(cache.placements) if p == Shard(2)]
    want = tuple(Replicate() if i in seq_dims else p
                 for i, p in enumerate(cache.placements))
    local = new.redistribute(mesh, want).to_local()
    block = cache.to_local()
    m = block.shape[2]
    first = shard_index(mesh, seq_dims) * m
    lo, hi = max(at, first), min(at + new.shape[2], first + m)
    if lo < hi:
        block[:, :, lo - first:hi - first] = \
            local[:, :, lo - at:hi - at].to(block.dtype)


def _attention_block(cfg, p, h, positions, kv_cache=None, cache_len=None):
    """h [B, S, d] (pre-normed) -> (attn_out [B, S, d], the cache tuple).
    With a cache, (k, v) or the int8 (k, v, k_scale, v_scale), the new
    k/v are written into it in place at ``cache_len`` and the query
    attends to the first ``cache_len + S`` positions."""
    q = torch.einsum("bsd,dhk->bhsk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bhsk", h, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", h, p["wv"])
    if cfg.qkv_bias:
        q = q + p["bq"][None, :, None, :]
        k = k + p["bk"][None, :, None, :]
        v = v + p["bv"][None, :, None, :]
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    q = logical_constraint(q, "batch", "heads", "seq", None)
    k = logical_constraint(k, "batch", "kv_heads", "seq", None)
    v = logical_constraint(v, "batch", "kv_heads", "seq", None)
    if kv_cache is None:
        o = attention(q, k, v, causal=True, softcap=cfg.attn_softcap)
        new_kv = (k, v)
    elif len(kv_cache) == 4:
        # int8 cache: quantize the new rows, attend to the dequantized cache
        ck, cv, cks, cvs = kv_cache
        if isinstance(ck, DTensor):
            raise ValueError("the int8 KV cache runs unsharded")
        qk, sk = kv_quantize(k)
        qv, sv = kv_quantize(v)
        for cache, new in ((ck, qk), (cv, qv), (cks, sk), (cvs, sv)):
            _write_cache(cache, cache_len, new)
        o = decode_attention(q, kv_dequantize(ck, cks, h.dtype),
                             kv_dequantize(cv, cvs, h.dtype),
                             cache_len + q.shape[2], softcap=cfg.attn_softcap)
        new_kv = kv_cache
    else:
        ck, cv = kv_cache
        _write_cache(ck, cache_len, k)
        _write_cache(cv, cache_len, v)
        o = decode_attention(q, ck, cv, cache_len + q.shape[2],
                             softcap=cfg.attn_softcap)
        new_kv = kv_cache
    out = torch.einsum("bhsk,hkd->bsd", o.to(h.dtype), p["wo"])
    return logical_constraint(out, "batch", "seq", "embed"), new_kv


def _layer_apply(cfg, p, x, positions, kv_cache=None, cache_len=None):
    """One block -> (x, the cache tuple, the MoE router statistics or
    None)."""
    h = _norm(cfg, x, p["ln1"])
    attn_out, new_kv = _attention_block(cfg, p["attn"], h, positions,
                                        kv_cache, cache_len)
    if cfg.parallel_block:
        ff_out, aux = _ffn(cfg, p, h)
        x = x + attn_out + ff_out
    else:
        x = x + attn_out
        ff_out, aux = _ffn(cfg, p, _norm(cfg, x, p["ln2"]))
        x = x + ff_out
    x = logical_constraint(x, "batch", "seq", "embed")
    return x, new_kv, aux


def _unembed(params, cfg, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return (x @ w.to(cfg.dtype)) * cfg.logit_scale


def _softcap_logits(cfg, logits):
    if cfg.logit_softcap:
        return cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


def _embed(params, tokens, cfg):
    """The scaled embedding rows of ``tokens``, laid out (batch, seq,
    embed); a DTensor table is looked up per rank (:func:`_lookup`)."""
    table = params["embed"]
    rows = (_lookup(table, tokens) if isinstance(table, DTensor)
            else table[tokens.long()])
    x = rows.to(cfg.dtype) * cfg.emb_scale
    return logical_constraint(x, "batch", "seq", "embed")


def _lookup(table, tokens):
    """``table[tokens]`` for a DTensor table (rows split over some mesh
    dims, or replicated) and DTensor tokens (split over others), on each
    rank's own blocks: a rank gathers its tokens' rows from its vocab
    block, zero where another block holds them, and the rows are partial
    sums over the vocab dims (DTensor's masked lookup, written out: its
    strategies differ between torch versions).  A replicated table is
    indexed as the unsharded path indexes it."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    if not isinstance(tokens, DTensor) or \
            tokens.device_mesh != table.device_mesh:
        raise TypeError("a DTensor embedding takes DTensor tokens on its "
                        "mesh")
    mesh = table.device_mesh
    vocab = [i for i, p in enumerate(table.placements) if p.is_shard()]
    tok = [i for i, p in enumerate(tokens.placements) if p.is_shard()]
    if any(p != Shard(0) for i, p in enumerate(table.placements)
           if i in vocab) or any(p != Shard(0) for i, p in
                                 enumerate(tokens.placements) if i in tok):
        raise ValueError(f"an embedding table laid out {table.placements} "
                         f"with tokens {tokens.placements}")
    if set(vocab) & set(tok):
        raise ValueError("tokens and vocab split over the same mesh dim")
    n = mesh.ndim
    local = table.to_local(grad_placements=[
        Shard(0) if i in vocab else Partial() if i in tok else Replicate()
        for i in range(n)])
    ids = tokens.to_local().long()
    if vocab:
        ids = ids - shard_index(mesh, vocab) * local.shape[0]
        inside = (ids >= 0) & (ids < local.shape[0])
        rows = torch.where(inside[..., None], local[ids.clamp(
            0, local.shape[0] - 1)], 0)
    else:
        rows = local[ids]
    return DTensor.from_local(
        rows, mesh, [Partial() if i in vocab else p
                     for i, p in enumerate(tokens.placements)],
        shape=(*tokens.shape, table.shape[1]),
        stride=(*(st * table.shape[1] for st in tokens.stride()), 1))


def _block(cfg, p, x, positions):
    x, _, aux = _layer_apply(cfg, p, x, positions)
    return x, aux


def _save_dots():
    """Selective-checkpoint contexts that keep the 2-D matrix products
    (``mm``/``addmm``: the projections, FFN and unembedding, JAX's dots
    without batch dimensions) and recompute the rest."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)

    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in dots
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def _layer_fn(cfg):
    """One block as the forward runs it: under a non-reentrant checkpoint
    when ``cfg.remat`` is set and gradients are on."""
    if cfg.remat_policy not in (None, "dots"):
        raise ValueError(f"remat_policy {cfg.remat_policy!r}: None or "
                         f"'dots'")
    if not (cfg.remat and torch.is_grad_enabled()):
        return _block
    from torch.utils.checkpoint import checkpoint

    kw = {"context_fn": _save_dots} if cfg.remat_policy == "dots" else {}
    ctx = current_context()
    if ctx is None:
        return lambda *a: checkpoint(_block, *a, use_reentrant=False, **kw)

    def block(*a):
        # the backward recomputes on the autograd engine's device thread,
        # which has no sharding context of its own: bind the forward's
        with sharding_context(ctx["mesh"], ctx["rules"], ctx["plan"]):
            return _block(*a)
    return lambda *a: checkpoint(block, *a, use_reentrant=False, **kw)


def forward(params: Transformer, tokens, cfg: TransformerConfig):
    """Training/prefill forward.  tokens [B, S] -> (logits [B, S, V],
    aux): aux is the MoE router statistics averaged over the layers, None
    for a dense FFN.  Differentiable when the parameters require grad."""
    x = _embed(params, tokens, cfg)
    positions = torch.arange(tokens.shape[1], device=x.device)
    layer = _layer_fn(cfg)
    auxs = []
    for p in params.layer_params():
        x, aux = layer(cfg, p, x, positions)
        auxs.append(aux)
    x = _norm(cfg, x, params["final_norm"])
    logits = _softcap_logits(cfg, _unembed(params, cfg, x))
    logits = logical_constraint(logits, "batch", "seq", "vocab")
    if cfg.moe is None:
        return logits, None
    return logits, {k: torch.stack([a[k] for a in auxs]).mean(0)
                    for k in auxs[0]}


def loss_fn(params: Transformer, tokens, labels, cfg: TransformerConfig):
    """Mean token cross entropy (f32, ``z_loss=1e-4``) plus, for an MoE
    LM, the router's load-balance and z losses."""
    logits, aux = forward(params, tokens, cfg)
    loss = cross_entropy(logits, labels, z_loss=1e-4)
    if aux is not None:
        loss = loss + router_aux_loss(aux, cfg.moe)
    return loss


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, device="cuda") -> dict:
    """Zeroed KV cache {"k", "v"}, each [L, B, Hkv, max_len, hd]; with
    ``kv_quant``, int8 values and f32 ``k_scale``/``v_scale`` [L, B, Hkv,
    max_len, 1]."""
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.hd)
    if cfg.kv_quant:
        sshape = shape[:-1] + (1,)
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(sshape, device=device),
                "v_scale": torch.zeros(sshape, device=device)}
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


@torch.no_grad()
def prefill(params: Transformer, tokens, cfg: TransformerConfig,
            max_len: int):
    """Prefill: (last-position logits [B, 1, V], the unquantized KV cache
    filled at positions < S and zero after), also with ``kv_quant``, as in
    the reference.  No ``logit_softcap``, as in the reference's prefill
    (its ``decode_step`` and ``forward`` apply it)."""
    b, s = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = torch.arange(s, device=x.device)
    if isinstance(x, DTensor):
        return _prefill_sharded(params, x, positions, cfg, max_len)
    cache = init_cache(dataclasses.replace(cfg, kv_quant=False), b, max_len,
                       device=x.device)
    for i, p in enumerate(params.layer_params()):
        x, (k, v), _ = _layer_apply(cfg, p, x, positions)
        cache["k"][i, :, :, :s] = k
        cache["v"][i, :, :, :s] = v
    x = _norm(cfg, x[:, -1:, :], params["final_norm"])
    return _unembed(params, cfg, x), cache


def _prefill_sharded(params, x, positions, cfg, max_len: int):
    """``prefill`` on DTensors: each layer's k/v padded to ``max_len``
    positions and stacked, as the reference's scan does, in the layout
    attention left them ([batch, kv_heads]).  The padding and the stack
    run on each rank's blocks (the positions are not split)."""
    from torch.distributed.tensor import Shard

    ks, vs = [], []
    pad = max_len - x.shape[1]
    for p in params.layer_params():
        x, (k, v), _ = _layer_apply(cfg, p, x, positions)
        ks.append(k)
        vs.append(v)
    x = _norm(cfg, x[:, -1:, :], params["final_norm"])

    def stacked(ts):
        t = ts[0]
        if any(q.is_partial() or (q.is_shard() and q.dim >= 2)
               for q in t.placements):
            raise ValueError(f"a KV block laid out {t.placements}")
        local = torch.stack([F.pad(u.to_local(), (0, 0, 0, pad))
                             for u in ts])
        shape = (len(ts), *t.shape[:2], max_len, t.shape[3])
        return DTensor.from_local(
            local, t.device_mesh, [Shard(q.dim + 1) if q.is_shard() else q
                                   for q in t.placements],
            shape=shape, stride=torch.empty(shape, device="meta").stride())
    return _unembed(params, cfg, x), {"k": stacked(ks), "v": stacked(vs)}


@torch.no_grad()
def decode_step(params: Transformer, token, cache: dict, cache_len: int,
                cfg: TransformerConfig):
    """One-token decode.  token [B, 1]; cache leaves [L, B, Hkv, M, hd]
    (with ``kv_quant`` the int8 cache of :func:`init_cache`), updated in
    place at position ``cache_len``.  Returns (logits [B, 1, V], cache)."""
    x = _embed(params, token, cfg)
    positions = torch.full((token.shape[0], 1), int(cache_len),
                           dtype=torch.int32, device=x.device)
    names = ("k", "v", "k_scale", "v_scale") if cfg.kv_quant else ("k", "v")
    for i, p in enumerate(params.layer_params()):
        x, _, _ = _layer_apply(cfg, p, x, positions,
                               kv_cache=tuple(cache[n][i] for n in names),
                               cache_len=int(cache_len))
    x = _norm(cfg, x, params["final_norm"])
    return _softcap_logits(cfg, _unembed(params, cfg, x)), cache
