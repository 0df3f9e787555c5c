"""Transformer encoder-decoder for NMT: the port of
paddle_tpu/models/transformer.py (BASELINE config "Transformer-big WMT
En-De").

The parameter tree is keyed exactly like the JAX package's (``src_embed``,
``enc[2].attn.q_w``, ``dec[0].cross_attn.o_b``, ``dec_ln.g``, ...) with
weights kept ``[in, out]``, so JAX parameters cross over by name through
:func:`params_from_numpy`. Parameters are fp32 masters; activations run in
``cfg.dtype`` (bf16 by default), each weight cast where it is used, as in
the JAX code:

- attention scores are computed in ``cfg.dtype`` and divided by sqrt(hd)
  there, then cast to fp32, where the fp32 -1e9 mask bias is added and the
  softmax taken; the probabilities go back to ``cfg.dtype``;
- LayerNorm takes fp32 statistics with eps 1e-6;
- the sinusoid table is concat(sin, cos), not interleaved;
- the output projection is tied to ``tgt_embed`` and runs in fp32, with
  TF32 off (``_fp32_matmuls``), as do all products of an fp32 config;
- ``cfg.dropout`` is kept for parity and applied nowhere, as in the JAX
  forward.

Nothing here reaches a Pallas kernel in the JAX package (its LayerNorm,
attention, embedding lookups and log-softmax are plain jnp), so this module
is plain PyTorch; the update is the optimizer's one ``fused_adam`` launch.
Decoding is a Python loop over ``pos`` with static shapes: the K/V cache is
preallocated at ``max_seq`` and written in place at ``pos``, every step
attends over all ``max_seq`` slots under the ``arange(max_seq) <= pos``
mask, and nothing in the loop reads a card value back, so a decode syncs
once, when its result is read. Sharding specs and the mesh are ROADMAP
queue 1 item 9.
"""

import contextlib
import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.models._mesh import refuse_mesh

__all__ = ["TransformerConfig", "transformer_base", "transformer_big",
           "transformer_tiny", "init_params", "params_from_numpy", "forward",
           "nmt_loss", "make_train_step", "greedy_decode",
           "beam_search_decode", "synthetic_batch"]

_NEG = -1e9     # the additive mask bias and the dead beams' score


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    src_vocab: int = 32768
    tgt_vocab: int = 32768
    hidden: int = 512
    num_heads: int = 8
    ffn: int = 2048
    enc_layers: int = 6
    dec_layers: int = 6
    max_seq: int = 256
    dropout: float = 0.1             # kept for parity; forward applies none
    dtype: torch.dtype = torch.bfloat16
    label_smoothing: float = 0.1
    bos_id: int = 0
    eos_id: int = 1
    # recompute each encoder layer in the backward (torch.utils.checkpoint),
    # as the JAX package's jax.checkpoint on _enc_layer
    remat: bool = False

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


def transformer_base(**kw):
    return TransformerConfig(**kw)


def transformer_big(**kw):
    kw.setdefault("hidden", 1024)
    kw.setdefault("num_heads", 16)
    kw.setdefault("ffn", 4096)
    return TransformerConfig(**kw)


def transformer_tiny(**kw):
    kw.setdefault("src_vocab", 64)
    kw.setdefault("tgt_vocab", 64)
    kw.setdefault("hidden", 32)
    kw.setdefault("num_heads", 4)
    kw.setdefault("ffn", 64)
    kw.setdefault("enc_layers", 2)
    kw.setdefault("dec_layers", 2)
    kw.setdefault("max_seq", 16)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _layout(cfg):
    """The parameter tree as (shape, init) leaves, init a normal's scale
    (the JAX package's ``_dense``: sqrt(1 / fan_in), 0.02 for the
    embeddings), "ones" or "zeros": the one description both
    :func:`init_params` and :func:`params_from_numpy` follow."""
    h, f = cfg.hidden, cfg.ffn

    def dense(i, o):
        return ((i, o), math.sqrt(1.0 / i))

    def attn():
        return {"q_w": dense(h, h), "q_b": ((h,), "zeros"),
                "k_w": dense(h, h), "k_b": ((h,), "zeros"),
                "v_w": dense(h, h), "v_b": ((h,), "zeros"),
                "o_w": dense(h, h), "o_b": ((h,), "zeros")}

    def ln():
        return {"g": ((h,), "ones"), "b": ((h,), "zeros")}

    def ffn():
        return {"w1": dense(h, f), "b1": ((f,), "zeros"),
                "w2": dense(f, h), "b2": ((h,), "zeros")}

    return {
        "src_embed": ((cfg.src_vocab, h), 0.02),
        "tgt_embed": ((cfg.tgt_vocab, h), 0.02),
        "enc": [{"attn": attn(), "ln1": ln(), "ffn": ffn(), "ln2": ln()}
                for _ in range(cfg.enc_layers)],
        "dec": [{"self_attn": attn(), "ln1": ln(), "cross_attn": attn(),
                 "ln2": ln(), "ffn": ffn(), "ln3": ln()}
                for _ in range(cfg.dec_layers)],
        "enc_ln": ln(), "dec_ln": ln(),
    }


def _walk(spec, fn, path=""):
    if isinstance(spec, dict):
        return {k: _walk(s, fn, f"{path}.{k}".lstrip("."))
                for k, s in spec.items()}
    if isinstance(spec, list):
        return [_walk(s, fn, f"{path}.{i}") for i, s in enumerate(spec)]
    return fn(path, *spec)


def init_params(cfg, generator, device=None):
    """fp32 master params as a nested dict (lists for ``enc``/``dec``):
    normal weights of the JAX package's scales drawn from ``generator`` (a
    ``torch.Generator``, on the CPU or on the card), ones/zeros for
    LayerNorm and biases. ``device`` defaults to the card."""
    device = resolve_device(device)

    def make(_, shape, init):
        if init in ("ones", "zeros"):
            fill = torch.ones if init == "ones" else torch.zeros
            return fill(shape, dtype=torch.float32, device=device)
        t = init * torch.randn(shape, generator=generator,
                               device=generator.device, dtype=torch.float32)
        return t.to(device)

    return _walk(_layout(cfg), make)


def params_from_numpy(tree, cfg, device=None):
    """The port's params from the JAX package's, after
    ``jax.tree.map(np.asarray, params)``. Strict: every leaf must be a
    float32 numpy array of the expected shape, every expected leaf present
    and no other; anything else raises. ``device`` defaults to the card."""
    device = resolve_device(device)

    def walk(spec, node, path):
        where = path or "params"
        if isinstance(spec, dict):
            if not isinstance(node, dict) or set(node) != set(spec):
                got = sorted(node) if isinstance(node, dict) \
                    else type(node).__name__
                raise EnforceNotMet(f"params_from_numpy: {where} must be a "
                                    f"dict of {sorted(spec)}, got {got}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise EnforceNotMet(
                    f"params_from_numpy: {where} must be a list of "
                    f"{len(spec)}, got {type(node).__name__}")
            return [walk(s, n, f"{path}.{i}")
                    for i, (s, n) in enumerate(zip(spec, node))]
        shape = spec[0]
        if (not isinstance(node, np.ndarray) or node.dtype != np.float32
                or node.shape != shape):
            got = (f"{node.dtype}{list(node.shape)}"
                   if isinstance(node, np.ndarray) else type(node).__name__)
            raise EnforceNotMet(
                f"params_from_numpy: {where} must be a float32 numpy array "
                f"of shape {list(shape)}, got {got}")
        return torch.tensor(node).to(device)

    return walk(_layout(cfg), tree, "")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def _fp32_matmuls():
    """fp32 matrix products stay fp32 while the model runs (forward and
    backward): cuBLAS's TF32 is off, and set back as it was after. bf16
    products are not affected."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _index(x, device):
    """Token ids or masks as an int64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), device=device).long()


def _layer_norm(x, ln, eps=1e-6):
    """fp32 statistics, the result in x's dtype (eps 1e-6, not BERT's)."""
    y = F.layer_norm(x.float(), x.shape[-1:], ln["g"], ln["b"], eps)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoid(max_seq, h, device):
    """[max_seq, h] fp32: concat(sin, cos) of pos / 10000^(2i/h), computed
    in float64 by numpy as the JAX package computes it."""
    pos = np.arange(max_seq)[:, None]
    i = np.arange(h // 2)[None, :]
    angle = pos / np.power(10000.0, 2 * i / h)
    enc = np.concatenate([np.sin(angle), np.cos(angle)], axis=-1)
    return torch.tensor(enc, dtype=torch.float32, device=device)


def _mask_bias(mask):
    """[B, 1, 1, S] fp32 additive bias: 0 where ``mask`` > 0, else -1e9."""
    return torch.where(mask[:, None, None, :] > 0, 0.0, _NEG)


def _heads(t, nh, hd):
    B, S, _ = t.shape
    return t.reshape(B, S, nh, hd).transpose(1, 2)


def _proj(x, w, b):
    return x @ w.to(x.dtype) + b.to(x.dtype)


def _mha(ap, q_in, kv_in, bias, cfg, kv=None):
    """bias: additive fp32, broadcast to [B, 1, q, k]. kv: precomputed
    (k, v) heads (the cross-attention's, or the self-attention's cache)."""
    nh, hd = cfg.num_heads, cfg.head_dim
    q = _heads(_proj(q_in, ap["q_w"], ap["q_b"]), nh, hd)
    if kv is None:
        k = _heads(_proj(kv_in, ap["k_w"], ap["k_b"]), nh, hd)
        v = _heads(_proj(kv_in, ap["v_w"], ap["v_b"]), nh, hd)
    else:
        k, v = kv
    scores = (q @ k.transpose(-1, -2)) / math.sqrt(hd)     # in cfg.dtype
    probs = torch.softmax(scores.float() + bias, dim=-1).to(q_in.dtype)
    ctx = probs @ v
    B, _, S, _ = ctx.shape
    ctx = ctx.transpose(1, 2).reshape(B, S, nh * hd)
    return _proj(ctx, ap["o_w"], ap["o_b"])


def _ffn(fp, x):
    return _proj(torch.relu(_proj(x, fp["w1"], fp["b1"])), fp["w2"],
                 fp["b2"])


def _enc_layer(lp, x, bias, cfg):
    x = _layer_norm(x + _mha(lp["attn"], x, x, bias, cfg), lp["ln1"])
    return _layer_norm(x + _ffn(lp["ffn"], x), lp["ln2"])


def _embed(table, ids, cfg, positions):
    """table[ids] * sqrt(hidden) + the sinusoid at ``positions`` (a slice
    or an int), in cfg.dtype."""
    x = F.embedding(ids, table) * math.sqrt(cfg.hidden)
    sin = _sinusoid(cfg.max_seq, cfg.hidden, table.device)[positions]
    return (x + sin).to(cfg.dtype)


def encode(params, cfg, src_ids, src_mask):
    """Encoder memory [B, S, hidden] in cfg.dtype, on the device of
    ``params``. Ids (in [0, src_vocab)) and the mask may be numpy arrays or
    tensors."""
    dev = params["src_embed"].device
    src_ids = _index(src_ids, dev)
    x = _embed(params["src_embed"], src_ids, cfg,
               slice(0, src_ids.shape[1]))
    bias = _mask_bias(_index(src_mask, dev))
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["enc"]:
        if remat:
            x = checkpoint(_enc_layer, lp, x, bias, cfg, use_reentrant=False)
        else:
            x = _enc_layer(lp, x, bias, cfg)
    return _layer_norm(x, params["enc_ln"])


def _dec_layer(lp, x, self_bias, memory, mem_bias, cfg, cache=None, pos=None,
               cross_kv=None):
    """One decoder layer. With ``cache`` (incremental decoding), this
    step's self-attention K/V are written into the cache at ``pos`` in
    place and attention runs over all of its slots."""
    ap = lp["self_attn"]
    if cache is None:
        a = _mha(ap, x, x, self_bias, cfg)
    else:
        nh, hd = cfg.num_heads, cfg.head_dim
        cache["k"][:, :, pos] = _heads(_proj(x, ap["k_w"], ap["k_b"]),
                                       nh, hd)[:, :, 0]
        cache["v"][:, :, pos] = _heads(_proj(x, ap["v_w"], ap["v_b"]),
                                       nh, hd)[:, :, 0]
        a = _mha(ap, x, None, self_bias, cfg, kv=(cache["k"], cache["v"]))
    x = _layer_norm(x + a, lp["ln1"])
    c = _mha(lp["cross_attn"], x, memory, mem_bias, cfg, kv=cross_kv)
    x = _layer_norm(x + c, lp["ln2"])
    return _layer_norm(x + _ffn(lp["ffn"], x), lp["ln3"])


def decode_train(params, cfg, tgt_ids, memory, src_mask, tgt_mask):
    """Teacher-forced decoder over the whole target (causal mask); fp32
    logits [B, T, tgt_vocab] from the tied output projection."""
    dev = params["tgt_embed"].device
    tgt_ids = _index(tgt_ids, dev)
    T = tgt_ids.shape[1]
    x = _embed(params["tgt_embed"], tgt_ids, cfg, slice(0, T))
    causal = torch.tril(torch.ones((T, T), dtype=torch.float32, device=dev))
    tgt_mask = _index(tgt_mask, dev)
    self_bias = torch.where(
        (causal[None, None] * tgt_mask[:, None, None, :]) > 0, 0.0, _NEG)
    mem_bias = _mask_bias(_index(src_mask, dev))
    for lp in params["dec"]:
        x = _dec_layer(lp, x, self_bias, memory, mem_bias, cfg)
    x = _layer_norm(x, params["dec_ln"])
    # tied output projection, fp32 logits
    return x.float() @ params["tgt_embed"].T


def forward(params, cfg, src_ids, tgt_ids, src_mask=None, tgt_mask=None):
    """fp32 logits [B, T, tgt_vocab]; masks default to all ones."""
    dev = params["src_embed"].device
    src_ids, tgt_ids = _index(src_ids, dev), _index(tgt_ids, dev)
    src_mask = (torch.ones_like(src_ids) if src_mask is None
                else _index(src_mask, dev))
    tgt_mask = (torch.ones_like(tgt_ids) if tgt_mask is None
                else _index(tgt_mask, dev))
    with _fp32_matmuls():
        memory = encode(params, cfg, src_ids, src_mask)
        return decode_train(params, cfg, tgt_ids, memory, src_mask,
                            tgt_mask)


def nmt_loss(params, cfg, batch):
    """batch: src_ids, src_mask, tgt_in, tgt_out, tgt_mask (numpy arrays or
    tensors). Label-smoothed cross-entropy averaged over non-pad target
    tokens, as -((1 - eps) logp[target] + eps / V sum(logp)): a gather and
    a reduction, no [B, T, V] one-hot."""
    logits = forward(params, cfg, batch["src_ids"], batch["tgt_in"],
                     batch.get("src_mask"), batch.get("tgt_mask"))
    logp = F.log_softmax(logits, dim=-1)
    eps, n = cfg.label_smoothing, cfg.tgt_vocab
    tgt_out = _index(batch["tgt_out"], logits.device)
    picked = logp.gather(-1, tgt_out[..., None])[..., 0]
    ll = (1.0 - eps) * picked + (eps / n) * logp.sum(dim=-1)
    w = (_index(batch["tgt_mask"], logits.device).float()
         if "tgt_mask" in batch else torch.ones_like(ll))
    return -(ll * w).sum() / torch.clamp(w.sum(), min=1.0)


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _loss_and_grads(params, cfg, batch):
    """:func:`nmt_loss` and its grads with respect to every fp32 leaf of
    params (a tree like params)."""
    live = map_tree(lambda _, t: t.detach().requires_grad_(), params)
    flat = leaves(live)
    with _fp32_matmuls():
        loss = nmt_loss(live, cfg, batch)
        grads = iter(torch.autograd.grad(loss, flat,
                                         materialize_grads=True))
    return loss.detach(), map_tree(lambda _, t: next(grads), live)


def make_train_step(cfg, optimizer, mesh=None, device=None):
    """Returns (init_fn, step_fn), as the JAX package's ``make_train_step``
    on one device: ``mesh`` must be None.

    ``init_fn(generator)`` -> (params, opt_state) on ``device`` (the card
    by default; ``generator`` as for :func:`init_params`).
    ``step_fn(params, opt_state, batch)`` -> (loss, params, opt_state): the
    grads of :func:`nmt_loss` over the fp32 leaves, then
    ``optimizer.apply_gradients`` (Adam: one ``fused_adam`` launch over the
    258 tensors of Transformer-big), which updates params and opt_state
    **in place** and returns them (JAX donates them instead). loss is a 0-d
    fp32 tensor on the device; reading it syncs."""
    refuse_mesh(mesh, "transformer.make_train_step")
    device = resolve_device(device)

    def init_fn(generator):
        params = init_params(cfg, generator, device=device)
        return params, optimizer.init(params)

    def step_fn(params, opt_state, batch):
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        loss, grads = _loss_and_grads(params, cfg, batch)
        optimizer.apply_gradients(params, grads, opt_state)
        return loss, params, opt_state

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# decoding
# ---------------------------------------------------------------------------
def _check_max_len(cfg, max_len):
    max_len = max_len or cfg.max_seq
    if max_len > cfg.max_seq:
        raise ValueError(
            f"max_len={max_len} exceeds cfg.max_seq={cfg.max_seq}: the "
            f"K/V cache and sinusoid table are sized to max_seq")
    return max_len


def _init_cache(cfg, B, device):
    """Per decoder layer, zeroed K and V caches [B, heads, max_seq, hd] in
    cfg.dtype, written in place at each step's position."""
    shape = (B, cfg.num_heads, cfg.max_seq, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
             "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
            for _ in range(cfg.dec_layers)]


def _cross_kv(params, cfg, memory):
    """Each decoder layer's cross-attention K/V heads of the encoder
    memory, projected once per decode instead of at every step."""
    nh, hd = cfg.num_heads, cfg.head_dim
    out = []
    for lp in params["dec"]:
        ap = lp["cross_attn"]
        out.append((_heads(_proj(memory, ap["k_w"], ap["k_b"]), nh, hd),
                    _heads(_proj(memory, ap["v_w"], ap["v_b"]), nh, hd)))
    return out


def _decode_params(params, cfg):
    """params with the layers' attention and FFN weights and biases cast to
    cfg.dtype once per decode: every step would cast them on use to the
    same values (``.to`` of a tensor already in the dtype is the tensor),
    so this only saves the per-step cast launches. LayerNorm and the tied
    embedding stay fp32."""
    def cast(path, t):
        return t.to(cfg.dtype) if ("attn." in path or "ffn." in path) \
            else t
    return map_tree(cast, params)


def _decode_step(params, cfg, tok, pos, caches, cross_kvs, mem_bias):
    """One incremental decoder step at host int ``pos``. tok: [B] int64.
    Returns (fp32 logits [B, tgt_vocab], caches, written in place)."""
    x = _embed(params["tgt_embed"], tok, cfg, pos)[:, None, :]   # [B,1,H]
    valid = torch.arange(cfg.max_seq, device=tok.device) <= pos
    self_bias = torch.where(valid, 0.0, _NEG)[None, None, None, :]
    for lp, cache, ckv in zip(params["dec"], caches, cross_kvs):
        x = _dec_layer(lp, x, self_bias, None, mem_bias, cfg, cache=cache,
                       pos=pos, cross_kv=ckv)
    x = _layer_norm(x, params["dec_ln"])
    return x[:, 0].float() @ params["tgt_embed"].T, caches


def _decode_setup(params, cfg, src_ids, src_mask, rows):
    """(params cast for decoding, src mask, cross K/V and memory bias with
    each source row repeated ``rows`` times)."""
    dev = params["tgt_embed"].device
    params = _decode_params(params, cfg)
    src_mask = _index(src_mask, dev)
    memory = encode(params, cfg, src_ids, src_mask)
    cross = [(k.repeat_interleave(rows, 0), v.repeat_interleave(rows, 0))
             for k, v in _cross_kv(params, cfg, memory)]
    return params, cross, _mask_bias(src_mask.repeat_interleave(rows, 0))


def greedy_decode(params, cfg, src_ids, src_mask, max_len=None):
    """Greedy argmax decode over all ``max_len`` steps (no early exit; a
    finished row emits EOS); returns int32 tokens [B, max_len] on the
    device of ``params``."""
    max_len = _check_max_len(cfg, max_len)
    dev = params["tgt_embed"].device
    with torch.no_grad(), _fp32_matmuls():
        params, cross, mem_bias = _decode_setup(params, cfg, src_ids,
                                                src_mask, 1)
        B = mem_bias.shape[0]
        caches = _init_cache(cfg, B, dev)
        tok = torch.full((B,), cfg.bos_id, dtype=torch.long, device=dev)
        done = torch.zeros((B,), dtype=torch.bool, device=dev)
        out = []
        for pos in range(max_len):
            logits, caches = _decode_step(params, cfg, tok, pos, caches,
                                          cross, mem_bias)
            # argmax takes the first of equal maxima, as jnp.argmax does
            tok = torch.where(done, cfg.eos_id, torch.argmax(logits, -1))
            done = done | (tok == cfg.eos_id)
            out.append(tok)
        return torch.stack(out, dim=1).to(torch.int32)


def beam_search_decode(params, cfg, src_ids, src_mask, beam_size=4,
                       max_len=None, alpha=0.6):
    """Batched beam search over all ``max_len`` steps with top-k pruning
    each step. Returns (int32 tokens [B, beam, max_len], fp32 scores
    [B, beam]) sorted best-first by the GNMT length penalty
    ((5 + len) / 6)^alpha, len counting non-EOS tokens plus one."""
    max_len = _check_max_len(cfg, max_len)
    K, V = beam_size, cfg.tgt_vocab
    if K > V:
        raise ValueError(f"beam_size={K} exceeds tgt_vocab={V}")
    dev = params["tgt_embed"].device
    with torch.no_grad(), _fp32_matmuls():
        params, cross, mbias = _decode_setup(params, cfg, src_ids, src_mask,
                                             K)
        B = mbias.shape[0] // K
        caches = _init_cache(cfg, B * K, dev)
        # beam 0 live at score 0, the others dead, so the first expansion
        # picks K distinct tokens, not K copies of beam 0
        scores = torch.full((B, K), _NEG, dtype=torch.float32, device=dev)
        scores[:, 0] = 0.0
        # a finished beam extends only with EOS, at no cost
        eos_only = torch.full((V,), _NEG, dtype=torch.float32, device=dev)
        eos_only[cfg.eos_id] = 0.0
        tok = torch.full((B, K), cfg.bos_id, dtype=torch.long, device=dev)
        done = torch.zeros((B, K), dtype=torch.bool, device=dev)
        row0 = torch.arange(B, device=dev)[:, None] * K
        toks, srcs = [], []
        for pos in range(max_len):
            logits, caches = _decode_step(params, cfg, tok.reshape(B * K),
                                          pos, caches, cross, mbias)
            logp = F.log_softmax(logits, dim=-1).reshape(B, K, V)
            logp = torch.where(done[..., None], eos_only, logp)
            cand = (scores[..., None] + logp).reshape(B, K * V)
            # lax.top_k takes the lower index among equal values, where
            # torch.topk promises no order. Equal values arise among the
            # -1e9 candidates (a dead beam's, or a finished beam's non-EOS
            # ones: -1e9 + logp rounds to -1e9 in fp32), and none of them
            # is ever selected: with K <= V every step has at least K
            # finite candidates (beam 0's V at the first step; then each
            # live beam's V, each finished beam's EOS, K beams in all)
            scores, idx = torch.topk(cand, K, dim=1)
            beam_src = idx // V
            tok = idx % V
            rows = (row0 + beam_src).reshape(-1)
            caches = [{n: c[rows] for n, c in layer.items()}
                      for layer in caches]
            done = done.gather(1, beam_src) | (tok == cfg.eos_id)
            toks.append(tok)
            srcs.append(beam_src)
        # backtrace: follow the source-beam pointers from the last step
        beam = torch.arange(K, device=dev).expand(B, K)
        rev = []
        for tok_t, src_t in zip(reversed(toks), reversed(srcs)):
            rev.append(tok_t.gather(1, beam))
            beam = src_t.gather(1, beam)
        seqs = torch.stack(rev[::-1], dim=-1)               # [B, K, max_len]
        lengths = (seqs != cfg.eos_id).float().sum(dim=-1) + 1.0
        final = scores / torch.pow((5.0 + lengths) / 6.0, alpha)
        # jnp.argsort is stable: equal scores keep their beam order
        order = torch.argsort(-final, dim=1, stable=True)
        seqs = seqs.gather(1, order[..., None].expand(-1, -1, max_len))
        return seqs.to(torch.int32), final.gather(1, order)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
def flops_per_step(cfg, batch, src_len, tgt_len):
    """Approximate training matmul FLOPs per step (fwd+bwd ~= 3x fwd), for
    MFU accounting, the JAX package's count."""
    h, f = cfg.hidden, cfg.ffn
    S, T = src_len, tgt_len
    # every term counts multiply-adds as 2 FLOPs. encoder layer: qkvo 8h^2
    # and ffn 4hf per token, scores + ctx 4 S^2 h
    enc = cfg.enc_layers * (S * (8 * h * h + 4 * h * f) + 4 * S * S * h)
    # decoder layer: self qkvo + ffn per target token, self attention
    # 4 T^2 h (full, not the causal half), cross q/o 4h^2 per target token,
    # cross k/v 4h^2 per source token, cross attention 4 T S h
    dec = cfg.dec_layers * (
        T * (8 * h * h + 4 * h * f) + 4 * T * T * h
        + S * 4 * h * h + 4 * T * S * h)
    logits = 2 * h * cfg.tgt_vocab * T
    return 3 * batch * (enc + dec + logits)


def synthetic_batch(cfg, batch_size, src_len=None, tgt_len=None, seed=0):
    """Random NMT batch (numpy), identical to the JAX package's."""
    src_len = src_len or cfg.max_seq
    tgt_len = tgt_len or cfg.max_seq
    rng = np.random.RandomState(seed)
    src = rng.randint(2, cfg.src_vocab, (batch_size, src_len), dtype=np.int32)
    tgt = rng.randint(2, cfg.tgt_vocab, (batch_size, tgt_len), dtype=np.int32)
    tgt_in = np.concatenate(
        [np.full((batch_size, 1), cfg.bos_id, np.int32), tgt[:, :-1]], axis=1)
    return {"src_ids": src, "src_mask": np.ones_like(src),
            "tgt_in": tgt_in, "tgt_out": tgt,
            "tgt_mask": np.ones_like(tgt)}
