"""BERT encoder, masked-LM head and pretraining step: the port of
paddle_tpu/models/bert.py.

``forward``, the masked-LM head and its loss, and :func:`make_train_step`
(Adam through ``paddle_tpu_torch.optimizer``), with the parameter tree keyed
exactly like the JAX package's (``embed.word``, ``layers[3].qkv_w``,
``mlm.dense_w``, ...) and weights kept ``[in, out]``, so JAX parameters
cross over by name through :func:`params_from_numpy` with nothing
transposed. Parameters are fp32 masters; activations run in ``cfg.dtype``
(bf16 by default), cast per use like the JAX code.

Every LayerNorm runs the ``fused_layer_norm`` kernel and attention at
S > 1024 (or under ``attention_impl="flash"``) the ``flash_attention``
kernel, both with their gradients (the flash backward kernels); the plain
matrix products stay ``torch.matmul``, as the JAX package left them to
XLA. Sharding specs, the mesh and ring attention are not ported yet.
"""

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.models._mesh import refuse_mesh
from paddle_tpu_torch.ops.kernels import flash_attention, fused_layer_norm

__all__ = ["BertConfig", "bert_base", "bert_large", "ernie_base",
           "bert_tiny", "init_params", "params_from_numpy", "forward",
           "mlm_loss", "make_train_step", "synthetic_batch",
           "flops_per_token"]


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30528
    hidden: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate: int = 3072
    max_seq: int = 512
    type_vocab: int = 2
    dropout: float = 0.1             # kept for parity; forward applies none
    dtype: torch.dtype = torch.bfloat16   # activation/compute dtype
    # recompute each block in the backward (torch.utils.checkpoint), as
    # jax.checkpoint per block: saved activations for FLOPs
    remat: bool = True
    # "auto": dense for S <= 1024, the flash kernel beyond; "dense";
    # "flash". ("ring" needs a mesh and is not ported yet.)
    attention_impl: str = "auto"
    # softmax accumulation dtype on the dense path: "fp32" or "bf16"
    softmax_dtype: str = "fp32"

    @property
    def head_dim(self):
        return self.hidden // self.num_heads


def bert_base(**kw):
    return BertConfig(**kw)


def bert_large(**kw):
    kw.setdefault("hidden", 1024)
    kw.setdefault("num_layers", 24)
    kw.setdefault("num_heads", 16)
    kw.setdefault("intermediate", 4096)
    return BertConfig(**kw)


def ernie_base(**kw):
    """ERNIE 1.0/2.0 base: BERT-base architecture with ERNIE's vocab."""
    kw.setdefault("vocab_size", 18000)
    return BertConfig(**kw)


def bert_tiny(**kw):
    """Small config for tests / dry runs."""
    kw.setdefault("vocab_size", 512)
    kw.setdefault("hidden", 64)
    kw.setdefault("num_layers", 2)
    kw.setdefault("num_heads", 4)
    kw.setdefault("intermediate", 128)
    kw.setdefault("max_seq", 64)
    kw.setdefault("remat", False)
    return BertConfig(**kw)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------
def _layout(cfg):
    """The parameter tree as (shape, init) leaves, init in
    {"normal", "ones", "zeros"}: the one description both
    :func:`init_params` and :func:`params_from_numpy` follow."""
    h, ffn, v = cfg.hidden, cfg.intermediate, cfg.vocab_size
    layer = {
        "qkv_w": ((h, 3 * h), "normal"), "qkv_b": ((3 * h,), "zeros"),
        "out_w": ((h, h), "normal"), "out_b": ((h,), "zeros"),
        "ln1_g": ((h,), "ones"), "ln1_b": ((h,), "zeros"),
        "fc1_w": ((h, ffn), "normal"), "fc1_b": ((ffn,), "zeros"),
        "fc2_w": ((ffn, h), "normal"), "fc2_b": ((h,), "zeros"),
        "ln2_g": ((h,), "ones"), "ln2_b": ((h,), "zeros"),
    }
    return {
        "embed": {
            "word": ((v, h), "normal"),
            "pos": ((cfg.max_seq, h), "normal"),
            "type": ((cfg.type_vocab, h), "normal"),
            "ln_g": ((h,), "ones"), "ln_b": ((h,), "zeros"),
        },
        "layers": [dict(layer) for _ in range(cfg.num_layers)],
        "mlm": {
            "dense_w": ((h, h), "normal"), "dense_b": ((h,), "zeros"),
            "ln_g": ((h,), "ones"), "ln_b": ((h,), "zeros"),
            "bias": ((v,), "zeros"),
        },
    }


def init_params(cfg, generator, device=None):
    """fp32 master params as a nested dict (lists for ``layers``): normal
    weights of std 0.02 drawn from ``generator`` (a ``torch.Generator``,
    on the CPU or on the card), ones/zeros for LayerNorm and biases.
    ``device`` defaults to the card."""
    device = resolve_device(device)

    def make(shape, init):
        if init == "normal":
            t = 0.02 * torch.randn(shape, generator=generator,
                                   device=generator.device,
                                   dtype=torch.float32)
            return t.to(device)
        fill = torch.ones if init == "ones" else torch.zeros
        return fill(shape, dtype=torch.float32, device=device)

    def walk(spec):
        if isinstance(spec, dict):
            return {k: walk(s) for k, s in spec.items()}
        if isinstance(spec, list):
            return [walk(s) for s in spec]
        return make(*spec)

    return walk(_layout(cfg))


def params_from_numpy(tree, cfg, device=None):
    """The port's params from the JAX package's, after
    ``jax.tree.map(np.asarray, params)``. Strict: every leaf must be a
    float32 numpy array of the expected shape, every expected leaf present
    and no other; anything else raises. ``device`` defaults to the card."""
    device = resolve_device(device)

    def walk(spec, node, path):
        if isinstance(spec, dict):
            if not isinstance(node, dict):
                raise EnforceNotMet(f"params_from_numpy: {path or 'params'} "
                                    f"must be a dict, got {type(node)}")
            if set(node) != set(spec):
                missing = sorted(set(spec) - set(node))
                extra = sorted(set(node) - set(spec))
                raise EnforceNotMet(
                    f"params_from_numpy: {path or 'params'}: missing "
                    f"{missing}, unexpected {extra}")
            return {k: walk(spec[k], node[k], f"{path}.{k}".lstrip("."))
                    for k in spec}
        if isinstance(spec, list):
            if not isinstance(node, (list, tuple)) or len(node) != len(spec):
                raise EnforceNotMet(
                    f"params_from_numpy: {path} must be a list of "
                    f"{len(spec)}, got {type(node).__name__} of "
                    f"{len(node) if hasattr(node, '__len__') else '?'}")
            return [walk(s, n, f"{path}.{i}")
                    for i, (s, n) in enumerate(zip(spec, node))]
        shape, _ = spec
        if (not isinstance(node, np.ndarray) or node.dtype != np.float32
                or node.shape != shape):
            got = (f"{node.dtype}{list(node.shape)}"
                   if isinstance(node, np.ndarray) else type(node).__name__)
            raise EnforceNotMet(
                f"params_from_numpy: {path} must be a float32 numpy array "
                f"of shape {list(shape)}, got {got}")
        return torch.tensor(node).to(device)

    return walk(_layout(cfg), tree, "")


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------
def _index(x, device):
    """Token ids / positions / labels as an int64 tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.long)
    return torch.as_tensor(np.asarray(x), device=device).long()


def _attention(lp, x, mask_bias, cfg):
    """MHA. "dense" keeps [B, S, N, D] with the heads as a batch axis of
    the two einsums; "flash" runs the flash-attention kernel on head views
    of the fused projection (no copies)."""
    B, S, H = x.shape
    nh, hd = cfg.num_heads, cfg.head_dim
    qkv = x @ lp["qkv_w"].to(x.dtype) + lp["qkv_b"].to(x.dtype)
    q, k, v = qkv.split(H, dim=-1)

    impl = cfg.attention_impl
    if impl == "auto":
        impl = "flash" if S > 1024 else "dense"

    if impl == "flash":
        def heads(t):
            return t.reshape(B, S, nh, hd).transpose(1, 2)

        bias = mask_bias.reshape(B, S).float()
        ctx = flash_attention(heads(q), heads(k), heads(v), bias=bias)
        ctx = ctx.transpose(1, 2).reshape(B, S, H).to(x.dtype)
    elif impl == "dense":
        q, k, v = (t.reshape(B, S, nh, hd) for t in (q, k, v))
        scores = torch.einsum("bqnd,bknd->bnqk", q, k) / math.sqrt(hd)
        scores = scores + mask_bias  # [B,1,1,S] additive, in cfg.dtype
        if cfg.softmax_dtype == "bf16":
            probs = torch.softmax(scores, dim=-1)
        else:
            probs = torch.softmax(scores.float(), dim=-1).to(x.dtype)
        ctx = torch.einsum("bnqk,bknd->bqnd", probs, v).reshape(B, S, H)
    else:
        raise EnforceNotMet(
            f"attention_impl {cfg.attention_impl!r}: the port runs 'auto', "
            "'dense' or 'flash' ('ring' is not ported yet)")
    return ctx @ lp["out_w"].to(x.dtype) + lp["out_b"].to(x.dtype)


def _block(lp, x, mask_bias, cfg):
    a = _attention(lp, x, mask_bias, cfg)
    x = fused_layer_norm(x + a, lp["ln1_g"], lp["ln1_b"])
    hme = F.gelu(x @ lp["fc1_w"].to(x.dtype) + lp["fc1_b"].to(x.dtype),
                 approximate="tanh")
    m = hme @ lp["fc2_w"].to(x.dtype) + lp["fc2_b"].to(x.dtype)
    return fused_layer_norm(x + m, lp["ln2_g"], lp["ln2_b"])


def forward(params, cfg, input_ids, token_type_ids=None,
            attention_mask=None, mesh=None):
    """Encoder forward on the device of ``params``; returns [B, S, H] in
    cfg.dtype. Ids and masks may be numpy arrays or tensors. ``mesh`` must
    be None (one device)."""
    refuse_mesh(mesh, "bert.forward")
    emb = params["embed"]
    dev = emb["word"].device
    input_ids = _index(input_ids, dev)
    B, S = input_ids.shape
    x = emb["word"][input_ids] + emb["pos"][None, :S, :]
    if token_type_ids is not None:
        x = x + emb["type"][_index(token_type_ids, dev)]
    x = fused_layer_norm(x.to(cfg.dtype), emb["ln_g"], emb["ln_b"])
    if attention_mask is None:
        mask_bias = torch.zeros((B, 1, 1, S), dtype=cfg.dtype, device=dev)
    else:
        # large finite negative, NOT -inf: an all-padded row must not
        # softmax to NaN
        am = _index(attention_mask, dev)
        mask_bias = torch.where(am[:, None, None, :] > 0, 0.0,
                                -1e9).to(cfg.dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    for lp in params["layers"]:
        if remat:
            x = checkpoint(_block, lp, x, mask_bias, cfg, use_reentrant=False)
        else:
            x = _block(lp, x, mask_bias, cfg)
    return x


def _mlm_head(params, cfg, hidden, positions=None):
    """Masked-LM head: fp32 logits [B, P, V] at ``positions`` [B, P] (or
    [B, S, V] at every position when None). Answers fill-mask requests
    with the same math as :func:`mlm_loss`."""
    if positions is not None:
        pos = _index(positions, hidden.device)
        hidden = torch.gather(
            hidden, 1, pos[..., None].expand(-1, -1, hidden.shape[-1]))
    m = params["mlm"]
    h = hidden @ m["dense_w"].to(hidden.dtype) + m["dense_b"].to(hidden.dtype)
    h = F.gelu(h, approximate="tanh")
    h = fused_layer_norm(h, m["ln_g"], m["ln_b"])
    # tied output embedding, fp32 logits for a stable softmax
    return h.float() @ params["embed"]["word"].T.float() + m["bias"]


def _mlm_xent(logits, labels, weights):
    """Weighted mean cross-entropy of fp32 ``logits`` [..., V]."""
    logp = F.log_softmax(logits, dim=-1)
    lab = _index(labels, logits.device)
    picked = logp.gather(-1, lab[..., None])[..., 0]
    w = torch.as_tensor(weights, device=logits.device).float()
    denom = torch.clamp(w.sum(), min=1.0)
    return -(picked * w).sum() / denom


def mlm_loss(params, cfg, batch, mesh=None):
    """Masked-LM objective. Two batch layouts:

    - dense: dict(input_ids, labels, weights [, token_type_ids,
      attention_mask]), labels/weights full-seq with weight 0 on unmasked
      positions;
    - gathered: masked_positions/masked_labels/masked_weights [B, P]
      instead, so the vocab-size head runs only on the masked positions.

    ``mesh`` must be None (one device).
    """
    hidden = forward(params, cfg, batch["input_ids"],
                     batch.get("token_type_ids"),
                     batch.get("attention_mask"), mesh=mesh)
    if "masked_positions" in batch:
        logits = _mlm_head(params, cfg, hidden, batch["masked_positions"])
        return _mlm_xent(logits, batch["masked_labels"],
                         batch["masked_weights"])
    logits = _mlm_head(params, cfg, hidden)
    return _mlm_xent(logits, batch["labels"], batch["weights"])


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------
def _loss_and_grads(params, cfg, batch):
    """:func:`mlm_loss` and its grads with respect to every fp32 leaf of
    params (a tree like params; zeros for a leaf the batch does not reach,
    as JAX gives)."""
    live = map_tree(lambda _, t: t.detach().requires_grad_(), params)
    flat = leaves(live)
    loss = mlm_loss(live, cfg, batch)
    grads = iter(torch.autograd.grad(loss, flat, materialize_grads=True))
    return loss.detach(), map_tree(lambda _, t: next(grads), live)


def make_train_step(cfg, optimizer, mesh=None, steps_per_call=1,
                    device=None):
    """Returns (init_fn, step_fn), as the JAX package's ``make_train_step``
    on one device: ``mesh`` must be None.

    ``init_fn(generator)`` -> (params, opt_state) on ``device`` (the card
    by default; ``generator`` as for :func:`init_params`).
    ``step_fn(params, opt_state, batch)`` -> (loss, params, opt_state):
    the grads of :func:`mlm_loss` over the fp32 leaves, then
    ``optimizer.apply_gradients``, which updates params and opt_state **in
    place** (the returned trees are the ones passed in; JAX donates them
    instead). loss is a 0-d fp32 tensor on the device; reading it syncs.

    ``steps_per_call > 1`` runs that many steps per call in a Python loop
    and returns the last loss. Batch leaves (numpy arrays or tensors) may
    carry a leading [steps_per_call] axis, one slice per step (told by 3-D
    input_ids), or be plain: the same batch reused."""
    refuse_mesh(mesh, "bert.make_train_step")
    device = resolve_device(device)

    def init_fn(generator):
        params = init_params(cfg, generator, device=device)
        return params, optimizer.init(params)

    def step_fn(params, opt_state, batch):
        stacked = (steps_per_call > 1
                   and np.ndim(batch["input_ids"]) == 3)
        if stacked and np.shape(batch["input_ids"])[0] != steps_per_call:
            raise ValueError(
                f"stacked batch leading axis "
                f"{np.shape(batch['input_ids'])[0]} != steps_per_call "
                f"{steps_per_call}")
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        for i in range(steps_per_call):
            step_batch = ({k: v[i] for k, v in batch.items()} if stacked
                          else batch)
            loss, grads = _loss_and_grads(params, cfg, step_batch)
            optimizer.apply_gradients(params, grads, opt_state)
        return loss, params, opt_state

    return init_fn, step_fn


# ---------------------------------------------------------------------------
# synthetic batch helper (benchmarks / dry runs)
# ---------------------------------------------------------------------------
def synthetic_batch(cfg, batch_size, seq_len=None, seed=0, max_preds=None):
    """Random pretraining batch (numpy), identical to the JAX package's.
    With ``max_preds`` set, emits the gathered MLM layout
    (masked_positions/labels/weights [B, P])."""
    seq_len = seq_len or cfg.max_seq
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (batch_size, seq_len), dtype=np.int32)
    batch = {
        "input_ids": ids,
        "token_type_ids": np.zeros_like(ids),
        "attention_mask": np.ones_like(ids),
    }
    if max_preds:
        pos = np.stack([rng.choice(seq_len, max_preds, replace=False)
                        for _ in range(batch_size)]).astype(np.int32)
        batch["masked_positions"] = np.sort(pos, axis=1)
        batch["masked_labels"] = rng.randint(
            0, cfg.vocab_size, (batch_size, max_preds), dtype=np.int32)
        batch["masked_weights"] = np.ones((batch_size, max_preds),
                                          np.float32)
    else:
        batch["labels"] = rng.randint(0, cfg.vocab_size,
                                      (batch_size, seq_len), dtype=np.int32)
        batch["weights"] = (rng.rand(batch_size, seq_len)
                            < 0.15).astype(np.float32)
    return batch


def flops_per_token(cfg, seq_len=None, max_preds=None):
    """Approximate training FLOPs/token (fwd+bwd ≈ 3x fwd matmul FLOPs).
    ``max_preds`` scales the vocab-head term to the gathered-MLM layout
    (head runs on P of S positions)."""
    h, f = cfg.hidden, cfg.intermediate
    s = seq_len or cfg.max_seq
    per_layer = 2 * h * 3 * h + 2 * h * h + 2 * h * f + 2 * f * h \
        + 2 * 2 * s * h  # qkv + out + mlp + attention scores/ctx
    head = 2 * h * cfg.vocab_size * ((max_preds / s) if max_preds else 1.0)
    fwd = cfg.num_layers * per_layer + head
    return 3 * fwd
