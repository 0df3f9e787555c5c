"""The Transformer of Fluid 1.5's dygraph examples, as ``nn.Layer`` classes
and ``layers`` calls, trained eagerly: ``model.init`` / ``model.apply``,
``pt.grad``, then the optimizer's ``apply_gradients``.

Source: PaddlePaddle/models ``dygraph/transformer`` (Fluid 1.5) and the
reference's ``test_imperative_transformer*.py``: ``PrePostProcessLayer``
("n" layer norm, "d" dropout, "a" residual add; pre "n", post "da"),
``PositionwiseFeedForwardLayer`` (FC relu, dropout, FC),
``MultiHeadAttentionLayer`` (q, k, v and output FCs without bias, scores
scaled by ``d_model ** -0.5`` as the source writes them, an additive bias,
softmax, dropout), ``EncoderSubLayer`` / ``DecoderSubLayer`` with a final
layer norm on each stack, ``PrepareEncoderDecoderLayer`` (the word
embedding scaled by ``sqrt(d_model)`` plus a fixed sinusoid position
table, ``position_encoding_init`` as the source writes it, then dropout),
the output projection against the shared word table (``weight_sharing``),
and the loss: label smoothing 0.1 over a one-hot target,
``softmax_with_cross_entropy(soft_label=True)`` weighted by
``lbl_weight`` and averaged over the tokens. :func:`transformer_base` is
its base configuration: d_model 512, 8 heads of 64, 6 + 6 layers, d_inner
2048, vocabularies of 10,000, position tables of 256, dropouts 0.1, Adam
(beta1 0.9, beta2 0.997, epsilon 1e-9) under ``dygraph.NoamDecay(512,
8000, learning_rate=2.0)``.

Where this module differs from a plain reading of those numbers, the
source wins:

- ``weight_sharing`` is True in the source's ``ModelHyperParams``: one
  [10000, 512] word table serves the source side, the target side and the
  output projection (``matmul(..., transpose_y=True)``), so the model has
  49,485,824 values (the two position tables' 262,144 included), not the
  ~60 M that two tables and an output FC would make. The module context
  keys a parameter by its scope, so the top Layer makes the table by name
  at its own scope (``layers.embedding`` with ``word_emb_table``, both
  sides) and takes it again there for the projection
  (``layers.create_parameter``);
- the position tables are parameters with a fixed initial value, and
  their lookups (``nn.Embedding``) are cut from the gradient with
  ``framework.stop_gradient`` (the source's ``stop_gradient = True``), so
  Adam leaves them as they are.

The batches are synthetic and seeded (:func:`synthetic_batch`): batch 64 at
length 64 on both sides (4,096 tokens a side), ids in [3, 10000), no
padding, so the source's attention biases are zero but for the target's
causal mask (-1e9 above the diagonal).

Everything is built from whichever package is passed as ``pt`` (this one,
or the JAX package: its ``nn``, ``layers``, ``initializer``,
``framework``, ``optimizer``, ``dygraph`` and ``amp`` take the same calls).
:func:`transformer_tiny` is the CPU tests' config (its dropouts are 0, so
the two packages' draws do not enter).
"""

import dataclasses

import numpy as np

__all__ = ["DygraphTransformerConfig", "transformer_base", "transformer_tiny",
           "position_encoding_init", "build", "make_optimizer",
           "synthetic_batch", "INPUTS", "loss_fn", "train_step",
           "param_count", "flops_per_step"]

#: the model's inputs, in ``forward``'s order (the source's feed names)
INPUTS = ("src_word", "src_pos", "src_slf_attn_bias", "trg_word", "trg_pos",
          "trg_slf_attn_bias", "trg_src_attn_bias", "lbl_word", "lbl_weight")


@dataclasses.dataclass(frozen=True)
class DygraphTransformerConfig:
    src_vocab: int = 10000
    trg_vocab: int = 10000
    max_length: int = 256
    d_model: int = 512
    d_inner: int = 2048
    d_key: int = 64
    d_value: int = 64
    n_head: int = 8
    n_layer: int = 6
    prepostprocess_dropout: float = 0.1
    attention_dropout: float = 0.1
    relu_dropout: float = 0.1
    weight_sharing: bool = True
    label_smooth_eps: float = 0.1
    learning_rate: float = 2.0
    beta1: float = 0.9
    beta2: float = 0.997
    epsilon: float = 1e-9
    warmup_steps: int = 8000
    batch: int = 64
    seq_len: int = 64
    first_id: int = 3            # 0, 1, 2 are <bos>, <eos>, <unk>


def transformer_base():
    """The source's base configuration at 4,096 tokens a side."""
    return DygraphTransformerConfig()


def transformer_tiny():
    """The CPU tests' config: the same network at small widths, one layer
    a side, no dropout, 100 warm-up steps (so that three steps move the
    loss)."""
    return DygraphTransformerConfig(
        src_vocab=64, trg_vocab=64, max_length=16, d_model=16, d_inner=32,
        d_key=8, d_value=8, n_head=2, n_layer=1, prepostprocess_dropout=0.0,
        attention_dropout=0.0, relu_dropout=0.0, warmup_steps=100, batch=2,
        seq_len=6)


def position_encoding_init(n_position, d_pos_vec):
    """The source's sinusoid table [n_position, d_pos_vec] (fp32), its
    ``inv_timescales = np.exp(np.arange(n)) * -increment`` kept as
    written."""
    channels = d_pos_vec
    position = np.arange(n_position)
    num_timescales = channels // 2
    log_timescale_increment = (np.log(float(1e4) / float(1))
                               / (num_timescales - 1))
    inv_timescales = np.exp(np.arange(num_timescales)) \
        * -log_timescale_increment
    scaled_time = position[:, None] * inv_timescales[None, :]
    signal = np.concatenate([np.sin(scaled_time), np.cos(scaled_time)],
                            axis=1)
    signal = np.pad(signal, [[0, 0], [0, np.mod(channels, 2)]], "constant")
    return signal.astype("float32")


def build(pt, cfg):
    """The model, a ``pt.nn.Layer``: ``forward(*inputs, is_test=False)``
    over :data:`INPUTS` returns ``(sum_cost, avg_cost, predict,
    token_num)`` as the source's ``TransFormer`` does."""
    nn, L, Init = pt.nn, pt.layers, pt.initializer

    class PrePostProcess(nn.Layer):
        def __init__(self, cmd, rate):
            super().__init__("pre_post_process")
            self.cmd, self.rate = cmd, rate
            for c in cmd:
                if c == "n":
                    self.norm = nn.LayerNorm(
                        cfg.d_model,
                        param_attr=pt.ParamAttr(
                            initializer=Init.Constant(1.0)),
                        bias_attr=pt.ParamAttr(
                            initializer=Init.Constant(0.0)))
                elif c == "d" and rate:
                    self.drop = nn.Dropout(rate)

        def forward(self, prev, out, is_test):
            for c in self.cmd:
                if c == "a":
                    out = out + prev if prev is not None else out
                elif c == "n":
                    out = self.norm(out)
                elif c == "d" and self.rate:
                    out = self.drop(out, is_test=is_test)
            return out

    class MultiHeadAttention(nn.Layer):
        def __init__(self):
            super().__init__("multi_head_attention")
            h = cfg.n_head
            self.q_fc = nn.FC(cfg.d_key * h, num_flatten_dims=2,
                              bias_attr=False)
            self.k_fc = nn.FC(cfg.d_key * h, num_flatten_dims=2,
                              bias_attr=False)
            self.v_fc = nn.FC(cfg.d_value * h, num_flatten_dims=2,
                              bias_attr=False)
            self.proj_fc = nn.FC(cfg.d_model, num_flatten_dims=2,
                                 bias_attr=False)
            if cfg.attention_dropout:
                self.drop = nn.Dropout(cfg.attention_dropout)

        def _heads(self, x, d):
            b, t = int(x.shape[0]), int(x.shape[1])
            return L.transpose(L.reshape(x, shape=[b, t, cfg.n_head, d]),
                               perm=[0, 2, 1, 3])

        def forward(self, queries, keys, values, attn_bias, is_test):
            keys = queries if keys is None else keys
            values = keys if values is None else values
            q = self._heads(self.q_fc(queries), cfg.d_key)
            k = self._heads(self.k_fc(keys), cfg.d_key)
            v = self._heads(self.v_fc(values), cfg.d_value)
            product = L.matmul(q, k, transpose_y=True,
                               alpha=cfg.d_model ** -0.5)
            if attn_bias is not None:
                product = product + L.cast(attn_bias, product.dtype)
            weights = L.softmax(product)
            if cfg.attention_dropout:
                weights = self.drop(weights, is_test=is_test)
            out = L.transpose(L.matmul(weights, v), perm=[0, 2, 1, 3])
            b, t = int(out.shape[0]), int(out.shape[1])
            out = L.reshape(out, shape=[b, t, cfg.n_head * cfg.d_value])
            return self.proj_fc(out)

    class FeedForward(nn.Layer):
        def __init__(self):
            super().__init__("positionwise_feed_forward")
            self.i2h = nn.FC(cfg.d_inner, num_flatten_dims=2, act="relu")
            self.h2o = nn.FC(cfg.d_model, num_flatten_dims=2)
            if cfg.relu_dropout:
                self.drop = nn.Dropout(cfg.relu_dropout)

        def forward(self, x, is_test):
            hidden = self.i2h(x)
            if cfg.relu_dropout:
                hidden = self.drop(hidden, is_test=is_test)
            return self.h2o(hidden)

    def pre():
        return PrePostProcess("n", cfg.prepostprocess_dropout)

    def post():
        return PrePostProcess("da", cfg.prepostprocess_dropout)

    class EncoderSubLayer(nn.Layer):
        def __init__(self):
            super().__init__("encoder_sub_layer")
            self.pre1, self.attn, self.post1 = pre(), MultiHeadAttention(), \
                post()
            self.pre2, self.ffn, self.post2 = pre(), FeedForward(), post()

        def forward(self, x, bias, is_test):
            attn = self.attn(self.pre1(None, x, is_test), None, None, bias,
                             is_test)
            attn = self.post1(x, attn, is_test)
            ffn = self.ffn(self.pre2(None, attn, is_test), is_test)
            return self.post2(attn, ffn, is_test)

    class DecoderSubLayer(nn.Layer):
        def __init__(self):
            super().__init__("decoder_sub_layer")
            self.pre1, self.slf, self.post1 = pre(), MultiHeadAttention(), \
                post()
            self.pre2, self.cross, self.post2 = pre(), MultiHeadAttention(), \
                post()
            self.pre3, self.ffn, self.post3 = pre(), FeedForward(), post()

        def forward(self, x, enc, slf_bias, cross_bias, is_test):
            slf = self.slf(self.pre1(None, x, is_test), None, None, slf_bias,
                           is_test)
            slf = self.post1(x, slf, is_test)
            cross = self.cross(self.pre2(None, slf, is_test), enc, enc,
                               cross_bias, is_test)
            cross = self.post2(slf, cross, is_test)
            ffn = self.ffn(self.pre3(None, cross, is_test), is_test)
            return self.post3(cross, ffn, is_test)

    class Stack(nn.Layer):
        def __init__(self, kind, sub):
            super().__init__(kind)
            self.subs = nn.LayerList([sub() for _ in range(cfg.n_layer)])
            self.final = pre()

        def forward(self, x, *rest):
            for s in self.subs:
                x = s(x, *rest)
            return self.final(None, x, rest[-1])

    class Prepare(nn.Layer):
        """The word embedding (looked up by the caller) scaled, plus the
        position table's rows, then dropout."""

        def __init__(self, kind):
            super().__init__(kind)
            self.pos = nn.Embedding(
                (cfg.max_length, cfg.d_model),
                param_attr=pt.ParamAttr(
                    initializer=Init.NumpyArrayInitializer(
                        position_encoding_init(cfg.max_length,
                                               cfg.d_model)),
                    trainable=False))
            if cfg.prepostprocess_dropout:
                self.drop = nn.Dropout(cfg.prepostprocess_dropout)

        def forward(self, word_emb, pos, is_test):
            x = L.scale(word_emb, scale=cfg.d_model ** 0.5)
            x = x + pt.framework.stop_gradient(self.pos(pos))
            if cfg.prepostprocess_dropout:
                x = self.drop(x, is_test=is_test)
            return x

    class TransFormer(nn.Layer):
        def __init__(self):
            super().__init__("transformer")
            self.prep_enc = Prepare("prepare_encoder")
            self.encoder = Stack("encoder", EncoderSubLayer)
            self.prep_dec = Prepare("prepare_decoder")
            self.decoder = Stack("decoder", DecoderSubLayer)
            if not cfg.weight_sharing:
                self.out_fc = nn.FC(cfg.trg_vocab, bias_attr=False)

        def _word(self, ids, name, vocab):
            return L.embedding(ids, size=[vocab, cfg.d_model], padding_idx=0,
                               param_attr=pt.ParamAttr(
                                   name=name,
                                   initializer=Init.Normal(
                                       0.0, cfg.d_model ** -0.5)))

        def forward(self, src_word, src_pos, src_slf_attn_bias, trg_word,
                    trg_pos, trg_slf_attn_bias, trg_src_attn_bias, lbl_word,
                    lbl_weight, is_test=False):
            trg_table = "word_emb_table" if cfg.weight_sharing \
                else "trg_word_emb_table"
            enc = self.prep_enc(
                self._word(src_word, "word_emb_table", cfg.src_vocab),
                src_pos, is_test)
            enc = self.encoder(enc, src_slf_attn_bias, is_test)
            dec = self.prep_dec(
                self._word(trg_word, trg_table, cfg.trg_vocab), trg_pos,
                is_test)
            dec = self.decoder(dec, enc, trg_slf_attn_bias,
                               trg_src_attn_bias, is_test)
            dec = L.reshape(dec, shape=[-1, cfg.d_model])
            if cfg.weight_sharing:
                w = L.create_parameter([cfg.trg_vocab, cfg.d_model],
                                       name="word_emb_table")
                predict = L.matmul(dec, L.cast(w, dec.dtype),
                                   transpose_y=True)
            else:
                predict = self.out_fc(dec)
            predict = L.cast(predict, "float32")
            label = L.one_hot(lbl_word, depth=cfg.trg_vocab)
            if cfg.label_smooth_eps:
                label = L.label_smooth(label, epsilon=cfg.label_smooth_eps)
            cost = L.softmax_with_cross_entropy(
                predict, label, soft_label=bool(cfg.label_smooth_eps))
            sum_cost = L.reduce_sum(cost * lbl_weight)
            token_num = pt.framework.stop_gradient(L.reduce_sum(lbl_weight))
            return sum_cost, sum_cost / token_num, predict, token_num

    return TransFormer()


def make_optimizer(pt, cfg):
    """Adam under the Noam schedule, as the source trains."""
    return pt.optimizer.Adam(
        learning_rate=pt.dygraph.NoamDecay(cfg.d_model, cfg.warmup_steps,
                                           learning_rate=cfg.learning_rate),
        beta1=cfg.beta1, beta2=cfg.beta2, epsilon=cfg.epsilon)


def synthetic_batch(cfg, seed, batch=None):
    """One seeded batch as numpy arrays keyed by :data:`INPUTS`: ``batch``
    sentences (cfg.batch when None) of ``cfg.seq_len`` tokens a side, ids
    in [first_id, vocab), no padding; the target's self-attention bias is
    the causal mask (-1e9 above the diagonal), [B, n_head, T, T] as the
    source feeds it; labels [B*T, 1] int64 with weights 1."""
    b, t = batch or cfg.batch, cfg.seq_len
    rng = np.random.RandomState(seed)
    src = rng.randint(cfg.first_id, cfg.src_vocab, (b, t)).astype(np.int64)
    trg = rng.randint(cfg.first_id, cfg.trg_vocab, (b, t)).astype(np.int64)
    lbl = rng.randint(cfg.first_id, cfg.trg_vocab, (b * t, 1)) \
        .astype(np.int64)
    pos = np.tile(np.arange(t, dtype=np.int64), (b, 1))
    causal = np.triu(np.full((t, t), -1e9, np.float32), 1)
    zeros = np.zeros((b, cfg.n_head, t, t), np.float32)
    return {"src_word": src, "src_pos": pos, "src_slf_attn_bias": zeros,
            "trg_word": trg, "trg_pos": pos.copy(),
            "trg_slf_attn_bias": np.broadcast_to(
                causal, (b, cfg.n_head, t, t)).copy(),
            "trg_src_attn_bias": zeros.copy(), "lbl_word": lbl,
            "lbl_weight": np.ones((b * t, 1), np.float32)}


def loss_fn(model, params, state, rng, inputs, is_test=False, cast=None):
    """``(avg_cost, (sum_cost, token_num))`` of one batch (``inputs`` in
    :data:`INPUTS` order), the params first cast by ``cast`` (an amp
    optimizer's ``cast_params``) when given."""
    if cast is not None:
        params = cast(params)
    (sum_cost, avg_cost, _, token_num), _ = model.apply(
        params, state, rng, *inputs, is_test=is_test)
    return avg_cost, (sum_cost, token_num)


def train_step(pt, model, opt, params, state, opt_state, inputs, rng=None,
               amp=False):
    """One eager step in either package: ``pt.grad`` of the average cost,
    then ``opt.apply_gradients`` (in place in this package). Returns
    ``(avg_cost, params, opt_state)``; ``amp`` casts the params with the
    (decorated) optimizer's policy."""
    cast = opt.cast_params if amp else None
    grads, (sum_cost, token_num) = pt.grad(
        lambda p: loss_fn(model, p, state, rng, inputs, cast=cast),
        has_aux=True)(params)
    params, opt_state = opt.apply_gradients(params, grads, opt_state)
    return sum_cost / token_num, params, opt_state


def param_count(params):
    """Values in a params dict."""
    return int(sum(int(np.prod(tuple(v.shape))) for v in params.values()))


def flops_per_step(cfg, batch, src_len, trg_len):
    """The matrix products' FLOPs of one training step (3 x the forward's:
    the projections, the attention scores and their weighted sums, the
    FFNs and the output projection)."""
    d, h = cfg.d_model, cfg.n_head
    qk, vv = cfg.d_key * h, cfg.d_value * h

    def attn(tq, tk, sq, sk):
        proj = 2 * tq * d * qk + 2 * tk * d * (qk + vv) + 2 * tq * vv * d
        return proj + 2 * batch * h * sq * sk * (cfg.d_key + cfg.d_value)

    ts, tt = batch * src_len, batch * trg_len
    ffn = 4 * cfg.d_inner * d
    enc = cfg.n_layer * (attn(ts, ts, src_len, src_len) + ffn * ts)
    dec = cfg.n_layer * (attn(tt, tt, trg_len, trg_len)
                         + attn(tt, ts, trg_len, src_len) + ffn * tt)
    return 3 * (enc + dec + 2 * tt * d * cfg.trg_vocab)
