"""The PTB LSTM language model as a Fluid static program: training through a
``StaticRNN`` sub-program (``layers.static_rnn``, a ``scan_block``) fed by a
``py_reader``, and greedy generation through ``layers.while_loop`` (a
``while_block``) over the same scope's parameters.

Source: PaddlePaddle/models ``PaddleNLP/language_model`` (Fluid 1.5 era),
``lm_model.py`` with ``rnn_model="static"``, and Zaremba et al. 2014;
:func:`medium` is its ``medium`` config (vocabulary 10,000, hidden 650, 2
layers, 35 steps, batch 20, uniform init 0.05, SGD at 1.0,
``GradientClipByGlobalNorm(5.0)``, dropout 0.5). The cell is
``lm_model.py``'s: gates i, j, f, o from one matmul of [x, h] with
``w`` [2H, 4H] plus ``b`` [4H], ``c = c * sigmoid(f) + sigmoid(i) *
tanh(j)``, ``h = tanh(c) * sigmoid(o)``, no forget bias; the loss is the
sum over the time steps of the batch-mean cross-entropy.

Where this program departs from ``lm_model.py``:

- the recurrent state is one Variable [B, 2 * layers * H] = [h0, c0, h1,
  c1, ...] cut with ``slice``: a ``scan_block`` carries one state
  Variable, and ``layers.split`` in a Program gives one Variable;
- dropout (``upscale_in_train``) sits on the embedding output and on the
  RNN output, outside the loop (a body may hold no op that draws), where
  ``lm_model.py`` also drops between the layers inside the step;
- the data are a seeded first-order Markov chain over the vocabulary
  (:func:`markov_stream`), cut into windows the way the PTB reader cuts
  its corpus (:func:`ptb_windows`); no corpus is read.
"""

import dataclasses

import numpy as np

__all__ = ["LMConfig", "medium", "lm_tiny", "build_train", "build_generate",
           "markov_stream", "ptb_windows", "param_names"]


@dataclasses.dataclass(frozen=True)
class LMConfig:
    vocab: int = 10000
    hidden: int = 650
    layers: int = 2
    num_steps: int = 35
    batch: int = 20
    init_scale: float = 0.05
    lr: float = 1.0
    max_grad_norm: float = 5.0
    dropout: float = 0.5

    @property
    def state_width(self):
        return 2 * self.layers * self.hidden


def medium():
    """``lm_model.py``'s ``medium`` config."""
    return LMConfig()


def lm_tiny(**kw):
    """A narrow config for CPU tests: V 50, hidden 8, 2 layers, T 6,
    batch 4, no dropout."""
    return dataclasses.replace(LMConfig(vocab=50, hidden=8, num_steps=6,
                                        batch=4, dropout=0.0), **kw)


def param_names(cfg):
    """The 7 trainable tensors (for 2 layers), by ``lm_model.py``'s
    names."""
    return (["embedding_para"]
            + [f"fc_{k}1_{i}" for i in range(cfg.layers)
               for k in ("weight", "bias")]
            + ["softmax_weight", "softmax_bias"])


def _params(pt, cfg):
    """The LSTM weights: created in the current program (their init ops in
    its startup program), uniform in [-init_scale, init_scale]."""
    L = pt.layers
    u = pt.initializer.Uniform(-cfg.init_scale, cfg.init_scale)
    H = cfg.hidden
    ws = [L.create_parameter([2 * H, 4 * H], "float32",
                             name=f"fc_weight1_{i}", default_initializer=u)
          for i in range(cfg.layers)]
    bs = [L.create_parameter([4 * H], "float32", name=f"fc_bias1_{i}",
                             default_initializer=u)
          for i in range(cfg.layers)]
    return ws, bs


def cell_step(L, cfg, x_t, state, ws, bs):
    """One time step of the stacked LSTM: (top layer's h, new state)."""
    H = cfg.hidden

    def cut(v, k, n=1):
        return L.slice(v, axes=[1], starts=[k * H], ends=[(k + n) * H])

    hs, inp = [], x_t
    for i in range(cfg.layers):
        h, c = cut(state, 2 * i), cut(state, 2 * i + 1)
        g = L.elementwise_add(L.matmul(L.concat([inp, h], axis=1), ws[i]),
                              bs[i])
        gi, gj, gf, go = (cut(g, k) for k in range(4))
        c = L.elementwise_add(L.elementwise_mul(c, L.sigmoid(gf)),
                              L.elementwise_mul(L.sigmoid(gi), L.tanh(gj)))
        h = L.elementwise_mul(L.tanh(c), L.sigmoid(go))
        hs += [h, c]
        inp = h
    return inp, L.concat(hs, axis=1)


def build_train(pt, cfg, capacity=16):
    """The training program (path A). ``pt`` is ``paddle_tpu_torch``.
    Returns a dict: main, startup, reader (a ``py_reader`` of (x [B, T]
    int64, y [B, T, 1] int64)), loss, final (the state after the window,
    fed back as the next window's ``init``), init (the data var of the
    initial state [B, 2 * layers * H])."""
    L = pt.layers
    B, T, V, H = cfg.batch, cfg.num_steps, cfg.vocab, cfg.hidden
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        reader = L.py_reader(capacity=capacity, shapes=[[B, T], [B, T, 1]],
                             dtypes=["int64", "int64"])
        x, y = L.read_file(reader)
        init = pt.data("init", [B, cfg.state_width], "float32",
                       append_batch_size=False)
        u = pt.initializer.Uniform(-cfg.init_scale, cfg.init_scale)
        emb = L.embedding(x, size=[V, H], param_attr=pt.ParamAttr(
            name="embedding_para", initializer=u))
        if cfg.dropout:
            emb = L.dropout(emb, cfg.dropout,
                            dropout_implementation="upscale_in_train")
        ws, bs = _params(pt, cfg)

        def step(state, x_t):
            out, new = cell_step(L, cfg, x_t, state, ws, bs)
            return new, out

        final, outs = L.static_rnn(step, emb, init)
        if cfg.dropout:
            outs = L.dropout(outs, cfg.dropout,
                             dropout_implementation="upscale_in_train")
        logits = L.fc(outs, V, num_flatten_dims=2,
                      param_attr=pt.ParamAttr(name="softmax_weight",
                                              initializer=u),
                      bias_attr=pt.ParamAttr(name="softmax_bias",
                                             initializer=u))
        xent = L.softmax_with_cross_entropy(logits, y)
        loss = L.reduce_sum(L.reduce_mean(L.reshape(xent, [-1, T]), dim=[0]))
        pt.optimizer.SGDOptimizer(
            cfg.lr, grad_clip=pt.clip.GradientClipByGlobalNorm(
                cfg.max_grad_norm)).minimize(loss)
    return dict(main=main, startup=startup, reader=reader, loss=loss,
                final=final, init=init)


def build_generate(pt, cfg, length):
    """The generation program (path B): greedy decoding of ``length``
    tokens for each of the B streams through ``layers.while_loop``, over
    the parameters of :func:`build_train` (the same names, so one scope
    serves both). Feeds: ``gen_state`` [B, 2 * layers * H] fp32,
    ``gen_tok`` [B] int64 (the last token seen), ``gen_buf`` [B, T] int64
    (the window the tokens are appended to). Returns a dict: main, out
    (the window after ``length`` tokens), state (the final state)."""
    L = pt.layers
    B, T, V, H = cfg.batch, cfg.num_steps, cfg.vocab, cfg.hidden
    main, startup = pt.Program(), pt.Program()
    with pt.program_guard(main, startup), pt.unique_name.guard():
        state = pt.data("gen_state", [B, cfg.state_width], "float32",
                        append_batch_size=False)
        tok = pt.data("gen_tok", [B], "int64", append_batch_size=False)
        buf = pt.data("gen_buf", [B, T], "int64", append_batch_size=False)
        emb = L.create_parameter([V, H], "float32", name="embedding_para")
        ws, bs = _params(pt, cfg)
        sm_w = L.create_parameter([H, V], "float32", name="softmax_weight")
        sm_b = L.create_parameter([V], "float32", name="softmax_bias")
        i = L.fill_constant(shape=[1], dtype="int32", value=0)
        n = L.fill_constant(shape=[1], dtype="int32", value=length)

        def cond(i, tok, state, buf):
            return L.reduce_all(L.less_than(i, n))

        def body(i, tok, state, buf):
            out, new = cell_step(L, cfg, L.gather(emb, tok), state, ws, bs)
            logits = L.elementwise_add(L.matmul(out, sm_w), sm_b)
            nxt = L.cast(L.argmax(logits, axis=1), "int64")
            buf = L.concat([L.slice(buf, axes=[1], starts=[1], ends=[T]),
                            L.reshape(nxt, [B, 1])], axis=1)
            return [L.increment(i, value=1), nxt, new, buf]

        _, _, final, out = L.while_loop(cond, body, [i, tok, state, buf])
    return dict(main=main, out=out, state=final)


def markov_stream(cfg, n_tokens, seed, successors=4):
    """A token stream from a seeded first-order Markov chain over the
    vocabulary: each id has ``successors`` next ids, drawn with fixed
    random weights, so a model can learn it below ln(vocab)."""
    rng = np.random.RandomState(seed)
    nxt = rng.randint(0, cfg.vocab, (cfg.vocab, successors))
    p = rng.dirichlet(np.ones(successors), cfg.vocab).cumsum(1)
    out = np.empty(n_tokens, np.int64)
    out[0] = rng.randint(cfg.vocab)
    u = rng.rand(n_tokens)
    for t in range(1, n_tokens):
        row = out[t - 1]
        out[t] = nxt[row, min(int(np.searchsorted(p[row], u[t])),
                              successors - 1)]
    return out


def ptb_windows(stream, cfg):
    """The PTB reader's cut (``reader.ptb_iterator``): the stream as B rows
    of ``len // B`` tokens, then consecutive windows of ``num_steps``; x is
    a window and y the same window shifted by one, [B, T, 1]. Returns a
    list of (x, y) int64 arrays."""
    B, T = cfg.batch, cfg.num_steps
    batch_len = len(stream) // B
    data = np.asarray(stream[:B * batch_len], np.int64).reshape(B, batch_len)
    return [(data[:, k * T:(k + 1) * T],
             data[:, k * T + 1:(k + 1) * T + 1][:, :, None])
            for k in range((batch_len - 1) // T)]
