"""Card-only tests of the port: the CUDA kernels against their plain
PyTorch bodies, and the model (forward and training step) through the
kernels against the CPU.

Every test here is marked ``cuda`` and skips without a card; whether there
is one is decided inside the ``cuda`` fixture, never at import. The file
imports neither JAX nor the JAX package, so on the machine with the card
(which has no JAX) it runs without the suite's conftest:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

Tolerances: the kernel and its plain body both compute in fp32 and round
once to the output dtype; sums run in another order, which may flip that
rounding by one unit in the last place (rtol 2^-7 for bf16) or move fp32
results by ~1e-6 (1e-5). The backward kernels sum over up to S terms, so
fp32 grads are held to 1e-4 absolute beside 1e-5 relative.
"""

import numpy as np
import pytest
import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.models import bert
from paddle_tpu_torch.ops import kernels as K

BF16_RTOL = 2.0 ** -7


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card with -m cuda)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _tols(dtype):
    return (BF16_RTOL, 1e-4) if dtype == torch.bfloat16 else (1e-5, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,hidden,dtype", [
    (4096, 768, torch.bfloat16), (1000, 768, torch.float32),
    (640, 768, torch.bfloat16), (37, 1024, torch.bfloat16),
    (5, 1024, torch.float32), (3, 40, torch.bfloat16)])
def test_layer_norm_kernel_matches_plain(cuda, rows, hidden, dtype):
    gen = torch.Generator(device=cuda).manual_seed(rows)
    x = (torch.randn(rows, hidden, generator=gen, device=cuda) * 3 + 1
         ).to(dtype)
    g = torch.randn(hidden, generator=gen, device=cuda)
    b = torch.randn(hidden, generator=gen, device=cuda)
    before = K.get_kernel("fused_layer_norm").launches
    y, mu, rstd = K.fused_layer_norm(x, g, b, return_stats=True)
    yr, mur, rstdr = K.get_body("fused_layer_norm", "reference")(
        x, g, b, return_stats=True)
    torch.cuda.synchronize()
    assert K.get_kernel("fused_layer_norm").launches == before + 1
    rtol, _ = _tols(dtype)
    torch.testing.assert_close(y.float(), yr.float(), atol=1e-5, rtol=rtol)
    torch.testing.assert_close(mu, mur, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(rstd, rstdr, atol=0, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D,dtype,causal,with_bias", [
    (2, 12, 2048, 64, torch.bfloat16, False, True),
    (1, 12, 1024, 64, torch.bfloat16, True, False),
    (2, 4, 1000, 64, torch.float32, False, True),
    (2, 4, 200, 16, torch.float32, True, True),
    (2, 4, 300, 32, torch.bfloat16, False, False),
    (1, 1, 1, 64, torch.float32, True, False)])
def test_flash_kernel_matches_plain(cuda, B, H, S, D, dtype, causal,
                                    with_bias):
    gen = torch.Generator(device=cuda).manual_seed(S)
    q, k, v = (torch.randn(B, H, S, D, generator=gen, device=cuda).to(dtype)
               for _ in range(3))
    bias = None
    if with_bias:
        bias = torch.zeros(B, S, device=cuda)
        bias[:, -(S // 10):] = -1e9
    before = K.get_kernel("flash_attention").launches
    o, lse = K.flash_attention(q, k, v, bias=bias, causal=causal,
                               return_lse=True)
    orf, lser = K.get_body("flash_attention", "reference")(
        q, k, v, bias=bias, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert K.get_kernel("flash_attention").launches == before + 1
    rtol, atol = _tols(dtype)
    torch.testing.assert_close(o.float(), orf.float(), atol=atol, rtol=rtol)
    torch.testing.assert_close(lse, lser, atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_flash_kernel_takes_strided_head_views(cuda):
    gen = torch.Generator(device=cuda).manual_seed(7)
    B, S, N, D = 2, 300, 4, 64
    qkv = torch.randn(B, S, 3 * N * D, generator=gen, device=cuda).to(
        torch.bfloat16)
    q, k, v = (t.reshape(B, S, N, D).transpose(1, 2)
               for t in qkv.split(N * D, dim=-1))
    assert not q.is_contiguous()
    o = K.flash_attention(q, k, v)
    oc = K.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.testing.assert_close(o, oc, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,S,D,dtype,causal,with_bias", [
    (2, 12, 512, 64, torch.bfloat16, False, True),
    (2, 4, 1000, 64, torch.bfloat16, False, True),
    (1, 4, 1000, 64, torch.float32, True, False),
    (2, 4, 200, 16, torch.float32, True, True),
    (2, 4, 300, 32, torch.bfloat16, False, False),
    (1, 1, 1, 64, torch.float32, True, False)])
def test_flash_backward_kernels_match_plain(cuda, B, H, S, D, dtype, causal,
                                            with_bias):
    gen = torch.Generator(device=cuda).manual_seed(S + 1)
    q, k, v, do = (torch.randn(B, H, S, D, generator=gen, device=cuda)
                   .to(dtype) for _ in range(4))
    bias = None
    if with_bias:
        bias = torch.zeros(B, S, device=cuda)
        bias[:, -(S // 10):] = -1e9
    o, lse = K.get_body("flash_attention", "reference")(
        q, k, v, bias=bias, causal=causal, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    args = (q, k, v, bias, do, lse, delta)
    before = K.launch_counts()
    dk, dv, dbh = K.dispatch("flash_attention_bwd_dkdv", *args,
                             causal=causal)
    dq = K.dispatch("flash_attention_bwd_dq", *args, causal=causal)
    ref_dk, ref_dv, ref_dbh = K.get_body("flash_attention_bwd_dkdv",
                                         "reference")(*args, causal=causal)
    ref_dq = K.get_body("flash_attention_bwd_dq", "reference")(
        *args, causal=causal)
    torch.cuda.synchronize()
    after = K.launch_counts()
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        assert after[name] == before[name] + 1
    rtol, atol = _tols(dtype)
    atol = max(atol, 1e-4)
    for got, want in ((dq, ref_dq), (dk, ref_dk), (dv, ref_dv)):
        assert got.dtype == dtype and got.shape == want.shape
        torch.testing.assert_close(got.float(), want.float(), atol=atol,
                                   rtol=rtol)
    torch.testing.assert_close(dbh, ref_dbh, atol=1e-4, rtol=1e-5)


@pytest.mark.cuda
def test_flash_backward_kernels_take_strided_views(cuda):
    # autograd hands the backward a transposed view of dO and the saved
    # head views of the fused projection
    gen = torch.Generator(device=cuda).manual_seed(11)
    B, S, N, D = 2, 300, 4, 64
    qkv, dctx = (torch.randn(B, S, n * N * D, generator=gen, device=cuda)
                 .to(torch.bfloat16) for n in (3, 1))
    q, k, v = (t.reshape(B, S, N, D).transpose(1, 2)
               for t in qkv.split(N * D, dim=-1))
    do = dctx.reshape(B, S, N, D).transpose(1, 2)
    assert not q.is_contiguous() and not do.is_contiguous()
    o, lse = K.flash_attention(q, k, v, return_lse=True)
    delta = (do.float() * o.float()).sum(-1)
    for name in ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq"):
        got = K.dispatch(name, q, k, v, None, do, lse, delta)
        want = K.dispatch(name, q.contiguous(), k.contiguous(),
                          v.contiguous(), None, do.contiguous(), lse, delta)
        for a, b in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 1000])
def test_fused_adam_kernel_matches_plain(cuda, t):
    gen = torch.Generator(device=cuda).manual_seed(t)
    # sizes off the vector width and off the 16K chunk, an empty one, one
    # spanning chunks, and views one element in (not 16-byte aligned: the
    # scalar path)
    shapes = [(3,), (1,), (0,), (33, 70), (16384 * 2 + 5,), (768, 768),
              (1001,)]
    state = [[torch.randn(s, generator=gen, device=cuda) for s in shapes]
             for _ in range(4)]
    state[3] = [m.abs() for m in state[3]]
    for xs in state:
        xs[-1] = xs[-1][1:]
    ref = [[x.clone() for x in xs] for xs in state]
    step = torch.tensor(t, dtype=torch.int32, device=cuda)
    before = K.get_kernel("fused_adam").launches
    K.fused_adam(*state, 1e-3, step)
    K.get_body("fused_adam", "reference")(*ref, 1e-3, step)
    torch.cuda.synchronize()
    assert K.get_kernel("fused_adam").launches == before + 1
    # the same fp32 ops in the same order; only powf may differ by an ulp
    for xs, rs in zip(state, ref):
        for x, r in zip(xs, rs):
            torch.testing.assert_close(x, r, atol=1e-7, rtol=1e-6)


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(4, 64, device=cuda)
    g, b = torch.ones(64, device=cuda), torch.zeros(64, device=cuda)
    with pytest.raises(EnforceNotMet, match="float32 or bfloat16"):
        K.fused_layer_norm(x.half(), g, b)
    with pytest.raises(EnforceNotMet, match="contiguous"):
        K.fused_layer_norm(torch.randn(64, 4, device=cuda).T, g, b)
    with pytest.raises(EnforceNotMet, match="multiple of"):
        K.fused_layer_norm(torch.randn(4, 66, device=cuda),
                           torch.ones(66, device=cuda),
                           torch.zeros(66, device=cuda))
    q = torch.randn(1, 2, 16, 128, device=cuda)
    with pytest.raises(EnforceNotMet, match="head_dim"):
        K.flash_attention(q, q, q)
    with pytest.raises(EnforceNotMet, match="CUDA device"):
        K.flash_attention(q[..., :64], q[..., :64].cpu(), q[..., :64])
    p = [torch.zeros(4, device=cuda)]
    one = torch.tensor(1, dtype=torch.int32, device=cuda)
    with pytest.raises(EnforceNotMet, match="float32 tensor"):
        K.fused_adam(p, [torch.zeros(4, device=cuda).half()], p, p, 0.1, one)
    with pytest.raises(EnforceNotMet, match="0-d int32"):
        K.fused_adam(p, p, p, p, 0.1, one.long())


@pytest.mark.cuda
def test_grads_flow_through_both_functions_and_match_cpu(cuda):
    gen = torch.Generator().manual_seed(5)
    B, H, S, D = 2, 4, 300, 64
    x = torch.randn(B, S, H * D, generator=gen)
    g, b = torch.randn(H * D, generator=gen), torch.randn(H * D, generator=gen)
    bias = torch.zeros(B, S)
    bias[1, -30:] = -1e9
    dy = torch.randn(B, S, H * D, generator=gen)

    def run(dev):
        leaves = [t.to(dev).requires_grad_() for t in (x, g, b)]
        h = K.fused_layer_norm(*leaves)
        q = h.reshape(B, S, H, D).transpose(1, 2)
        o = K.flash_attention(q, q * 0.5, q * 2.0, bias=bias.to(dev),
                              causal=True)
        o.transpose(1, 2).reshape(B, S, H * D).backward(dy.to(dev))
        return [t.grad.cpu() for t in leaves]

    K.reset_launch_counts()
    on_card = run(cuda)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    assert counts["fused_layer_norm"] == 1 and counts["flash_attention"] == 1
    assert counts["flash_attention_bwd_dkdv"] == 1
    assert counts["flash_attention_bwd_dq"] == 1
    # fp32 throughout: summation order only
    for a, c in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bert_on_card_matches_cpu(cuda, impl):
    cfg = bert.bert_tiny(dtype=torch.float32, attention_impl=impl)
    params = bert.init_params(cfg, torch.Generator().manual_seed(0),
                              device="cpu")
    batch = bert.synthetic_batch(cfg, 2, 48, seed=1, max_preds=6)
    batch["attention_mask"][1, 40:] = 0
    on_card = {k: [{n: t.to(cuda) for n, t in lp.items()} for lp in v]
               if isinstance(v, list) else {n: t.to(cuda) for n, t in
                                            v.items()}
               for k, v in params.items()}
    with torch.inference_mode():
        loss_cpu = float(bert.mlm_loss(params, cfg, batch))
        K.reset_launch_counts()
        loss_card = float(bert.mlm_loss(on_card, cfg, batch))
    counts = K.launch_counts()
    assert counts["fused_layer_norm"] == 2 * cfg.num_layers + 2
    assert counts["flash_attention"] == (cfg.num_layers if impl == "flash"
                                         else 0)
    assert np.isfinite(loss_card)
    assert abs(loss_cpu - loss_card) <= 1e-4, (loss_cpu, loss_card)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_bert_train_step_on_card_matches_cpu(cuda, impl):
    from paddle_tpu_torch import optimizer

    cfg = bert.bert_tiny(dtype=torch.float32, attention_impl=impl)
    batch = bert.synthetic_batch(cfg, 2, 48, seed=1, max_preds=6)
    batch["attention_mask"][1, 40:] = 0
    losses = {}
    final = {}
    for dev in ("cpu", cuda):
        opt = optimizer.Adam(learning_rate=1e-3)
        init_fn, step_fn = bert.make_train_step(cfg, opt, steps_per_call=3,
                                                device=dev)
        params, state = init_fn(torch.Generator().manual_seed(0))
        K.reset_launch_counts()
        loss, params, state = step_fn(params, state, batch)
        losses[str(dev)] = float(loss)
        final[str(dev)] = params
        if dev != "cpu":
            counts = K.launch_counts()
            assert counts["fused_adam"] == 3
            assert counts["fused_layer_norm"] == 3 * (2 * cfg.num_layers + 2)
            n_flash = 3 * cfg.num_layers if impl == "flash" else 0
            for name in ("flash_attention", "flash_attention_bwd_dkdv",
                         "flash_attention_bwd_dq"):
                assert counts[name] == n_flash, (name, counts)
    # fp32 on both; Adam's sign-like early updates turn summation-order
    # differences of near-zero grads into update differences (see
    # tests/test_torch_train.py): loss 1e-4, parameters 1e-4
    assert abs(losses["cpu"] - losses[str(cuda)]) <= 1e-4, losses
    for a, c in zip(final["cpu"]["layers"], final[str(cuda)]["layers"]):
        for name in a:
            torch.testing.assert_close(c[name].cpu(), a[name], atol=1e-4,
                                       rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("h,d,dtype,n,ids_dtype", [
    (2073, 32, torch.float32, 100, torch.int64),      # word2vec's table
    (30528, 768, torch.bfloat16, 64 * 512, torch.int64),   # BERT-base words
    (7, 3, torch.float32, 50, torch.int32),           # 12-byte rows
    (9, 5, torch.bfloat16, 33, torch.int64),          # 10-byte rows
    (4, 6, torch.float16, 9, torch.int32)])
def test_embedding_gather_kernel_matches_plain(cuda, h, d, dtype, n,
                                               ids_dtype):
    gen = torch.Generator(device=cuda).manual_seed(h)
    table = torch.randn(h, d, generator=gen, device=cuda).to(dtype)
    # valid, negative (wrap once) and out-of-range (NaN rows) ids
    ids = torch.randint(-h - 3, h + 3, (n,), generator=gen, device=cuda,
                        dtype=torch.int64).to(ids_dtype)
    ids[:3] = torch.tensor([0, -1, h], device=cuda)
    before = K.get_kernel("embedding_gather").launches
    out = K.embedding_gather(table, ids.reshape(1, n))
    ref = K.get_body("embedding_gather", "reference")(table, ids)
    torch.cuda.synchronize()
    assert K.get_kernel("embedding_gather").launches == before + 1
    assert out.shape == (1, n, d) and out.dtype == dtype
    # a copy: bit-identical, NaN rows where the plain body has them
    torch.testing.assert_close(out[0], ref, atol=0, rtol=0, equal_nan=True)
    assert torch.isnan(out[0, 2]).all() and not torch.isnan(out[0, 1]).any()


@pytest.mark.cuda
def test_embedding_gather_grad_on_card_matches_cpu(cuda):
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(50, 16, generator=gen)
    ids = torch.tensor([[0, 3, 3, -1], [49, 50, -51, 7]])
    dy = torch.randn(2, 4, 16, generator=gen)

    def run(dev):
        t = table.to(dev).requires_grad_()
        K.embedding_gather(t, ids.to(dev)).backward(dy.to(dev))
        return t.grad.cpu()

    # fp32 index_add in another order on the card (atomics): 1e-6
    torch.testing.assert_close(run(cuda), run("cpu"), atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,act,dtype,with_bias", [
    (100, 128, 256, "sigmoid", torch.float32, True),   # word2vec's fc 1
    (100, 256, 2073, None, torch.float32, True),       # word2vec's fc 2
    (8192, 256, 2073, None, torch.float32, True),
    (4096, 768, 3072, "relu", torch.bfloat16, True),   # BERT's FFN
    (33, 70, 130, "tanh", torch.float32, False),
    (1, 1, 1, "relu", torch.float32, True),
    (65, 17, 63, "gelu", torch.bfloat16, True)])
def test_fused_matmul_kernel_matches_plain(cuda, m, k, n, act, dtype,
                                           with_bias):
    gen = torch.Generator(device=cuda).manual_seed(m + n)
    x = torch.randn(m, k, generator=gen, device=cuda).to(dtype)
    w = (torch.randn(k, n, generator=gen, device=cuda) / k ** 0.5).to(dtype)
    b = torch.randn(n, generator=gen, device=cuda) if with_bias else None
    K.reset_launch_counts()
    out = K.fused_matmul(x, w, b, act)
    ref = K.get_body("fused_matmul", "reference")(
        x, w, b, None if act == "gelu" else act)
    if act == "gelu":
        ref = torch.nn.functional.gelu(ref)
    torch.cuda.synchronize()
    assert K.launch_counts()["fused_matmul"] == 1
    assert out.dtype == dtype and out.shape == (m, n)
    # fp32 sums of K products in another order: 1e-4 (bf16 inputs: exact
    # fp32 products, the same sums), then one rounding to the output dtype
    rtol = BF16_RTOL if dtype == torch.bfloat16 else 1e-4
    torch.testing.assert_close(out.float(), ref.to(dtype).float(),
                               atol=1e-4, rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("act", [None, "relu", "sigmoid", "tanh", "gelu"])
def test_fused_matmul_grads_on_card_match_cpu(cuda, act):
    gen = torch.Generator().manual_seed(7)
    x, w = torch.randn(37, 20, generator=gen), torch.randn(20, 131,
                                                           generator=gen)
    b, dy = torch.randn(131, generator=gen), torch.randn(37, 131,
                                                         generator=gen)

    def run(dev):
        leaves = [t.to(dev).requires_grad_() for t in (x, w, b)]
        K.fused_matmul(*leaves, act=act).backward(dy.to(dev))
        return [t.grad.cpu() for t in leaves]

    K.reset_launch_counts()
    on_card = run(cuda)
    assert K.launch_counts()["fused_matmul"] == 1
    for a, c in zip(on_card, run("cpu")):
        torch.testing.assert_close(a, c, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("rule", ["sgd", "momentum", "nesterov"])
def test_fused_sgd_and_momentum_kernels_match_plain(cuda, rule):
    gen = torch.Generator(device=cuda).manual_seed(11)
    # word2vec's five tensors, one past a chunk, an empty one, and views
    # one element in (not 16-byte aligned: the scalar loop)
    shapes = [(2073, 32), (128, 256), (256,), (256, 2073), (2073,),
              (16385,), (0,), (5,)]
    base = [torch.randn(2 + int(np.prod(s)), generator=gen, device=cuda)
            for s in shapes]
    p = [t[1:1 + int(np.prod(s))].view(s) if i >= 6 else t[:int(np.prod(s))]
         .view(s) for i, (t, s) in enumerate(zip(base, shapes))]
    g = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    v = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    ref_p, ref_v = [t.clone() for t in p], [t.clone() for t in v]
    name = "fused_sgd" if rule == "sgd" else "fused_momentum"
    before = K.get_kernel(name).launches
    if rule == "sgd":
        K.fused_sgd(p, g, 1e-3)
        K.get_body(name, "reference")(ref_p, g, 1e-3)
    else:
        nest = rule == "nesterov"
        K.fused_momentum(p, g, v, 1e-3, 0.9, nest)
        K.get_body(name, "reference")(ref_p, g, ref_v, 1e-3, 0.9, nest)
    torch.cuda.synchronize()
    assert K.get_kernel(name).launches == before + 1
    # each product and sum rounded on its own in the plain order: exact
    for a, r in zip(p + (v if rule != "sgd" else []),
                    ref_p + (ref_v if rule != "sgd" else [])):
        torch.testing.assert_close(a, r, atol=0, rtol=0)
