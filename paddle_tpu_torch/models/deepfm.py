"""DeepFM CTR model over the host-resident sparse embedding tables: the port
of paddle_tpu/models/deepfm.py.

The device step is a function of (dense params, pulled embedding slices,
dense features, labels) that returns gradients for both: the dense grads
update the dense params on the device (inline SGD, ``p - lr * g``, in place
here), and the slice grads leave the device and are pushed, sync or async,
to :class:`~paddle_tpu_torch.distributed.SparseEmbeddingTable` on the host.
FM math:
logit = w0 + sum first_order(slot) + 1/2 [(sum e)^2 - sum e^2] . 1
+ DNN(concat e, dense).

Nothing here reaches a Pallas kernel in the JAX package (the step is plain
jnp and the tables numpy), so the step is plain PyTorch on the device and
the tables stay numpy on the host. ``wire_dtype`` ("float32", "float16" or
"bfloat16") is the dtype of the pulled rows on their way to the device and
of the slice grads on their way back; the casts of the rows are made by
torch on the host (numpy has no bfloat16), the grads' on the device, and
the host tables accumulate fp32 either way.
"""

import collections
import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.distributed.sparse_embedding import SparseEmbeddingTable
from paddle_tpu_torch.ops.loss import sigmoid_cross_entropy_with_logits

__all__ = ["DeepFMConfig", "init_dense_params", "params_from_numpy",
           "forward", "loss_fn", "CTRTrainer", "synthetic_ctr_batch"]

_WIRE = {"float32": torch.float32, "float16": torch.float16,
         "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class DeepFMConfig:
    num_slots: int = 26          # criteo-style categorical slots
    embed_dim: int = 8
    dense_dim: int = 13          # continuous features
    dnn_sizes: tuple = (64, 32)
    vocab_per_slot: int = 100000  # id space (hashed); table auto-grows
    num_shards: int = 1
    sparse_lr: float = 0.05
    sparse_optimizer: str = "adagrad"


def _sizes(cfg):
    return ((cfg.num_slots * cfg.embed_dim + cfg.dense_dim,)
            + tuple(cfg.dnn_sizes) + (1,))


def _shapes(cfg):
    """{name: shape} of the dense params, in the JAX package's names."""
    sizes = _sizes(cfg)
    out = {"w0": ()}
    for i in range(len(sizes) - 1):
        out[f"dnn_w{i}"] = (sizes[i], sizes[i + 1])
        out[f"dnn_b{i}"] = (sizes[i + 1],)
    return out


def init_dense_params(cfg, generator, device=None):
    """fp32 dense params {w0, dnn_w<i>, dnn_b<i>}: normal weights over
    sqrt(fan_in) drawn from ``generator`` (a ``torch.Generator``), zero
    biases and w0. ``device`` defaults to the card."""
    device = resolve_device(device)
    params = {}
    for name, shape in _shapes(cfg).items():
        if name.startswith("dnn_w"):
            t = torch.randn(shape, generator=generator,
                            device=generator.device) / np.sqrt(shape[0])
            params[name] = t.to(device)
        else:
            params[name] = torch.zeros(shape, device=device)
    return params


def params_from_numpy(tree, cfg, device=None):
    """The port's dense params from the JAX package's, after
    ``jax.tree.map(np.asarray, params)``. Strict about names, shapes and
    float32. ``device`` defaults to the card."""
    device = resolve_device(device)
    shapes = _shapes(cfg)
    if not isinstance(tree, dict) or set(tree) != set(shapes):
        got = sorted(tree) if isinstance(tree, dict) else type(tree).__name__
        raise EnforceNotMet(f"params_from_numpy: expected a dict of "
                            f"{sorted(shapes)}, got {got}")
    out = {}
    for name, shape in shapes.items():
        a = tree[name]
        if (not isinstance(a, np.ndarray) or a.dtype != np.float32
                or a.shape != shape):
            got = (f"{a.dtype}{list(a.shape)}" if isinstance(a, np.ndarray)
                   else type(a).__name__)
            raise EnforceNotMet(
                f"params_from_numpy: {name} must be a float32 numpy array "
                f"of shape {list(shape)}, got {got}")
        out[name] = torch.tensor(a).to(device)
    return out


def forward(params, cfg, emb, first, dense):
    """emb [B, slots, D] second-order embeddings; first [B, slots] pulled
    first-order weights; dense [B, dense_dim]. Returns logits [B]."""
    b = emb.shape[0]
    fo = first.sum(dim=1)                                # [B]
    s1 = emb.sum(dim=1)                                  # [B, D]
    so = 0.5 * (s1 * s1 - (emb * emb).sum(dim=1)).sum(dim=-1)
    x = torch.cat([emb.reshape(b, -1), dense], dim=-1)
    n_layers = len(cfg.dnn_sizes) + 1
    for i in range(n_layers):
        x = x @ params[f"dnn_w{i}"] + params[f"dnn_b{i}"]
        if i < n_layers - 1:
            x = torch.relu(x)
    return params["w0"] + fo + so + x[:, 0]


def loss_fn(params, cfg, emb, first, dense, labels):
    """(mean sigmoid cross-entropy, logits)."""
    logits = forward(params, cfg, emb, first, dense)
    loss = sigmoid_cross_entropy_with_logits(logits, labels.float())
    return loss.mean(), logits


def _train_step(cfg, params, emb, first, dense, labels, lr,
                wire_dtype="float32"):
    """One step on the device: loss and grads of the dense params AND of
    the pulled slices; the dense params take ``p - lr * g`` in place; the
    slice grads leave in ``wire_dtype``. Returns (loss, logits, params,
    gemb, gfirst), loss and logits detached."""
    emb = emb.float().requires_grad_()
    first = first.float().requires_grad_()
    live = {k: p.detach().requires_grad_() for k, p in params.items()}
    loss, logits = loss_fn(live, cfg, emb, first, dense, labels)
    *gp, gemb, gfirst = torch.autograd.grad(
        loss, [*live.values(), emb, first])
    with torch.no_grad():
        for p, g in zip(params.values(), gp):
            p.sub_(lr * g)
    wire = _WIRE[wire_dtype]
    return (loss.detach(), logits.detach(), params, gemb.to(wire),
            gfirst.to(wire))


class CTRTrainer:
    """Train loop glue: pull -> device step -> push, as the JAX package's.

    ``train_step`` pulls synchronously (each step reads the freshest rows:
    sync-PS semantics) and pushes sync or async; ``train_stream`` is the
    three-stage pipeline whose staging thread pulls up to ``prefetch``
    steps ahead, so embeddings are steps behind the pushes (the reference's
    async Communicator mode). ``wire_dtype`` quantizes the embeddings and
    grads crossing the host-device link in both loops; the host tables
    accumulate fp32 either way. The dense params live on ``device`` (the
    card by default)."""

    def __init__(self, cfg, seed=0, sync_push=False, wire_dtype="float32",
                 device=None):
        if wire_dtype not in _WIRE:
            raise EnforceNotMet(f"wire_dtype {wire_dtype!r}: one of "
                                f"{sorted(_WIRE)}")
        self.cfg = cfg
        self.sync_push = sync_push
        self.wire_dtype = wire_dtype
        self.device = resolve_device(device)
        self.table = SparseEmbeddingTable(
            cfg.embed_dim, num_shards=cfg.num_shards, seed=seed,
            optimizer=cfg.sparse_optimizer, learning_rate=cfg.sparse_lr)
        # first-order weights: their own 1-dim sharded table
        self.table_w1 = SparseEmbeddingTable(
            1, num_shards=cfg.num_shards, seed=seed + 1,
            optimizer=cfg.sparse_optimizer, learning_rate=cfg.sparse_lr)
        self.params = init_dense_params(
            cfg, torch.Generator().manual_seed(seed), device=self.device)

    def _pull(self, ids):
        """The batch's rows of both tables on the host, in the wire dtype
        (emb [B, slots, D], first [B, slots])."""
        wire = _WIRE[self.wire_dtype]
        emb = torch.from_numpy(self.table.pull(ids)).to(wire)
        first = torch.from_numpy(self.table_w1.pull(ids)[..., 0]).to(wire)
        return emb, first

    def _stage(self, batch):
        """Host pull + copy to the device of one batch (the staging
        thread's work in ``train_stream``)."""
        ids, dense, labels = batch
        ids = np.asarray(ids)
        emb, first = self._pull(ids)
        dev = self.device
        return (ids, emb.to(dev), first.to(dev),
                torch.as_tensor(np.asarray(dense), dtype=torch.float32,
                                device=dev),
                torch.as_tensor(np.asarray(labels), device=dev))

    @staticmethod
    def _fetch(gemb, gfirst):
        """The slice grads on the host as fp32 numpy (gemb [B, slots, D],
        gfirst [B, slots, 1]), widened from the wire dtype."""
        return (gemb.cpu().float().numpy(),
                gfirst.cpu().float().numpy()[..., None])

    def _push(self, ids, gemb, gfirst, sync):
        if sync:
            self.table.push(ids, gemb)
            self.table_w1.push(ids, gfirst)
        else:
            self.table.push_async(ids, gemb)
            self.table_w1.push_async(ids, gfirst)

    def train_step(self, ids, dense, labels, lr=0.01):
        """ids [B, slots] int64; dense [B, dense_dim]; labels [B]. Returns
        (float loss, numpy logits)."""
        ids, emb, first, dense, labels = self._stage((ids, dense, labels))
        loss, logits, self.params, gemb, gfirst = _train_step(
            self.cfg, self.params, emb, first, dense, labels, lr,
            self.wire_dtype)
        self._push(ids, *self._fetch(gemb, gfirst), self.sync_push)
        return float(loss), logits.cpu().numpy()

    def _drain(self, ids, gemb, gfirst, loss):
        """Fetch of one step's grads + async push (the drain thread)."""
        self._push(ids, *self._fetch(gemb, gfirst), sync=False)
        return float(loss)

    def train_stream(self, batches, lr=0.01, prefetch=2):
        """Three-stage pipelined loop: a staging thread runs batch i+k's
        host pull and copy to the device while the device computes step i,
        and a drain thread fetches step i-1's grads and pushes them.
        Embeddings are therefore up to ``prefetch`` steps stale relative to
        the pushes, as in the JAX package. Yields the float loss of each
        batch, in order."""
        stage_pool = ThreadPoolExecutor(1)
        drain_pool = ThreadPoolExecutor(1)
        staged = collections.deque()
        drains = collections.deque()
        it = iter(batches)

        def fill():
            while len(staged) < max(prefetch, 1):
                try:
                    b = next(it)
                except StopIteration:
                    return
                staged.append(stage_pool.submit(self._stage, b))

        try:
            fill()
            while staged:
                ids, emb, first, dense, labels = staged.popleft().result()
                fill()      # stage the next batch behind the compute
                loss, _, self.params, gemb, gfirst = _train_step(
                    self.cfg, self.params, emb, first, dense, labels, lr,
                    self.wire_dtype)
                drains.append(drain_pool.submit(
                    self._drain, ids, gemb, gfirst, loss))
                while len(drains) > 1:
                    yield drains.popleft().result()
            while drains:
                yield drains.popleft().result()
        finally:
            # early consumer exit: in-flight grads must still land before
            # the tables are read
            while drains:
                try:
                    drains.popleft().result()
                except Exception:   # the first error was raised already
                    pass
            # wait=True: an in-flight _stage pull materializes ids into the
            # tables; returning while it runs would race a later
            # save()/pull() against that mutation
            stage_pool.shutdown(wait=True, cancel_futures=True)
            drain_pool.shutdown(wait=True)
            self.finalize()

    def finalize(self):
        self.table.flush()
        self.table_w1.flush()

    def save(self, dirname):
        self.table.save(dirname, "deepfm_emb")
        self.table_w1.save(dirname, "deepfm_w1")

    def load(self, dirname):
        self.table.load(dirname, "deepfm_emb")
        self.table_w1.load(dirname, "deepfm_w1")


def synthetic_ctr_batch(cfg, batch_size, seed=0):
    """Learnable synthetic CTR data (numpy), identical to the JAX
    package's: the label depends on a fixed random score per id, so the
    model can overfit it."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_per_slot,
                      (batch_size, cfg.num_slots)).astype(np.int64)
    # slot offset so ids are disjoint across slots (one table, offset ids)
    ids = ids + np.arange(cfg.num_slots)[None, :] * cfg.vocab_per_slot
    dense = rng.rand(batch_size, cfg.dense_dim).astype(np.float32)
    w = ((ids * 2654435761) % 97 / 97.0 - 0.5).sum(1)
    score = w + dense.sum(1) * 0.3 - 0.15 * cfg.dense_dim
    labels = (score > np.median(score)).astype(np.int64)
    return ids, dense, labels
