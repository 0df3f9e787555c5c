"""Host-resident sharded sparse embeddings: the port's own copy of
``paddle_tpu/distributed/sparse_embedding.py`` (numpy only; not imported
from the JAX package, which the port never imports).

Giant embeddings live in host RAM, sharded by id hash; the device step only
ever sees the dense [batch, slots, dim] slice pulled for the current batch.
The gradients of that slice come out of the step as dense arrays and are
pushed back, optionally asynchronously, so the push overlaps the next
step's compute. A "shard" is the unit a multi-host deployment would place
per host; in-process the shards are independent lock-protected tables,
keeping the parameter server's sharding semantics without the RPC hop.

Everything here computes what the JAX package's copy computes, bit for bit:
the same id hash and shard layout, the same deterministic row init, the
same merge and Adagrad/SGD rules, and the same checkpoint files
(``<name>.shard<s>.npz`` with ids, rows and slot, and ``<name>.manifest``),
so a table saved by either package loads in the other.
"""

import os
import queue
import threading

import numpy as np

__all__ = ["SparseEmbeddingTable", "sparse_sgd", "sparse_adagrad"]


def _hash_ids(ids, num_shards):
    # splitmix-style mix so adjacent ids spread across shards
    x = ids.astype(np.uint64)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(num_shards)).astype(np.int64)


def _hash_uniform_rows(ids, dim, seed, scale):
    """Vectorized deterministic init: per-(id, column) splitmix64 →
    uniform[-scale, scale). One numpy pass for ANY number of new ids —
    the per-id RandomState the naive form needs costs ~50us each, which
    at CTR id-churn rates (millions of new ids) dominates the step."""
    with np.errstate(over="ignore"):
        idn = np.asarray(ids, np.uint64)[:, None]
        jn = np.arange(dim, dtype=np.uint64)[None, :]
        x = (idn * np.uint64(0x9E3779B97F4A7C15)
             + (jn + np.uint64(1)) * np.uint64(0xD1B54A32D192ED03)
             + np.uint64(np.uint64(seed) * np.uint64(0x2545F4914F6CDD1D)))
        x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        x = x ^ (x >> np.uint64(31))
    u = (x >> np.uint64(11)).astype(np.float64) * (1.0 / (1 << 53))
    return ((u * 2.0 - 1.0) * scale).astype(np.float32)


class _Shard:
    """One id-hash shard: auto-growing row store + per-row optimizer slots
    (lookup_sparse_table_op.cc auto-growth; pserver optimize block state)."""

    def __init__(self, dim, initializer, seed, optimizer, grow=1024):
        self.dim = dim
        self.initializer = initializer
        self.seed = seed
        self.optimizer = optimizer
        self.index = {}                      # id -> row
        self.rows = np.zeros((0, dim), np.float32)
        self.slot = np.zeros((0, dim), np.float32)   # adagrad accumulator
        self.grow = grow
        self.lock = threading.Lock()

    def _ensure(self, ids):
        # dedupe (order-preserving): a duplicate id in one batch must not
        # claim two rows — the second claim would alias the next new id's
        # row slot
        new = list(dict.fromkeys(i for i in ids if i not in self.index))
        if not new:
            return
        need = len(self.index) + len(new)
        if need > len(self.rows):
            cap = max(need, len(self.rows) + self.grow)
            pad = cap - len(self.rows)
            self.rows = np.concatenate(
                [self.rows, np.zeros((pad, self.dim), np.float32)])
            self.slot = np.concatenate(
                [self.slot, np.zeros((pad, self.dim), np.float32)])
        r0 = len(self.index)
        for i in new:
            self.index[i] = len(self.index)
        if self.initializer is None:
            # deterministic per-id init: the same id always materialises
            # the same row, on any shard layout — one vectorized pass
            self.rows[r0:r0 + len(new)] = _hash_uniform_rows(
                np.asarray(new, np.int64), self.dim, self.seed,
                1.0 / np.sqrt(self.dim))
        else:
            # custom initializer: per-id RandomState keeps the same
            # (rng, dim) contract and per-id determinism
            for r, i in enumerate(new, start=r0):
                rng = np.random.RandomState((self.seed ^ (i * 2654435761))
                                            & 0x7FFFFFFF)
                self.rows[r] = self.initializer(rng, self.dim)

    def pull(self, ids):
        with self.lock:
            self._ensure(ids)
            rix = np.fromiter((self.index[i] for i in ids), np.int64,
                              len(ids))
            return self.rows[rix].copy()

    def push(self, ids, grads, lr):
        with self.lock:
            self._ensure(ids)
            rix = np.fromiter((self.index[i] for i in ids), np.int64,
                              len(ids))
            # the table merges to unique ids before dispatching to
            # shards — tell the builtin rules so they skip the
            # uniqueness sort; custom optimizers keep the old signature
            if self.optimizer in (sparse_sgd, sparse_adagrad):
                self.optimizer(self.rows, self.slot, rix, grads, lr,
                               unique=True)
            else:
                self.optimizer(self.rows, self.slot, rix, grads, lr)

    def state(self):
        with self.lock:
            n = len(self.index)
            ids = np.fromiter(self.index.keys(), np.int64, n)
            rix = np.fromiter(self.index.values(), np.int64, n)
            return ids, self.rows[rix].copy(), self.slot[rix].copy()

    def load(self, ids, rows, slot):
        with self.lock:
            self.index = {int(i): r for r, i in enumerate(ids)}
            self.rows = np.asarray(rows, np.float32).copy()
            self.slot = np.asarray(slot, np.float32).copy()


def _rix_unique(rix):
    if len(rix) < 2:
        return True
    s = np.sort(rix)
    return bool(np.all(s[1:] != s[:-1]))


def sparse_sgd(rows, slot, rix, grads, lr, unique=None):
    """Sparse SGD row update (pserver sgd optimize block parity).
    Unique row indices (the table's merge guarantees this, passed as
    unique=True so the hot path skips the O(n log n) confirmation) take
    the vectorized fancy-indexing path; ufunc.at only for duplicates."""
    if _rix_unique(rix) if unique is None else unique:
        rows[rix] -= lr * grads
    else:
        np.subtract.at(rows, rix, lr * grads)


def sparse_adagrad(rows, slot, rix, grads, lr, eps=1e-6, unique=None):
    """Sparse Adagrad (operators/optimizers/adagrad_op.cc SelectedRows
    kernel parity): accumulate g² per row, scale update."""
    if _rix_unique(rix) if unique is None else unique:
        slot[rix] += grads * grads
        rows[rix] -= lr * grads / (np.sqrt(slot[rix]) + eps)
    else:
        np.add.at(slot, rix, grads * grads)
        denom = np.sqrt(slot[rix]) + eps
        np.subtract.at(rows, rix, lr * grads / denom)


_OPTIMIZERS = {"sgd": sparse_sgd, "adagrad": sparse_adagrad}


class SparseEmbeddingTable:
    """Sharded, auto-growing, host-RAM embedding table with async push.

    - ``pull(ids)`` gathers dense rows (parameter_prefetch.cc parity),
      initializing unseen ids deterministically.
    - ``push(ids, grads)`` merges duplicate ids (SelectedRows merge-add,
      merge_selected_rows_op.cc) then applies the sparse optimizer.
    - ``push_async`` enqueues the push to a background thread per table —
      the caller (the device step loop) never blocks; ``flush()`` barriers,
      and training-loop reads are safe because pull takes the shard lock.
    - ``save(dir)/load(dir)`` checkpoint shard-by-shard
      (listen_and_serv checkpoint block parity).
    """

    def __init__(self, dim, num_shards=1, initializer=None, seed=0,
                 optimizer="sgd", learning_rate=0.01):
        # initializer=None → the vectorized uniform(-1/sqrt(dim)) hash
        # init in _Shard._ensure; a custom callable keeps the
        # (rng, dim) -> row contract at per-id RandomState cost
        self.dim = dim
        self.num_shards = num_shards
        self.learning_rate = learning_rate
        opt = _OPTIMIZERS[optimizer] if isinstance(optimizer, str) \
            else optimizer
        self._opt_name = optimizer if isinstance(optimizer, str) else "custom"
        # every shard derives row init from the SAME base seed: a given id
        # materialises identically under any shard count (shard-layout
        # invariance — resharding a checkpointed table is a pure repartition)
        self.shards = [_Shard(dim, initializer, seed, opt)
                       for s in range(num_shards)]
        self._q = queue.Queue()
        self._worker = None
        self._err = None

    # -- pull ---------------------------------------------------------------
    def pull(self, ids):
        """ids: int array of any shape → rows [*ids.shape, dim]."""
        ids = np.asarray(ids, np.int64)
        flat = ids.reshape(-1)
        out = np.empty((flat.size, self.dim), np.float32)
        sh = _hash_ids(flat, self.num_shards)
        for s in range(self.num_shards):
            m = sh == s
            if m.any():
                out[m] = self.shards[s].pull(flat[m].tolist())
        return out.reshape(ids.shape + (self.dim,))

    # -- push ---------------------------------------------------------------
    def _merge(self, flat_ids, flat_grads):
        uniq, inv = np.unique(flat_ids, return_inverse=True)
        # per-column bincount segment-sum: vectorized C loops instead
        # of np.add.at's one-element-at-a-time scatter (~50x at 100k
        # rows; the SelectedRows merge is on the CTR hot path)
        merged = np.stack(
            [np.bincount(inv, weights=flat_grads[:, j],
                         minlength=uniq.size)
             for j in range(self.dim)], axis=1).astype(np.float32)
        return uniq, merged

    def push(self, ids, grads, learning_rate=None):
        ids = np.asarray(ids, np.int64).reshape(-1)
        grads = np.asarray(grads, np.float32).reshape(-1, self.dim)
        lr = self.learning_rate if learning_rate is None else learning_rate
        uniq, merged = self._merge(ids, grads)
        sh = _hash_ids(uniq, self.num_shards)
        for s in range(self.num_shards):
            m = sh == s
            if m.any():
                self.shards[s].push(uniq[m].tolist(), merged[m], lr)

    def _worker_loop(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            try:
                self.push(*item)
            except Exception as e:  # surfaced on flush()
                self._err = e
            finally:
                self._q.task_done()

    def push_async(self, ids, grads, learning_rate=None):
        """Enqueue a push; returns immediately (Communicator send-thread
        parity, operators/distributed/communicator.h:160)."""
        if self._worker is None:
            self._worker = threading.Thread(target=self._worker_loop,
                                            daemon=True)
            self._worker.start()
        self._q.put((np.asarray(ids, np.int64).copy(),
                     np.asarray(grads, np.float32).copy(), learning_rate))

    def flush(self):
        """Barrier: wait until queued pushes applied (send_barrier parity)."""
        self._q.join()
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    # -- checkpoint ---------------------------------------------------------
    def save(self, dirname, name="sparse_table"):
        import glob
        os.makedirs(dirname, exist_ok=True)
        self.flush()
        # a re-save with fewer shards must not leave stale shard files
        # behind (load would reject or merge them)
        for f in glob.glob(os.path.join(dirname, f"{name}.shard*.npz")):
            os.remove(f)
        for s, shard in enumerate(self.shards):
            ids, rows, slot = shard.state()
            np.savez(os.path.join(dirname, f"{name}.shard{s}.npz"),
                     ids=ids, rows=rows, slot=slot)
        # manifest: lets load() tell "resharded checkpoint" apart from
        # "shard files missing" (partial copy)
        with open(os.path.join(dirname, f"{name}.manifest"), "w") as f:
            f.write(str(self.num_shards))

    def load(self, dirname, name="sparse_table"):
        """Loads a checkpoint written under ANY shard count: all shard
        files are merged and repartitioned by id hash into this table's
        layout (shard-layout invariance — resharding a checkpoint is a
        pure repartition)."""
        import glob
        self.flush()   # stale queued pushes must not land on the
                       # freshly loaded rows
        files = sorted(glob.glob(
            os.path.join(dirname, f"{name}.shard*.npz")))
        if not files:
            raise FileNotFoundError(
                f"no {name}.shard*.npz under {dirname}")
        manifest = os.path.join(dirname, f"{name}.manifest")
        if os.path.exists(manifest):
            with open(manifest) as f:
                want = int(f.read().strip())
            if len(files) != want:
                raise FileNotFoundError(
                    f"checkpoint {name} incomplete: manifest says "
                    f"{want} shard files, found {len(files)}")
        parts = [np.load(f) for f in files]
        ids = np.concatenate([p["ids"] for p in parts])
        rows = np.concatenate([p["rows"] for p in parts])
        slot = np.concatenate([p["slot"] for p in parts])
        sh = _hash_ids(ids, self.num_shards)
        for s, shard in enumerate(self.shards):
            m = sh == s
            shard.load(ids[m], rows[m], slot[m])

    @property
    def size(self):
        return sum(len(s.index) for s in self.shards)
