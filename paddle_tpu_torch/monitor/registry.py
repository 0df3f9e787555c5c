"""Process-wide metrics registry: Counter / Gauge / Histogram.

The port's own copy of ``paddle_tpu/monitor/registry.py`` (stdlib only):
the metrics of the serving modules, the Executor, the cost, goodput,
numerics and tensor-watch monitors, read by the exporter.

Design constraints, in order:

1. The write path must be cheap enough for the serving hot path: counters
   and histograms write into THREAD-LOCAL shards (one plain dict per thread;
   dict mutation is atomic under the GIL) and a read merges all shards. The
   only lock is taken once per (metric, thread) at shard registration and on
   reads.
2. Gauges are set rarely (queue depth, replica counts), so they use a
   single locked store: last-write-wins is the semantics a gauge wants, and
   merged shards cannot provide it.
3. Stdlib only.

Metric names follow Prometheus conventions (``snake_case``, counters end in
``_total``, unit suffix like ``_ms`` on histograms). Every name the port
registers is a row of docs/OBSERVABILITY.md's catalogue, under the JAX
package's kind and labels (``tests/test_torch_monitor.py`` holds them).
"""

import bisect
import re
import threading

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
]

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

#: default histogram buckets, in milliseconds
DEFAULT_BUCKETS_MS = (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0,
                      500.0, 1000.0, 2500.0, 5000.0, 10000.0, 30000.0)


class _ThreadShards:
    """The shard idiom of the hot-path recorders: each thread writes its
    OWN shard (created once and registered under the lock, mutated
    lock-free after) and readers take a locked snapshot of the shard list.
    Dead threads' shards are folded (``fold_dead``) or dropped (``None``)
    on the rare registration path, so thread churn cannot grow the list
    without bound."""

    def __init__(self, make_shard, fold_dead=None):
        self._make = make_shard
        self._fold = fold_dead
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._entries = []              # (owner thread, shard)

    def get(self):
        """The calling thread's shard."""
        d = getattr(self._tls, "shard", None)
        if d is None:
            d = self._make()
            self._tls.shard = d
            with self._lock:
                live = []
                for t, sd in self._entries:
                    if t.is_alive():
                        live.append((t, sd))
                    elif self._fold is not None:
                        self._fold(sd)
                live.append((threading.current_thread(), d))
                self._entries = live
        return d

    def shards(self):
        with self._lock:
            return [sd for _t, sd in self._entries]

    def items(self):
        """[(owner thread, shard)]: for readers that need the owner (the
        flight recorder naming a stuck thread)."""
        with self._lock:
            return list(self._entries)


def _snap_items(d):
    """``list(d.items())`` robust to a concurrent writer inserting a new key
    mid-iteration (the RuntimeError is only the resize guard, so retrying
    converges as soon as one pass sees no insert)."""
    while True:
        try:
            return list(d.items())
        except RuntimeError:
            continue


def _fold_cells(acc, shard):
    """Merge a cell shard into an accumulator dict: float cells add,
    list cells (histogram) add elementwise."""
    for k, v in shard.items():
        cur = acc.get(k)
        if cur is None:
            acc[k] = list(v) if isinstance(v, list) else v
        elif isinstance(v, list):
            for i, x in enumerate(v):
                cur[i] += x
        else:
            acc[k] = cur + v


class _Metric:
    """Shared shape: name/help/labelnames + the thread-local shard
    machinery subclasses write through."""

    kind = None

    def __init__(self, name, help="", labelnames=()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        self._retired = {}          # dead threads' cells, folded in
        self._shards = _ThreadShards(
            dict, lambda sd: _fold_cells(self._retired, sd))

    def _shard(self):
        return self._shards.get()

    def _all_shards(self):
        return [self._retired] + self._shards.shards()

    def _labelkey(self, labels):
        if not self.labelnames and not labels:
            return ()
        if set(labels) != set(self.labelnames):
            raise ValueError(
                f"{self.name}: got labels {sorted(labels)}, declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(labels[k]) for k in self.labelnames)


class Counter(_Metric):
    """Monotonic counter. ``inc`` is the lock-free hot path."""

    kind = "counter"

    def inc(self, amount=1.0, **labels):
        if not amount >= 0:          # also rejects NaN
            raise ValueError(f"{self.name}: counters only go up "
                             f"(inc({amount}))")
        key = self._labelkey(labels)
        shard = self._shard()
        shard[key] = shard.get(key, 0.0) + amount

    def value(self, **labels):
        key = self._labelkey(labels)
        return sum(s.get(key, 0.0) for s in self._all_shards())

    def samples(self):
        """{labelvalues tuple: merged value}."""
        out = {}
        for s in self._all_shards():
            for k, v in _snap_items(s):
                out[k] = out.get(k, 0.0) + v
        return out


class Gauge(_Metric):
    """Point-in-time value; single locked store (last write wins)."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values = {}

    def set(self, value, **labels):
        key = self._labelkey(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, amount=1.0, **labels):
        key = self._labelkey(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + amount

    def dec(self, amount=1.0, **labels):
        self.inc(-amount, **labels)

    def value(self, **labels):
        key = self._labelkey(labels)
        with self._lock:
            return self._values.get(key, 0.0)

    def clear(self):
        """Drop every labeled series (a superseded object's gauges)."""
        with self._lock:
            self._values.clear()

    def remove(self, **labels):
        """Drop ONE labeled series — for gauges whose label values
        rotate (the served model version): without removal every
        superseded label value would linger as a series."""
        key = self._labelkey(labels)
        with self._lock:
            self._values.pop(key, None)

    def samples(self):
        with self._lock:
            return dict(self._values)


class Histogram(_Metric):
    """Bucketed distribution; ``observe`` is the lock-free hot path.

    Per-shard cell layout: ``[count_b0, ..., count_bN, count_inf,
    sum, count]`` with NON-cumulative bucket counts (merging is
    elementwise add; the exporter cumulates for Prometheus ``le``)."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets=DEFAULT_BUCKETS_MS):
        super().__init__(name, help, labelnames)
        bs = tuple(sorted(float(b) for b in buckets))
        if not bs:
            raise ValueError(f"{self.name}: need at least one bucket")
        self.buckets = bs

    def observe(self, value, **labels):
        key = self._labelkey(labels)
        shard = self._shard()
        cell = shard.get(key)
        if cell is None:
            cell = shard[key] = [0] * (len(self.buckets) + 1) + [0.0, 0]
        cell[bisect.bisect_left(self.buckets, value)] += 1
        cell[-2] += value
        cell[-1] += 1

    def _merged(self):
        out = {}
        nb = len(self.buckets) + 3
        for s in self._all_shards():
            for k, cell in _snap_items(s):
                acc = out.get(k)
                if acc is None:
                    acc = out[k] = [0] * (nb - 2) + [0.0, 0]
                for i in range(nb):
                    acc[i] += cell[i]
        return out

    def samples(self):
        """{labelvalues: (cumulative bucket counts incl +Inf, sum,
        count)}."""
        out = {}
        for k, cell in self._merged().items():
            cum, running = [], 0
            for c in cell[:-2]:
                running += c
                cum.append(running)
            out[k] = (cum, cell[-2], cell[-1])
        return out

    def count(self, **labels):
        key = self._labelkey(labels)
        return sum(s.get(key, [0.0, 0])[-1] for s in self._all_shards())

    def sum(self, **labels):
        key = self._labelkey(labels)
        return sum(s.get(key, [0.0, 0])[-2] for s in self._all_shards())


class Registry:
    """Name → metric table with get-or-create semantics: instrumenting
    modules declare their metrics at import with ``counter(...)`` etc.;
    re-declaring an existing name returns the SAME object iff kind and
    labels match, and raises otherwise."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics = {}

    def _get_or_create(self, cls, name, help, labelnames, **kw):
        with self._lock:
            m = self._metrics.get(name)
            if m is not None:
                if not isinstance(m, cls) or \
                        m.labelnames != tuple(labelnames):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{m.kind} with labels {m.labelnames}")
                want = kw.get("buckets")
                if want is not None and tuple(sorted(
                        float(b) for b in want)) != m.buckets:
                    # silently handing back other buckets would put
                    # this caller's observations in the wrong ranges
                    raise ValueError(
                        f"histogram {name!r} already registered with "
                        f"buckets {m.buckets}")
                return m
            m = cls(name, help, labelnames, **kw)
            self._metrics[name] = m
            return m

    def counter(self, name, help="", labels=()):
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()):
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets=DEFAULT_BUCKETS_MS):
        # the default-sentinel means "whatever is registered": only an
        # EXPLICIT bucket spec conflicts with an existing one
        if buckets is DEFAULT_BUCKETS_MS:
            return self._get_or_create(Histogram, name, help, labels)
        return self._get_or_create(Histogram, name, help, labels,
                                   buckets=buckets)

    def get(self, name):
        with self._lock:
            return self._metrics.get(name)

    def collect(self):
        """All metrics, name-sorted (the exporter's iteration order)."""
        with self._lock:
            ms = list(self._metrics.values())
        return sorted(ms, key=lambda m: m.name)

    def clear(self):
        """Drop every metric (tests only): instrumented modules hold
        references to their metric objects, which keep counting but stop
        being exported after a clear."""
        with self._lock:
            self._metrics.clear()


#: the process-wide default registry every instrumented layer writes to
REGISTRY = Registry()


def counter(name, help="", labels=(), registry=None):
    return (registry or REGISTRY).counter(name, help, labels)


def gauge(name, help="", labels=(), registry=None):
    return (registry or REGISTRY).gauge(name, help, labels)


def histogram(name, help="", labels=(), buckets=DEFAULT_BUCKETS_MS,
              registry=None):
    return (registry or REGISTRY).histogram(name, help, labels, buckets)
