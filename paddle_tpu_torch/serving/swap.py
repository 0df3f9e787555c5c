"""Zero-downtime hot model swap: the supervised, reversible
training-to-serving handoff. The port of ``paddle_tpu/serving/swap.py``.

:class:`SwapController` turns a deploy into a staged, abortable pipeline in
which the LIVE version keeps serving until the new one has proven itself,
and keeps serving if it never does:

1. **gate**: ``verify_aot_dir`` (CRC of every file the manifest vouches
   for) plus compatibility with the live contract: the same feed names,
   fetch names and per-feed sample specs, per-row fetches at the ladder's
   top. ``swap()`` always re-gates, even on a server booted with
   ``verify_aot=False``.
2. **admission**: the live pool's ``projected_bytes`` plus the standby's
   param bytes must fit under ``ServingConfig.hbm_limit_bytes`` (else the
   card's total memory / ``PADDLE_TPU_HBM_LIMIT_BYTES``); otherwise the swap
   is refused before anything boots.
3. **standby warm boot**: the new version's params go to the card and
   every bucket runs once, BESIDE the live pool
   (``ReplicaPool(role="standby")``), on a worker thread bounded by
   ``standby_timeout_ms``: a wedged or failing boot quarantines the SWAP,
   never the live traffic.
4. **canary**: golden requests run through the standby replica directly
   (no real traffic touches it): per-row shapes, finite float fetches,
   optional parity bounds against the live version and a caller hook.
5. **atomic cutover**: the scheduler's dispatch target flips at a batch
   boundary (``MicroBatchScheduler.set_dispatch``: the batcher reads it
   once per formed batch), so every micro-batch runs wholly on one version;
   batches already queued on the old pool drain there in the background,
   and its params are released (and the allocator's cache emptied) only
   after the drain.
6. **rollback**: a failure in stages 3-5, or the post-cutover
   :class:`~.resilience.SwapWatchdog` window tripping, reverts dispatch to
   the still-resident old version and raises a typed
   :class:`~.resilience.SwapFailedError` naming the stage.

``watch_dir()`` runs the same pipeline continuously: it polls the export
directory's manifest ``model_version`` and swaps whenever a new one is
published, remembering a failed version so a bad artifact logs once.

Telemetry: ``serving_model_version{version}`` and
``serving_swaps_total{outcome=ok|gate_failed|refused_memory|canary_failed|
rolled_back}``, the JAX package's names and outcomes.
"""

import threading
import time

import numpy as np

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce
from paddle_tpu_torch.monitor import memory as _memory
from paddle_tpu_torch.monitor.registry import counter, gauge
from paddle_tpu_torch.serving.resilience import (
    SwapFailedError, SwapWatchdog, _log,
)
from paddle_tpu_torch.serving.scheduler import pick_bucket

__all__ = ["SwapController", "publish_model_version",
           "clear_model_version", "default_canary_feeds"]

_m_version = gauge(
    "serving_model_version",
    "1 for the model version this process is currently serving "
    "(label: version = the AOT manifest's model_version, or "
    "'unversioned'); superseded series are removed at cutover so "
    "cardinality stays one per process",
    labels=("version",))
_m_swaps = counter(
    "serving_swaps_total",
    "Hot model swaps by outcome: ok (cutover committed and the "
    "watchdog window passed), gate_failed (integrity/compatibility "
    "refusal before any resource was committed — includes a "
    "concurrent-swap refusal), canary_failed (golden requests "
    "through the standby replica failed shape/finiteness/parity), "
    "rolled_back (standby warm-boot failed or wedged, cutover "
    "reverted, or the post-cutover watchdog tripped — the old "
    "version is serving again), refused_memory (memory-aware "
    "admission projected the standby could not co-reside with the "
    "live pool under the HBM limit — refused BEFORE booting it)",
    labels=("outcome",))

_version_lock = threading.Lock()
_current_version_label = None


def publish_model_version(version):
    """Point the ``serving_model_version`` gauge at ``version``
    (None -> 'unversioned'), removing the superseded series so the
    export never shows two live versions. Process-global, like every
    serving gauge: one server per process when the series must be
    attributable."""
    global _current_version_label
    label = version or "unversioned"
    with _version_lock:
        prev = _current_version_label
        _m_version.set(1, version=label)
        if prev is not None and prev != label:
            _m_version.remove(version=prev)
        _current_version_label = label


def clear_model_version(version):
    """Server close: drop the version series — a closed server serves
    nothing, and a lingering ``serving_model_version 1`` would read as
    a live deployment."""
    global _current_version_label
    label = version or "unversioned"
    with _version_lock:
        _m_version.remove(version=label)
        if _current_version_label == label:
            _current_version_label = None


def default_canary_feeds(bundle, ladder):
    """The default golden set when the caller supplies none: one
    all-zeros request at 1 row and one at the top bucket — enough to
    exercise the smallest and largest bucket and catch a
    non-finite-on-neutral-input model. Callers with real invariants
    should pass representative ``canary_feeds`` (and parity bounds)
    instead; zeros are a smoke signal, not a quality bar."""
    out = []
    for rows in (1, ladder[-1]):
        out.append({
            n: np.zeros((rows,) + tuple(shape), dtype)
            for n, (shape, dtype) in bundle.sample_specs.items()})
    return out


class SwapController:
    """One server's hot-swap state machine. Owned lazily by
    :class:`~.server.InferenceServer` (``server.swap()`` /
    ``server.watch_dir()`` delegate here); at most one swap runs at a
    time — a concurrent ``swap()`` is refused at the gate rather than
    queued, because the second deploy's author must decide against the
    FIRST deploy's outcome, not race it."""

    def __init__(self, server):
        self._server = server
        self._swap_lock = threading.Lock()
        #: serializes the cutover flips against shutdown's _closed
        #: write: a swap that outlives a timed-out close() must abort
        #: BEFORE promoting a pool nothing would ever close
        self._state_lock = threading.Lock()
        self._closed = False
        self._watch_thread = None
        self._watch_stop = threading.Event()
        self._watch_failed_version = None
        self._drain_threads = []
        #: abandoned standby BUILD threads (timed-out warm boots):
        #: shutdown joins these too — a late-built pool must not boot
        #: replica threads after close() reported "fully stopped"
        self._standby_threads = []
        self._drain_lock = threading.Lock()

    # -- the staged pipeline ----------------------------------------------
    def swap(self, model_dir, canary_feeds=None, canary_check=None,
             parity_rtol=None, parity_atol=0.0,
             standby_timeout_ms=120_000.0, watchdog_ms=500.0,
             watchdog_max_errors=3, watchdog_latency_x=None):
        """Execute one staged swap to ``model_dir``; returns the
        report dict ``{"outcome": "ok", "model_version",
        "previous_version", "stage_ms": {...}}`` or raises
        :class:`SwapFailedError` (stage named, old version serving).

        - ``canary_feeds``: list of golden ``{feed: array}`` request
          dicts (leading batch dim); default
          :func:`default_canary_feeds`.
        - ``canary_check``: optional ``fn(feeds, outs) -> bool|None``
          run per canary request on the NEW version's sliced outputs;
          False or an exception fails the canary.
        - ``parity_rtol``/``parity_atol``: when ``parity_rtol`` is not
          None, the same canary batches also run through the LIVE
          version and every fetch must ``allclose`` within the bounds
          — for weight-identical refactor swaps, not retrained models.
        - ``standby_timeout_ms``: warm-boot budget before the swap is
          quarantined (stage ``standby``).
        - ``watchdog_ms`` / ``watchdog_max_errors`` /
          ``watchdog_latency_x``: the post-cutover
          :class:`~.resilience.SwapWatchdog` window; ``swap()`` blocks
          through it so the caller gets the typed verdict.
          ``watchdog_ms=0`` skips the window (cutover commits
          immediately)."""
        if not self._swap_lock.acquire(False):
            _m_swaps.inc(outcome="gate_failed")
            raise SwapFailedError(
                f"a swap is already in progress on this server; "
                f"refusing {model_dir!r} at the gate — decide against "
                f"the running deploy's outcome, don't race it",
                stage="gate", retryable=True)
        try:
            return self._swap_locked(
                model_dir, canary_feeds, canary_check, parity_rtol,
                parity_atol, standby_timeout_ms, watchdog_ms,
                watchdog_max_errors, watchdog_latency_x)
        finally:
            self._swap_lock.release()

    def _swap_locked(self, model_dir, canary_feeds, canary_check,
                     parity_rtol, parity_atol, standby_timeout_ms,
                     watchdog_ms, watchdog_max_errors,
                     watchdog_latency_x):
        stage_ms = {}
        t0 = time.perf_counter()
        if self._closed:
            _m_swaps.inc(outcome="gate_failed")
            raise SwapFailedError(
                "server is closing; swap refused at the gate",
                stage="gate", retryable=True)
        # cheap ARGUMENT validation before any stage spends work: a
        # caller error is an EnforceNotMet, never a swap outcome (it
        # judges the call, not the artifact — no outcome counted)
        enforce(canary_feeds is None or len(canary_feeds) >= 1,
                "canary_feeds must hold at least one golden request "
                "(pass None for the default zeros canary)")
        bundle = self._gate(model_dir)
        stage_ms["gate"] = round((time.perf_counter() - t0) * 1e3, 2)
        old_version = self._server.model_version
        _log(f"swap gate passed for "
             f"{bundle.version or 'unversioned'} (live: "
             f"{old_version or 'unversioned'}); warm-booting standby")

        ta = time.perf_counter()
        self._admit(bundle)
        stage_ms["admit"] = round((time.perf_counter() - ta) * 1e3, 2)

        t1 = time.perf_counter()
        standby = self._standby(bundle, standby_timeout_ms)
        stage_ms["standby"] = round((time.perf_counter() - t1) * 1e3, 2)

        t2 = time.perf_counter()
        try:
            self._canary(standby, bundle, canary_feeds, canary_check,
                         parity_rtol, parity_atol)
        except SwapFailedError:
            _m_swaps.inc(outcome="canary_failed")
            self._drain_background(standby)
            raise
        except EnforceNotMet:
            # argument validation inside the canary (e.g. a golden
            # request bigger than the ladder's top bucket): a CALLER
            # error, not a verdict against the artifact — propagate
            # raw (no outcome counted) so watch_dir can tell a broken
            # config from a broken publish; the standby still drains
            self._drain_background(standby)
            raise
        except Exception as e:
            _m_swaps.inc(outcome="canary_failed")
            self._drain_background(standby)
            raise SwapFailedError(
                f"canary execution failed on the standby version "
                f"({type(e).__name__}: {e}); the live version was "
                f"never touched", stage="canary") from e
        stage_ms["canary"] = round((time.perf_counter() - t2) * 1e3, 2)

        t3 = time.perf_counter()
        try:
            old_pool, old_bundle = self._cutover(standby, bundle)
        except SwapFailedError:
            # the closed-server abort inside _cutover: typed already
            _m_swaps.inc(outcome="rolled_back")
            self._drain_background(standby)
            raise
        except Exception as e:
            _m_swaps.inc(outcome="rolled_back")
            self._drain_background(standby)
            raise SwapFailedError(
                f"cutover failed ({type(e).__name__}: {e}); dispatch "
                f"was not committed to the new version",
                stage="cutover") from e
        stage_ms["cutover"] = round((time.perf_counter() - t3) * 1e3, 2)

        t4 = time.perf_counter()
        reason = self._watch_window(watchdog_ms, watchdog_max_errors,
                                    watchdog_latency_x, standby)
        stage_ms["watchdog"] = round((time.perf_counter() - t4) * 1e3,
                                     2)
        if reason is not None:
            self._rollback(old_pool, old_bundle, standby)
            _m_swaps.inc(outcome="rolled_back")
            _log(f"SWAP ROLLED BACK: {reason}; reverted to model "
                 f"version {old_bundle.version or 'unversioned'} "
                 f"(still resident — no reboot, no recompile)")
            raise SwapFailedError(
                f"post-cutover watchdog tripped: {reason}; traffic "
                f"was reverted to the previous version "
                f"{old_bundle.version or 'unversioned'} at a batch "
                f"boundary", stage="watchdog")

        # committed: the old pool drains its already-dispatched
        # batches in the background and releases its params — the end
        # of the ~2x-param-memory window
        self._drain_background(old_pool)
        with self._state_lock:
            # rotate the old series out, then honor a close() that
            # already gave up waiting on this swap: a closing server
            # serves nothing, whatever this swap just committed
            publish_model_version(bundle.version)
            if self._closed:
                clear_model_version(bundle.version)
        _m_swaps.inc(outcome="ok")
        _log(f"serving model version "
             f"{bundle.version or 'unversioned'} from "
             f"{bundle.model_dir} (cutover from "
             f"{old_version or 'unversioned'}, "
             f"{(time.perf_counter() - t0) * 1e3:.0f}ms total)")
        return {"outcome": "ok",
                "model_version": bundle.version,
                "previous_version": old_version,
                "model_dir": model_dir,
                # "int8"/"bf16" when the new version is a quantized
                # export (fp->quant and quant->fp swaps are ordinary
                # swaps; the gate/canary already ran the quantized
                # graph) — an operator reading the report can tell a
                # PTQ deploy from a retrain
                "quantized": bundle.quantized,
                "stage_ms": stage_ms}

    # -- stage 1: gate -----------------------------------------------------
    def _gate(self, model_dir):
        """Integrity + compatibility, committing nothing: re-runs the
        full ``verify_aot_dir`` CRC pass (the boot-time gate does not
        cover an artifact rewritten AFTER boot), loads the new
        program/params on the host, and refuses loudly on any drift
        from the live serving contract."""
        from paddle_tpu_torch.serving.server import (
            _check_fetch_contract, _load_bundle,
        )
        server = self._server
        try:
            bundle = _load_bundle(model_dir, server.config.feed_specs,
                                  verify=True)
        except Exception as e:
            _m_swaps.inc(outcome="gate_failed")
            raise SwapFailedError(
                f"swap gate refused {model_dir!r}: "
                f"{type(e).__name__}: {e} — nothing was committed and "
                f"the live version keeps serving", stage="gate") from e
        live = server._bundle
        for what, new, cur in (
                ("feed names", bundle.feed_names, live.feed_names),
                ("fetch names", bundle.fetch_names, live.fetch_names),
                ("feed sample specs", bundle.sample_specs,
                 live.sample_specs)):
            if new != cur:
                _m_swaps.inc(outcome="gate_failed")
                raise SwapFailedError(
                    f"swap gate refused {model_dir!r}: {what} "
                    f"incompatible with the live config ({new!r} != "
                    f"{cur!r}) — in-flight and queued requests were "
                    f"validated against the live contract and must "
                    f"stay servable on either version through the "
                    f"cutover; deploy contract changes with a new "
                    f"server", stage="gate")
        try:
            _check_fetch_contract(bundle, server.pool.ladder)
        except Exception as e:
            _m_swaps.inc(outcome="gate_failed")
            raise SwapFailedError(
                f"swap gate refused {model_dir!r}: {e}",
                stage="gate") from e
        return bundle

    # -- stage 1.5: memory-aware admission --------------------------------
    def _admit(self, bundle):
        """Project whether the standby can CO-RESIDE with the live
        pool under the per-device memory limit, and refuse with the
        projected numbers BEFORE the warm boot, instead of discovering a
        mid-cutover OOM. Projection (per device): the live pool's
        ``projected_bytes`` (its params plus its largest measured bucket
        peak) + one copy of the standby's param bytes (its buckets have not
        run yet: params dominate, and the refusal errs permissive). Limit:
        ``ServingConfig.hbm_limit_bytes``, else the serving card's total
        memory / PADDLE_TPU_HBM_LIMIT_BYTES; no known limit means admission
        is advisory and always passes."""
        limit = self._server.config.hbm_limit_bytes
        if limit is None:
            limit = _memory.hbm_limit_bytes()
            replicas = self._server.pool.replicas
            if replicas:
                limit = _memory.hbm_limit_bytes(replicas[0].device) or limit
        if not limit:
            return
        live = int(self._server.pool.projected_bytes())
        standby_params = int(sum(p.numel() * p.element_size()
                                 for p in bundle.params))
        projected = live + standby_params
        if projected <= int(limit):
            return
        _m_swaps.inc(outcome="refused_memory")
        msg = (f"standby {bundle.version or 'unversioned'} projects "
               f"{projected} bytes per device (live pool {live} + "
               f"standby params {standby_params}) over the HBM limit "
               f"{int(limit)} — the two versions cannot co-reside "
               f"for the cutover window")
        _log(f"SWAP REFUSED at memory admission: {msg}")
        raise SwapFailedError(
            f"swap refused at memory admission: {msg}",
            stage="admission")

    # -- stage 2: standby warm boot ---------------------------------------
    def _build_standby_pool(self, bundle):
        """The expensive build (params onto the card, every bucket run
        once): a method of its own, the seam a test wedges."""
        from paddle_tpu_torch.serving.server import _boot_pool
        return _boot_pool(bundle, self._server.config, role="standby")

    def _standby(self, bundle, timeout_ms):
        """Warm-boot the new version on a bounded worker thread. A
        build that wedges past ``timeout_ms`` or raises quarantines
        the SWAP (typed, stage ``standby``) while live traffic never
        notices — the abandoned thread's eventual pool, if any, is
        closed and released, never promoted."""
        state = {"pool": None, "err": None, "abandoned": False}
        lk = threading.Lock()

        def build():
            try:
                try:
                    pool = self._build_standby_pool(bundle)
                except BaseException as e:
                    with lk:
                        state["err"] = e
                    return
                with lk:
                    if not state["abandoned"]:
                        state["pool"] = pool
                        return
                # quarantined before we finished: dispose through the
                # TRACKED drain path — shutdown() joins it (close must
                # not report "fully stopped" over this pool's live
                # replica threads) and a drain that fails logs the
                # resident-params leak loudly, never `pass` silence
                self._drain_background(pool)
            finally:
                with self._drain_lock:
                    if t in self._standby_threads:
                        self._standby_threads.remove(t)

        t = threading.Thread(target=build, daemon=True,
                             name="serving-swap-standby")
        t.start()
        t.join(float(timeout_ms) / 1e3)
        with lk:
            pool, err = state["pool"], state["err"]
            if pool is None and err is None:
                state["abandoned"] = True
                # track the still-running build so shutdown can join
                # it: until it finishes (and its pool is disposed via
                # the drain path) the server is not "fully stopped"
                with self._drain_lock:
                    self._standby_threads.append(t)
        if pool is not None:
            return pool
        _m_swaps.inc(outcome="rolled_back")
        if err is not None:
            raise SwapFailedError(
                f"standby warm boot for "
                f"{bundle.version or 'unversioned'} failed "
                f"({type(err).__name__}: {err}); the swap was "
                f"quarantined and the live version keeps serving",
                stage="standby") from err
        raise SwapFailedError(
            f"standby warm boot wedged past {timeout_ms:g}ms; the "
            f"swap was quarantined (build thread abandoned — a pool "
            f"it eventually produces will be discarded) and the live "
            f"version keeps serving", stage="standby")

    # -- stage 3: canary ---------------------------------------------------
    def _canary(self, standby, bundle, canary_feeds, canary_check,
                parity_rtol, parity_atol):
        # the replicas run under inference mode in their own threads; the
        # canary runs on the caller's, so it enters it here
        with torch.inference_mode():
            self._canary_batches(standby, bundle, canary_feeds,
                                 canary_check, parity_rtol, parity_atol)

    def _canary_batches(self, standby, bundle, canary_feeds, canary_check,
                        parity_rtol, parity_atol):
        ladder = standby.ladder
        feeds_list = (canary_feeds if canary_feeds is not None
                      else default_canary_feeds(bundle, ladder))
        enforce(len(feeds_list) >= 1,
                "canary_feeds must hold at least one golden request")
        for ci, feeds in enumerate(feeds_list):
            # feed-presence/shape/rows problems judge the CALLER's
            # canary_feeds, not the artifact — the gate already
            # guaranteed the new version's specs equal the live ones,
            # so these would fail identically for EVERY publish.
            # Argument errors (EnforceNotMet), never a canary verdict:
            # watch_dir stops loudly on them instead of blacklisting
            # good deploys one by one.
            missing = [n for n in bundle.feed_names if n not in feeds]
            enforce(not missing,
                    f"canary request {ci} missing feeds {missing} — "
                    f"canary_feeds must carry every served feed")
            rows = None
            padded = {}
            for n in bundle.feed_names:
                shape, dtype = bundle.sample_specs[n]
                a = np.asarray(feeds[n], dtype=dtype)
                enforce(a.ndim >= 1
                        and tuple(a.shape[1:]) == tuple(shape),
                        f"canary request {ci} feed {n!r} sample "
                        f"shape {tuple(a.shape[1:]) if a.ndim else ()}"
                        f" != served {tuple(shape)}")
                rows = int(a.shape[0]) if rows is None else rows
                enforce(int(a.shape[0]) == rows,
                        f"canary request {ci} feed {n!r} rows "
                        f"{a.shape[0]} != {rows} (all feeds of one "
                        f"canary request share the batch dim)")
                buf = np.zeros((pick_bucket(rows, ladder),)
                               + tuple(shape), dtype)
                buf[:rows] = a
                padded[n] = buf
            bucket = pick_bucket(rows, ladder)
            outs = standby.replicas[0].run_batch(bucket, padded)
            sliced = [np.asarray(o)[:rows] for o in outs]
            for name, o in zip(bundle.fetch_names, sliced):
                if np.issubdtype(o.dtype, np.floating) and \
                        not np.all(np.isfinite(o)):
                    bad = int(np.size(o) - np.count_nonzero(
                        np.isfinite(o)))
                    raise SwapFailedError(
                        f"canary request {ci}: fetch {name!r} from "
                        f"the standby version has {bad} non-finite "
                        f"value(s) — the new version is broken on a "
                        f"golden input; live version untouched",
                        stage="canary")
            if parity_rtol is not None:
                live_outs = self._server.pool.replicas[0].run_batch(
                    bucket, padded)
                for name, a, b in zip(bundle.fetch_names, sliced,
                                      [np.asarray(o)[:rows]
                                       for o in live_outs]):
                    if not np.allclose(a, b, rtol=float(parity_rtol),
                                       atol=float(parity_atol)):
                        diff = float(np.max(np.abs(
                            a.astype(np.float64)
                            - b.astype(np.float64))))
                        raise SwapFailedError(
                            f"canary request {ci}: fetch {name!r} "
                            f"diverges from the live version beyond "
                            f"the parity bounds (max abs diff "
                            f"{diff:.3g}, rtol={parity_rtol}, "
                            f"atol={parity_atol})", stage="canary")
            if canary_check is not None:
                try:
                    ok = canary_check(feeds, sliced)
                except Exception as e:
                    raise SwapFailedError(
                        f"canary request {ci}: canary_check raised "
                        f"{type(e).__name__}: {e}",
                        stage="canary") from e
                if ok is False:
                    raise SwapFailedError(
                        f"canary request {ci}: canary_check returned "
                        f"False", stage="canary")

    # -- stage 4: cutover + rollback --------------------------------------
    def _cutover(self, standby, bundle):
        """Flip dispatch to the standby pool at a batch boundary.
        Batches already queued on the old pool drain THERE (every
        micro-batch executes wholly on one version); the old pool
        stays warm-resident until the watchdog window passes, so a
        rollback is two attribute flips, not a reboot. A method of its
        own: the seam a test patches to poison the new pool right after
        the flip."""
        server = self._server
        with self._state_lock:
            # atomic with shutdown()'s _closed write: a close() whose
            # bounded wait on this swap expired must not be outrun by
            # a later cutover that promotes a pool nothing will ever
            # close and republishes a series nothing will ever clear
            if self._closed:
                raise SwapFailedError(
                    "server closed while the swap was in flight; "
                    "aborted before cutover — nothing was committed "
                    "and the standby is being discarded",
                    stage="cutover", retryable=True)
            old_pool, old_bundle = server.pool, server._bundle
            try:
                server.pool = standby
                server._apply_bundle(bundle)
                server.scheduler.set_dispatch(standby.dispatch)
                old_pool.demote()
                standby.promote()
            except BaseException:
                # a flip raised partway (only reachable through
                # instrumented/chaos-wrapped methods — the flips are
                # plain attribute stores — but the generic handler
                # above us says "dispatch was not committed" and must
                # be telling the truth): put every already-applied
                # flip back before the standby is drained out
                server.scheduler.set_dispatch(old_pool.dispatch)
                server.pool = old_pool
                server._apply_bundle(old_bundle)
                standby.demote()
                old_pool.promote()
                raise
        return old_pool, old_bundle

    def _rollback(self, old_pool, old_bundle, standby):
        """Revert traffic to the still-resident old version — the
        mirror of ``_cutover``, plus background disposal of the failed
        new pool (its queued batches drain/fail typed there). Like
        ``_cutover``, the flips are atomic with shutdown's ``_closed``
        write: a rollback racing server.close() must NOT promote the
        old pool (republishing gauges close just zeroed) or leave its
        replica threads running past a True close — on a closing
        server the reverted-to pool drains out too, and close()'s
        swap-lock wait joins that drain before reporting stopped."""
        server = self._server
        with self._state_lock:
            closed = self._closed
            server.scheduler.set_dispatch(old_pool.dispatch)
            server.pool = old_pool
            server._apply_bundle(old_bundle)
            standby.demote()
            if not closed:
                old_pool.promote()
        self._drain_background(standby)
        if closed:
            self._drain_background(old_pool)

    def _watch_window(self, watchdog_ms, max_errors, latency_x,
                      new_pool):
        """Run the post-cutover watchdog window; returns a rollback
        reason or None. The error verdict counts the NEW pool's own
        ``batch_failures`` — the old pool's still-draining batches can
        fail (a wedged straggler) without tripping a rollback of a
        healthy new version. The baseline for the (opt-in) latency
        verdict is the process-lifetime mean request latency captured
        at the flip — crude but monotone-safe; error-storm detection
        is the primary signal."""
        if not watchdog_ms or watchdog_ms <= 0:
            return None
        baseline = None
        if latency_x is not None:
            s, c = SwapWatchdog._latency()
            baseline = (s / c) if c else None
            if baseline is None:
                # the caller opted into a latency verdict it cannot
                # get — degraded coverage must be visible, not silent
                _log("swap watchdog: watchdog_latency_x requested but "
                     "no request has completed before this swap, so "
                     "there is no latency baseline — the latency "
                     "verdict is DISABLED for this swap (the "
                     "error-storm verdict still runs)")
        wd = SwapWatchdog(window_ms=watchdog_ms,
                          max_errors=max_errors, latency_x=latency_x,
                          baseline_ms=baseline,
                          errors_fn=lambda: new_pool.batch_failures
                          ).start()
        while True:
            reason = wd.verdict()
            if reason is not None:
                return reason
            if wd.expired():
                # one terminal verdict above covers counts that landed
                # in the final poll gap
                return None
            time.sleep(min(0.02, wd.window_s / 4 or 0.001))

    # -- background drain of a retired pool -------------------------------
    def _drain_background(self, pool):
        """Close + release a demoted/rejected pool without blocking
        traffic: its replicas finish the batches already queued to it
        (completing or failing them typed), then its device params
        drop — ending the 2x-memory window. A pool
        that will not drain (a replica wedged longer than close's own
        loss-judging can absorb) leaves its params RESIDENT — that is
        a real leak and it is logged loudly, never swallowed."""

        def drain():
            try:
                # one bounded retry: close() keeps judging wedged
                # replicas itself, so a second pass is usually enough
                # for a straggler that outlived the first window
                ok = pool.close(timeout=120) or pool.close(timeout=120)
                if ok:
                    pool.release()
                else:
                    _log("retired pool failed to drain within 240s; "
                         "its params remain RESIDENT "
                         "(the hot-swap 2x-param-memory window did "
                         "not end) — a replica is wedged past every "
                         "loss-judging window; restart the server to "
                         "reclaim the memory")
            except Exception as e:
                _log(f"retired pool drain failed "
                     f"({type(e).__name__}: {e}); its params remain "
                     f"RESIDENT — restart the server to reclaim the "
                     f"memory")
            with self._drain_lock:
                if t in self._drain_threads:
                    self._drain_threads.remove(t)

        t = threading.Thread(target=drain, daemon=True,
                             name="serving-swap-drain")
        with self._drain_lock:
            self._drain_threads.append(t)
        t.start()

    # -- watch-dir mode ----------------------------------------------------
    def watch_dir(self, model_dir=None, poll_ms=1000.0,
                  **swap_kwargs):
        """Continuous deploy: poll ``model_dir`` (default: the dir the
        server is currently serving from) for a NEW manifest
        ``model_version`` via the cheap index-only
        ``read_aot_version`` probe, and ``swap()`` to it when it
        changes. A version whose swap failed is remembered and skipped
        until the publisher writes a DIFFERENT version — one loud log
        line per bad artifact, no gate crash-loop, live version
        serving throughout. Unversioned dirs (no ``export_aot``
        manifest) are never auto-swapped: versioning is the publish
        signal."""
        enforce(self._watch_thread is None
                or not self._watch_thread.is_alive(),
                "watch_dir is already running on this server; "
                "stop_watch() first")
        enforce(not self._closed,
                "watch_dir refused: the server is closed")
        enforce(float(poll_ms) > 0,
                f"poll_ms must be positive, got {poll_ms!r}")
        target = model_dir or self._server.model_dir
        self._watch_stop.clear()

        def loop():
            from paddle_tpu_torch.inference import read_aot_version
            while not self._watch_stop.wait(float(poll_ms) / 1e3):
                if self._closed:
                    return
                v = read_aot_version(target)
                if (v is None or v == self._server.model_version
                        or v == self._watch_failed_version):
                    continue
                _log(f"watch_dir: new model version {v} published in "
                     f"{target}; swapping")
                try:
                    self.swap(target, **swap_kwargs)
                    self._watch_failed_version = None
                except SwapFailedError as e:
                    if e.retryable:
                        # the TARGET was never judged (another swap
                        # held the lock / server closing): retry next
                        # poll — memoizing here would silently strand
                        # a good publish forever
                        _log(f"watch_dir: swap to {v} deferred "
                             f"({e}); will retry next poll")
                        continue
                    self._watch_failed_version = v
                    _log(f"watch_dir: swap to {v} failed at stage "
                         f"{e.stage!r} ({e}); live version keeps "
                         f"serving — will not retry until a new "
                         f"version is published")
                except EnforceNotMet as e:
                    # argument validation: the WATCHER's swap_kwargs
                    # are wrong, which says nothing about this (or
                    # any) artifact — every future attempt would fail
                    # identically, so stop loudly instead of either
                    # blacklisting a never-judged publish or retrying
                    # a config error forever
                    _log(f"watch_dir: swap arguments invalid ({e}); "
                         f"STOPPING the watcher — fix the watch_dir "
                         f"kwargs and re-arm (live version keeps "
                         f"serving, version {v} was NOT judged)")
                    return
                except Exception as e:  # never kill the watcher
                    self._watch_failed_version = v
                    _log(f"watch_dir: swap to {v} failed "
                         f"unexpectedly ({type(e).__name__}: {e}); "
                         f"live version keeps serving")

        self._watch_thread = threading.Thread(
            target=loop, daemon=True, name="serving-swap-watch")
        self._watch_thread.start()
        return self

    def stop_watch(self, timeout=5.0):
        """Stop the watch-dir poller (idempotent). Returns True when
        the thread exited within ``timeout``."""
        self._watch_stop.set()
        t = self._watch_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    # -- lifecycle ---------------------------------------------------------
    def begin_shutdown(self):
        """The FAST half of a server close, run BEFORE the scheduler
        stops admission: refuse new swaps (atomic with ``_cutover`` —
        an in-flight swap that has not yet flipped dispatch will abort
        instead of promoting a pool on a closing server) and stop the
        watch-dir poller so no swap can start mid-close."""
        with self._state_lock:
            self._closed = True
        self.stop_watch(timeout=5.0)

    def finish_shutdown(self, timeout=None):
        """The SLOW half, run after the scheduler and live pool have
        closed: wait for an in-flight swap to finish aborting/rolling
        back, join background pool drains and any abandoned standby
        build, so close() never reports "fully stopped" over live swap
        machinery. ``timeout=None`` blocks to completion (the close()
        contract) — except for a standby BUILD thread wedged inside a
        native call, which cannot be interrupted: it is joined for
        a bounded grace, the leak is logged LOUDLY, and False is
        returned. One deadline is shared by every phase — a caller's
        close(T) bounds the whole wait near T, not T-per-phase."""
        deadline = None if timeout is None \
            else time.monotonic() + timeout

        def left(default):
            if deadline is None:
                return default
            return max(deadline - time.monotonic(), 0.0)

        done = True
        # every swap stage is individually bounded (standby_timeout_ms,
        # the canary's finite batch set, watchdog_ms), so a blocking
        # acquire terminates; with a timeout, a miss means the swap is
        # still unwinding — not "fully stopped", so False propagates
        if deadline is None:
            self._swap_lock.acquire()
            self._swap_lock.release()
        elif self._swap_lock.acquire(timeout=left(0.0)):
            self._swap_lock.release()
        else:
            done = False
        with self._drain_lock:
            drains = list(self._drain_threads)
            builds = list(self._standby_threads)
        for t in drains:
            # drain threads are bounded by construction (two 120s
            # close windows + release), so a None timeout can safely
            # block on them
            t.join(left(None) if deadline is None else left(0.0))
            done = done and not t.is_alive()
        for t in builds:
            t.join(left(300.0))
            if t.is_alive():
                done = False
                _log("close: an abandoned standby build is still "
                     "wedged inside its warm boot; the pool it may "
                     "eventually produce will be discarded, but its "
                     "thread (and any params it allocates) cannot be "
                     "reclaimed — restart the process to be rid of it")
        return done

    def shutdown(self, timeout=None):
        """Both halves back to back — for callers outside the
        server's own close() sequencing."""
        self.begin_shutdown()
        return self.finish_shutdown(timeout)
