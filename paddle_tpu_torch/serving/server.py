"""InferenceServer: the serving front-end, the port of
``paddle_tpu/serving/server.py``.

``InferenceServer(model_dir, ServingConfig(...))`` loads a
``save_inference_model`` directory, verifies its AOT integrity manifest (a
torn export fails at boot, naming the first bad file), runs the pass
pipeline, applies the weight-only quant sidecar when the directory carries
one (the dequant folded into each served matmul, which then launches the
``fused_matmul_int8`` kernel on the card), warm-boots every (replica device,
bucket), and only then accepts requests:

    server = InferenceServer(model_dir, ServingConfig(replicas=1))
    outs = server.infer({"x": batch})          # blocking convenience
    pending = server.submit({"x": batch})      # pipelined
    outs = pending.result(timeout=5)
    server.swap(new_model_dir)                 # zero-downtime deploy
    server.close()                             # drains, then stops

Request contract: every feed carries a leading batch dim (1..max_batch
rows); outputs come back in fetch order, sliced to the request's rows, as
numpy arrays. Devices: ``ServingConfig.devices`` (default: the card).

Deploying a new model version is a supervised operation: ``swap(model_dir)``
runs the staged gate -> memory admission -> standby warm boot -> canary ->
atomic cutover -> watchdog pipeline (``swap.py``), and ``watch_dir()`` keeps
doing it as training publishes new ``export_aot`` outputs. Loading is split
from the warm boot (``_load_bundle`` / ``_boot_pool``) so the swap can build
a SECOND pool beside the live one. ``frontdoor.HttpFrontDoor`` puts HTTP in
front of ``submit``.
"""

import numpy as np

from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.serving import swap as _swap
from paddle_tpu_torch.serving.replica import ReplicaPool, zero_pool_gauges
from paddle_tpu_torch.serving.resilience import ShedController, _log
from paddle_tpu_torch.serving.scheduler import (
    MicroBatchScheduler, bucket_ladder,
)

__all__ = ["ServingConfig", "InferenceServer"]


class ServingConfig:
    """Knobs for one server.

    - ``max_batch``: top of the power-of-two bucket ladder (every rung is
      warmed on every replica device at boot).
    - ``max_wait_ms``: batching deadline, the most latency a lone request
      trades for fill.
    - ``max_queue``: admission bound; beyond it ``submit`` raises
      ``QueueFullError``.
    - ``replicas``: worker count, assigned round-robin over ``devices``
      (default: ``[default_device()]``, the card; pass
      ``[torch.device("cpu")]`` to serve on the CPU).
    - ``feed_specs``: optional {feed name: (sample_shape, dtype)} override
      when the program declares dynamic non-batch dims.
    - ``verify_aot``: verify the AOT integrity manifest at boot.
    - ``default_deadline_ms``: the deadline of every request that passes
      none; None = no deadline.
    - ``replica_stall_ms`` / ``max_consecutive_stalls`` /
      ``respawn_backoff_ms`` / ``supervise``: the replica supervisor (see
      ``ReplicaPool``).
    - ``shed_mode``: ``"off"`` (default) or ``"adaptive"`` (brownout
      shedding with ``OverloadedError``; requires ``default_deadline_ms``),
      with ``shed_enter_frac`` / ``shed_exit_frac`` as its hysteresis.
    - ``hbm_limit_bytes``: per-device memory capacity the hot swap's
      memory-aware admission projects against (a standby that cannot
      co-reside with the live pool under it is refused before it boots).
      None falls back to the card's total memory /
      ``PADDLE_TPU_HBM_LIMIT_BYTES``; with neither (the CPU), admission is
      advisory.
    - ``shed_hbm_frac``: optional HBM-pressure shed input: the worst card's
      utilization at or above this fraction sheds new admissions
      (``reason="hbm_pressure"``); it reads the memory poller
      (``monitor.memory.enable()``). None disables.
    """

    def __init__(self, max_batch=8, max_wait_ms=5.0, max_queue=256,
                 replicas=1, devices=None, feed_specs=None,
                 verify_aot=True, default_deadline_ms=None,
                 replica_stall_ms=30_000.0, max_consecutive_stalls=3,
                 respawn_backoff_ms=100.0, supervise=True,
                 shed_mode="off", shed_enter_frac=0.5,
                 shed_exit_frac=0.25, hbm_limit_bytes=None,
                 shed_hbm_frac=None):
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.max_queue = max_queue
        self.replicas = replicas
        self.devices = devices
        self.feed_specs = feed_specs
        self.verify_aot = verify_aot
        self.default_deadline_ms = default_deadline_ms
        self.replica_stall_ms = replica_stall_ms
        self.max_consecutive_stalls = max_consecutive_stalls
        self.respawn_backoff_ms = respawn_backoff_ms
        self.supervise = supervise
        self.shed_mode = shed_mode
        self.shed_enter_frac = shed_enter_frac
        self.shed_exit_frac = shed_exit_frac
        self.hbm_limit_bytes = hbm_limit_bytes
        self.shed_hbm_frac = shed_hbm_frac


def _infer_sample_specs(program, feed_names, overrides):
    """{feed name: (sample shape, numpy dtype)} from the program's feed var
    declarations: dim 0 is the batch dim the scheduler owns; every other dim
    must be static (or overridden), since each bucket is one fixed shape."""
    from paddle_tpu_torch.core.dtypes import dtype_name

    blk = program.global_block()
    out = {}
    for n in feed_names:
        if overrides and n in overrides:
            shape, dtype = overrides[n]
            out[n] = (tuple(int(d) for d in shape), np.dtype(dtype))
            continue
        v = blk.vars.get(n)
        enforce(v is not None, f"feed {n!r} not declared in program")
        sample = list(v.shape)[1:]
        enforce(all(d >= 0 for d in sample),
                f"feed {n!r} has dynamic non-batch dims {list(v.shape)}; "
                f"serving warms fixed-shape buckets: pass "
                f"ServingConfig(feed_specs={{{n!r}: (shape, dtype)}})")
        out[n] = (tuple(int(d) for d in sample), np.dtype(dtype_name(v.dtype)))
    return out


class _ModelBundle:
    """Everything one model version needs to serve, loaded but not yet on
    a device: the served program, its feed/fetch contract, the pure fn and
    its params (CPU tensors), and the manifest's ``model_version``. The
    server boots from one; the swap loads a SECOND one for the standby."""

    __slots__ = ("model_dir", "program", "feed_names", "fetch_names",
                 "sample_specs", "pure_fn", "params", "version",
                 "quantized")

    def __init__(self, model_dir, program, feed_names, fetch_names,
                 sample_specs, pure_fn, params, version, quantized=None):
        self.model_dir = model_dir
        self.program = program
        self.feed_names = feed_names
        self.fetch_names = fetch_names
        self.sample_specs = sample_specs
        self.pure_fn = pure_fn
        self.params = params
        self.version = version
        #: "int8"/"bf16" when the directory's quantized export was loaded
        self.quantized = quantized


def _load_bundle(model_dir, feed_specs=None, verify=True):
    """Load, verify (optionally), optimize and quantize one model version
    into a :class:`_ModelBundle`, in the JAX package's order. Commits no
    device memory: the pool's warm boot does that."""
    from paddle_tpu_torch import inference as inf
    from paddle_tpu_torch.core.flags import get_flag
    from paddle_tpu_torch.core.place import CPUPlace
    from paddle_tpu_torch.static import io as static_io
    from paddle_tpu_torch.static import opt_passes as _opt
    from paddle_tpu_torch.static.executor import Executor, Scope

    scope = Scope()
    prog, feed_names, fetch_names = static_io.load_inference_model(
        model_dir, Executor(CPUPlace()), scope=scope)
    version = (inf.verify_aot_dir(model_dir).model_version if verify
               else inf.read_aot_version(model_dir))
    feed_names = list(feed_names)
    fetch_names = list(fetch_names)
    sample_specs = _infer_sample_specs(prog, feed_names, feed_specs)
    if bool(get_flag("apply_ir_passes")):
        prog = _opt.optimize_inference(prog, fetch_names)
    # the quantized arrays become the resident params: int8 weights are
    # ~4x smaller than fp32
    quant = inf.load_quantized_params(model_dir)
    if quant is not None:
        prog = _opt.apply_weight_quant(prog, quant["weights"], quant["mode"])
        for n, v in quant["values"].items():
            scope.set_var(n, v)
        _log(f"loaded {quant['mode']} weight-quantized params for "
             f"{len(quant['weights'])} weight(s) from {model_dir}")
    pure_fn, state_names = inf._build_pure_fn(prog, feed_names, fetch_names)
    params = [scope.find_var(n) for n in state_names]
    missing = [n for n, v in zip(state_names, params) if v is None]
    enforce(not missing,
            f"scope missing persistables for serving: {missing[:5]}")
    return _ModelBundle(model_dir, prog, feed_names, fetch_names,
                        sample_specs, pure_fn, params, version,
                        quantized=quant["mode"] if quant else None)


def _check_fetch_contract(bundle, ladder):
    """Micro-batched serving requires every fetch to be per-row (leading
    dim = batch). The served function runs once at the top bucket on the
    ``meta`` device (shapes only, no data, no device memory: the port's
    ``jax.eval_shape``; the kernels' plain bodies compute the shapes), so a
    batch-reduced fetch fails at load and at the swap gate, before any warm
    boot, naming the fetch."""
    import torch
    from paddle_tpu_torch.core.dtypes import convert_dtype
    from paddle_tpu_torch.ops.kernels.registry import meta_shapes

    top = ladder[-1]
    meta = torch.device("meta")
    with torch.inference_mode(), meta_shapes():
        params = tuple(torch.empty(p.shape, dtype=p.dtype, device=meta)
                       for p in bundle.params)
        feeds = tuple(
            torch.empty((top,) + tuple(shape), dtype=convert_dtype(dt),
                        device=meta)
            for shape, dt in (bundle.sample_specs[n]
                              for n in bundle.feed_names))
        outs = bundle.pure_fn(params, feeds)
    for name, o in zip(bundle.fetch_names, outs):
        shape = tuple(o.shape)
        enforce(len(shape) >= 1 and int(shape[0]) == top,
                f"fetch {name!r} has output shape {shape} for a batch of "
                f"{top}: not per-row, so micro-batched results cannot be "
                f"sliced back to requests: move the reduction out of the "
                f"served graph or use the single-request Predictor")


def _boot_pool(bundle, config, role="live"):
    """Warm-boot a replica pool for one model bundle: params onto each
    device, every bucket run once. A hot-swap standby passes
    ``role="standby"`` so the live pool keeps gauge ownership while both
    are resident. The pool carries the bundle's version, which its
    replicas stamp on every result they compute."""
    pool = ReplicaPool(
        bundle.pure_fn, bundle.params, bundle.feed_names,
        bundle.sample_specs, ladder=bucket_ladder(config.max_batch),
        n_replicas=config.replicas, devices=config.devices,
        replica_stall_ms=config.replica_stall_ms,
        max_consecutive_stalls=config.max_consecutive_stalls,
        respawn_backoff_ms=config.respawn_backoff_ms,
        supervise=config.supervise, role=role)
    pool.model_version = bundle.version
    return pool


class InferenceServer:
    """Continuous micro-batching server over a frozen inference model.

    Construction performs the full warm boot (load, verify, warm every
    bucket on every replica device, start the workers); when ``__init__``
    returns the server is serving. ``swap()`` / ``watch_dir()`` replace the
    served model version with zero downtime."""

    def __init__(self, model_dir, config=None):
        self.config = config = config or ServingConfig()
        enforce(config.shed_mode in ("off", "adaptive"),
                f"shed_mode must be 'off' or 'adaptive', got "
                f"{config.shed_mode!r}")
        shed = None
        if config.shed_mode == "adaptive":
            enforce(config.default_deadline_ms is not None,
                    "shed_mode='adaptive' requires default_deadline_ms: the "
                    "controller sheds against deadline headroom, and "
                    "without a deadline there is none")
            shed = ShedController(
                deadline_ms=config.default_deadline_ms,
                enter_frac=config.shed_enter_frac,
                exit_frac=config.shed_exit_frac,
                hbm_high_frac=config.shed_hbm_frac)
        bundle = _load_bundle(model_dir, config.feed_specs,
                              verify=config.verify_aot)
        self._apply_bundle(bundle)
        # the scheduler validates its knobs before the warm boot, so a bad
        # knob fails in microseconds; dispatch targets the live pool through
        # one attribute read (_dispatch_batch), and the hot-swap cutover
        # rebinds it (scheduler.set_dispatch)
        self.scheduler = MicroBatchScheduler(
            dispatch=self._dispatch_batch,
            feed_names=self._feed_names,
            max_batch=config.max_batch,
            max_wait_ms=config.max_wait_ms,
            max_queue=config.max_queue,
            sample_specs=self._sample_specs,
            default_deadline_ms=config.default_deadline_ms,
            shed=shed)
        _check_fetch_contract(bundle, bucket_ladder(config.max_batch))
        self.pool = _boot_pool(bundle, config, role="live")
        self._swap_controller = None
        self._closing = False
        _swap.publish_model_version(self.model_version)
        _log(f"serving model version "
             f"{self.model_version or 'unversioned'} from {model_dir} "
             f"(boot)")
        self.scheduler.start()

    def _apply_bundle(self, bundle):
        """Point the server's introspection at one model bundle: at boot
        and at every hot-swap cutover and rollback (the gate guarantees the
        feed/fetch/spec contract is unchanged, so requests validated under
        the previous bundle stay valid)."""
        self._bundle = bundle
        self.model_dir = bundle.model_dir
        self._program = bundle.program
        self._feed_names = bundle.feed_names
        self._fetch_names = bundle.fetch_names
        self._sample_specs = bundle.sample_specs

    def _dispatch_batch(self, mb):
        # one read of self.pool per formed batch: the cutover rebinds the
        # scheduler's dispatch directly, so this path carries boot traffic
        self.pool.dispatch(mb)

    # -- introspection -----------------------------------------------------
    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    @property
    def ladder(self):
        return self.pool.ladder

    @property
    def model_version(self):
        """The manifest ``model_version`` this server serves (None for an
        unversioned export)."""
        return self._bundle.version

    # -- serving -----------------------------------------------------------
    def submit(self, feeds, deadline_ms=None, trace_attrs=None):
        """Admit one request; returns a ``PendingResult``. ``deadline_ms``
        bounds it end to end (None = the config's ``default_deadline_ms``);
        ``trace_attrs`` (optional dict) rides its kept trace's root span."""
        return self.scheduler.submit(feeds, deadline_ms=deadline_ms,
                                     trace_attrs=trace_attrs)

    def infer(self, feeds, timeout=None, deadline_ms=None):
        """Blocking convenience: submit + result."""
        return self.submit(feeds, deadline_ms=deadline_ms).result(timeout)

    # -- graceful drain ----------------------------------------------------
    @property
    def draining(self):
        """True between ``begin_drain()`` and ``close()``."""
        return self.scheduler.draining

    def begin_drain(self):
        """Admission refuses with the retryable ``ServerDrainingError``
        while accepted requests complete; ``close()`` is the terminal half.
        Idempotent; returns whether this call flipped the state."""
        flipped = self.scheduler.begin_drain()
        if flipped:
            _log(f"drain begun: model version "
                 f"{self.model_version or 'unversioned'} refusing new "
                 f"admissions (ServerDrainingError, retryable); accepted "
                 f"requests completing")
        return flipped

    # -- hot model swap ----------------------------------------------------
    def _swap_ctl(self):
        if self._swap_controller is None:
            self._swap_controller = _swap.SwapController(self)
            if self._closing:
                # a controller made lazily AFTER close() inherits the
                # closed state: a swap on a closed server must not boot
                # and promote a pool nothing will ever close
                self._swap_controller._closed = True
        return self._swap_controller

    def swap(self, model_dir, **kwargs):
        """Zero-downtime hot model swap: gate (integrity + compatibility) ->
        memory admission -> standby warm boot beside the live pool ->
        canary -> atomic cutover at a batch boundary -> post-cutover
        watchdog, with automatic rollback to the still-resident old version
        on any failure (a typed ``SwapFailedError`` naming the stage).
        Returns the swap report dict. Keyword knobs: ``canary_feeds``,
        ``canary_check``, ``parity_rtol`` / ``parity_atol``,
        ``standby_timeout_ms``, ``watchdog_ms``, ``watchdog_max_errors``,
        ``watchdog_latency_x`` (see ``swap.SwapController``)."""
        return self._swap_ctl().swap(model_dir, **kwargs)

    def watch_dir(self, model_dir=None, poll_ms=1000.0, **swap_kwargs):
        """Continuous deploy: poll ``model_dir`` (default: the directory
        being served) for a new manifest ``model_version`` and ``swap`` to
        it; a failed version is skipped until a different one is
        published. Returns the ``SwapController``; ``stop_watch()`` or
        ``close()`` ends it."""
        return self._swap_ctl().watch_dir(model_dir, poll_ms=poll_ms,
                                          **swap_kwargs)

    def close(self, timeout=None):
        """Graceful shutdown: stop admission, drain every accepted request
        through the replicas, stop the workers, and wait out an in-flight
        swap and its background pool drains. Returns True when fully
        stopped; with a ``timeout`` that expires mid-drain, False (the
        drain keeps running; call close() again). Idempotent."""
        # the swap machinery brackets the close: the fast half first (no
        # new swap starts, an in-flight one aborts before its cutover, the
        # watcher stops), and the flag survives for a controller made
        # lazily after this close (_swap_ctl)
        self._closing = True
        if self._swap_controller is not None:
            self._swap_controller.begin_shutdown()
        # the scheduler drains its request queue into the batch queue
        # first, THEN the pool's per-replica sentinels land behind every
        # formed batch
        if not self.scheduler.close(timeout):
            return False
        if not self.pool.close(timeout):
            return False
        # the slow half last: a False here means swap machinery is still
        # running, and "fully stopped" over it would be a lie
        if self._swap_controller is not None and \
                not self._swap_controller.finish_shutdown(timeout):
            return False
        if self.scheduler._shed is not None:
            self.scheduler._shed.shutdown()
        # gauge truth is the SERVER's on a true close: a rollback racing it
        # can leave the pool just closed demoted (its role-gated zeroing
        # skipped)
        zero_pool_gauges()
        _swap.clear_model_version(self.model_version)
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
