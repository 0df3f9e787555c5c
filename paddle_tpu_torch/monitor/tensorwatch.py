"""Opt-in tensor/grad watch: grad global-norm, param-norm, update-ratio
and AMP loss-scale events in the metrics registry. The port of
``paddle_tpu/monitor/tensorwatch.py``: the same ops, var names, metrics
and program documents (a program built with the watch on serializes and
loads in either package).

- With ``tensorwatch.enable()`` active at ``Optimizer.minimize()`` time,
  the optimizer brackets its update ops with two watch ops:
  ``tensor_watch_pre`` (before clipping: the pre-clip grad global norm and
  the param global norm, by ``clip.global_norm``'s arithmetic, so under
  ``GradientClipByGlobalNorm`` the two agree) and ``tensor_watch_post``
  (after the updates: ``||new - old|| / ||old||``, the update ratio).
- **In place.** The port's ``apply_optimizer`` updates the parameters in
  place, so the JAX pre-op's pass-through ``PreParams`` would alias the
  tensors the update then overwrites and the update norm would read 0.
  The port's pre-op keeps one flattened copy of the parameters
  (``torch.cat``) and hands out ``PreParams`` as views of it; the post-op
  writes ``old - new`` into that copy, which is dead after it, and takes
  its norm: one extra param-sized buffer while the watch is on, nothing
  when off.
- The stats land in one tiny ``@watch@stats`` vector the Executor fetches
  with the user's fetch list, peels off before the user sees it, and
  publishes here (``on_step``) as gauges/histograms. With
  ``return_numpy=False`` publication is one step late, so the watch adds no
  host read of its own.
- AMP: ``record_loss_scale`` turns the loss-scale state into a
  ``loss_scale`` gauge and a ``loss_scale_decrements_total`` counter (each
  decrement is an overflow event the scaler absorbed);
  ``amp.OptimizerWithMixedPrecision.monitor_state`` is the hookup.

Grad norms also feed ``monitor.anomaly``'s grad-explosion window when the
detector is enabled. torch is imported inside the functions only.
"""

import threading

from paddle_tpu_torch.monitor import flight_recorder as _flight
from paddle_tpu_torch.monitor.registry import counter, gauge, histogram

__all__ = [
    "TensorMonitor", "enable", "disable", "is_enabled", "on_step",
    "flush", "record_loss_scale", "STATS_VAR", "PRE_VAR",
]

#: program var the watch ops write / the executor auto-fetches
STATS_VAR = "@watch@stats"
PRE_VAR = "@watch@prenorms"

_g_grad = gauge(
    "grad_global_norm",
    "Last published step's PRE-CLIP global gradient norm (tensor "
    "watch; the norm GradientClipByGlobalNorm computes)")
_h_grad = histogram(
    "grad_global_norm_per_step",
    "Distribution of the pre-clip global gradient norm across "
    "published steps",
    buckets=(1e-4, 1e-3, 1e-2, 0.1, 1.0, 10.0, 100.0, 1e3, 1e4))
_g_param = gauge(
    "param_global_norm",
    "Last published step's global parameter norm (pre-update)")
_g_ratio = gauge(
    "update_ratio",
    "Last published step's ||new_params - old_params|| / "
    "||old_params|| (tensor watch)")
_g_scale = gauge(
    "loss_scale",
    "Current AMP dynamic loss scale (record_loss_scale)")
_c_scale_dec = counter(
    "loss_scale_decrements_total",
    "AMP loss-scale decrements observed — each one is a non-finite "
    "fp16 gradient event the scaler absorbed")

_enabled = False
_lock = threading.Lock()
_pending = None               # (stats vector, step) awaiting publish
_last_scale = None


def enable():
    """Arm the watch. Programs built (``minimize()``d) while enabled
    carry the watch ops; publication is also gated on this flag. Also
    forgets the loss-scale baseline: a new run starting from its init
    scale must not read as a decrement of the previous run's grown
    scale."""
    global _enabled, _last_scale
    _enabled = True
    _last_scale = None


def disable():
    global _enabled, _last_scale
    _enabled = False
    _last_scale = None
    flush()


def is_enabled():
    return _enabled


# -- in-graph op computes (registered by optimizer.py, which owns the
# -- program layout; traced inside the executor's fused step) --------------
def _watch_pre_compute(ins, attrs):
    import torch

    from paddle_tpu_torch import clip as clip_mod
    grads = list(ins.get("Grads", []))
    params = [p.detach() for p in ins.get("Params", [])]
    gn = clip_mod.global_norm(grads)
    pn = clip_mod.global_norm(params)
    # the update writes the parameters in place: keep ONE flattened copy
    # and hand out views of it for the post op's update ratio
    pre = []
    if params:
        flat = torch.cat([p.reshape(-1) for p in params])
        pre = [v.view_as(p) for v, p in zip(
            flat.split([p.numel() for p in params]), params)]
    return {"Norms": [torch.stack([gn, pn])], "PreParams": pre}


def _watch_post_compute(ins, attrs):
    import torch

    from paddle_tpu_torch import clip as clip_mod
    new = list(ins.get("Params", []))
    old = list(ins.get("PreParams", []))
    pre = ins["PreNorms"][0]
    # the pre op's flat copy is dead after this op: the update's
    # difference goes into it (old - new has the norm of new - old)
    if old:
        torch._foreach_sub_(old, new)
    un = clip_mod.global_norm(old)
    ratio = un / torch.clamp(pre[1], min=1e-12)
    return {"Out": [torch.stack([pre[0], pre[1], un, ratio])]}


# -- host-side publication --------------------------------------------------
def _publish(vec, step=None):
    import numpy as np
    if hasattr(vec, "detach"):
        vec = vec.detach().to("cpu").double().numpy()
    v = np.asarray(vec, dtype=np.float64).ravel()
    if v.size < 4:
        return
    gn, pn, un, ratio = (float(x) for x in v[:4])
    _g_grad.set(gn)
    _h_grad.observe(gn)
    _g_param.set(pn)
    _g_ratio.set(ratio)
    if _flight._enabled:
        _flight.RECORDER.note("watch", "tensorwatch", step=step,
                              grad_norm=round(gn, 6),
                              update_ratio=round(ratio, 8))
    from paddle_tpu_torch.monitor import anomaly
    if anomaly._enabled:
        anomaly.DETECTOR.observe(step=step, grad_norm=gn)


def on_step(stats, step=None, sync=True):
    """The executor's hookup: hand over one step's ``@watch@stats``
    vector. ``sync=True`` publishes immediately (the caller is about
    to block on fetches anyway); ``sync=False`` (async dispatch)
    defers to the NEXT call — by then the device has long finished the
    value, so materializing it cannot stall the pipeline."""
    global _pending
    with _lock:
        prev, _pending = _pending, (None if sync else (stats, step))
    if prev is not None:
        _publish(prev[0], prev[1])
    if sync:
        _publish(stats, step)


def flush():
    """Publish any deferred async-mode stats (end of a training run)."""
    global _pending
    with _lock:
        prev, _pending = _pending, None
    if prev is not None:
        _publish(prev[0], prev[1])


def record_loss_scale(scale, step=None):
    """Publish the AMP dynamic loss scale; count decrements (each is an
    absorbed non-finite-gradient event). Call with the MATERIALIZED
    scale between steps — amp.OptimizerWithMixedPrecision
    .monitor_state does."""
    global _last_scale
    s = float(scale)
    _g_scale.set(s)
    if _last_scale is not None and s < _last_scale:
        _c_scale_dec.inc()
        if _flight._enabled:
            _flight.RECORDER.note("watch", "loss_scale_decrement",
                                  step=step, scale=s)
    _last_scale = s
    return s


class TensorMonitor:
    """Eager-path watch: compute the same stats from (params, grads[,
    new_params]) trees of tensors and publish them. This costs device work
    of its own (the static path's watch ops ride the step); it is the
    convenience wrapper for eager loops. Pass ``params`` as they were before
    an in-place update (a copy) when giving ``new_params``."""

    def observe(self, params, grads, new_params=None, step=None):
        import torch

        from paddle_tpu_torch import clip as clip_mod
        from paddle_tpu_torch.core.tree import leaves
        gn = clip_mod.global_norm(grads)
        pn = clip_mod.global_norm(params)
        if new_params is not None:
            un = clip_mod.global_norm([n - o for n, o in zip(
                leaves(new_params), leaves(params))])
            ratio = un / torch.clamp(pn, min=1e-12)
        else:
            un = torch.zeros((), device=pn.device)
            ratio = torch.zeros((), device=pn.device)
        _publish(torch.stack([gn, pn, un, ratio]), step)
        return float(gn)
