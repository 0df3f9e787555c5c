"""Learning-rate schedules: the port of
``paddle_tpu/layers/learning_rate_scheduler.py`` (noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay, polynomial_decay,
piecewise_decay, cosine_decay, linear_lr_warmup).

A schedule is a callable ``step -> lr`` of torch ops in fp32, as the JAX
ones are jnp ops in f32: given the optimizer's step counter (a 0-d tensor on
the card) it returns a 0-d fp32 tensor on the card, so an update reads its
rate from device memory and no step waits for the host. A Python number
gives a CPU tensor.
"""

import math

import torch

__all__ = [
    "Schedule", "noam_decay", "exponential_decay", "natural_exp_decay",
    "inverse_time_decay", "polynomial_decay", "piecewise_decay",
    "cosine_decay", "linear_lr_warmup",
]


class Schedule:
    def __init__(self, fn):
        self._fn = fn

    def __call__(self, step):
        step = (step.to(torch.float32) if isinstance(step, torch.Tensor)
                else torch.tensor(step, dtype=torch.float32))
        return self._fn(step)


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    def fn(step):
        step = torch.clamp(step, min=1.0)
        a = step ** -0.5
        b = step * (warmup_steps ** -1.5)
        return learning_rate * (d_model ** -0.5) * torch.minimum(a, b)
    return Schedule(fn)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def fn(step):
        e = step / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * (decay_rate ** e)
    return Schedule(fn)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    def fn(step):
        e = step / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate * torch.exp(-decay_rate * e)
    return Schedule(fn)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    def fn(step):
        e = step / decay_steps
        if staircase:
            e = torch.floor(e)
        return learning_rate / (1.0 + decay_rate * e)
    return Schedule(fn)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=1e-4,
                     power=1.0, cycle=False):
    def fn(step):
        if cycle:
            div = torch.clamp(torch.ceil(step / decay_steps), min=1.0)
            ds = decay_steps * div
        else:
            ds = decay_steps
            step = torch.clamp(step, max=float(ds))
        return ((learning_rate - end_learning_rate)
                * (1 - step / ds) ** power + end_learning_rate)
    return Schedule(fn)


def piecewise_decay(boundaries, values):
    """values[i] for the i boundaries at or below the step, with the
    boundaries and values rounded to fp32 (the JAX package's f32 tables).
    The count and the pick are torch.where chains over Python numbers, so
    no table is copied to the card."""
    def fn(step):
        idx = torch.zeros((), dtype=torch.int32, device=step.device)
        for b in boundaries:
            idx = idx + (step >= b).to(torch.int32)
        out = torch.full((), values[0], dtype=torch.float32,
                         device=step.device)
        for i, v in enumerate(values[1:], 1):
            out = torch.where(idx == i, v, out)
        return out
    return Schedule(fn)


def cosine_decay(learning_rate, step_each_epoch, epochs):
    def fn(step):
        epoch = torch.floor(step / step_each_epoch)
        return learning_rate * 0.5 * (torch.cos(epoch * math.pi / epochs)
                                      + 1)
    return Schedule(fn)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    base = learning_rate if not isinstance(learning_rate, Schedule) else None

    def fn(step):
        lr = learning_rate(step) if base is None else base
        warm = start_lr + (end_lr - start_lr) * (step / warmup_steps)
        return torch.where(step < warmup_steps, warm, lr)
    return Schedule(fn)
