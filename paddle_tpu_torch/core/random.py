"""Global RNG state: the port of ``paddle_tpu/core/random.py``.

The reference's random ops are stateful (per-device curand generators,
seeded by an op attr or globally). The JAX package bridges that with a
process-global seed and draw counter minting ``jax.random`` keys; the port
keeps the same rules over ``torch.Generator`` objects:

- an op seed that is not 0 gives a fresh generator seeded with it, so the
  same seed gives the same draws on every call (as ``PRNGKey(seed)`` does);
- seed 0 takes the next generator of the global counter, which
  :func:`seed` resets.

The draws are torch's (Philox on the card, the Mersenne twister on the
CPU), not threefry's: what carries over from the JAX package is each op's
shape, dtype, range, distribution and determinism, never its values.
"""

import threading

import torch

__all__ = ["seed", "next_generator", "generator_for"]

_GLOBAL = {"seed": 0, "counter": 0}
_lock = threading.Lock()


def seed(s):
    """paddle.seed parity: reset the global generator."""
    with _lock:
        _GLOBAL["seed"] = int(s)
        _GLOBAL["counter"] = 0


def next_generator(device="cpu"):
    """A fresh generator on ``device`` from the global seed and the next
    draw of the counter (the JAX ``fold_in(PRNGKey(seed), counter)``)."""
    with _lock:
        s, n = _GLOBAL["seed"], _GLOBAL["counter"]
        _GLOBAL["counter"] += 1
    mixed = (s * 0x9E3779B1 + n * 0x85EBCA77 + 0x5BD1E995) & ((1 << 63) - 1)
    return torch.Generator(device=device).manual_seed(mixed)


def generator_for(op_seed, device="cpu"):
    """The generator of an op carrying its own seed attr (seed 0 means the
    global one), on ``device``."""
    if op_seed:
        return torch.Generator(device=device).manual_seed(int(op_seed))
    return next_generator(device)
