"""The distributed process environment: the port of
``paddle_tpu/parallel/env.py`` (the reference's env-var identity wiring,
python/paddle/fluid/dygraph/parallel.py:54-82, and its ``prepare_context``
and ``DataParallel``).

The rank and world size come from ``PADDLE_TRAINER_ID`` and
``PADDLE_TRAINERS_NUM``, else from ``torch.distributed`` once a process
group is initialised, else 0 and 1. ``DataParallel`` wraps a Layer and
delegates to it; at one rank ``scale_loss`` and ``apply_collective_grads``
are the identity, as in the JAX package. At more ranks they need the
collectives, which are ROADMAP queue 1 item 9: they raise naming it.
"""

import os

import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "ParallelStrategy", "prepare_context", "DataParallel"]


def _dist():
    d = torch.distributed
    return d if d.is_available() and d.is_initialized() else None


class ParallelEnv:
    """dygraph.parallel.ParallelEnv parity."""

    def __init__(self):
        d = _dist()
        self._rank = int(os.environ.get(
            "PADDLE_TRAINER_ID", d.get_rank() if d else 0))
        self._world = int(os.environ.get(
            "PADDLE_TRAINERS_NUM", d.get_world_size() if d else 1))
        self._endpoint = os.environ.get("PADDLE_CURRENT_ENDPOINT", "")
        self._endpoints = os.environ.get(
            "PADDLE_TRAINER_ENDPOINTS", "").split(",")

    @property
    def local_rank(self):
        return self._rank

    @property
    def nranks(self):
        return self._world

    @property
    def dev_id(self):
        """0: one process drives its card (a device per rank comes with the
        collectives, ROADMAP queue 1 item 9)."""
        return 0

    @property
    def current_endpoint(self):
        return self._endpoint

    @property
    def trainer_endpoints(self):
        return self._endpoints


def get_rank():
    return ParallelEnv().local_rank


def get_world_size():
    return ParallelEnv().nranks


def init_parallel_env(coordinator_address=None, num_processes=None,
                      process_id=None):
    """Multi-process bring-up: with a ``coordinator_address``
    (``host:port``) the ``torch.distributed`` process group (NCCL on the
    card, gloo on the CPU) is initialised with the given world size and
    rank; the environment is returned either way."""
    if coordinator_address is not None and _dist() is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
        torch.distributed.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes, rank=process_id)
    return ParallelEnv()


class ParallelStrategy:
    """dygraph.parallel.ParallelStrategy parity (the prepare_context
    product): the world size, this rank and the endpoints."""

    def __init__(self, nranks=1, local_rank=0, trainer_endpoints=(),
                 current_endpoint=""):
        self.nranks = nranks
        self.local_rank = local_rank
        self.trainer_endpoints = list(trainer_endpoints)
        self.current_endpoint = current_endpoint


def prepare_context(strategy=None):
    """dygraph.parallel.prepare_context parity (ref dygraph/parallel.py:30):
    ``strategy``, or one from the process environment."""
    if strategy is not None:
        return strategy
    env = ParallelEnv()
    return ParallelStrategy(env.nranks, env.local_rank,
                            env.trainer_endpoints, env.current_endpoint)


def _needs_collectives(what):
    raise EnforceNotMet(
        f"DataParallel.{what} at more than one rank needs the cross-rank "
        "all-reduce, which the port does not have yet (ROADMAP queue 1 "
        "item 9)")


class DataParallel:
    """dygraph.parallel.DataParallel parity (ref dygraph/parallel.py:84) in
    functional form: wraps an nn.Layer (``init``/``apply``/``sublayers``
    delegate to it). At one rank ``scale_loss`` and
    ``apply_collective_grads`` return their argument; at more they raise
    (queue 1 item 9)."""

    def __init__(self, layers, strategy=None, axis_name="data"):
        self._layers = layers
        self._strategy = strategy or prepare_context()
        self._axis = axis_name

    def __call__(self, *args, **kwargs):
        return self._layers(*args, **kwargs)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.__dict__["_layers"], name)

    def scale_loss(self, loss):
        if max(self._strategy.nranks, 1) > 1:
            _needs_collectives("scale_loss")
        return loss

    def apply_collective_grads(self, grads):
        if max(self._strategy.nranks, 1) > 1:
            _needs_collectives("apply_collective_grads")
        return grads
