"""Parallelism: the process environment of ``paddle_tpu/parallel/env.py``
(``ParallelEnv``, ``get_rank``, ``get_world_size``, ``init_parallel_env``,
``ParallelStrategy``, ``prepare_context``, ``DataParallel`` at one rank).
The mesh, the collectives and the SPMD trainers are ROADMAP queue 1
item 9."""

from paddle_tpu_torch.parallel.env import (  # noqa: F401
    DataParallel, ParallelEnv, ParallelStrategy, get_rank, get_world_size,
    init_parallel_env, prepare_context,
)

__all__ = ["ParallelEnv", "get_rank", "get_world_size", "init_parallel_env",
           "ParallelStrategy", "prepare_context", "DataParallel"]
