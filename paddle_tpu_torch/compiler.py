"""fluid.compiler: the port of ``paddle_tpu/compiler.py``'s
``CompiledProgram``, ``BuildStrategy.apply_ir_passes``, the on/off lever
of the pass pipeline per program, and ``ExecutionStrategy``, recorded for
inspection only as in the JAX package. Data parallelism and mesh sharding
are not ported yet (ROADMAP queue 1 item 9): they raise.
"""

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["CompiledProgram", "ExecutionStrategy", "BuildStrategy"]


class ExecutionStrategy:
    """execution_strategy.h parity: the SSA executors' thread and scope
    knobs. The port's Executor interprets one program on one device, so
    they are recorded for inspection only (compiler.py:36-46)."""

    def __init__(self):
        self.num_threads = 0
        self.num_iteration_per_drop_scope = 1
        self.num_iteration_per_run = 1
        self.allow_op_delay = False
        self.use_thread_barrier = True


class BuildStrategy:
    """build_strategy.h parity, for the field the port reads:
    ``apply_ir_passes`` (None: follow ``FLAGS_apply_ir_passes``; True or
    False: pin the pass pipeline on or off for this program)."""

    def __init__(self):
        self.apply_ir_passes = None


class CompiledProgram:
    """A Program with a BuildStrategy; ``Executor.run`` takes it where it
    takes a Program."""

    def __init__(self, program, build_strategy=None):
        from paddle_tpu_torch.static.program import Program
        if not isinstance(program, Program):
            raise EnforceNotMet(
                f"CompiledProgram wraps a Program, got {type(program)}")
        self._program = program
        self._build_strategy = build_strategy

    def with_data_parallel(self, *args, **kwargs):
        raise EnforceNotMet("CompiledProgram.with_data_parallel is not "
                            "ported yet (ROADMAP queue 1 item 9)")

    def with_mesh_sharding(self, *args, **kwargs):
        raise EnforceNotMet("CompiledProgram.with_mesh_sharding is not "
                            "ported yet (ROADMAP queue 1 item 9)")
