"""fluid.compiler: the port of ``paddle_tpu/compiler.py``'s
``CompiledProgram`` and ``BuildStrategy.apply_ir_passes``, the on/off lever
of the pass pipeline per program. Data parallelism and mesh sharding are not
ported yet (ROADMAP queue 1 item 9): they raise.
"""

from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = ["CompiledProgram", "BuildStrategy"]


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
