"""Program-level pass framework: the port of ``paddle_tpu/static/
passes.py``'s ``ProgramPass`` and ``PassManager`` (the graph queries the
port's two passes use live beside them in ``static/opt_passes.py``).

The Program is the IR: a pass transforms a Program's op list and returns
the Program (rewritten in place or replaced).
"""

__all__ = ["ProgramPass", "PassManager"]


class ProgramPass:
    """Base pass (framework/ir/pass.h parity)."""

    name = None

    def apply(self, program):
        raise NotImplementedError

    def __call__(self, program):
        return self.apply(program)


class PassManager:
    """An ordered pass pipeline; ``applied`` records the pass names run."""

    def __init__(self, passes=()):
        self.passes = list(passes)
        self.applied = []

    def apply(self, program):
        for p in self.passes:
            out = p.apply(program)
            program = out if out is not None else program
            self.applied.append(p.name)
        return program

