"""Program-level pass framework: the port of ``paddle_tpu/static/
passes.py``'s ``ProgramPass``, ``PassManager`` and the graph queries
``producers``, ``consumers``, ``backward_slice`` and ``extract_subprogram``
(passes.py:67-173; ``static/io._prune`` runs on the last two).

The Program is the IR: a pass transforms a Program's op list and returns
the Program (rewritten in place or replaced).
"""

import copy

from paddle_tpu_torch.static.program import Operator, Program

__all__ = ["ProgramPass", "PassManager", "producers", "consumers",
           "backward_slice", "extract_subprogram"]


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


# -- graph queries ---------------------------------------------------------

def producers(block):
    """{var name: (op index, op)} of the op that writes each var (last
    writer wins, matching execution order)."""
    out = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            out[n] = (i, op)
    return out


def consumers(block):
    """{var name: [(op index, op), ...]} of the ops reading each var."""
    out = {}
    for i, op in enumerate(block.ops):
        for n in op.input_names():
            out.setdefault(n, []).append((i, op))
    return out


def backward_slice(block, target_names, stop_at=(), skip_types=()):
    """Ops needed (in order) to produce ``target_names``, walking backward
    from the targets and stopping at ``stop_at`` vars (framework/prune.cc).
    Returns (kept ops list, needed var names set)."""
    needed = set(target_names)
    stop = set(stop_at)
    kept = []
    for op in reversed(block.ops):
        if op.type in skip_types:
            continue
        if any(n in needed for n in op.output_names()):
            kept.append(op)
            needed.update(n for n in op.input_names() if n not in stop)
    kept.reverse()
    return kept, needed


def extract_subprogram(program, kept_ops, needed_vars, extra_vars=()):
    """New Program holding copies of ``kept_ops`` and the var table entries
    they reference, with the program constants they read."""
    blk = program.global_block()
    out = Program()
    ob = out.global_block()
    keep = set(needed_vars) | set(extra_vars)
    for name, var in blk.vars.items():
        if name in keep:
            nv = copy.copy(var)
            nv.block = ob
            ob.vars[name] = nv
    for op in kept_ops:
        new = Operator(ob, op.type, None, None, dict(op.attrs))
        new.inputs = {k: list(v) for k, v in op.inputs.items()}
        new.outputs = {k: list(v) for k, v in op.outputs.items()}
        ob.ops.append(new)
    out._constants = {n: v for n, v in program._constants.items()
                      if n in keep}
    out._bump()
    return out
