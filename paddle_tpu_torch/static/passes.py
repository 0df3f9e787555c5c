"""Program-level pass framework: the port of ``paddle_tpu/static/
passes.py``: ``ProgramPass``, ``PassManager``, the graph queries
``producers``, ``consumers``, ``match_ops``, ``match_chain``,
``backward_slice`` and ``extract_subprogram`` (``static/io._prune`` runs on
the last two), and ``BlockRewriter``, the queued insert/replace/drop over a
block's op list that ``contrib/quant.py``'s passes are written on.

The Program is the IR: a pass transforms a Program's op list and returns
the Program (rewritten in place or replaced).
"""

import copy

from paddle_tpu_torch.static.program import Operator, Program

__all__ = ["ProgramPass", "PassManager", "producers", "consumers",
           "match_ops", "match_chain", "backward_slice",
           "extract_subprogram", "BlockRewriter"]


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

    def add(self, p):
        self.passes.append(p)
        return self

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


def _matches(op, spec):
    """spec: an op type, a collection of types, or a predicate."""
    if callable(spec) and not isinstance(spec, str):
        return bool(spec(op))
    if isinstance(spec, (tuple, list, set, frozenset)):
        return op.type in spec
    return op.type == spec


def _block(program_or_block):
    return (program_or_block.global_block()
            if hasattr(program_or_block, "global_block")
            else program_or_block)


def match_ops(program_or_block, spec):
    """[(index, op)] of the ops matching ``spec`` in the global block (or
    the given block)."""
    return [(i, op) for i, op in enumerate(_block(program_or_block).ops)
            if _matches(op, spec)]


def match_chain(program_or_block, specs):
    """Producer -> consumer chains: tuples (o1, ..., oN) where each op's
    output feeds the next one's input and o[k] matches specs[k]; a var read
    by several matching ops gives one tuple each."""
    blk = _block(program_or_block)
    cons = consumers(blk)
    chains = [(op,) for _, op in match_ops(blk, specs[0])]
    for spec in specs[1:]:
        nxt = []
        for chain in chains:
            seen = set()
            for n in chain[-1].output_names():
                for _, op in cons.get(n, []):
                    if id(op) not in seen and _matches(op, spec):
                        seen.add(id(op))
                        nxt.append(chain + (op,))
        chains = nxt
    return chains


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


class BlockRewriter:
    """Queued rewrites of a program's global block, committed in one pass:
    ``insert_before``/``insert_after``/``replace``/``remove`` by the op's
    index in the block as it was, then ``commit()`` rebuilds the op list
    and bumps the program's version."""

    def __init__(self, program):
        self.program = program
        self.block = program.global_block()
        self._before = {}
        self._after = {}
        self._replace = {}     # index -> [ops] ([] drops the op)

    def insert_before(self, index, *ops):
        self._before.setdefault(index, []).extend(ops)
        return self

    def insert_after(self, index, *ops):
        self._after.setdefault(index, []).extend(ops)
        return self

    def replace(self, index, *ops):
        self._replace[index] = list(ops)
        return self

    def remove(self, index):
        self._replace[index] = []
        return self

    def make_op(self, type, inputs=None, outputs=None, attrs=None):
        """An Operator of this block, not appended."""
        return Operator(self.block, type, inputs, outputs, attrs)

    def create_var(self, name, shape=None, dtype="float32", **kw):
        return self.block.create_var(name=name, shape=shape, dtype=dtype,
                                     **kw)

    def commit(self):
        n = len(self.block.ops)
        # insert_before(n) appends; any other edit past the end is a bug
        stray = {i for d in (self._before, self._after, self._replace)
                 for i in d if i > n or (i == n and d is not self._before)}
        if stray:
            raise IndexError(
                f"BlockRewriter: edits queued at out-of-range op indices "
                f"{sorted(stray)} (block has {n} ops)")
        new_ops = []
        for i, op in enumerate(self.block.ops):
            new_ops.extend(self._before.get(i, ()))
            new_ops.extend(self._replace.get(i, (op,)))
            new_ops.extend(self._after.get(i, ()))
        new_ops.extend(self._before.get(n, ()))
        self.block.ops = new_ops
        self._before, self._after, self._replace = {}, {}, {}
        self.program._bump()
        return self.program
