"""Program-level optimization passes and the default pipeline: the port of
``paddle_tpu/static/opt_passes.py``'s ``fused_matmul`` op,
``FuseMatmulBiasActPass``, ``DeadOpEliminationPass`` and the entry points
``optimize_program`` / ``optimize_for_execution``.

The Executor runs the pipeline on a clone of each main program it executes
(``FLAGS_apply_ir_passes``, on by default, or ``BuildStrategy.
apply_ir_passes``), against the step's fetch list. The caller's program is
never mutated. A rewrite fires only when the matched vars are written once,
the intermediates have one consumer and are neither fetched, persistable nor
fed, and the chain stays inside one autodiff region.

The ``fused_matmul`` op's compute calls ``try_fused_matmul``, the kernel's
path (``ops/kernels/matmul.py``): inside the kernel's contract it runs the
kernel (CUDA) or its plain body (CPU); outside it, the composition of the
ops it replaced.
"""

import time

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops import math as _m
from paddle_tpu_torch.ops.kernels import try_fused_matmul
from paddle_tpu_torch.static.passes import PassManager, ProgramPass
from paddle_tpu_torch.static.program import Operator, register_op

__all__ = ["FUSED_MATMUL", "FuseMatmulBiasActPass", "DeadOpEliminationPass",
           "default_pipeline", "optimize_program", "optimize_for_execution",
           "PipelineReport"]

#: the fused matmul (+bias) (+act) op the fusion pass emits
FUSED_MATMUL = "fused_matmul"

#: activations the matmul fusion absorbs (attr-free unary ops)
_FUSABLE_ACTS = frozenset({"relu", "sigmoid", "tanh", "gelu"})
_MATMUL_TYPES = ("mul", "matmul")


def _fused_matmul_compute(ins, attrs):
    """x @ w (+ bias) (+ act): the kernel inside its contract, else the
    composition of the ops the pass replaced (matmul.py:90-134)."""
    if attrs.get("quant"):
        raise EnforceNotMet(
            "a quantized fused_matmul (weight-only PTQ, the int8 kernel) is "
            "not ported yet (ROADMAP queue 1 item 8, queue 2 row 9)")
    fast = try_fused_matmul(ins, attrs)
    if fast is not None:
        return {"Out": [fast]}
    xs = list(ins["X"])
    out = getattr(_m, attrs["mm_type"])(xs[0], xs[1],
                                        **attrs.get("mm_attrs", {}))
    if attrs.get("has_bias"):
        out = _m.elementwise_add(out, xs[2], axis=attrs.get("bias_axis", -1))
    act = attrs.get("act")
    if act:
        out = getattr(_act, act)(out)
    return {"Out": [out]}


register_op(FUSED_MATMUL, _fused_matmul_compute)


# ---------------------------------------------------------------------------
# shared analysis helpers
# ---------------------------------------------------------------------------
def _write_counts(block):
    c = {}
    for op in block.ops:
        for n in op.output_names():
            c[n] = c.get(n, 0) + 1
    return c


def _consumer_map(block):
    """{name: [(index, op)]}, each reading op once."""
    out = {}
    for i, op in enumerate(block.ops):
        for n in set(op.input_names()):
            out.setdefault(n, []).append((i, op))
    return out


def _write_indices(block):
    """{name: [indices of the ops that write it]}. A name may be written
    more than once (optimizer ops write params in place), so a rewrite that
    moves a read across a write must check ``_written_between``."""
    w = {}
    for i, op in enumerate(block.ops):
        for n in op.output_names():
            w.setdefault(n, []).append(i)
    return w


def _written_between(widx, name, lo, hi):
    """True when ``name`` is written by an op with index in (lo, hi]."""
    return any(lo < k <= hi for k in widx.get(name, ()))


def _regions(ops):
    """Region id per op index: the autodiff marker is a barrier (fusing
    across it would move work in or out of the differentiated prefix)."""
    rid, out = 0, []
    for op in ops:
        barrier = op.type == "autodiff"
        if barrier:
            rid += 1
        out.append(rid)
        if barrier:
            rid += 1
    return out


def _protected_names(block, targets):
    """Vars no rewrite may erase: fetch targets, persistable state and
    feed vars."""
    prot = set(targets)
    for n, v in block.vars.items():
        if v.persistable or v.is_data:
            prot.add(n)
    return prot


def _single_consumer(cons_map, name, wcounts):
    """The one (index, op) reading ``name``, or None when the var has
    several consumers or writers, or none."""
    if wcounts.get(name, 0) != 1:
        return None
    cs = cons_map.get(name, [])
    if len(cs) != 1 or cs[0][1].input_names().count(name) != 1:
        return None
    return cs[0]


def _attrs_nontrivial(op):
    """True when an activation op carries attrs beyond cosmetic ones: such
    an op must not be absorbed into a fusion that replays it attr-free."""
    return any(k != "name" and v is not None for k, v in op.attrs.items())


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------
class FuseMatmulBiasActPass(ProgramPass):
    """mul|matmul -> elementwise_add(bias) -> [relu|sigmoid|tanh|gelu]
    chains (``layers.fc``'s emission) collapse into one ``fused_matmul``
    op (opt_passes.py:512-610)."""

    name = "fuse_matmul_bias_act"

    def __init__(self, targets=()):
        self.targets = set(targets)

    def apply(self, program):
        blk = program.global_block()
        prot = _protected_names(blk, self.targets)
        wcounts = _write_counts(blk)
        cons = _consumer_map(blk)
        widx = _write_indices(blk)
        regions = _regions(blk.ops)
        region_of = {id(op): regions[i] for i, op in enumerate(blk.ops)}
        index_of = {id(op): i for i, op in enumerate(blk.ops)}
        used = set()
        plans = []          # (member op ids, fused Operator, anchor id)
        for i, op in enumerate(blk.ops):
            if op.type not in _MATMUL_TYPES or id(op) in used:
                continue
            xs = op.inputs.get("X", [])
            if len(xs) != 2:
                continue
            mm_out = op.outputs["Out"][0]
            if mm_out in prot:
                continue
            nxt = _single_consumer(cons, mm_out, wcounts)
            if nxt is None or nxt[1].type != "elementwise_add" \
                    or id(nxt[1]) in used \
                    or region_of[id(nxt[1])] != regions[i]:
                continue
            j, add = nxt
            add_xs = add.inputs.get("X", [])
            # the matmul's output must be the LEFT operand: the axis-aligned
            # broadcast is defined on (big, small)
            if len(add_xs) != 2 or add_xs[0] != mm_out \
                    or add_xs[1] == mm_out:
                continue
            add_out = add.outputs["Out"][0]
            members = [op, add]
            act = None
            anchor = add
            if add_out not in prot:
                nxt2 = _single_consumer(cons, add_out, wcounts)
                if nxt2 is not None and nxt2[1].type in _FUSABLE_ACTS \
                        and id(nxt2[1]) not in used \
                        and region_of[id(nxt2[1])] == regions[i] \
                        and not _attrs_nontrivial(nxt2[1]):
                    act = nxt2[1].type
                    anchor = nxt2[1]
                    members.append(nxt2[1])
            # the fused op reads the operands at the anchor's (later)
            # position: refuse if one is re-written in between
            anchor_idx = index_of[id(anchor)]
            if any(_written_between(widx, n, i, anchor_idx) for n in xs) \
                    or _written_between(widx, add_xs[1], j, anchor_idx):
                continue
            mm_attrs = {k: v for k, v in op.attrs.items()
                        if k != "name" and v is not None}
            fused = Operator(
                blk, FUSED_MATMUL,
                inputs={"X": [xs[0], xs[1], add_xs[1]]},
                outputs={"Out": [anchor.outputs["Out"][0]]},
                attrs={"mm_type": op.type, "mm_attrs": mm_attrs,
                       "has_bias": True,
                       "bias_axis": add.attrs.get("axis", -1),
                       **({"act": act} if act else {})})
            used.update(id(m) for m in members)
            plans.append(({id(m) for m in members}, fused, id(anchor)))
        if not plans:
            return program
        member_ids = set()
        fused_at = {}
        for ids, fused, anchor_id in plans:
            member_ids |= ids
            fused_at[anchor_id] = fused
        blk.ops = [fused_at.get(id(op), op) for op in blk.ops
                   if id(op) in fused_at or id(op) not in member_ids]
        program._bump()
        return program


class DeadOpEliminationPass(ProgramPass):
    """Drop ops whose outputs reach neither a fetch target, persistable
    state, nor the autodiff marker (opt_passes.py:623-660)."""

    name = "dead_op_elim"

    def __init__(self, targets=()):
        self.targets = set(targets)

    def apply(self, program):
        blk = program.global_block()
        needed = set(self.targets)
        kept = []
        for op in reversed(blk.ops):
            keep = (op.type == "autodiff"
                    or any(blk.has_var(n) and blk.vars[n].persistable
                           for n in op.output_names())
                    or any(n in needed for n in op.output_names()))
            if keep:
                kept.append(op)
                needed.update(op.input_names())
        if len(kept) != len(blk.ops):
            kept.reverse()
            blk.ops = kept
            program._bump()
        return program


# ---------------------------------------------------------------------------
# pipeline entry points
# ---------------------------------------------------------------------------
class PipelineReport:
    """What one pipeline run did: per-pass op counts and times."""

    def __init__(self):
        self.per_pass = []
        self.ops_before = 0
        self.ops_after = 0

    def ops_removed(self):
        return self.ops_before - self.ops_after


def default_pipeline(targets=()):
    """The port's pass order: fusion, then dead-op elimination (which sweeps
    what the fusion orphaned).

    The JAX package's pipeline runs three more passes first, not ported
    yet (ROADMAP queue 1 item 6): constant folding, scale/cast chain
    folding and transpose/reshape cancelling. On the programs this port
    runs (fc stacks with embeddings, softmax and losses) they rewrite
    nothing; tests/test_torch_static.py pins that the op lists still match.
    """
    return PassManager([FuseMatmulBiasActPass(targets),
                        DeadOpEliminationPass(targets)])


def optimize_program(program, targets=(), pipeline=None):
    """Clone ``program``, run the pass pipeline against ``targets`` (the
    step's fetch names) and return ``(optimized_program, report)``. The
    input program is never mutated."""
    prog = program.clone()
    pm = pipeline or default_pipeline(targets)
    report = PipelineReport()
    report.ops_before = len(prog.global_block().ops)
    for p in pm.passes:
        n0 = len(prog.global_block().ops)
        t0 = time.perf_counter()
        out = p.apply(prog)
        prog = out if out is not None else prog
        n1 = len(prog.global_block().ops)
        pm.applied.append(p.name)
        report.per_pass.append({
            "pass": p.name, "ops_before": n0, "ops_after": n1,
            "ops_removed": n0 - n1,
            "ms": (time.perf_counter() - t0) * 1e3})
    # keep only the constants a surviving op (or fetch target) still reads
    live = set(targets)
    for op in prog.global_block().ops:
        live.update(op.input_names())
    prog._constants = {k: v for k, v in prog._constants.items() if k in live}
    report.ops_after = len(prog.global_block().ops)
    return prog, report


def optimize_for_execution(program, fetch_names):
    """The Executor's entry: optimize against the step's fetch list."""
    return optimize_program(program, targets=tuple(fetch_names))[0]
