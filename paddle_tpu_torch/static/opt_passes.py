"""Program-level optimization passes and the default pipeline: the port of
``paddle_tpu/static/opt_passes.py``: the ``fused_matmul`` op, the five
passes (``ConstantFoldingPass``, ``FoldScaleCastChainPass``,
``CancelTransposeReshapePass``, ``FuseMatmulBiasActPass``,
``DeadOpEliminationPass``, run in that order by ``default_pipeline``) and
the entry points ``optimize_program`` / ``optimize_for_execution``.

The Executor runs the pipeline on a clone of each main program it executes
(``FLAGS_apply_ir_passes``, on by default, or ``BuildStrategy.
apply_ir_passes``), against the step's fetch list. The caller's program is
never mutated. A rewrite fires only when the matched vars are written once,
the intermediates have one consumer and are neither fetched, persistable nor
fed, and the chain crosses neither a host op nor the autodiff op. Constant
folding evaluates, on the CPU, the ops whose inputs are all program
constants (``Program._constants``) and records their outputs as constants;
it skips ops that draw, host ops, ops with side effects (``print``,
``py_func``, ...), control-flow ops (a sub-Program in an attr), ops writing
a persistable var, and results over ``max_elements``.

The ``fused_matmul`` op's compute calls ``try_fused_matmul``, the kernels'
path (``ops/kernels/matmul.py``): inside the kernels' contract it runs the
kernel (CUDA) or its plain body (CPU); outside it, the composition of the
ops it replaced.

The weight-only PTQ half (``plan_weight_quant`` / ``apply_weight_quant`` /
``quantize_weight_values``, opt_passes.py:790-948) serves
``export_aot(quantize=)`` and the serving warm boot: per-channel abs-max
int8 (or bf16 storage), the dequant folded into the consuming matmul as one
``fused_matmul`` op with ``quant`` set, which the ``fused_matmul_int8``
kernel (int8) or the ``fused_matmul`` kernel (bf16) computes. The int8
arrays and scale tables are bit-identical to the JAX package's for the same
fp32 weights (round half to even, clip to [-128, 127]).
"""

import time

import torch

from paddle_tpu_torch.core.dtypes import convert_dtype
from paddle_tpu_torch.core.enforce import EnforceNotMet, enforce
from paddle_tpu_torch.ops import activation as _act
from paddle_tpu_torch.ops import math as _m
from paddle_tpu_torch.ops.kernels import try_fused_matmul
from paddle_tpu_torch.static.passes import PassManager, ProgramPass
from paddle_tpu_torch.static.program import Operator, Program, register_op

__all__ = ["FUSED_MATMUL", "ConstantFoldingPass", "FoldScaleCastChainPass",
           "CancelTransposeReshapePass", "FuseMatmulBiasActPass",
           "DeadOpEliminationPass", "default_pipeline", "optimize_program", "optimize_for_execution",
           "optimize_inference", "PipelineReport", "QUANT_SCALE_SUFFIX",
           "QUANT_BINS", "plan_weight_quant", "apply_weight_quant",
           "quantize_weight_values"]

#: the fused matmul(+dequant)(+bias)(+act) op the fusion and quant passes
#: emit
FUSED_MATMUL = "fused_matmul"
#: per-channel scale table var name: ``<weight>@quant_scale``
QUANT_SCALE_SUFFIX = "@quant_scale"
#: int8 bins: q = round(w / scale * 127)
QUANT_BINS = 127

#: ops kept whatever reaches them (side effects without the _host attr)
_SIDE_EFFECT_TYPES = frozenset({"print", "py_func"})

#: activations the matmul fusion absorbs (attr-free unary ops)
_FUSABLE_ACTS = frozenset({"relu", "sigmoid", "tanh", "gelu"})
_MATMUL_TYPES = ("mul", "matmul")


def _fused_matmul_compute(ins, attrs):
    """x @ dequant(w) (+ bias) (+ act): a kernel inside its contract, else
    the composition of the ops the passes replaced (opt_passes.py:90-134),
    the int8 weight dequantized per output channel first."""
    fast = try_fused_matmul(ins, attrs)
    if fast is not None:
        return {"Out": [fast]}
    xs = list(ins["X"])
    x, w = xs[0], xs[1]
    i = 2
    quant = attrs.get("quant")
    if quant == "int8":
        w = w.float() * (xs[i] / float(QUANT_BINS))
        i += 1
    elif quant == "bf16":
        w = w.float()
    out = getattr(_m, attrs["mm_type"])(x, w, **attrs.get("mm_attrs", {}))
    if attrs.get("has_bias"):
        out = _m.elementwise_add(out, xs[i], axis=attrs.get("bias_axis", -1))
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
    """Region id per op index: host ops and the autodiff marker are
    barriers (fusing across one would move work across the host or in or
    out of the differentiated prefix)."""
    rid, out = 0, []
    for op in ops:
        barrier = op.type == "autodiff" or bool(op.attrs.get("_host"))
        if barrier:
            rid += 1
        out.append(rid)
        if barrier:
            rid += 1
    return out


def _has_program_attr(op):
    """Control-flow ops hold sub-Programs in attrs: opaque to value
    rewrites."""
    return any(isinstance(v, Program) for v in op.attrs.values())


def _rewire(block, old, new, skip_ops=()):
    """Point every reader of var ``old`` at ``new``."""
    for op in block.ops:
        if op in skip_ops:
            continue
        for slot, names in op.inputs.items():
            if old in names:
                op.inputs[slot] = [new if n == old else n for n in names]


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


def _last_read(cons, name, at):
    return max((k for k, _ in cons.get(name, ())), default=at)


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------
class ConstantFoldingPass(ProgramPass):
    """Evaluate the ops whose inputs are all program constants (literals or
    earlier folds) and record their outputs as constants
    (opt_passes.py:246-311). ``targets`` is taken for the pipeline's
    uniformity: a folded fetch target is still fetched, from the run's
    constants."""

    name = "constant_fold"

    def __init__(self, targets=(), max_elements=1 << 22):
        self.targets = set(targets)
        self.max_elements = int(max_elements)

    def apply(self, program):
        from paddle_tpu_torch.static.executor import exec_op
        blk = program.global_block()
        consts = dict(program._constants)
        wcounts = _write_counts(blk)
        kept = []
        for op in blk.ops:
            if (op.type == "autodiff" or op.attrs.get("_host")
                    or op.attrs.get("_needs_rng")
                    or op.type in _SIDE_EFFECT_TYPES
                    or _has_program_attr(op)):
                kept.append(op)
                continue
            ins, outs = op.input_names(), op.output_names()
            if (not outs or not all(n in consts for n in ins)
                    or any(wcounts.get(n, 0) != 1 for n in outs)
                    or any(blk.has_var(n) and blk.vars[n].persistable
                           for n in outs)):
                kept.append(op)
                continue
            try:
                with torch.no_grad():
                    bound = exec_op(op, consts, None)
            except Exception:
                kept.append(op)       # not evaluable at once: leave it
                continue
            bound = {n: torch.as_tensor(v) for n, v in bound.items()}
            if sum(v.numel() for v in bound.values()) > self.max_elements:
                kept.append(op)
                continue
            consts.update(bound)
        if len(kept) != len(blk.ops):
            blk.ops = kept
            program._constants = consts
            program._bump()
        return program


class FoldScaleCastChainPass(ProgramPass):
    """scale -> scale chains compose into one scale op; identity scales
    (x * 1 + 0) and identity casts (to the input var's dtype) drop, their
    readers rewired (opt_passes.py:314-402)."""

    name = "fold_scale_cast"

    def __init__(self, targets=()):
        self.targets = set(targets)

    @staticmethod
    def _affine(attrs):
        """(a, c) with y = a * x + c for one scale op."""
        s = float(attrs.get("scale", 1.0))
        b = float(attrs.get("bias", 0.0))
        if attrs.get("bias_after_scale", True):
            return s, b
        return s, b * s

    def apply(self, program):
        blk = program.global_block()
        prot = _protected_names(blk, self.targets)
        changed = True
        while changed:
            changed = False
            wcounts = _write_counts(blk)
            cons = _consumer_map(blk)
            widx = _write_indices(blk)
            drop = set()
            for i, op in enumerate(blk.ops):
                if id(op) in drop or op.type not in ("scale", "cast"):
                    continue
                src, out = op.inputs["X"][0], op.outputs["Out"][0]
                if op.type == "scale":
                    nxt = _single_consumer(cons, out, wcounts)
                    if (nxt is not None and nxt[1].type == "scale"
                            and out not in prot and id(nxt[1]) not in drop
                            and not _written_between(widx, src, i, nxt[0])):
                        a1, c1 = self._affine(op.attrs)
                        a2, c2 = self._affine(nxt[1].attrs)
                        nxt[1].inputs["X"] = list(op.inputs["X"])
                        nxt[1].attrs = {"scale": a1 * a2,
                                        "bias": c1 * a2 + c2,
                                        "bias_after_scale": True}
                        drop.add(id(op))
                        changed = True
                        continue
                    a, c = self._affine(op.attrs)
                    if (a == 1.0 and c == 0.0 and out not in prot
                            and wcounts.get(out, 0) == 1
                            and not _written_between(
                                widx, src, i, _last_read(cons, out, i))):
                        _rewire(blk, out, src, skip_ops=(op,))
                        drop.add(id(op))
                        changed = True
                    continue
                v = blk.vars.get(src)
                if (v is None or v.dtype is None or out in prot
                        or wcounts.get(out, 0) != 1
                        or _written_between(widx, src, i,
                                            _last_read(cons, out, i))):
                    continue
                try:
                    same = convert_dtype(op.attrs.get("dtype")) == v.dtype
                except Exception:
                    continue
                if same:
                    _rewire(blk, out, src, skip_ops=(op,))
                    drop.add(id(op))
                    changed = True
            if drop:
                blk.ops = [o for o in blk.ops if id(o) not in drop]
                program._bump()
        return program


class CancelTransposeReshapePass(ProgramPass):
    """transpose o transpose and reshape o reshape chains cancel or
    collapse; identity transposes (perm == iota) and identity reshapes (a
    static target shape equal to the static input shape) drop
    (opt_passes.py:405-510)."""

    name = "cancel_transpose_reshape"

    def __init__(self, targets=()):
        self.targets = set(targets)

    def apply(self, program):
        blk = program.global_block()
        prot = _protected_names(blk, self.targets)
        changed = True
        while changed:
            changed = False
            wcounts = _write_counts(blk)
            cons = _consumer_map(blk)
            widx = _write_indices(blk)
            drop = set()
            for i, op in enumerate(blk.ops):
                if id(op) in drop:
                    continue
                if op.type == "transpose":
                    changed |= self._transpose(blk, i, op, prot, wcounts,
                                               cons, widx, drop)
                elif op.type == "reshape":
                    changed |= self._reshape(blk, i, op, prot, wcounts,
                                             cons, widx, drop)
            if drop:
                blk.ops = [o for o in blk.ops if id(o) not in drop]
                program._bump()
        return program

    @staticmethod
    def _transpose(blk, i, op, prot, wcounts, cons, widx, drop):
        src, out = op.inputs["X"][0], op.outputs["Out"][0]
        perm = [int(p) for p in op.attrs.get("perm", [])]
        if out in prot or wcounts.get(out, 0) != 1:
            return False
        if perm == list(range(len(perm))):
            if _written_between(widx, src, i, _last_read(cons, out, i)):
                return False
            _rewire(blk, out, src, skip_ops=(op,))
            drop.add(id(op))
            return True
        nxt = _single_consumer(cons, out, wcounts)
        if nxt is None or nxt[1].type != "transpose" or id(nxt[1]) in drop:
            return False
        perm2 = [int(p) for p in nxt[1].attrs.get("perm", [])]
        out2 = nxt[1].outputs["Out"][0]
        if len(perm2) != len(perm) or out2 in prot \
                or wcounts.get(out2, 0) != 1:
            return False
        composed = [perm[p] for p in perm2]
        if composed == list(range(len(perm))):
            # both cancel: the readers of out2 read src
            if _written_between(widx, src, i,
                                _last_read(cons, out2, nxt[0])):
                return False
            _rewire(blk, out2, src, skip_ops=(op, nxt[1]))
            drop.add(id(op))
            drop.add(id(nxt[1]))
        else:
            # one transpose at the second op's place, reading src there
            if _written_between(widx, src, i, nxt[0]):
                return False
            nxt[1].inputs["X"] = [src]
            nxt[1].attrs = dict(nxt[1].attrs)
            nxt[1].attrs["perm"] = composed
            drop.add(id(op))
        return True

    @staticmethod
    def _reshape(blk, i, op, prot, wcounts, cons, widx, drop):
        src, out = op.inputs["X"][0], op.outputs["Out"][0]
        if out in prot or wcounts.get(out, 0) != 1:
            return False
        v_in = blk.vars.get(src)
        shape = [int(s) for s in op.attrs.get("shape", [])]
        if (v_in is not None and v_in.shape is not None
                and all(d not in (-1, None) for d in v_in.shape)
                and shape == [int(d) for d in v_in.shape]):
            # an identity reshape (static on both sides)
            if _written_between(widx, src, i, _last_read(cons, out, i)):
                return False
            _rewire(blk, out, src, skip_ops=(op,))
            drop.add(id(op))
            return True
        nxt = _single_consumer(cons, out, wcounts)
        if nxt is None or nxt[1].type != "reshape" or id(nxt[1]) in drop \
                or _written_between(widx, src, i, nxt[0]):
            return False
        # a 0 in the second shape copies ITS input's dim: collapsing would
        # re-anchor it on another input
        if any(int(s) == 0 for s in nxt[1].attrs.get("shape", [])):
            return False
        nxt[1].inputs["X"] = [src]
        drop.add(id(op))
        return True


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
    state, a host or side-effect op, nor the autodiff marker
    (opt_passes.py:623-660)."""

    name = "dead_op_elim"

    def __init__(self, targets=()):
        self.targets = set(targets)

    def apply(self, program):
        blk = program.global_block()
        needed = set(self.targets)
        kept = []
        for op in reversed(blk.ops):
            keep = (op.type == "autodiff" or bool(op.attrs.get("_host"))
                    or op.type in _SIDE_EFFECT_TYPES
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

    def as_dict(self):
        return {"ops_before": self.ops_before, "ops_after": self.ops_after,
                "ops_removed": self.ops_removed(),
                "per_pass": [dict(p) for p in self.per_pass]}


def default_pipeline(targets=()):
    """The JAX package's pass order (opt_passes.py:682-693): folding first
    (it orphans producers), the scale/cast and transpose/reshape cleanups
    next (they expose adjacent chains), fusion on the canonical chains,
    dead-op elimination last (it sweeps what the others orphaned)."""
    return PassManager([ConstantFoldingPass(targets),
                        FoldScaleCastChainPass(targets),
                        CancelTransposeReshapePass(targets),
                        FuseMatmulBiasActPass(targets),
                        DeadOpEliminationPass(targets)])


def optimize_program(program, targets=(), pipeline=None, record=True,
                     cost_probe=None):
    """Clone ``program``, run the pass pipeline against ``targets`` (the
    step's fetch names), publish per-pass evidence through
    ``monitor/cost.py`` (``record``) and return ``(optimized_program,
    report)``. The input program is never mutated.

    ``cost_probe`` (optional, ``FLAGS_pass_cost_evidence``): a callable
    ``prog -> {"flops", "bytes"} | None`` (the Executor's is the cost
    monitor's abstract pass on meta copies of the step's state and feeds).
    When given, it runs before the pipeline and after every pass; each
    pass's predicted delta (negative = cheaper) lands in its
    ``report.per_pass`` row and the ``program_pass_flops_delta`` /
    ``program_pass_bytes_delta`` gauges. A probe that raises disables
    probing, never the pipeline."""
    from paddle_tpu_torch.monitor import cost as _cost

    prog = program.clone()
    pm = pipeline or default_pipeline(targets)
    report = PipelineReport()
    report.ops_before = len(prog.global_block().ops)

    def _probe(p):
        nonlocal cost_probe
        if cost_probe is None:
            return None
        try:
            return cost_probe(p)
        except Exception:
            cost_probe = None
            return None

    cost0 = _probe(prog)
    for p in pm.passes:
        n0 = len(prog.global_block().ops)
        t0 = time.perf_counter()
        out = p.apply(prog)
        ms = (time.perf_counter() - t0) * 1e3
        prog = out if out is not None else prog
        n1 = len(prog.global_block().ops)
        pm.applied.append(p.name)
        row = {"pass": p.name, "ops_before": n0, "ops_after": n1,
               "ops_removed": n0 - n1, "ms": ms}
        flops_d = bytes_d = None
        if cost0 is not None:
            cost1 = _probe(prog)
            if cost1 is not None:
                flops_d = cost1["flops"] - cost0["flops"]
                bytes_d = cost1["bytes"] - cost0["bytes"]
                row["flops_delta"] = flops_d
                row["bytes_delta"] = bytes_d
                cost0 = cost1
        report.per_pass.append(row)
        if record:
            _cost.record_pass(p.name, ops_removed=n0 - n1, ms=ms,
                              flops_delta=flops_d, bytes_delta=bytes_d)
    # keep only the constants a surviving op (or fetch target) still reads
    live = set(targets)
    for op in prog.global_block().ops:
        live.update(op.input_names())
    prog._constants = {k: v for k, v in prog._constants.items() if k in live}
    report.ops_after = len(prog.global_block().ops)
    return prog, report


def optimize_for_execution(program, fetch_names, cost_probe=None):
    """The Executor's entry: optimize against the step's fetch list."""
    return optimize_program(program, targets=tuple(fetch_names),
                            cost_probe=cost_probe)[0]


def optimize_inference(program, fetch_names):
    """The export/serving entry: the same pipeline, under its own name as
    in the JAX package."""
    return optimize_program(program, targets=tuple(fetch_names))[0]


# ---------------------------------------------------------------------------
# weight-only post-training quantization (export_aot, the serving boot)
# ---------------------------------------------------------------------------
def _mm_weight_slot(op):
    """The weight var name if ``op`` consumes its RHS in a quantizable way
    ([in, out] layout, no transpose), else None."""
    xs = op.inputs.get("X", [])
    if op.type in _MATMUL_TYPES:
        if len(xs) != 2 or xs[0] == xs[1]:
            return None
        if op.type == "matmul" and op.attrs.get("transpose_y"):
            return None
        if op.type == "mul" and op.attrs.get("y_num_col_dims", 1) != 1:
            return None
        return xs[1]
    if op.type == FUSED_MATMUL:
        # a self-product: only the RHS is dequantized, so quantizing the
        # shared operand would feed the LHS raw int8
        if len(xs) < 2 or xs[0] == xs[1] or op.attrs.get("quant"):
            return None
        mm_attrs = op.attrs.get("mm_attrs", {})
        if op.attrs.get("mm_type") == "matmul" \
                and mm_attrs.get("transpose_y"):
            return None
        if op.attrs.get("mm_type") == "mul" \
                and mm_attrs.get("y_num_col_dims", 1) != 1:
            return None
        return xs[1]
    return None


def _check_mode(mode):
    enforce(mode in ("int8", "bf16"),
            f"quantize mode must be 'int8' or 'bf16', got {mode!r}")


def plan_weight_quant(program, values, mode):
    """Names of the weights eligible for weight-only PTQ: persistable 2-D
    float32 vars written by no op and read only as the RHS of
    matmul/mul/fused_matmul ops in [in, out] layout. ``values`` maps names
    to their trained tensors or arrays. Returns a sorted name list."""
    _check_mode(mode)
    blk = program.global_block()
    written = {n for op in blk.ops for n in op.output_names()}
    cons = _consumer_map(blk)
    eligible = []
    for name, var in blk.vars.items():
        if not var.persistable or name in written:
            continue
        v = values.get(name)
        if v is None:
            continue
        v = torch.as_tensor(v)
        if v.dim() != 2 or v.dtype != torch.float32 or not v.numel():
            continue
        readers = [op for _, op in cons.get(name, ())]
        if readers and all(_mm_weight_slot(op) == name for op in readers):
            eligible.append(name)
    return sorted(eligible)


def apply_weight_quant(program, weights, mode):
    """Clone ``program`` with each weight in ``weights`` retyped to its
    quantized storage dtype and every consuming matmul rewritten to a
    ``fused_matmul`` carrying the dequant (int8: plus a per-channel
    ``<w>@quant_scale`` persistable input). The serving boot applies the
    list the AOT manifest recorded and never re-derives eligibility, so a
    program/manifest mismatch raises here."""
    _check_mode(mode)
    prog = program.clone()
    blk = prog.global_block()
    wset = set(weights)
    missing = sorted(n for n in wset if n not in blk.vars)
    enforce(not missing,
            f"quantized weight(s) {missing[:3]} not in program: the quant "
            f"manifest does not match this model; re-export")
    for w in sorted(wset):
        var = blk.vars[w]
        enforce(var.shape is not None and len(var.shape) == 2,
                f"quantized weight {w!r} is not 2-D in this program")
        var.dtype = torch.int8 if mode == "int8" else torch.bfloat16
        if mode == "int8":
            sv = blk.create_var(name=w + QUANT_SCALE_SUFFIX,
                                shape=[int(var.shape[1])], dtype="float32")
            sv.persistable = True
    rewritten = 0
    for op in blk.ops:
        target = _mm_weight_slot(op)
        if target is None or target not in wset:
            bad = sorted(set(op.input_names()) & wset)
            if bad:
                raise EnforceNotMet(
                    f"op {op.type!r} reads quantized weight {bad[0]!r} in a "
                    f"non-dequantizable position: the quant manifest does "
                    f"not match this model; re-export")
            continue
        xs = list(op.inputs["X"])
        new_xs, tail = xs[:2], xs[2:]
        if op.type in _MATMUL_TYPES:
            mm_attrs = {k: v for k, v in op.attrs.items()
                        if k != "name" and v is not None}
            op.attrs = {"mm_type": op.type, "mm_attrs": mm_attrs,
                        "has_bias": False, "quant": mode}
            op.type = FUSED_MATMUL
        else:                       # already fused_matmul
            op.attrs = dict(op.attrs)
            op.attrs["quant"] = mode
        if mode == "int8":
            new_xs.append(target + QUANT_SCALE_SUFFIX)
        new_xs.extend(tail)         # bias rides after the scale
        op.inputs["X"] = new_xs
        rewritten += 1
    enforce(rewritten > 0 or not wset,
            "quant rewrite matched no consuming matmul op")
    prog._bump()
    return prog


def quantize_weight_values(values, weights, mode):
    """{name: quantized CPU tensor} (plus ``<name>@quant_scale`` float32
    tables for int8): per-output-channel abs-max over the [in, out]
    weight's columns (``fake_channel_wise_quantize_abs_max`` at
    quant_axis=1), q = round_half_even(w / scale * 127) clipped to
    [-128, 127]; bf16 rounds to nearest even."""
    _check_mode(mode)
    out = {}
    for w in weights:
        v = torch.as_tensor(values[w]).detach().to("cpu", torch.float32)
        if mode == "bf16":
            out[w] = v.to(torch.bfloat16)
            continue
        scale = v.abs().amax(dim=0)                     # [out] channels
        safe = scale.clamp_min(1e-12)
        out[w] = torch.round(v / safe[None, :] * QUANT_BINS).clamp(
            -QUANT_BINS - 1, QUANT_BINS).to(torch.int8)
        out[w + QUANT_SCALE_SUFFIX] = scale
    return out
