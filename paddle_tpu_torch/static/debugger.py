"""Program introspection: pretty printer, graphviz export, memory estimate;
the port of ``paddle_tpu/static/debugger.py``.

Parity targets: python/paddle/fluid/debugger.py (draw_block_graphviz,
pprint_program_codes), net_drawer.py / graphviz.py (op graph rendering),
the ir graph_viz_pass.cc (dot export of the IR graph), and
contrib/memory_usage_calc.py (per-program memory estimate).

The text and the dot source are the JAX package's, character for
character, on the same program (dtypes print by name, ``float32``). The
dot output needs no graphviz binding: it is plain text for ``dot -Tpng``;
vars are ellipses, ops boxes, parameters doubled ellipses.
"""

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.static.program import Parameter, default_main_program

__all__ = ["pprint_program", "draw_graph", "memory_usage"]


def _fmt_shape(shape):
    return "x".join("?" if s in (None, -1) else str(s)
                    for s in (shape or ()))


def pprint_program(program=None, show_vars=True):
    """debugger.pprint_program_codes parity: a readable dump of every
    block's vars and ops. Returns the string (and prints nothing)."""
    program = program or default_main_program()
    lines = []
    for blk in program.blocks:
        lines.append(f"-- block {blk.idx} (parent {blk.parent_idx}) --")
        if show_vars:
            for name, v in sorted(blk.vars.items()):
                kind = ("param" if isinstance(v, Parameter)
                        else "data" if v.is_data else "var")
                persist = " persistable" if v.persistable else ""
                lines.append(f"  {kind:6s} {name}: {_fmt_shape(v.shape)} "
                             f"{dtype_name(v.dtype)}{persist}")
        for i, op in enumerate(blk.ops):
            ins = ", ".join(f"{k}={v}" for k, v in op.inputs.items())
            outs = ", ".join(f"{k}={v}" for k, v in op.outputs.items())
            lines.append(f"  [{i:3d}] {op.type}({ins}) -> {outs}")
    return "\n".join(lines)


def draw_graph(program=None, path=None, graph_name="program"):
    """Graphviz dot source of the op/var dependency graph
    (draw_block_graphviz / graph_viz_pass.cc parity). Writes it to
    ``path`` if given; always returns the text."""
    program = program or default_main_program()
    blk = program.global_block()
    out = [f"digraph {graph_name} {{", "  rankdir=TB;"]

    def vid(name):
        return f"var_{name}".replace(".", "_").replace("@", "_AT_")

    drawn = set()

    def draw_var(name):
        if name in drawn:
            return
        drawn.add(name)
        v = blk.vars.get(name)
        if isinstance(v, Parameter):
            style = "shape=ellipse, peripheries=2, color=darkgreen"
        elif v is not None and v.is_data:
            style = "shape=ellipse, color=blue"
        else:
            style = "shape=ellipse"
        label = name if v is None else f"{name}\\n{_fmt_shape(v.shape)}"
        out.append(f'  {vid(name)} [label="{label}", {style}];')

    for i, op in enumerate(blk.ops):
        oid = f"op_{i}"
        out.append(f'  {oid} [label="{op.type}", shape=box, '
                   f'style=filled, fillcolor=lightgrey];')
        for name in op.input_names():
            draw_var(name)
            out.append(f"  {vid(name)} -> {oid};")
        for name in op.output_names():
            draw_var(name)
            out.append(f"  {oid} -> {vid(name)};")
    out.append("}")
    text = "\n".join(out)
    if path:
        with open(path, "w") as f:
            f.write(text)
    return text


def memory_usage(program=None, batch_size=1):
    """contrib/memory_usage_calc.py parity: a (lower, upper) estimate in
    bytes of the program's tensors at ``batch_size``, read for every -1 or
    None dim. The band is +/-30%, as the reference reports it: activation
    reuse and gradient doubling are unknown before a run."""
    program = program or default_main_program()
    total = 0
    for blk in program.blocks:
        for v in blk.vars.values():
            if not v.shape:
                continue
            n = 1
            for s in v.shape:
                n *= batch_size if s in (None, -1) else int(s)
            total += n * v.dtype.itemsize
    return int(total * 0.7), int(total * 1.3)
