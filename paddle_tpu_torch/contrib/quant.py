"""The quantization toolkit: the port of ``paddle_tpu/contrib/quant.py``
(contrib/slim/quantization/quantization_pass.py, contrib/quantize/
quantize_transpiler.py): quantization-aware training by program rewriting,
activation calibration, the int8 freeze and post-training quantization.

- :class:`QuantizeTranspiler` inserts ``fake_quantize_dequantize_abs_max``
  (abs-max, 8 bits by default) before every tensor input of every
  quantizable op (``mul``, ``matmul``, ``conv2d``, ``depthwise_conv2d``):
  ``{name}.quant_dequant`` and ``{name}.quant_scale`` vars, weights and
  activations alike. Gradients pass through the straight-through round
  (``ops/quantize.py``).
- :func:`calibrate_activations` fetches every activation feeding a
  quantizable op over sample batches: ``abs_max`` (the max over batches)
  or ``moving_average_abs_max`` (an EMA of the batch maxima).
- :class:`QuantizationFreezePass` strips the fake-quant ops, quantizes each
  trained weight to integers in the scope (abs-max of its value; int8
  tensors on the weight's device) and rewrites each quantizable op into
  ``quantized_mul`` / ``quantized_conv2d`` with the weight and activation
  scales as attrs. It plans every op before changing anything, so a
  missing activation scale raises before any weight is converted; it
  leaves float what the integer kernels cannot express (a transposed
  matmul, a weight-first matmul, a weight another float op reads) and sets
  ``groups`` of a ``depthwise_conv2d`` from its weight's shape.
- :class:`ConvertToInt8Pass` converts the weights' storage only.
- :func:`fake_quant_params`, :func:`post_training_quantize` and
  :func:`dequantize_params` act on the port's parameter trees (nested
  dicts and lists of tensors, ``core/tree.py``) where the JAX package's act
  on pytrees; the ``treedef`` is the tree of leaf positions.

The passes are written on ``static/passes.py`` (``BlockRewriter``,
``match_ops``).
"""

from paddle_tpu_torch.core.tree import leaves, map_tree
from paddle_tpu_torch.ops import quantize as Q
from paddle_tpu_torch.static.passes import (BlockRewriter, ProgramPass,
                                            match_ops)

__all__ = ["QuantizeTranspiler", "fake_quant_params",
           "post_training_quantize", "dequantize_params",
           "calibrate_activations", "QuantizationFreezePass",
           "ConvertToInt8Pass", "quantize_program_int8"]

_QUANTIZABLE = ("mul", "matmul", "conv2d", "depthwise_conv2d")


def _abs_max(t):
    """max |t| as a Python float (0 for an empty tensor)."""
    return float(t.abs().max()) if t.numel() else 0.0


def _quantize_weight_in_scope(scope, name, bits):
    """Abs-max quantize a scope weight to integer storage in place (on its
    device); returns the fp32 scale."""
    var = scope.find_var(name)
    if var is None:
        raise KeyError(f"weight {name!r} not initialized in scope")
    w = Q._t(var).float()
    scale = _abs_max(w)
    scope.set_var(name, Q.quantize_linear(w, max(scale, 1e-12),
                                          bit_length=bits))
    return scale


class QuantizeTranspiler(ProgramPass):
    """Insert fake quant-dequant ops before every quantizable op's tensor
    inputs (QuantizationTransformPass with abs_max weights and
    activations)."""

    name = "quantize_transform"

    def __init__(self, weight_bits=8, activation_bits=8,
                 quantizable_op_type=_QUANTIZABLE):
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.op_types = tuple(quantizable_op_type)

    def apply(self, program):
        rw = BlockRewriter(program)
        blk = rw.block
        quantized = {}       # var name -> its quant-dequant output's name
        for i, op in match_ops(program, self.op_types):
            for slot, names in op.inputs.items():
                rewritten = []
                for name in names:
                    if name not in quantized:
                        var = blk.vars.get(name)
                        is_w = var is not None and var.persistable
                        bits = (self.weight_bits if is_w
                                else self.activation_bits)
                        qname = f"{name}.quant_dequant"
                        rw.create_var(
                            qname,
                            shape=var.shape if var is not None else None,
                            dtype=var.dtype if var is not None
                            else "float32")
                        rw.create_var(f"{name}.quant_scale", shape=[],
                                      dtype="float32")
                        rw.insert_before(i, rw.make_op(
                            "fake_quantize_dequantize_abs_max",
                            inputs={"X": [name]},
                            outputs={"Out": [qname,
                                             f"{name}.quant_scale"]},
                            attrs={"bit_length": bits}))
                        quantized[name] = qname
                    rewritten.append(quantized[name])
                op.inputs[slot] = rewritten
        return rw.commit()

    # the reference's name
    transpile = apply


def fake_quant_params(params, bit_length=8, channel_wise=False):
    """Eager QAT: quant-dequant every weight leaf of a parameter tree (the
    straight-through gradient flows); 0-d leaves pass. Call it inside the
    loss: ``loss_fn(fake_quant_params(params), ...)``."""
    def qd(_, p):
        if p.dim() == 0:
            return p
        if channel_wise and p.dim() >= 2:
            return Q.fake_channel_wise_quantize_dequantize_abs_max(
                p, bit_length=bit_length)[0]
        return Q.fake_quantize_dequantize_abs_max(p,
                                                  bit_length=bit_length)[0]
    return map_tree(qd, params)


def post_training_quantize(params, bit_length=8):
    """Weight-only abs-max PTQ of a parameter tree: ([(integer tensor, fp32
    scale)] in leaf order, treedef), the integers' width following
    ``bit_length``."""
    quantized = []
    for p in leaves(params):
        p = Q._t(p).detach().float()
        scale = _abs_max(p)
        quantized.append((Q.quantize_linear(p, scale, bit_length=bit_length),
                          scale))
    count = iter(range(len(quantized)))
    treedef = map_tree(lambda _, __: next(count), params)
    return quantized, treedef


def dequantize_params(quantized, treedef, bit_length=8):
    """The inverse of :func:`post_training_quantize`."""
    return map_tree(lambda _, i: Q.dequantize_linear(
        quantized[i][0], max(quantized[i][1], 1e-12),
        bit_length=bit_length), treedef)


def calibrate_activations(exe, program, feed_batches, scope=None,
                          quantizable_op_type=_QUANTIZABLE,
                          strategy="abs_max", moving_rate=0.9):
    """Activation ranges from sample batches: runs ``program`` over
    ``feed_batches`` fetching every activation (non-persistable var) that
    feeds a quantizable op, and returns {var name: scale}: the max |x| over
    the batches (``abs_max``) or the EMA of the batch maxima
    (``moving_average_abs_max``)."""
    from paddle_tpu_torch.static.executor import global_scope
    scope = scope or global_scope()
    blk = program.global_block()
    act_names = []
    for op in blk.ops:
        if op.type not in quantizable_op_type:
            continue
        for names in op.inputs.values():
            for name in names:
                base = name.split(".quant_dequant")[0]
                var = blk.vars.get(base)
                if var is not None and var.persistable:
                    continue          # weights calibrate from their values
                if base not in act_names:
                    act_names.append(base)
    scales = {}
    for feed in feed_batches:
        # each batch's max |x| is taken on the executor's device: only the
        # numbers cross to the host
        vals = exe.run(program, feed=feed, fetch_list=act_names,
                       scope=scope, return_numpy=False)
        for name, v in zip(act_names, vals):
            m = _abs_max(v)
            if strategy == "moving_average_abs_max":
                prev = scales.get(name)
                scales[name] = m if prev is None else (
                    moving_rate * prev + (1 - moving_rate) * m)
            else:
                scales[name] = max(scales.get(name, 0.0), m)
    return scales


class QuantizationFreezePass(ProgramPass):
    """Freeze a fake-quant (QAT) or plain program into an int8 inference
    program: strip the fake quant-dequant ops, quantize each trained
    weight to integers in the scope, rewrite each quantizable op into its
    integer op carrying the weight scale and the calibrated activation
    scale (``act_scales``: original activation name -> range, see
    :func:`calibrate_activations`)."""

    name = "quantization_freeze"
    _REWRITE = {"mul": "quantized_mul", "matmul": "quantized_mul",
                "conv2d": "quantized_conv2d",
                "depthwise_conv2d": "quantized_conv2d"}
    # the attrs each integer op takes: any other attr keeps the op float
    _KERNEL_ATTRS = {
        "quantized_mul": {"x_num_col_dims"},
        "quantized_conv2d": {"stride", "padding", "dilation", "groups",
                             "data_format"},
    }
    # attr values that are the integer op's default: dropped
    _DROPPABLE_DEFAULTS = {"y_num_col_dims": 1, "transpose_x": False,
                           "transpose_y": False, "alpha": 1.0,
                           "name": None}

    def __init__(self, scope=None, weight_bits=8, activation_bits=8,
                 act_scales=None):
        self.scope = scope
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.act_scales = dict(act_scales or {})
        self.weight_scales = {}

    def _base(self, name):
        return name.split(".quant_dequant")[0]

    def _plan_op(self, op, blk, scope):
        """How one quantizable op freezes, changing nothing: (kernel,
        attrs, activation name, weight name), or None to leave it float."""
        kernel = self._REWRITE[op.type]
        attrs, unsupported = {}, False
        for k, v in op.attrs.items():
            if k in self._KERNEL_ATTRS[kernel]:
                attrs[k] = v
            elif (k in self._DROPPABLE_DEFAULTS
                  and v == self._DROPPABLE_DEFAULTS[k]):
                pass
            else:
                unsupported = True    # e.g. transpose_y=True
        bases = [self._base(n) for names in op.inputs.values()
                 for n in names]

        def is_weight(base):
            var = blk.vars.get(base)
            return var is not None and var.persistable
        # the integer ops compute act @ weight: a weight-first product stays
        # float rather than being reordered
        if (unsupported or len(bases) != 2 or is_weight(bases[0])
                or not is_weight(bases[1])):
            return None
        act_name, w_name = bases
        if op.type == "depthwise_conv2d":
            # the float op's groups are the channels: only the multiplier-1
            # filter (C, 1, kh, kw) tells them
            w_shape = tuple(scope.find_var(w_name).shape)
            if len(w_shape) == 4 and w_shape[1] == 1:
                attrs["groups"] = int(w_shape[0])
            else:
                return None
        if act_name not in self.act_scales:
            raise KeyError(
                f"no calibrated scale for activation {act_name!r} "
                f"feeding {op.type} — run calibrate_activations over "
                f"sample batches first")
        return kernel, attrs, act_name, w_name

    def apply(self, program):
        from paddle_tpu_torch.static.executor import global_scope
        scope = self.scope or global_scope()
        rw = BlockRewriter(program)
        blk = rw.block
        # plan every op first: a missing scale raises before any weight in
        # the scope is converted
        plans = {i: self._plan_op(op, blk, scope)
                 for i, op in match_ops(program, tuple(self._REWRITE))}
        # a weight freezes only when every op still reading it freezes
        # with it: a float reader would get integers with no dequantize
        float_read = set()
        for i, op in enumerate(blk.ops):
            if op.type == "fake_quantize_dequantize_abs_max":
                continue              # stripped below
            plan = plans.get(i)
            frozen_w = plan[3] if plan is not None else None
            for n in op.input_names():
                if self._base(n) != frozen_w:
                    float_read.add(self._base(n))
        for i, plan in list(plans.items()):
            if plan is not None and plan[3] in float_read:
                plans[i] = None
        for i, op in enumerate(blk.ops):
            if op.type == "fake_quantize_dequantize_abs_max":
                rw.remove(i)
            elif plans.get(i) is not None:
                kernel, attrs, act_name, w_name = plans[i]
                w_scale = self._freeze_weight(scope, w_name)
                attrs["x_scale"] = float(self.act_scales[act_name])
                attrs["w_scale"] = float(w_scale)
                attrs["bit_length"] = self.activation_bits
                if self.weight_bits != self.activation_bits:
                    attrs["w_bit_length"] = self.weight_bits
                rw.replace(i, rw.make_op(
                    kernel, inputs={"X": [act_name, w_name]},
                    outputs=dict(op.outputs), attrs=attrs))
            else:
                # a float op: its quant-dequant reads go back to the base
                for slot, names in op.inputs.items():
                    op.inputs[slot] = [self._base(n) for n in names]
        return rw.commit()

    def _freeze_weight(self, scope, name):
        if name not in self.weight_scales:
            self.weight_scales[name] = _quantize_weight_in_scope(
                scope, name, self.weight_bits)
        return self.weight_scales[name]


class ConvertToInt8Pass(ProgramPass):
    """Storage-only conversion (ConvertToInt8Pass): every persistable
    weight a quantizable op reads becomes integers in the scope; no op is
    rewritten. Returns {weight: scale}."""

    name = "convert_to_int8"

    def __init__(self, scope=None, weight_bits=8,
                 quantizable_op_type=_QUANTIZABLE):
        self.scope = scope
        self.weight_bits = weight_bits
        self.op_types = tuple(quantizable_op_type)

    def apply(self, program):
        from paddle_tpu_torch.static.executor import global_scope
        scope = self.scope or global_scope()
        blk = program.global_block()
        scales = {}
        for _, op in match_ops(program, self.op_types):
            for name in op.input_names():
                var = blk.vars.get(name)
                if var is None or not var.persistable or name in scales:
                    continue
                scales[name] = _quantize_weight_in_scope(scope, name,
                                                         self.weight_bits)
        return scales


def quantize_program_int8(exe, program, feed_batches, scope=None,
                          weight_bits=8, activation_bits=8,
                          quantizable_op_type=_QUANTIZABLE,
                          strategy="abs_max"):
    """Post-training int8 in one call: calibrate the activation ranges
    over ``feed_batches``, then freeze ``program`` (rewritten in place and
    returned). Takes a plain fp32 program or a QAT-transpiled one."""
    scales = calibrate_activations(
        exe, program, feed_batches, scope=scope,
        quantizable_op_type=quantizable_op_type, strategy=strategy)
    return QuantizationFreezePass(
        scope=scope, weight_bits=weight_bits,
        activation_bits=activation_bits, act_scales=scales).apply(program)
