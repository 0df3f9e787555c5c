"""Structural (no-pickle) program serialization: the port of
``paddle_tpu/static/serialize.py``.

It reads and writes the same schema'd JSON documents (``FORMAT_VERSION`` 1)
as the JAX package, so a model directory written by either package loads in
both:

- ops are (type, input slots, output slots, attrs), attrs encoded
  structurally with tagged nodes for tuples, arrays, dtypes, nested Programs
  and framework objects (``{"__obj__": "paddle_tpu.<mod>:<Cls>", "state":
  {...}}``, rebuilt by ``__new__`` + ``__dict__.update``, never by calling
  user code);
- the document format belongs to the framework, not to a package: an object
  of the port's ``paddle_tpu_torch.<mod>`` is written under the name
  ``paddle_tpu.<mod>``, and a ``paddle_tpu.<mod>:<Cls>`` node is rebuilt as
  the port's class of the same module and name. Any other module is refused
  (:class:`SerializationError`), and so is a class the port lacks yet;
- dtypes decode to torch dtypes (``"bfloat16"`` to ``torch.bfloat16``),
  program constants to CPU tensors, array attrs to numpy arrays (a bfloat16
  one to a CPU tensor: numpy has no bfloat16).

``program_fingerprint`` hashes the document, so a program loaded from a JAX
package's ``__model__`` has the JAX package's fingerprint, and the AOT
index's ``program_hash`` matches in both.
"""

import base64
import hashlib
import importlib
import json

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import EnforceNotMet

__all__ = [
    "SerializationError", "encode_value", "decode_value",
    "program_to_dict", "program_from_dict", "dumps_program",
    "loads_program", "program_fingerprint", "tree_manifest",
    "tree_from_manifest", "to_numpy", "raw_bytes",
]

FORMAT_VERSION = 1
#: the documents' namespace, and the port package that serves it
_DOC_PKG, _PORT_PKG = "paddle_tpu", "paddle_tpu_torch"


class SerializationError(EnforceNotMet):
    pass


def raw_bytes(t):
    """The bytes of a tensor's (or array's) row-major image."""
    if isinstance(t, torch.Tensor):
        t = t.detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:       # numpy has no bfloat16
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(t).tobytes()


def to_numpy(t):
    """A tensor as a numpy array on the host (a copy-free view of a CPU
    tensor); numpy arrays pass through. numpy has no bfloat16: such a
    tensor raises."""
    if not isinstance(t, torch.Tensor):
        return np.asarray(t)
    if t.dtype == torch.bfloat16:
        raise SerializationError(
            "a bfloat16 tensor has no numpy dtype; store its 16-bit lanes "
            "(tensor.view(torch.int16)) or cast it first")
    return t.detach().cpu().numpy()


def _array_node(dtype, shape, data):
    return {"__ndarray__": {
        "dtype": dtype, "shape": list(shape),
        "b64": base64.b64encode(data).decode("ascii")}}


def _is_program(v):
    from paddle_tpu_torch.static.program import Program
    return isinstance(v, Program)


def encode_value(v, where=""):
    """Value -> JSON-able structure. ``where`` names the op/attr for
    error messages."""
    if v is None or isinstance(v, (bool, int, str, float)):
        return v
    if isinstance(v, np.integer):
        return int(v)
    if isinstance(v, np.floating):
        return float(v)
    if isinstance(v, bytes):
        return {"__bytes__": base64.b64encode(v).decode("ascii")}
    if isinstance(v, tuple):
        return {"__tuple__": [encode_value(x, where) for x in v]}
    if isinstance(v, list):
        return [encode_value(x, where) for x in v]
    if isinstance(v, torch.dtype):
        return {"__dtype__": dtype_name(v)}
    if isinstance(v, np.dtype):
        return {"__dtype__": v.name}
    if isinstance(v, type) and issubclass(v, np.generic):
        return {"__dtype__": np.dtype(v).name}
    if isinstance(v, torch.Tensor):
        return _array_node(dtype_name(v.dtype), v.shape, raw_bytes(v))
    if isinstance(v, np.ndarray):
        return _array_node(v.dtype.name, v.shape, raw_bytes(v))
    if _is_program(v):
        return {"__program__": program_to_dict(v)}
    if isinstance(v, dict):
        bad = [k for k in v if not isinstance(k, str)]
        if bad:
            raise SerializationError(
                f"{where}: dict attr has non-string keys {bad[:3]}")
        return {"__dict__": {k: encode_value(x, f"{where}.{k}")
                             for k, x in v.items()}}
    cls = type(v)
    mod = getattr(cls, "__module__", "")
    if mod == _PORT_PKG or mod.startswith(_PORT_PKG + "."):
        state = getattr(v, "__dict__", None)
        if state is None:
            raise SerializationError(
                f"{where}: {cls.__name__} has no __dict__ state")
        return {"__obj__": f"{_DOC_PKG}{mod[len(_PORT_PKG):]}:"
                           f"{cls.__qualname__}",
                "state": {k: encode_value(x, f"{where}.{cls.__name__}.{k}")
                          for k, x in state.items()}}
    if callable(v):
        raise SerializationError(
            f"{where}: attr holds a Python callable "
            f"({getattr(v, '__name__', v)!r}); host callbacks are not "
            f"serializable")
    raise SerializationError(
        f"{where}: cannot serialize attr of type {cls.__module__}."
        f"{cls.__qualname__}")


def _resolve_class(path):
    """The port's class for a document's ``paddle_tpu.<mod>:<Cls>``."""
    mod, _, qual = path.partition(":")
    if not (mod == _DOC_PKG or mod.startswith(_DOC_PKG + ".")):
        raise SerializationError(
            f"refusing to instantiate class outside paddle_tpu: {path}")
    port_mod = _PORT_PKG + mod[len(_DOC_PKG):]
    missing = SerializationError(
        f"{path}: the port has no {qual} in {port_mod} yet (ROADMAP queue "
        f"1: items 9 and 10 are still to port)")
    try:
        obj = importlib.import_module(port_mod)
    except ModuleNotFoundError:
        raise missing from None
    for part in qual.split("."):
        obj = getattr(obj, part, None)
        if obj is None:
            raise missing
    if not isinstance(obj, type):
        raise SerializationError(f"{path} is not a class")
    return obj


def _torch_dtype(name):
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise SerializationError(f"dtype {name!r} has no torch dtype")
    return dt


def _decode_array(d):
    data = base64.b64decode(d["b64"])
    if d["dtype"] == "bfloat16":
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16
                                ).reshape(d["shape"])
    arr = np.frombuffer(data, dtype=np.dtype(d["dtype"])).reshape(d["shape"])
    return arr.copy()   # writable, owned


def decode_value(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, list):
        return [decode_value(x) for x in v]
    if isinstance(v, dict):
        if "__tuple__" in v:
            return tuple(decode_value(x) for x in v["__tuple__"])
        if "__bytes__" in v:
            return base64.b64decode(v["__bytes__"])
        if "__dtype__" in v:
            return _torch_dtype(v["__dtype__"])
        if "__ndarray__" in v:
            return _decode_array(v["__ndarray__"])
        if "__program__" in v:
            return program_from_dict(v["__program__"])
        if "__dict__" in v:
            return {k: decode_value(x) for k, x in v["__dict__"].items()}
        if "__obj__" in v:
            cls = _resolve_class(v["__obj__"])
            obj = cls.__new__(cls)
            obj.__dict__.update(
                {k: decode_value(x) for k, x in v["state"].items()})
            return obj
    raise SerializationError(f"cannot decode node {v!r:.80}")


# ---------------------------------------------------------------------------
# Program <-> dict
# ---------------------------------------------------------------------------
def _var_to_dict(var):
    from paddle_tpu_torch.static.program import Parameter
    d = {
        "name": var.name,
        "shape": None if var.shape is None else list(var.shape),
        "dtype": dtype_name(var.dtype),
        "persistable": bool(var.persistable),
        "stop_gradient": bool(var.stop_gradient),
        "is_data": bool(var.is_data),
        "lod_level": int(var.lod_level),
    }
    if isinstance(var, Parameter):
        where = f"var {var.name}"
        d["is_parameter"] = True
        d["trainable"] = bool(var.trainable)
        d["optimize_attr"] = encode_value(var.optimize_attr, where)
        d["regularizer"] = encode_value(var.regularizer, where)
        d["do_model_average"] = bool(var.do_model_average)
        d["initializer"] = encode_value(var.initializer, where)
        d["gradient_clip"] = encode_value(var.gradient_clip, where)
    return d


def _var_from_dict(block, d):
    from paddle_tpu_torch.static.program import Parameter, Variable
    shape = tuple(d["shape"]) if d["shape"] is not None else None
    if d.get("is_parameter"):
        v = Parameter(
            block, d["name"], shape, d["dtype"],
            trainable=d.get("trainable", True),
            optimize_attr=decode_value(d.get("optimize_attr")),
            regularizer=decode_value(d.get("regularizer")),
            gradient_clip=decode_value(d.get("gradient_clip")),
            do_model_average=d.get("do_model_average", True),
            initializer=decode_value(d.get("initializer")))
    else:
        v = Variable(
            block, d["name"], shape, d["dtype"],
            persistable=d.get("persistable", False),
            stop_gradient=d.get("stop_gradient", False),
            is_data=d.get("is_data", False),
            lod_level=d.get("lod_level", 0))
    block.vars[d["name"]] = v
    return v


def program_to_dict(program):
    blk = program.global_block()
    ops = [{
        "type": op.type,
        "inputs": {k: list(v) for k, v in op.inputs.items()},
        "outputs": {k: list(v) for k, v in op.outputs.items()},
        "attrs": {k: encode_value(v, f"op {op.type}, attr {k!r}")
                  for k, v in op.attrs.items()},
    } for op in blk.ops]
    consts = {n: encode_value(torch.as_tensor(c), f"constant {n}")
              for n, c in program._constants.items()}
    return {
        "format_version": FORMAT_VERSION,
        "random_seed": int(program.random_seed),
        "vars": [_var_to_dict(v) for v in blk.vars.values()],
        "ops": ops,
        "constants": consts,
    }


def program_from_dict(d):
    from paddle_tpu_torch.static.program import Operator, Program
    ver = d.get("format_version")
    if ver != FORMAT_VERSION:
        raise SerializationError(
            f"unsupported program format version {ver!r}")
    program = Program()
    program.random_seed = d.get("random_seed", 0)
    blk = program.global_block()
    for vd in d["vars"]:
        _var_from_dict(blk, vd)
    for od in d["ops"]:
        op = Operator(blk, od["type"], None, None,
                      {k: decode_value(v)
                       for k, v in od.get("attrs", {}).items()})
        op.inputs = {k: list(v) for k, v in od.get("inputs", {}).items()}
        op.outputs = {k: list(v) for k, v in od.get("outputs", {}).items()}
        blk.ops.append(op)
    program._constants = {n: torch.as_tensor(decode_value(c))
                          for n, c in (d.get("constants") or {}).items()}
    program._bump()
    return program


def dumps_program(program, extra=None):
    """Program (+ extra JSON-able metadata) -> JSON text."""
    doc = {"program": program_to_dict(program)}
    if extra:
        doc.update(extra)
    return json.dumps(doc, sort_keys=True, separators=(",", ":"))


def loads_program(text):
    """JSON text -> (Program, full document dict)."""
    doc = json.loads(text)
    return program_from_dict(doc["program"]), doc


def program_fingerprint(program, feed_names=(), fetch_names=()):
    """Canonical structural hash of (program, feed, fetch): the AOT index
    key, equal to the JAX package's for the same document."""
    doc = {"program": program_to_dict(program),
           "feeds": list(feed_names), "fetches": list(fetch_names)}
    blob = json.dumps(doc, sort_keys=True,
                      separators=(",", ":")).encode("utf-8")
    return hashlib.sha256(blob).hexdigest()


# ---------------------------------------------------------------------------
# tree manifests (checkpoints): npz + structural treedef, zero pickle
# ---------------------------------------------------------------------------
def tree_manifest(tree, to_array=to_numpy):
    """Tree of tensors/arrays -> (manifest dict, {key: ndarray}). The
    manifest records the structure with array leaves replaced by npz keys
    (``a0``, ``a1``, ... in walk order, as the JAX package numbers them);
    non-array leaves (ints, floats, strings) are stored inline. Each array
    leaf goes through ``to_array`` (default: a numpy array on the host; a
    checkpoint passes the leaves through and snapshots them itself)."""
    arrays = {}

    def enc(x):
        if isinstance(x, (bool, int, float, str)) or x is None:
            return {"__leaf__": x}
        key = f"a{len(arrays)}"
        arrays[key] = to_array(x)
        return {"__array__": key}

    def rec(node):
        if isinstance(node, dict):
            bad = [k for k in node if not isinstance(k, str)]
            if bad:
                raise SerializationError(
                    f"checkpoint tree has non-string dict keys {bad[:3]!r}: "
                    f"JSON manifests would stringify them; use string keys")
            return {"__d__": {k: rec(v) for k, v in node.items()}}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            raise SerializationError(
                f"checkpoint tree contains a namedtuple "
                f"({type(node).__name__}): it would restore as a plain "
                f"tuple; convert to a dict before saving")
        if isinstance(node, (list, tuple)):
            tag = "__l__" if isinstance(node, list) else "__t__"
            return {tag: [rec(v) for v in node]}
        return enc(node)

    return {"format_version": FORMAT_VERSION, "tree": rec(tree)}, arrays


def tree_from_manifest(manifest, arrays):
    """(manifest, npz mapping) -> tree, array leaves as CPU tensors."""
    if manifest.get("format_version") != FORMAT_VERSION:
        raise SerializationError(
            f"unsupported manifest version "
            f"{manifest.get('format_version')!r}")

    def rec(node):
        if "__d__" in node:
            return {k: rec(v) for k, v in node["__d__"].items()}
        if "__l__" in node:
            return [rec(v) for v in node["__l__"]]
        if "__t__" in node:
            return tuple(rec(v) for v in node["__t__"])
        if "__leaf__" in node:
            return node["__leaf__"]
        if "__array__" in node:
            return torch.as_tensor(np.asarray(arrays[node["__array__"]]))
        raise SerializationError(f"bad manifest node {node!r:.60}")

    return rec(manifest["tree"])
