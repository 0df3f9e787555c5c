"""Model save/load: the port of ``paddle_tpu/static/io.py``.

Parity: python/paddle/fluid/io.py (save_params:242, save_persistables:475,
load_params:527, load_persistables:714, save_inference_model:921,
load_inference_model:1109). The files are the JAX package's: parameters in
one ``params.npz`` (numpy arrays, the file boundary), the program as the
schema'd JSON document of ``static/serialize.py`` in ``__model__``. A model
directory written by either package loads in the other.

Values load onto the executor's device. The op forms of save/load
(``append_save_op``/``append_load_op``) and ``save_vars``/``load_vars`` are
not ported yet: they raise naming ROADMAP queue 1 item 10.
"""

import os

import numpy as np
import torch

from paddle_tpu_torch.core.enforce import EnforceNotMet
from paddle_tpu_torch.static.executor import global_scope
from paddle_tpu_torch.static.program import Parameter, default_main_program
from paddle_tpu_torch.static.serialize import (
    dumps_program, loads_program, to_numpy,
)

__all__ = ["save_params", "load_params", "save_persistables",
           "load_persistables", "save_inference_model",
           "load_inference_model", "append_save_op", "append_load_op",
           "save_vars", "load_vars", "PARAMS_FILE", "PROGRAM_FILE"]

PARAMS_FILE = "params.npz"
PROGRAM_FILE = "__model__"


def _collect(program, scope, predicate):
    out = {}
    for name, var in program.global_block().vars.items():
        if predicate(var):
            val = scope.find_var(name)
            if val is not None:
                out[name] = to_numpy(val)
    return out


def _savez(dirname, filename, vals):
    os.makedirs(dirname, exist_ok=True)
    np.savez(os.path.join(dirname, filename or PARAMS_FILE), **vals)


def save_params(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    _savez(dirname, filename, _collect(main_program, global_scope(),
                                       lambda v: isinstance(v, Parameter)))


def save_persistables(executor, dirname, main_program=None, filename=None):
    main_program = main_program or default_main_program()
    scope = global_scope()
    vals = _collect(main_program, scope, lambda v: v.persistable)
    # optimizer state lives scope-side without block vars; include it
    for name in scope.names():
        if name not in vals and not name.startswith("@") \
                and scope.find_var(name) is not None \
                and not main_program.global_block().has_var(name):
            vals[name] = to_numpy(scope.find_var(name))
    _savez(dirname, filename, vals)


def _load_npz(path, scope, executor):
    device = executor.device
    with np.load(path, allow_pickle=False) as data:
        for name in data.files:
            scope.set_var(name, torch.from_numpy(data[name]).to(device))


def load_params(executor, dirname, main_program=None, filename=None):
    _load_npz(os.path.join(dirname, filename or PARAMS_FILE),
              global_scope(), executor)


def load_persistables(executor, dirname, main_program=None, filename=None):
    _load_npz(os.path.join(dirname, filename or PARAMS_FILE),
              global_scope(), executor)


def _prune(program, feed_names, fetch_names):
    """Backward-reachability prune from the fetches (io.py:921's
    prune + inference_optimize), on the pass framework's slice and
    extract primitives."""
    from paddle_tpu_torch.static.passes import (
        backward_slice, extract_subprogram,
    )
    kept, needed = backward_slice(program.global_block(), fetch_names,
                                  skip_types=("autodiff",))
    return extract_subprogram(program, kept, needed, extra_vars=fetch_names)


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, aot_shapes=None):
    """Freeze + prune + save. With ``aot_shapes`` (a list of {feed name:
    (shape, dtype)} buckets) the AOT index is written too
    (``paddle_tpu_torch.inference.export_aot``)."""
    main_program = main_program or default_main_program()
    os.makedirs(dirname, exist_ok=True)
    fetch_names = [t if isinstance(t, str) else t.name for t in target_vars]
    inference_program = _prune(main_program.clone(for_test=True),
                               feeded_var_names, fetch_names)
    text = dumps_program(inference_program, extra={
        "feed_names": list(feeded_var_names),
        "fetch_names": fetch_names,
    })
    with open(os.path.join(dirname, model_filename or PROGRAM_FILE),
              "w") as f:
        f.write(text)
    _savez(dirname, params_filename,
           _collect(inference_program, global_scope(),
                    lambda v: v.persistable))
    if aot_shapes:
        from paddle_tpu_torch import inference as _inf
        _inf.export_aot(dirname, inference_program,
                        list(feeded_var_names), fetch_names,
                        global_scope(), aot_shapes)
    return fetch_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch names); the parameters go to ``scope``
    (default: the global scope) on the executor's device."""
    with open(os.path.join(dirname, model_filename or PROGRAM_FILE)) as f:
        program, doc = loads_program(f.read())
    _load_npz(os.path.join(dirname, params_filename or PARAMS_FILE),
              scope if scope is not None else global_scope(), executor)
    return program, doc["feed_names"], doc["fetch_names"]


def _not_ported(what):
    raise EnforceNotMet(
        f"{what} is not ported yet (ROADMAP queue 1 item 10: the "
        f"save/load ops and var-list checkpoints)")


def append_save_op(program, vars_, file_path):
    """Not ported yet: raises."""
    _not_ported("append_save_op (the save_combine op)")


def append_load_op(program, vars_, file_path):
    """Not ported yet: raises."""
    _not_ported("append_load_op (the load_combine op)")


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Not ported yet: raises."""
    _not_ported("save_vars")


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None):
    """Not ported yet: raises."""
    _not_ported("load_vars")
