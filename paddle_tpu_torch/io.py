"""fluid.io parity: model save/load (``paddle_tpu/io.py``'s re-exports of
``static/io.py``), ``PyReader`` (``dataio``'s), ``batch``, the reader
decorator, and the eager checkpoints (``save_pytree``, ``load_pytree``,
``save_dygraph``, ``load_dygraph``): one ``.npz`` with a JSON manifest of
the tree (``static/serialize.py``'s ``tree_manifest``), the JAX package's
format, so a file written by either package loads in the other. Loading
never unpickles. ``DataLoader`` is ``dataio``'s."""

import json
import os

import numpy as np

from paddle_tpu_torch.core.tree import map_tensors
from paddle_tpu_torch.dataio.pyreader import DataLoader, PyReader  # noqa: F401
from paddle_tpu_torch.static.io import (  # noqa: F401
    load_inference_model, load_params, load_persistables, load_vars,
    save_inference_model, save_params, save_persistables, save_vars,
)

__all__ = ["save_inference_model", "load_inference_model", "save_params",
           "load_params", "save_persistables", "load_persistables",
           "save_vars", "load_vars", "batch", "save_pytree", "load_pytree",
           "save_dygraph", "load_dygraph", "DataLoader", "PyReader"]


def batch(reader, batch_size, drop_last=False):
    """fluid.io.batch / paddle.batch parity: a sample reader as a reader of
    sample lists, the last partial list kept by default."""
    from paddle_tpu_torch.dataio.feeder import batch_reader
    return batch_reader(reader, batch_size, drop_last)


def save_pytree(tree, path):
    """A params/state tree (dicts, lists, tuples of tensors or arrays, and
    plain scalars) to one ``.npz`` at ``path``, with its structure as a
    JSON manifest (no pickle), written to a temporary file first."""
    from paddle_tpu_torch.static.serialize import tree_manifest
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    manifest, arrays = tree_manifest(tree)
    mblob = np.frombuffer(json.dumps(manifest).encode("utf-8"),
                          dtype=np.uint8)
    tmp = path + ".tmp.npz"
    np.savez(tmp, __manifest__=mblob, **arrays)
    os.replace(tmp, path)


def load_pytree(path, device=None):
    """The tree :func:`save_pytree` wrote (or the JAX package's), its
    arrays as tensors on ``device`` (the card when None)."""
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.static.serialize import tree_from_manifest
    dev = resolve_device(device)
    with np.load(path, allow_pickle=False) as blob:
        manifest = json.loads(
            bytes(blob["__manifest__"].tobytes()).decode("utf-8"))
        arrays = {k: blob[k] for k in blob.files if k != "__manifest__"}
    return map_tensors(lambda t: t.to(dev),
                       tree_from_manifest(manifest, arrays))


def _pdparams(model_path):
    return model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"


def save_dygraph(state_dict, model_path):
    """dygraph/checkpoint.py save_dygraph parity: ``{model_path}.pdparams``
    in :func:`save_pytree`'s format."""
    save_pytree(state_dict, _pdparams(model_path))


def load_dygraph(model_path, device=None):
    """``(param_dict, None)`` from ``{model_path}.pdparams``, on
    ``device`` (the card when None)."""
    return load_pytree(_pdparams(model_path), device=device), None
