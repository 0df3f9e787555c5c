"""Inference stack: the port of ``paddle_tpu/inference.py`` — ``Config`` and
``Predictor`` over frozen programs, the AOT index of ``export_aot`` with its
integrity manifest, and the weight-only PTQ sidecar.

Parity: the reference's AnalysisConfig (inference/api/analysis_config.cc),
AnalysisPredictor with ZeroCopyTensor I/O (analysis_predictor.h:46,56,68)
and NaiveExecutor's per-op loop (framework/naive_executor.cc). The port runs
the frozen program op by op, eagerly, as ``Executor.run`` does; each op
launches the port's kernels on the card (or their plain bodies on the CPU).

Model directories are the carrier between the packages: ``__model__``,
``params.npz`` and ``__aot__/`` (``index.json`` and the quant sidecar) are
read and written alike by both. What differs: the JAX package also writes an
XLA executable (``.xla``) and a StableHLO export (``.shlo``) per shape
bucket, which have no counterpart here. The port's ``export_aot`` writes
neither, and its index entries carry no ``xla``/``shlo`` key and carry
``torch_version`` in place of ``jax_version`` (the JAX Predictor and server
then take their retrace path on such a directory). The port's loaders
verify the CRC of every file a manifest names, ``.xla``/``.shlo`` included,
and never open those two.
"""

import hashlib
import json
import os
import threading
import time
import zlib

import numpy as np
import torch

from paddle_tpu_torch.core.dtypes import dtype_name
from paddle_tpu_torch.core.enforce import enforce
from paddle_tpu_torch.core.place import CPUPlace
from paddle_tpu_torch.static import io as static_io
from paddle_tpu_torch.static.executor import (
    Executor, Scope, _op_generator, exec_op,
)
from paddle_tpu_torch.static.serialize import raw_bytes

__all__ = ["Config", "Predictor", "create_predictor", "ZeroCopyTensor",
           "export_aot", "verify_aot_dir", "read_aot_version",
           "load_quantized_params", "AOTIntegrityError"]

AOT_DIR = "__aot__"
AOT_INDEX = "index.json"


def _build_pure_fn(program, feed_names, fetch_names):
    """``fn(params_tuple, feeds_tuple) -> fetches_tuple`` over a frozen
    (host-op-free) inference program, running its ops through ``exec_op``
    on the tensors it is given. The param order is the sorted state names
    (recorded in the AOT index), the feed order the given one. An op that
    draws (``_needs_rng``: dropout) gets, on every call, the generator the
    Executor gives it at its first run of the program, the counterpart of
    the JAX function's step-0 keys: inference is stateless."""
    blk = program.global_block()
    ops = list(blk.ops)
    enforce(not any(op.attrs.get("_host") for op in ops),
            "an inference program must be host-op-free")
    constants = dict(program._constants)
    state_names = sorted(n for n, v in blk.vars.items()
                         if v.persistable and n not in constants)
    on_device = {}              # device -> the constants there

    def fn(params, feeds):
        dev = feeds[0].device if feeds else params[0].device
        if dev not in on_device:
            on_device[dev] = {n: c.to(dev) for n, c in constants.items()}
        env = dict(on_device[dev])
        env.update(zip(state_names, params))
        env.update(zip(feed_names, feeds))
        # a shape-only run on the meta device draws nothing: any generator
        # does, and torch makes none for meta
        gdev = torch.device("cpu") if dev.type == "meta" else dev
        for op in ops:
            rng = (_op_generator(gdev, program.random_seed, 1, op)
                   if op.attrs.get("_needs_rng") else None)
            env.update(exec_op(op, env, rng))
        return tuple(env[n] for n in fetch_names)

    return fn, state_names


def _program_hash(program):
    """Fingerprint of the frozen program: AOT index entries are valid only
    for the graph they were written from (the canonical structural hash of
    static/serialize.py, equal to the JAX package's)."""
    from paddle_tpu_torch.static.serialize import program_fingerprint
    return program_fingerprint(program)[:16]


def _dtype_str(dtype):
    """The numpy name of a dtype given as a name, numpy dtype or torch
    dtype ('float32', 'bfloat16', ...)."""
    if isinstance(dtype, torch.dtype):
        return dtype_name(dtype)
    return np.dtype(dtype).name


def _sig_of(feed_names, shaped):
    """Signature entry for one shape bucket: [[name, shape, dtype]...] in
    feed order. ``shaped``: {name: tensor, array or (shape, dtype)}."""
    sig = []
    for n in feed_names:
        v = shaped[n]
        if isinstance(v, tuple):
            shape, dtype = v
        elif isinstance(v, torch.Tensor):
            shape, dtype = v.shape, v.dtype
        else:
            v = np.asarray(v)
            shape, dtype = v.shape, v.dtype
        sig.append([n, [int(d) for d in shape], _dtype_str(dtype)])
    return sig


def _sig_key(sig):
    return hashlib.sha256(json.dumps(sig).encode()).hexdigest()[:16]


class AOTIntegrityError(RuntimeError):
    """An AOT artifact failed its integrity manifest (CRC/size drift or a
    missing file): evidence of a torn or bit-rotted export, named
    precisely."""


class AOTVerifyResult(int):
    """``verify_aot_dir``'s return value: the number of artifact files
    verified, carrying the ``model_version`` the manifest declares (None
    for an absent or unversioned index)."""

    def __new__(cls, verified, model_version=None):
        self = super().__new__(cls, int(verified))
        self.model_version = model_version
        return self


def _model_version_of(prog_hash, state_names, params):
    """``<sha256[:12]>.<unix-microseconds>``: a content hash of (program,
    weights), equal to the JAX package's for the same program and values,
    and the export's timestamp."""
    h = hashlib.sha256(prog_hash.encode())
    for n, p in zip(state_names, params):
        h.update(n.encode())
        h.update(str(tuple(p.shape)).encode())
        h.update(_dtype_str(p.dtype).encode())
        h.update(raw_bytes(p))
    return f"{h.hexdigest()[:12]}.{int(time.time() * 1e6)}"


def _file_integrity(path):
    """{"crc32", "nbytes"} of a file's bytes."""
    crc = 0
    n = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
            n += len(chunk)
    return {"crc32": crc & 0xFFFFFFFF, "nbytes": n}


def _verify_artifact(path, expect):
    """Verify one artifact file against its manifest record; raises
    :class:`AOTIntegrityError` naming the file and the first mismatch."""
    name = os.path.basename(path)
    try:
        got = _file_integrity(path)
    except FileNotFoundError:
        raise AOTIntegrityError(
            f"AOT artifact {name!r} is missing but listed in the integrity "
            f"manifest: torn export; re-run export_aot") from None
    if got["nbytes"] != expect["nbytes"]:
        raise AOTIntegrityError(
            f"AOT artifact {name!r} failed integrity: size {got['nbytes']} "
            f"!= manifest {expect['nbytes']}: torn export or concurrent "
            f"rewrite; re-run export_aot")
    if got["crc32"] != expect["crc32"]:
        raise AOTIntegrityError(
            f"AOT artifact {name!r} failed integrity: CRC32 "
            f"{got['crc32']:#010x} != manifest {expect['crc32']:#010x}: bit "
            f"rot or torn export; re-run export_aot")


def _stamp(entry):
    """The publish timestamp of an entry's ``model_version`` (0 without)."""
    try:
        return int(str(entry.get("model_version")).rsplit(".", 1)[1])
    except (IndexError, ValueError):
        return 0


def _read_index(model_dir):
    """The AOT index's entries (dicts), or None when there is none or it
    is unreadable."""
    try:
        with open(os.path.join(model_dir or "", AOT_DIR, AOT_INDEX)) as f:
            entries = json.load(f)
    except (OSError, ValueError):
        return None
    return [e for e in entries if isinstance(e, dict)] \
        if isinstance(entries, list) else []


def _version_from_entries(entries):
    """The newest per-entry ``model_version`` by publish timestamp: an index
    merged across exports keeps older entries with older stamps."""
    best, best_ts = None, -1
    for e in entries:
        if e.get("model_version") and _stamp(e) >= best_ts:
            best, best_ts = e["model_version"], _stamp(e)
    return best


def verify_aot_dir(model_dir):
    """Verify every file the ``<model_dir>/__aot__`` index's integrity
    manifest names (the quant sidecar, and the JAX package's ``.xla`` and
    ``.shlo`` files, which the port never opens). Returns an
    :class:`AOTVerifyResult`: the number of files verified (0 without an
    index) carrying the manifest's ``model_version``; raises
    :class:`AOTIntegrityError` on the first bad file. The server runs it at
    boot, so corruption fails at load, not mid-traffic."""
    aot_dir = os.path.join(model_dir or "", AOT_DIR)
    if not os.path.exists(os.path.join(aot_dir, AOT_INDEX)):
        return AOTVerifyResult(0)
    entries = _read_index(model_dir)
    if entries is None:
        raise AOTIntegrityError(
            f"AOT index under {aot_dir!r} is unreadable; re-run export_aot")
    verified = 0
    for e in entries:
        for name, rec in sorted(e.get("integrity", {}).items()):
            _verify_artifact(os.path.join(aot_dir, name), rec)
            verified += 1
    return AOTVerifyResult(verified, _version_from_entries(entries))


def load_quantized_params(model_dir):
    """The quantized-serving sidecar of ``export_aot(quantize=...)``, or
    None when the directory's newest export is not quantized. Returns
    ``{"mode", "weights", "values"}``, ``values`` mapping each quantized
    weight (and its ``@quant_scale`` table for int8) to a CPU tensor (a
    bf16 sidecar stores the 16-bit lanes as uint16, viewed back as
    ``torch.bfloat16``). The file is checked against the newest entry's
    integrity record first, and the weight list comes from the manifest,
    never re-derived."""
    entries = _read_index(model_dir)
    if not entries:
        return None
    # the NEWEST export decides: a later fp32 re-export leaves older
    # quantized entries in the index, whose sidecar must not be served
    best, best_ts = None, -1
    for e in entries:
        ts = _stamp(e)
        if ts > best_ts or (ts == best_ts
                            and isinstance(e.get("quant"), dict)
                            and not isinstance((best or {}).get("quant"),
                                               dict)):
            best, best_ts = e, ts
    if best is None or not isinstance(best.get("quant"), dict):
        return None
    q = best["quant"]
    qpath = os.path.join(model_dir, AOT_DIR, q.get("file", ""))
    rec = (best.get("integrity") or {}).get(q.get("file"))
    if not rec:
        raise AOTIntegrityError(
            f"quantized sidecar {q.get('file')!r} has no integrity record "
            f"in the AOT index; treating as tampered: re-run export_aot")
    _verify_artifact(qpath, rec)
    try:
        with np.load(qpath, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except (OSError, ValueError) as e:
        raise AOTIntegrityError(
            f"quantized sidecar {qpath!r} is unreadable ({e}); re-run "
            f"export_aot") from None
    mode = q.get("mode")
    weights = list(q.get("weights", []))
    values = {}
    for k, v in arrays.items():
        if mode == "bf16" and k in weights:
            values[k] = torch.from_numpy(v.view(np.int16)).view(
                torch.bfloat16)
        else:
            values[k] = torch.from_numpy(v)
    return {"mode": mode, "weights": weights, "values": values}


def read_aot_version(model_dir):
    """The manifest's ``model_version`` without verifying any CRC (one
    small JSON read), or None."""
    entries = _read_index(model_dir)
    return None if entries is None else _version_from_entries(entries)


def export_aot(dirname, program, feed_names, fetch_names, scope,
               shape_buckets, platforms=("cpu", "tpu"), quantize=None,
               apply_passes=None):
    """Write the AOT index of a frozen program under ``<dirname>/__aot__``:
    one entry per shape bucket (``sig``, ``key``, ``program_hash``,
    ``model_version``, ``state_names``, ``torch_version``, ``quant``,
    ``integrity``), merged into an existing index with stale entries pruned
    and their files removed, as the JAX package does. No executable is
    written (see the module docstring). Returns the new entries.

    ``shape_buckets``: list of {feed name: (shape, dtype)} (or example
    arrays). ``apply_passes`` (default ``FLAGS_apply_ir_passes``) runs the
    pass pipeline on a clone first. ``platforms`` is accepted for the JAX
    signature and ignored: it names the platforms the JAX package lowers its
    StableHLO export for, and the port writes no such export.

    ``quantize="int8"|"bf16"``: weight-only post-training quantization.
    Every eligible matmul weight is stored quantized (int8: per-output-
    channel abs-max scales; bf16: the storage cast) in a
    ``quant.<mode>.<ts>.npz`` sidecar covered by the integrity manifest, and
    the serving boot folds the dequant into the consuming matmul
    (``fused_matmul_int8``). The single-request ``Predictor`` keeps the fp32
    params file."""
    from paddle_tpu_torch.core.flags import get_flag
    from paddle_tpu_torch.static import opt_passes as _opt

    if apply_passes is None:
        apply_passes = bool(get_flag("apply_ir_passes"))
    # the deploy identity is the CALLER's program, the graph
    # save_inference_model wrote; loaders hash the loaded __model__
    prog_hash = _program_hash(program)
    if apply_passes:
        program = _opt.optimize_inference(program, fetch_names)
    out_dir = os.path.join(dirname, AOT_DIR)
    os.makedirs(out_dir, exist_ok=True)
    overlay = {}
    qmeta = None
    if quantize is not None:
        enforce(quantize in ("int8", "bf16"),
                f"quantize must be 'int8' or 'bf16', got {quantize!r}")
        blk = program.global_block()
        values = {n: scope.find_var(n) for n, v in blk.vars.items()
                  if v.persistable and scope.find_var(n) is not None}
        plan = _opt.plan_weight_quant(program, values, quantize)
        enforce(plan,
                f"quantize={quantize!r}: no eligible weight found (2-D "
                f"persistable float32 consumed only as a matmul/mul RHS in "
                f"[in, out] layout)")
        program = _opt.apply_weight_quant(program, plan, quantize)
        overlay = _opt.quantize_weight_values(values, plan, quantize)
        # per-export file name: npz bytes are not reproducible (zip headers
        # embed mtimes), and older surviving entries record the CRC of
        # their own sidecar
        qfile = f"quant.{quantize}.{time.time_ns() // 1000}.npz"
        qtmp = os.path.join(out_dir, f".{qfile}.{os.getpid()}.tmp")
        with open(qtmp, "wb") as f:
            # numpy has no bfloat16: a bf16 weight is stored as its raw
            # 16-bit lanes (uint16), which the loaders view back
            np.savez(f, **{
                k: (v.view(torch.int16).numpy().view(np.uint16)
                    if v.dtype == torch.bfloat16 else v.numpy())
                for k, v in overlay.items()})
        os.replace(qtmp, os.path.join(out_dir, qfile))
        qmeta = {
            "mode": quantize, "file": qfile, "weights": sorted(plan),
            "scales_sha256": {
                w: hashlib.sha256(raw_bytes(
                    overlay[w + _opt.QUANT_SCALE_SUFFIX])).hexdigest()[:16]
                for w in plan} if quantize == "int8" else {},
        }

    _, state_names = _build_pure_fn(program, feed_names, fetch_names)
    raw = [overlay.get(n, scope.find_var(n)) for n in state_names]
    missing = [n for n, v in zip(state_names, raw) if v is None]
    enforce(not missing,
            f"scope missing persistables for AOT export: {missing[:5]}")
    model_version = _model_version_of(prog_hash, state_names, raw)
    integrity = ({qmeta["file"]: _file_integrity(
        os.path.join(out_dir, qmeta["file"]))} if qmeta else {})
    entries = []
    for bucket in shape_buckets:
        sig = _sig_of(feed_names, bucket)
        # the key covers the PROGRAM too: a re-saved model must never
        # serve a stale graph from a surviving shape bucket
        entry = {"sig": sig,
                 "key": _sig_key(sig + [["__program__", [], prog_hash]]),
                 "torch_version": torch.__version__,
                 "program_hash": prog_hash, "model_version": model_version,
                 "state_names": state_names}
        if qmeta is not None:
            entry["quant"] = qmeta
        entry["integrity"] = dict(integrity)
        entries.append(entry)
    _write_index(dirname, entries, prog_hash)
    return entries


def _write_index(dirname, entries, prog_hash):
    """Merge ``entries`` into the index: drop superseded buckets and every
    entry of another program, unlink the files no surviving entry names,
    then replace the index atomically."""
    out_dir = os.path.join(dirname, AOT_DIR)
    index_path = os.path.join(out_dir, AOT_INDEX)
    old = [e for e in (_read_index(dirname) or []) if "key" in e]
    new_keys = {e["key"] for e in entries}
    keep = [e for e in old if e["key"] not in new_keys
            and e.get("program_hash") == prog_hash]

    def files(e):
        return {n for n in (e.get("xla"), e.get("shlo"),
                            (e.get("quant") or {}).get("file")) if n}

    live = {n for e in keep + entries for n in files(e)}
    for e in old:
        if e in keep:
            continue
        for name in files(e) - live:
            try:
                os.unlink(os.path.join(out_dir, name))
            except OSError:
                pass
    tmp = f"{index_path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(keep + entries, f, indent=1)
    os.replace(tmp, index_path)


class Config:
    """AnalysisConfig parity: the model directory (or program and params
    files), ``switch_ir_optim``, and the device: the card unless
    ``disable_gpu()`` asks for the CPU."""

    def __init__(self, model_dir=None, prog_file=None, params_file=None):
        self.model_dir = model_dir
        self.prog_file = prog_file
        self.params_file = params_file
        self._ir_optim = True
        self._memory_optim = False
        self._device = None          # None: the card

    def set_model(self, model_dir, params_file=None):
        self.model_dir = model_dir
        self.params_file = params_file

    def switch_ir_optim(self, flag=True):
        self._ir_optim = flag

    def enable_memory_optim(self):
        # the caching allocator owns buffer reuse; a toggle for API parity
        self._memory_optim = True

    def disable_gpu(self):
        self._device = "cpu"

    def ir_optim(self):
        return self._ir_optim


class ZeroCopyTensor:
    """Input/output handle (AnalysisPredictor::GetInputTensor parity)."""

    def __init__(self, name, owner):
        self.name = name
        self._owner = owner

    def copy_from_cpu(self, arr):
        self._owner._feeds[self.name] = np.asarray(arr)

    def reshape(self, shape):  # parity no-op: shape comes from the array
        pass

    def copy_to_cpu(self):
        out = self._owner._outputs.get(self.name)
        if out is None:
            raise KeyError(f"output {self.name!r} not computed yet; run()")
        return np.asarray(out)


class Predictor:
    """A predictor over a ``save_inference_model`` directory: the fp32
    params on the config's device, the program run by ``Executor.run``
    (with the pass pipeline, so fc chains launch the fused-matmul kernel on
    the card).

    Trust boundary: the program (``__model__``, schema'd JSON) and params
    (``.npz``) load without executing code. When the directory has an AOT
    index, every file its integrity manifest names is verified at
    construction (:func:`verify_aot_dir`); none is opened.

    Thread safety: ``run(feed=...)`` is serialized by a per-predictor lock;
    ``clone()`` gives each serving thread its own handle state over shared
    weights. For throughput use ``paddle_tpu_torch.serving.InferenceServer``.
    """

    def __init__(self, config):
        self.config = config
        self._run_lock = threading.Lock()
        self._scope = Scope()
        self._exe = Executor(CPUPlace() if config._device == "cpu"
                             else None)
        prog, feeds, fetches = static_io.load_inference_model(
            config.model_dir, self._exe, model_filename=config.prog_file,
            params_filename=config.params_file, scope=self._scope)
        verify_aot_dir(config.model_dir)
        if config.ir_optim():
            # re-prune to the fetch-reachable subgraph (idempotent on
            # save_inference_model artifacts, which prune at save)
            prog = static_io._prune(prog, feeds, fetches)
        self._program = prog
        self._feed_names = feeds
        self._fetch_names = fetches
        self._feeds = {}
        self._outputs = {}

    def clone(self):
        """A predictor sharing this one's weights, program and executor but
        owning its per-request feed/fetch state and lock (one clone per
        serving thread)."""
        c = object.__new__(Predictor)
        c.__dict__.update(self.__dict__)
        c._feeds = {}
        c._outputs = {}
        c._run_lock = threading.Lock()
        return c

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return list(self._fetch_names)

    def get_input_handle(self, name):
        return ZeroCopyTensor(name, self)

    def get_output_handle(self, name):
        return ZeroCopyTensor(name, self)

    def run(self, feed=None):
        """feed: optional {name: array} (else the zero-copy handles'
        values). Returns the outputs in fetch order, as numpy arrays."""
        with self._run_lock:
            if feed is not None:
                self._feeds = {k: np.asarray(v) for k, v in feed.items()}
            missing = [n for n in self._feed_names if n not in self._feeds]
            if missing:
                raise KeyError(f"missing inputs: {missing}")
            outs = self._exe.run(self._program, feed=dict(self._feeds),
                                 fetch_list=list(self._fetch_names),
                                 scope=self._scope)
            self._outputs = dict(zip(self._fetch_names, outs))
            return outs


def create_predictor(config):
    """create_paddle_predictor / CreatePaddlePredictor parity."""
    return Predictor(config)
