"""Framed binary wire protocol for the PS transport — no pickle; the
port's copy of ``paddle_tpu/distributed/wire.py`` (numpy and struct only):
the same frames, so either package's trainers read the other's. The
sample exchange of ``InMemoryDataset.global_shuffle`` uses it today.

Parity targets: the reference's fixed tensor wire schema
(operators/distributed/send_recv.proto.in + sendrecvop_utils.cc splits
a tensor into typed meta + raw payload) and the RPC client contract
(operators/distributed/rpc_client.h:33, retry path grpc_client.cc).
The previous transport was length-prefixed pickle: unpickling bytes
from a socket is arbitrary-code-execution on any non-loopback
deployment. This codec decodes ONLY fixed-schema scalar/string/ndarray
fields, validates magic/version/size before touching the payload, and
rejects oversized or malformed frames without evaluating anything.

Frame layout (little-endian):
    magic "PT" | version u8 | kind u8 | client_id u64 | seq u64
    | payload_len u64 | payload
Payload is the concatenation of the fields registered for the kind in
SCHEMAS; decoding validates the payload is consumed exactly.

Field encodings:
    STR  -> u16 len | utf-8 bytes
    U64  -> u64
    F64  -> f64 (NaN encodes None for optional floats)
    ARR  -> dtype u8 | ndim u8 | dims u32[ndim] | raw bytes
"""

import struct

import numpy as np

from paddle_tpu_torch.core.flags import define_flag, get_flag

define_flag("ps_max_message_bytes", 1 << 31,
            "Max PS wire frame payload (rpc max-size knob)")

MAGIC = b"PT"
VERSION = 1

# messages
PUSH_GRAD = 1          # name, trainer_id u64, grad arr
PULL_PARAM = 2         # name, min_round u64
PULL_SPARSE = 3        # name, ids arr
PUSH_SPARSE = 4        # name, ids arr, grads arr, lr f64 (NaN=None)
BARRIER = 5            # tag, trainer_id u64
CHECKPOINT_NOTIFY = 6  # dirname
LIST_VARS = 7          # -
STOP = 8               # -
SHRINK_TABLE = 9       # name, max_age u64
SHUFFLE_PUSH = 10      # from_trainer u64, npz-packed sample blob arr
SHUFFLE_DONE = 11      # from_trainer u64, sent-count u64
SERVER_INFO = 12       # - (reply: i64 arr [incarnation, min dense round];
                       #    the failover probe — a client reconnecting
                       #    after a pserver restart reads the new
                       #    incarnation token here and re-establishes its
                       #    round expectations instead of deadlocking)
# elastic-membership migration (docs/ELASTIC_TRAINING.md "Resizing the
# pserver fleet"): the coordinator and migration peers speak these with
# client_id=0 (control plane — no retry dedup; every call is idempotent
# or answered-by-state), data frames carry their fleet epoch so a
# server on a different epoch can fence them with WRONG_EPOCH
MIGRATE_PLAN = 13      # plan json (coordinator -> source: stream these
                       #   units to their targets; reply OK_ARR [rows])
MIGRATE_BEGIN = 14     # spec json (source -> target: units incoming)
MIGRATE_CHUNK = 15     # meta json, npz-blob u8 arr, crc32 u64
MIGRATE_END = 16       # end json (target stages durable shadows;
                       #   reply OK_ARR [staged rows])
MIGRATE_COMMIT = 17    # commit json {"epoch","map"} (idempotent;
                       #   reply OK_ARR [server's epoch])
MIGRATE_ABORT = 18     # abort json {"epoch"} (drop staging, unfreeze)
EPOCH_MAP = 19         # - (reply OK_JSON {"epoch","map"})
# epoch-fenced data variants (PSClient sends these once it holds a
# shard map; schema = epoch u64 + the legacy kind's fields)
PUSH_GRAD_E = 20       # epoch u64, name, trainer_id u64, grad arr
PULL_PARAM_E = 21      # epoch u64, name, min_round u64
PULL_SPARSE_E = 22     # epoch u64, name, ids arr
PUSH_SPARSE_E = 23     # epoch u64, name, ids arr, grads arr, lr f64
# responses
OK = 100               # -
OK_ARR = 101           # arr
OK_NAMES = 102         # dense-names str, sparse-names str ("\n"-joined)
ERR = 103              # message
OK_JSON = 104          # json str
WRONG_EPOCH = 105      # server's epoch u64, shard-map json str (the
                       #   fencing reply: nothing was applied; the
                       #   client adopts the newer map and re-routes)

STR, U64, F64, ARR = "str", "u64", "f64", "arr"

SCHEMAS = {
    PUSH_GRAD: (STR, U64, ARR),
    PULL_PARAM: (STR, U64),
    PULL_SPARSE: (STR, ARR),
    PUSH_SPARSE: (STR, ARR, ARR, F64),
    BARRIER: (STR, U64),
    CHECKPOINT_NOTIFY: (STR,),
    LIST_VARS: (),
    STOP: (),
    SHRINK_TABLE: (STR, U64),
    SHUFFLE_PUSH: (U64, ARR),
    SHUFFLE_DONE: (U64, U64),
    SERVER_INFO: (),
    MIGRATE_PLAN: (STR,),
    MIGRATE_BEGIN: (STR,),
    MIGRATE_CHUNK: (STR, ARR, U64),
    MIGRATE_END: (STR,),
    MIGRATE_COMMIT: (STR,),
    MIGRATE_ABORT: (STR,),
    EPOCH_MAP: (),
    PUSH_GRAD_E: (U64, STR, U64, ARR),
    PULL_PARAM_E: (U64, STR, U64),
    PULL_SPARSE_E: (U64, STR, ARR),
    PUSH_SPARSE_E: (U64, STR, ARR, ARR, F64),
    OK: (),
    OK_ARR: (ARR,),
    OK_NAMES: (STR, STR),
    ERR: (STR,),
    OK_JSON: (STR,),
    WRONG_EPOCH: (U64, STR),
}

# kinds whose server-side effect must not re-apply on a retried frame.
# BARRIER is here because its set-based fan-in is only idempotent
# within an unreleased round: a retry landing after the release would
# enroll the trainer in the NEXT generation and desynchronize rounds.
# The MIGRATE_* control plane is deliberately absent: it is spoken with
# client_id=0 (dedup bypass) and every call is idempotent by state
# (COMMIT/ABORT compare epochs, PLAN/BEGIN/CHUNK/END restage).
MUTATING = {PUSH_GRAD, PUSH_SPARSE, CHECKPOINT_NOTIFY, STOP, BARRIER,
            SHRINK_TABLE, PUSH_GRAD_E, PUSH_SPARSE_E}

_HDR = struct.Struct("<2sBBQQQ")
_U16 = struct.Struct("<H")
_U64 = struct.Struct("<Q")
_F64 = struct.Struct("<d")
_U32 = struct.Struct("<I")

_DTYPES = {1: np.float32, 2: np.float64, 3: np.int32, 4: np.int64,
           5: np.uint8, 6: np.bool_}
_DTYPE_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


def max_message_bytes():
    """Upper bound on a frame's payload (validated before allocation);
    FLAGS_ps_max_message_bytes overrides (rpc_client.h's max-size knob).
    """
    return int(get_flag("ps_max_message_bytes"))


class WireError(Exception):
    """Malformed / oversized / unsupported frame."""


def _enc_field(ftype, v, out):
    if ftype == STR:
        b = v.encode("utf-8")
        if len(b) > 0xFFFF:
            raise WireError(f"string too long ({len(b)})")
        out.append(_U16.pack(len(b)))
        out.append(b)
    elif ftype == U64:
        out.append(_U64.pack(int(v)))
    elif ftype == F64:
        out.append(_F64.pack(float("nan") if v is None else float(v)))
    elif ftype == ARR:
        a = np.ascontiguousarray(v)
        code = _DTYPE_CODES.get(a.dtype)
        if code is None:
            raise WireError(f"unsupported array dtype {a.dtype}")
        if a.ndim > 0xFF:
            raise WireError(f"array rank {a.ndim} too large")
        out.append(struct.pack("<BB", code, a.ndim))
        for d in a.shape:
            out.append(_U32.pack(d))
        # zero-copy data view (empty arrays can't cast: shape has a 0)
        out.append(memoryview(a).cast("B") if a.size else b"")
    else:  # pragma: no cover
        raise WireError(f"unknown field type {ftype!r}")


def encode_parts(kind, fields, client_id=0, seq=0):
    """Serialize a message to a list of buffers (header first). Large
    array payloads stay as zero-copy memoryviews of the source arrays —
    the sender writes them with writev/sendmsg instead of concatenating
    (the grpc bytebuffer zero-copy serde role, grpc_bytebuffer_stream)."""
    schema = SCHEMAS.get(kind)
    if schema is None:
        raise WireError(f"unknown message kind {kind}")
    if len(fields) != len(schema):
        raise WireError(f"kind {kind} wants {len(schema)} fields, "
                        f"got {len(fields)}")
    out = []
    for ftype, v in zip(schema, fields):
        _enc_field(ftype, v, out)
    n = sum(len(p) for p in out)
    if n > max_message_bytes():
        raise WireError(f"message too large ({n} bytes)")
    hdr = _HDR.pack(MAGIC, VERSION, kind, client_id, seq, n)
    # coalesce small pieces; keep big array buffers as separate views
    parts = [hdr]
    small = []
    for p in out:
        if len(p) < 65536:
            small.append(bytes(p))
        else:
            if small:
                parts.append(b"".join(small))
                small = []
            parts.append(p)
    if small:
        parts.append(b"".join(small))
    return parts


def encode(kind, fields, client_id=0, seq=0):
    """Serialize a message to one bytes blob (header + payload)."""
    return b"".join(bytes(p) for p in
                    encode_parts(kind, fields, client_id, seq))


class _Reader:
    def __init__(self, buf):
        self.buf = memoryview(buf)   # slices below are zero-copy
        self.off = 0

    def take(self, n):
        if self.off + n > len(self.buf):
            raise WireError("truncated payload")
        v = self.buf[self.off:self.off + n]
        self.off += n
        return v

    def done(self):
        if self.off != len(self.buf):
            raise WireError(
                f"trailing bytes in payload ({len(self.buf) - self.off})")


def _dec_field(ftype, r):
    if ftype == STR:
        (n,) = _U16.unpack(bytes(r.take(_U16.size)))
        return bytes(r.take(n)).decode("utf-8")
    if ftype == U64:
        return _U64.unpack(bytes(r.take(_U64.size)))[0]
    if ftype == F64:
        v = _F64.unpack(bytes(r.take(_F64.size)))[0]
        return None if np.isnan(v) else v
    if ftype == ARR:
        code, ndim = struct.unpack("<BB", bytes(r.take(2)))
        dt = _DTYPES.get(code)
        if dt is None:
            raise WireError(f"unknown dtype code {code}")
        dims = [_U32.unpack(bytes(r.take(_U32.size)))[0]
                for _ in range(ndim)]
        # python-int product: attacker-chosen u32 dims must not wrap a
        # fixed-width accumulator past the size guard
        size = 1
        for d in dims:
            size *= int(d)
        nbytes = size * np.dtype(dt).itemsize
        if nbytes > max_message_bytes():
            raise WireError(f"array too large ({nbytes} bytes)")
        raw = r.take(nbytes)
        # zero-copy (read-only) view over the received payload buffer.
        # STR fields precede ARR fields in several schemas, so the view
        # can start at an arbitrary byte offset; when that offset is not
        # a multiple of the itemsize the array is copied to an aligned
        # buffer — these arrays are handed by pointer into the native
        # table, and misaligned loads are UB off x86-64/ARM64 and a
        # hazard for SIMD C++ code.
        arr = np.frombuffer(raw, dtype=dt)
        if not arr.flags.aligned:
            arr = arr.copy()
        return arr.reshape(dims)
    raise WireError(f"unknown field type {ftype!r}")  # pragma: no cover


def decode_header(hdr):
    """Validate and unpack a frame header. Returns
    (kind, client_id, seq, payload_len)."""
    if len(hdr) != _HDR.size:
        raise WireError("short header")
    magic, ver, kind, client_id, seq, n = _HDR.unpack(hdr)
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise WireError(f"unsupported protocol version {ver}")
    if kind not in SCHEMAS:
        raise WireError(f"unknown message kind {kind}")
    if n > max_message_bytes():
        raise WireError(f"oversized frame ({n} bytes)")
    return kind, client_id, seq, n


def decode_payload(kind, payload):
    """Decode a validated kind's payload into its field tuple. ANY
    decoding failure surfaces as WireError — the malformed-frame
    contract callers rely on (a typed ERR reply, never a crash)."""
    try:
        r = _Reader(payload)
        fields = tuple(_dec_field(ftype, r) for ftype in SCHEMAS[kind])
        r.done()
        return fields
    except WireError:
        raise
    except Exception as e:
        raise WireError(f"malformed payload: {type(e).__name__}: {e}")


HEADER_SIZE = _HDR.size


# -- shared socket framing (one implementation for every wire user) -------

def send_frame(sock, kind, fields, client_id=0, seq=0):
    """writev via sendmsg: large array payloads go out zero-copy."""
    parts = [memoryview(p).cast("B")
             for p in encode_parts(kind, fields, client_id, seq)]
    while parts:
        sent = sock.sendmsg(parts)
        while parts and sent >= len(parts[0]):
            sent -= len(parts[0])
            parts.pop(0)
        if parts and sent:
            parts[0] = parts[0][sent:]


def recv_exact(sock, n):
    """Read exactly n bytes into a preallocated buffer. The buffer is
    an UNINITIALIZED np.empty, not bytearray(n): bytearray zeroes its
    memory, a full extra pass over a 64 MB frame that recv_into
    immediately overwrites."""
    import numpy as _np
    buf = _np.empty(n, _np.uint8)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:])
        if not r:
            raise ConnectionError("peer closed")
        got += r
    return buf.data


def recv_frame(sock):
    """Read one validated frame: (kind, client_id, seq, fields).
    Raises WireError on malformed bytes — NOTHING from the socket is
    ever evaluated, only fixed-schema fields are decoded."""
    kind, client_id, seq, n = decode_header(
        recv_exact(sock, HEADER_SIZE))
    fields = decode_payload(kind, recv_exact(sock, n))
    return kind, client_id, seq, fields
