"""fluid.recordio_writer parity; the port of
``paddle_tpu/recordio_writer.py`` (the same records, so either package's
``layers.open_files`` reads the other's files).

Parity: python/paddle/fluid/recordio_writer.py
(convert_reader_to_recordio_file, convert_reader_to_recordio_files)
over the native RecordIO writer (native/src/recordio.cc — chunked,
CRC-checked, the reference's paddle/fluid/recordio format role).

Record payload: each sample tuple is serialized as an ``np.savez``
archive with arrays ``f0..fN`` — the exact format
``layers.open_files`` reads back, so convert + open_files round-trips.
"""

import io as _io

import numpy as np

__all__ = ["convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files"]


def _serialize_sample(sample, feeder=None):
    if feeder is not None:
        # reference signature compatibility: the feeder defines field
        # order; we just need positional arrays
        sample = tuple(sample)
    if not isinstance(sample, (tuple, list)):
        sample = (sample,)
    arrays = {}
    for i, v in enumerate(sample):
        arr = np.asarray(v)
        if arr.dtype == object:
            # np.savez would pickle object arrays and layers.open_files
            # (allow_pickle=False) could never read the record back
            raise TypeError(
                f"recordio sample field {i} is object-dtype (ragged/"
                "non-numeric); convert fields to rectangular arrays")
        arrays[f"f{i}"] = arr
    buf = _io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None,
                                    max_num_records=1000,
                                    feed_order=None):
    """Write every sample the reader yields into one RecordIO file;
    returns the record count (reference behavior)."""
    from paddle_tpu_torch import native
    count = 0
    with native.RecordIOWriter(filename,
                               compress=compressor is not None,
                               max_chunk_records=max_num_records) as w:
        for sample in reader_creator():
            w.write(_serialize_sample(sample, feeder))
            count += 1
    return count


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None,
                                     max_num_records=1000,
                                     feed_order=None):
    """Split the stream into numbered files of batch_per_file records
    each (filename-00000, filename-00001, ...); returns the paths."""
    from paddle_tpu_torch import native
    paths, w, count = [], None, 0
    try:
        for sample in reader_creator():
            if w is None or count % batch_per_file == 0:
                if w is not None:
                    w.close()
                path = f"{filename}-{len(paths):05d}"
                paths.append(path)
                w = native.RecordIOWriter(
                    path, compress=compressor is not None,
                    max_chunk_records=max_num_records)
            w.write(_serialize_sample(sample, feeder))
            count += 1
    finally:
        if w is not None:
            w.close()
    return paths
