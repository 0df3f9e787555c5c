"""Dataset download + md5 cache (python/paddle/dataset/common.py parity):
the port of ``paddle_tpu/dataio/common.py``, numpy and the standard
library only.

The builtin dataset family stays SYNTHETIC by default (hermetic CI);
real corpora are opt-in via ``PT_DATASET_REAL=1`` (or passing
``source="real"``), which routes mnist/cifar10 through this module's
`download` — url fetch with md5 verification, retries, and a local
cache under ``$PT_DATA_HOME`` (default ~/.cache/paddle_tpu_torch/dataset),
exactly the reference's DATA_HOME + download(url, module, md5) contract
(ref: python/paddle/dataset/common.py `DATA_HOME`, `download`,
`md5file`).
"""

import gzip
import hashlib
import os
import shutil
import time

import numpy as np

__all__ = ["DATA_HOME", "data_home", "download", "md5file",
           "real_data_enabled"]

DATA_HOME = os.environ.get(
    "PT_DATA_HOME",
    os.path.join(os.path.expanduser("~"), ".cache", "paddle_tpu_torch",
                 "dataset"))


def data_home(module_name=""):
    d = os.path.join(DATA_HOME, module_name)
    os.makedirs(d, exist_ok=True)
    return d


def real_data_enabled():
    """Opt-in switch: real corpora only when PT_DATASET_REAL=1."""
    return os.environ.get("PT_DATASET_REAL", "0") in ("1", "true", "on")


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None, save_name=None, retries=3):
    """Fetch ``url`` into the module's cache dir; verify md5; reuse the
    cached file when it already matches (the reference's download()).
    Raises RuntimeError after ``retries`` failed attempts."""
    import urllib.request

    d = data_home(module_name)
    fname = os.path.join(d, save_name or url.split("/")[-1])
    if os.path.exists(fname) and (md5sum is None
                                  or md5file(fname) == md5sum):
        return fname
    last = None
    tmp = f"{fname}.{os.getpid()}.part"
    for attempt in range(retries):
        try:
            with urllib.request.urlopen(url, timeout=60) as r, \
                    open(tmp, "wb") as f:
                shutil.copyfileobj(r, f)
            if md5sum is not None and md5file(tmp) != md5sum:
                raise RuntimeError(f"md5 mismatch for {url}")
            os.replace(tmp, fname)
            return fname
        except Exception as e:
            last = e
            # never leave a truncated .part behind
            try:
                os.unlink(tmp)
            except OSError:
                pass
            if attempt < retries - 1:   # no backoff after the last try
                time.sleep(min(2 ** attempt, 5))
    raise RuntimeError(f"download failed after {retries} attempts: "
                       f"{url}: {last}")


# ---------------------------------------------------------------------------
# real-corpus readers (mnist idx / cifar-10 python pickle formats)
# ---------------------------------------------------------------------------
MNIST_URLS = {
    # Yann LeCun's original host frequently 403s; ossci mirror carries
    # the same idx files (same md5s the reference pins,
    # ref: python/paddle/dataset/mnist.py TRAIN_IMAGE_MD5 etc.)
    "train_images": ("https://ossci-datasets.s3.amazonaws.com/mnist/"
                     "train-images-idx3-ubyte.gz",
                     "f68b3c2dcbeaaa9fbdd348bbdeb94873"),
    "train_labels": ("https://ossci-datasets.s3.amazonaws.com/mnist/"
                     "train-labels-idx1-ubyte.gz",
                     "d53e105ee54ea40749a09fcbcd1e9432"),
    "test_images": ("https://ossci-datasets.s3.amazonaws.com/mnist/"
                    "t10k-images-idx3-ubyte.gz",
                    "9fb629c4189551a2d022fa330f9573f3"),
    "test_labels": ("https://ossci-datasets.s3.amazonaws.com/mnist/"
                    "t10k-labels-idx1-ubyte.gz",
                    "ec29112dd5afa0611ce80d1b7f02629c"),
}

CIFAR10_URL = ("https://www.cs.toronto.edu/~kriz/"
               "cifar-10-python.tar.gz",
               "c58f30108f718f92721af3b95e74349a")


def _read_idx_images(path):
    with gzip.open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[4:8], "big")
    rows = int.from_bytes(data[8:12], "big")
    cols = int.from_bytes(data[12:16], "big")
    imgs = np.frombuffer(data, np.uint8, offset=16).reshape(
        n, rows * cols)
    return imgs


def _read_idx_labels(path):
    with gzip.open(path, "rb") as f:
        data = f.read()
    n = int.from_bytes(data[4:8], "big")
    return np.frombuffer(data, np.uint8, offset=8, count=n)


def mnist_reader(split="train"):
    """Zero-arg reader factory over the REAL mnist idx files (the
    reference's dataset.mnist normalization: float32 in [-1, 1])."""
    img_url, img_md5 = MNIST_URLS[f"{split}_images"]
    lab_url, lab_md5 = MNIST_URLS[f"{split}_labels"]
    img_path = download(img_url, "mnist", img_md5)
    lab_path = download(lab_url, "mnist", lab_md5)

    def reader():
        imgs = _read_idx_images(img_path)
        labels = _read_idx_labels(lab_path)
        for i in range(len(labels)):
            yield (imgs[i].astype(np.float32) / 127.5 - 1.0,
                   int(labels[i]))

    return reader


def cifar10_reader(split="train"):
    """Zero-arg reader factory over the REAL cifar-10 python batches
    (float32 in [0, 1], flattened 3*32*32 — the reference's layout)."""
    import pickle
    import tarfile

    url, md5 = CIFAR10_URL
    path = download(url, "cifar", md5)
    names = ([f"data_batch_{i}" for i in range(1, 6)]
             if split == "train" else ["test_batch"])

    def reader():
        with tarfile.open(path) as tf:
            for m in tf.getmembers():
                if any(m.name.endswith(n) for n in names):
                    # trusted artifact pinned by md5 above (the
                    # reference unpickles these batches the same way)
                    blob = pickle.load(tf.extractfile(m),
                                       encoding="bytes")
                    data = blob[b"data"].astype(np.float32) / 255.0
                    for row, lab in zip(data, blob[b"labels"]):
                        yield row, int(lab)

    return reader


def digits_reader(split="train", test_fraction=0.2, seed=42):
    """Zero-arg reader factory over the REAL scikit-learn digits corpus
    (1,797 8x8 handwritten digits, UCI Optical Recognition of
    Handwritten Digits — bundled with sklearn, so it works with zero
    network egress). The OFFLINE stand-in for the recognize_digits
    convergence run when the mnist idx download is unreachable: same
    task shape (images in [-1, 1], integer labels 0-9), deterministic
    train/test split.
    """
    from sklearn.datasets import load_digits

    d = load_digits()
    imgs = (d.images.reshape(len(d.images), -1)
            .astype(np.float32) / 8.0 - 1.0)      # pixel range 0..16
    labels = d.target.astype(np.int64)
    rng = np.random.RandomState(seed)
    order = rng.permutation(len(labels))
    n_test = int(len(labels) * test_fraction)
    idx = order[n_test:] if split == "train" else order[:n_test]

    def reader():
        for i in idx:
            yield imgs[i], int(labels[i])

    return reader


# --- dataset-to-file utilities (ref python/paddle/dataset/common.py:
# split, cluster_files_reader, convert) --------------------------------

def _npz_dump(obj, f):
    """Default dumper: np.savez of the sample list (structural, no
    pickle — the repo's artifact discipline; pass your own dumper for
    the reference's pickle format)."""
    import io as _io
    import numpy as np
    arrays = {}
    for i, sample in enumerate(obj):
        if not isinstance(sample, (tuple, list)):
            sample = (sample,)
        for j, field in enumerate(sample):
            arr = np.asarray(field)
            if arr.dtype == object:
                # np.savez would PICKLE object arrays — and the paired
                # loader (allow_pickle=False) could never read them
                # back; fail at dump time with a usable message
                raise TypeError(
                    f"split: sample {i} field {j} is object-dtype "
                    "(ragged/non-numeric); convert fields to rectangular "
                    "arrays, or pass a custom dumper/loader pair")
            arrays[f"s{i}_f{j}"] = arr
        arrays[f"s{i}_n"] = np.asarray(len(sample))
    buf = _io.BytesIO()
    np.savez(buf, n=np.asarray(len(obj)), **arrays)
    f.write(buf.getvalue())


def _npz_load(f):
    import io as _io
    import numpy as np
    with np.load(_io.BytesIO(f.read())) as z:
        n = int(z["n"])
        out = []
        for i in range(n):
            k = int(z[f"s{i}_n"])
            out.append(tuple(z[f"s{i}_f{j}"] for j in range(k)))
        return out


def split(reader, line_count, suffix="%05d.npz", dumper=None):
    """dataset.common.split parity: dump a reader into numbered chunk
    files of line_count samples (dumper(obj, f); default: structural
    npz)."""
    dumper = dumper or _npz_dump
    if not callable(dumper):
        raise TypeError("dumper should be callable")
    lines, idx, written = [], 0, []
    for d in reader():
        lines.append(d)
        if len(lines) == line_count:
            path = suffix % idx
            with open(path, "wb") as f:
                dumper(lines, f)
            written.append(path)
            lines, idx = [], idx + 1
    if lines:
        path = suffix % idx
        with open(path, "wb") as f:
            dumper(lines, f)
        written.append(path)
    return written


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """dataset.common.cluster_files_reader parity: round-robin the
    sorted file list over trainers, yield this trainer's samples."""
    loader = loader or _npz_load

    def reader():
        import glob
        if not callable(loader):
            raise TypeError("loader should be callable")
        file_list = sorted(glob.glob(files_pattern))
        for idx, fn in enumerate(file_list):
            if idx % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    yield from loader(f)
    return reader


def convert(output_path, reader, line_count, name_prefix):
    """dataset.common.convert parity: reader -> RecordIO shard files
    (the np.savez record format layers.open_files reads), written by the
    port's ``recordio_writer``."""
    import os
    from paddle_tpu_torch.recordio_writer import convert_reader_to_recordio_files
    return convert_reader_to_recordio_files(
        os.path.join(output_path, name_prefix), line_count, reader)
