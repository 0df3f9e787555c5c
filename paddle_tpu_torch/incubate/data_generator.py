"""Dataset-file data generators; the port's copy of
``paddle_tpu/incubate/data_generator.py`` (pure Python: the same lines).

Parity: python/paddle/fluid/incubate/data_generator/__init__.py
(DataGenerator:21, MultiSlotDataGenerator:282). Users subclass,
override ``generate_sample(line)`` (and optionally
``generate_batch``), and the runner emits MultiSlot text lines —
``<n> v1 ... vn`` per slot — the exact format the native MultiSlot
parser reads (native/src/strings.cc, dataio/fluid_dataset.py), so
generated files feed train_from_dataset directly.
"""

import sys

__all__ = ["DataGenerator", "MultiSlotDataGenerator"]


class DataGenerator:
    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32
        self._line_limit = None

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def _set_line_limit(self, line_limit):
        if not isinstance(line_limit, int):
            raise ValueError(f"line_limit {type(line_limit)} must be int")
        if line_limit < 1:
            raise ValueError("line_limit can not be less than 1")
        self._line_limit = line_limit

    # -- user hooks --------------------------------------------------------
    def generate_sample(self, line):
        """Override: return a zero-arg iterator of parsed samples
        ([(slot_name, [values...]), ...]) for one input line."""
        raise NotImplementedError(
            "subclasses must implement generate_sample(line)")

    def generate_batch(self, samples):
        """Optional override: batch-level processing; default yields
        the samples unchanged."""
        def local_iter():
            yield from samples
        return local_iter

    # -- runners -----------------------------------------------------------
    def _flush_batch(self, batch_samples, out):
        for sample in self.generate_batch(batch_samples)():
            out.write(self._gen_str(sample))

    def run_from_memory(self, out=None):
        """Emit samples produced by generate_sample(None) (debug /
        benchmarking path)."""
        out = out or sys.stdout
        batch = []
        for sample in self.generate_sample(None)():
            if sample is None:
                continue
            batch.append(sample)
            if len(batch) == self.batch_size_:
                self._flush_batch(batch, out)
                batch = []
        if batch:
            self._flush_batch(batch, out)

    def run_from_stdin(self, inp=None, out=None):
        """Parse each input line with generate_sample and write
        MultiSlot text to stdout (the dataset-preprocessing pipeline
        contract: hadoop/shell pipes run this script per shard)."""
        inp = inp or sys.stdin
        out = out or sys.stdout
        batch = []
        for n, line in enumerate(inp, 1):
            for sample in self.generate_sample(line)():
                if sample is None:
                    continue
                batch.append(sample)
                if len(batch) == self.batch_size_:
                    self._flush_batch(batch, out)
                    batch = []
            if self._line_limit and n >= self._line_limit:
                break
        if batch:
            self._flush_batch(batch, out)

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator (or override _gen_str)")


class MultiSlotDataGenerator(DataGenerator):
    def _gen_str(self, line):
        """[(name, [v...]), ...] -> "n v1 .. vn m w1 .. wm\\n" and track
        per-slot dtype in _proto_info (uint64 until a float appears)."""
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of generate_sample must be list/tuple of "
                "(name, [values...]) pairs")
        # validate fully into a local proto, THEN commit — a rejected
        # line must not leave half-updated slot state behind
        first = self._proto_info is None
        proto = [] if first else list(self._proto_info)
        if not first and len(line) != len(proto):
            raise ValueError(
                "the field set of two lines are inconsistent: "
                f"{len(line)} vs {len(proto)}")
        parts = []
        for idx, (name, elements) in enumerate(line):
            if not isinstance(name, str):
                raise ValueError(f"slot name {type(name)} must be str")
            if not isinstance(elements, list) or not elements:
                raise ValueError(
                    f"slot '{name}': elements must be a non-empty list "
                    "(pad in generate_sample if needed)")
            if first:
                proto.append((name, "uint64"))
            elif name != proto[idx][0]:
                raise ValueError(
                    f"field name mismatch: require "
                    f"<{proto[idx][0]}>, got <{name}>")
            parts.append(str(len(elements)))
            for elem in elements:
                if isinstance(elem, bool):
                    # bool IS an int subclass but str(True) would write
                    # the literal 'True' into the MultiSlot file
                    raise ValueError(
                        f"slot '{name}': bool elements are not valid "
                        "MultiSlot values — cast to int")
                if isinstance(elem, float):
                    proto[idx] = (name, "float")
                elif not isinstance(elem, int):
                    raise ValueError(
                        f"slot '{name}': element type {type(elem)} must "
                        "be int or float")
                parts.append(str(elem))
        self._proto_info = proto
        return " ".join(parts) + "\n"
