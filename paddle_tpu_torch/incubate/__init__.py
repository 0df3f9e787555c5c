"""incubate namespace: the port of ``paddle_tpu/incubate``'s
``data_generator`` (the MultiSlot dataset-file writers). ``fleet`` is
the distributed item of ROADMAP queue 1."""

from paddle_tpu_torch.incubate import data_generator  # noqa: F401

__all__ = ["data_generator"]
