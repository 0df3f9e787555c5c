"""The static path's ``mean``: the port of ``paddle_tpu/ops/reduce.py``'s
(mean_op.cc parity: the scalar mean of all elements)."""

__all__ = ["mean"]


def mean(x, name=None):
    return x.mean()
