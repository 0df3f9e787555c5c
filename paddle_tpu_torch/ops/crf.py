"""Linear-chain CRF ops: the port of ``paddle_tpu/ops/crf.py``.

The reference's CRF operators (ref: paddle/fluid/operators/
linear_chain_crf_op.cc, crf_decoding_op.cc) over dense-padded
[batch, time, num_tags] emissions with an explicit ``length`` vector. The
JAX package runs the time recursions as ``lax.scan``; here they are Python
loops over time, each step a few ops on the card with the masks as tensors:
no step reads a value on the host. The gradient is autograd's over the
forward.

Transition layout as in the reference, so weights are interchangeable:
``[num_tags + 2, num_tags]``, row 0 the start weights, row 1 the stop
weights, rows 2: the [num_tags, num_tags] tag-to-tag transitions.
"""

import torch

__all__ = ["linear_chain_crf", "crf_decoding"]


def _split_transition(transition):
    return transition[0], transition[1], transition[2:]


def _lengths(length, b, t, device):
    if length is None:
        return torch.full((b,), t, dtype=torch.int32, device=device)
    return torch.as_tensor(length, device=device).to(torch.int32)


def linear_chain_crf(input, transition, label, length=None):
    """Negative log-likelihood of tag sequences under a linear-chain CRF.

    Args:
      input: emissions ``[batch, time, num_tags]`` (unnormalized).
      transition: ``[num_tags + 2, num_tags]`` (see the module docstring).
      label: int tags ``[batch, time]`` (or ``[batch, time, 1]``).
      length: int ``[batch]`` valid lengths; None means the full time axis.

    Returns:
      ``[batch]`` per-sequence negative log-likelihood (log_norm -
      path_score), the reference op's output.
    """
    input = torch.as_tensor(input)
    label = torch.as_tensor(label, device=input.device)
    if label.dim() == 3:
        label = label[..., 0]
    label = label.long()
    b, t, d = input.shape
    length = _lengths(length, b, t, input.device)
    start, stop, trans = _split_transition(torch.as_tensor(transition))

    steps = torch.arange(t, device=input.device)
    mask = (steps[None, :] < length[:, None]).to(input.dtype)

    # log partition: the forward algorithm, alpha carried past the end
    alpha = input[:, 0, :] + start[None, :]
    for s in range(1, t):
        nxt = torch.logsumexp(alpha[:, :, None] + trans[None, :, :],
                              dim=1) + input[:, s, :]
        alpha = torch.where(mask[:, s, None] > 0, nxt, alpha)
    log_norm = torch.logsumexp(alpha + stop[None, :], dim=1)

    # score of the gold path
    em_score = torch.sum(
        torch.gather(input, 2, label[..., None])[..., 0] * mask, dim=1)
    tr_score = torch.sum(trans[label[:, :-1], label[:, 1:]] * mask[:, 1:],
                         dim=1)
    last_idx = torch.clamp(length - 1, min=0).long()
    last_tag = torch.gather(label, 1, last_idx[:, None])[:, 0]
    gold = em_score + tr_score + start[label[:, 0]] + stop[last_tag]
    return log_norm - gold


def crf_decoding(input, transition, length=None):
    """Viterbi decode: the most likely tag path of each sequence.

    Returns int32 ``[batch, time]`` paths; steps past ``length`` are 0 (the
    reference emits LoD-cut sequences; callers mask with ``length``). Ties
    take the first maximum, as ``jnp.argmax`` does; past a row's end the
    back-pointers are the identity.
    """
    input = torch.as_tensor(input)
    b, t, d = input.shape
    length = _lengths(length, b, t, input.device)
    start, stop, trans = _split_transition(torch.as_tensor(transition))

    steps = torch.arange(t, device=input.device)
    mask = steps[None, :] < length[:, None]
    ident = torch.arange(d, device=input.device)[None, :]

    score = input[:, 0, :] + start[None, :]
    backs = []
    for s in range(1, t):
        cand = score[:, :, None] + trans[None, :, :]
        best, back = torch.max(cand, dim=1)             # first maximum
        m = mask[:, s, None]
        score = torch.where(m, best + input[:, s, :], score)
        backs.append(torch.where(m, back, ident))
    tag = torch.argmax(score + stop[None, :], dim=1)    # [b]
    path = [tag]
    for back in reversed(backs):
        tag = torch.gather(back, 1, tag[:, None])[:, 0]
        path.append(tag)
    path = torch.stack(path[::-1], dim=1).to(torch.int32)   # [b, t]
    return torch.where(mask, path, torch.zeros_like(path))
