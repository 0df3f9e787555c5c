"""CTC ops: the port of ``paddle_tpu/ops/ctc.py`` (loss, greedy alignment,
edit distance).

Parity targets: warpctc_op.cc (the reference wraps the warp-ctc library),
ctc_align_op.cc, edit_distance_op.cc and ``fluid.layers.ctc_greedy_decoder``.
Plain PyTorch: no Pallas body bounds them.

- :func:`ctc_loss` is the JAX op's log-space alpha recursion over the
  blank-interleaved label sequence, with its ``-1e30`` in place of -inf and
  alpha frozen past each logit length: a Python loop over time on the
  tensors' device (a few elementwise launches a step, no host read). Its
  gradient is autograd's through ``torch.logaddexp``.
- :func:`ctc_align` compacts each row stably (merge repeats, drop blanks)
  by a cumulative sum and one scatter, on the device.
- :func:`edit_distance` runs the Levenshtein rows on the device, one
  vectorised step per hypothesis token: within a row, ``row[j] = min(a_j,
  row[j-1] + 1)`` is ``j + cummin(a_k - k)``, exact in fp32 for integer
  costs. The lengths are never read on the host.
"""

import torch

__all__ = ["ctc_loss", "warpctc", "ctc_align", "ctc_greedy_decoder",
           "edit_distance"]

_NEG = -1e30


def _lengths(v, b, full, device):
    if v is None:
        return torch.full((b,), full, dtype=torch.int64, device=device)
    return torch.as_tensor(v, device=device).to(torch.int64)


def _shift(a, k, fill):
    """``a`` [B, S] moved k places right along S, ``fill`` coming in."""
    if k >= a.shape[1]:
        return torch.full_like(a, fill)
    return torch.cat([torch.full_like(a[:, :k], fill), a[:, :-k]], dim=1)


def ctc_loss(logits, labels, logit_lengths=None, label_lengths=None,
             blank=0, norm_by_times=False):
    """Connectionist Temporal Classification loss.

    Args:
      logits: ``[batch, time, num_classes]`` unnormalized activations.
      labels: int ``[batch, max_label_len]`` target ids (no blanks).
      logit_lengths / label_lengths: int ``[batch]``; None = full.
      blank: the blank class id.
      norm_by_times: divide each loss by its logit length (warpctc_op.cc's
        ``norm_by_times``).

    Returns:
      ``[batch]`` negative log-likelihoods.
    """
    b, t, c = logits.shape
    dev = logits.device
    labels = labels.to(torch.int64)
    l = labels.shape[1]
    logit_lengths = _lengths(logit_lengths, b, t, dev)
    label_lengths = _lengths(label_lengths, b, l, dev)
    logp = torch.log_softmax(logits, dim=-1)
    s = 2 * l + 1
    # the extended sequence: blanks interleaved with the labels
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels
    can_skip = (ext != blank) & (ext != _shift(ext, 2, -1))
    pos = torch.arange(s, device=dev)[None]
    valid_s = pos < (2 * label_lengths[:, None] + 1)
    has_label = label_lengths > 0
    # emissions of every extended position at every step: [B, T, S] (an id
    # outside [0, C) wraps, as the JAX gather normalizes it; such a
    # position lies past the label length)
    em = torch.gather(logp, 2, (ext % c)[:, None, :].expand(b, t, s))
    first = (pos == 0) | ((pos == 1) & has_label[:, None])
    alpha = torch.where(first & valid_s, em[:, 0], _NEG)
    live = torch.arange(t, device=dev)[None] < logit_lengths[:, None]
    for ti in range(1, t):
        a_m2 = torch.where(can_skip, _shift(alpha, 2, _NEG), _NEG)
        merged = torch.logaddexp(torch.logaddexp(alpha, _shift(alpha, 1,
                                                               _NEG)), a_m2)
        nxt = torch.where(valid_s, merged + em[:, ti], _NEG)
        alpha = torch.where(live[:, ti, None], nxt, alpha)
    end = 2 * label_lengths
    a_end = torch.gather(alpha, 1, end[:, None])[:, 0]
    a_end1 = torch.where(
        has_label,
        torch.gather(alpha, 1, torch.clamp(end - 1, min=0)[:, None])[:, 0],
        _NEG)
    loss = -torch.logaddexp(a_end, a_end1)
    if norm_by_times:
        loss = loss / torch.clamp(logit_lengths, min=1).to(loss.dtype)
    return loss


def warpctc(input, label, input_length=None, label_length=None,
            blank=0, norm_by_times=False):
    """The reference's name for :func:`ctc_loss` (warpctc_op.cc)."""
    return ctc_loss(input, label, input_length, label_length, blank,
                    norm_by_times)


def ctc_align(input, input_length=None, blank=0, padding_value=0):
    """Greedy CTC collapse: merge repeats, drop blanks (ctc_align_op.cc).

    Args:
      input: int frame-wise predictions ``[batch, time]`` or float logits
        ``[batch, time, classes]`` (their first-max argmax).

    Returns:
      (aligned int32 ``[batch, time]`` padded with ``padding_value``,
       int32 lengths ``[batch]``).
    """
    if input.dim() == 3:
        input = torch.argmax(input, dim=-1)
    input = input.to(torch.int32)
    b, t = input.shape
    dev = input.device
    tmask = torch.arange(t, device=dev)[None] < _lengths(
        input_length, b, t, dev)[:, None]
    prev = torch.cat([torch.full_like(input[:, :1], -1), input[:, :-1]], 1)
    keep = (input != blank) & (input != prev) & tmask
    # stable compaction: each kept token's place; dropped ones land past
    # the end, which is cut off
    idx = torch.cumsum(keep.to(torch.int64), dim=1) - 1
    where_to = torch.where(keep, idx, t)
    out = torch.full((b, t + 1), padding_value, dtype=torch.int32,
                     device=dev)
    out = out.scatter(1, where_to, torch.where(
        keep, input, torch.full_like(input, padding_value)))
    return out[:, :t], keep.sum(dim=1).to(torch.int32)


def edit_distance(input, label, input_length=None, label_length=None,
                  normalized=True):
    """Levenshtein distance between hypothesis and reference rows
    (edit_distance_op.cc).

    An empty reference gives the hypothesis length (the reference op's
    convention); ``normalized`` divides by the reference length where it is
    not 0. Returns (fp32 distances ``[batch]``, the batch size as an int32
    scalar).
    """
    hyp, ref = input.to(torch.int32), label.to(torch.int32)
    b, n = hyp.shape
    m = ref.shape[1]
    dev = hyp.device
    hlen = _lengths(input_length, b, n, dev)
    rlen = _lengths(label_length, b, m, dev)
    j = torch.arange(m + 1, dtype=torch.float32, device=dev)
    row = j[None].expand(b, m + 1)
    for i in range(1, n + 1):
        sub = row[:, :-1] + (hyp[:, i - 1:i] != ref).to(torch.float32)
        dele = row[:, 1:] + 1.0
        a = torch.cat([torch.full((b, 1), float(i), device=dev),
                       torch.minimum(sub, dele)], dim=1)
        new = j + torch.cummin(a - j, dim=1).values
        row = torch.where((i <= hlen)[:, None], new, row)
    dist = torch.gather(row, 1, rlen[:, None])[:, 0]
    dist = torch.where(rlen == 0, hlen.to(torch.float32), dist)
    if normalized:
        dist = torch.where(rlen > 0, dist / torch.clamp(rlen, min=1).to(
            torch.float32), dist)
    return dist, torch.full((), b, dtype=torch.int32, device=dev)


def ctc_greedy_decoder(input, blank=None, input_length=None,
                       padding_value=0, name=None):
    """fluid.layers.ctc_greedy_decoder parity: the first-max argmax over
    classes per frame, then :func:`ctc_align`. ``blank`` defaults to
    num_classes - 1, as in the reference.

    Returns (decoded int32 [B, T] padded with ``padding_value``, int32
    lengths [B]).
    """
    if input.dim() != 3:
        raise ValueError("ctc_greedy_decoder expects [batch, time, classes]")
    if blank is None:
        blank = input.shape[-1] - 1
    return ctc_align(torch.argmax(input, dim=-1), input_length=input_length,
                     blank=blank, padding_value=padding_value)
