"""Loss ops: the port of ``paddle_tpu/ops/loss.py``, every name of its
``__all__``, in plain PyTorch (none of them reaches a kernel, as in the JAX
package; the fused kernel is ``ops.kernels.softmax_cross_entropy``).

Parity targets: cross_entropy_op.cc, softmax_with_cross_entropy_op.cc,
sigmoid_cross_entropy_with_logits_op.cc, squared_l2_distance_op.cc,
smooth_l1_loss_op.cc, huber_loss_op.cc, log_loss_op.cc, hinge_loss_op.cc,
margin_rank_loss_op.cc, rank_loss_op.cc, kldiv_loss_op.cc, bpr_loss_op.cc,
cos_sim_op.cc, modified_huber_loss_op.cc, mse (square_error),
teacher_student_sigmoid_loss_op.cc, npair_loss, dice_loss and
sampled_softmax_with_cross_entropy (sample_logits_op.cc).

At their kinks the losses take the JAX functions' gradients: ``jnp.maximum``
and ``jnp.clip`` split a tie in half and ``jnp.abs`` has gradient 1 at 0,
so ``sigmoid_cross_entropy_with_logits`` has gradient ``-label`` at logit 0
(not the math's ``0.5 - label``) and ``hinge_loss`` half a unit at the
hinge.
"""

import torch
import torch.nn.functional as F

from paddle_tpu_torch.ops.math import _abs, _clip, _maximum

__all__ = [
    "cross_entropy", "softmax_with_cross_entropy",
    "sigmoid_cross_entropy_with_logits", "square_error_cost",
    "smooth_l1", "huber_loss", "log_loss", "hinge_loss",
    "margin_rank_loss", "rank_loss", "kldiv_loss", "bpr_loss", "cos_sim",
    "modified_huber_loss", "mse_loss", "teacher_student_sigmoid_loss",
    "npair_loss", "dice_loss", "sampled_softmax_with_cross_entropy",
]


def _squeeze_label(label):
    if label.dim() and label.shape[-1] == 1:
        return label[..., 0]
    return label


def cross_entropy(input, label, soft_label=False, ignore_index=-100,
                  name=None):
    """cross_entropy_op.cc parity: ``input`` is a probability distribution
    (after softmax); returns [..., 1]."""
    eps = 1e-12
    if soft_label:
        return -torch.sum(label * torch.log(input + eps), dim=-1,
                          keepdim=True)
    lab = _squeeze_label(label)
    picked = torch.gather(input, -1, lab[..., None].long())
    loss = -torch.log(picked + eps)
    if ignore_index >= 0:
        loss = loss.masked_fill(lab[..., None] == ignore_index, 0.0)
    return loss


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, return_softmax=False,
                               axis=-1, name=None):
    """softmax_with_cross_entropy_op.cc parity: the numerically stable
    ``log_softmax`` form. ``label`` is logits-shaped with the class axis of
    size 1, or has the class axis dropped (hard labels), or is a
    distribution over the classes (``soft_label``)."""
    logp = F.log_softmax(logits, dim=axis)
    if soft_label:
        loss = -torch.sum(label * logp, dim=axis, keepdim=True)
    else:
        lab = torch.as_tensor(label)
        if lab.dim() != logp.dim():
            lab = lab.unsqueeze(axis)
        labx = lab.long()
        loss = -torch.gather(logp, axis, labx)
        if ignore_index >= 0:
            loss = loss.masked_fill(labx == ignore_index, 0.0)
    if return_softmax:
        return loss, torch.exp(logp)
    return loss


def sigmoid_cross_entropy_with_logits(x, label, ignore_index=-100,
                                      normalize=False, name=None):
    """sigmoid_cross_entropy_with_logits_op.cc parity."""
    loss = (_maximum(x, 0) - x * label
            + torch.log1p(torch.exp(-_abs(x))))
    valid = label != ignore_index
    loss = torch.where(valid, loss, 0.0)
    if normalize:
        loss = loss / torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
    return loss


def square_error_cost(input, label, name=None):
    return torch.square(input - label)


def mse_loss(input, label):
    return torch.mean(torch.square(input - label))


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=1.0,
              name=None):
    """smooth_l1_loss_op.cc parity; returns [N, 1] summed over trailing
    dims."""
    sigma2 = sigma * sigma
    diff = x - y
    if inside_weight is not None:
        diff = diff * inside_weight
    ad = torch.abs(diff)
    loss = torch.where(ad < 1.0 / sigma2, 0.5 * sigma2 * diff * diff,
                       ad - 0.5 / sigma2)
    if outside_weight is not None:
        loss = loss * outside_weight
    return loss.reshape(loss.shape[0], -1).sum(1, keepdim=True)


def huber_loss(input, label, delta=1.0, name=None):
    d = label - input
    ad = torch.abs(d)
    return torch.where(ad <= delta, 0.5 * d * d, delta * (ad - 0.5 * delta))


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def hinge_loss(input, label, name=None):
    return _maximum(1.0 - input * (2 * label - 1), 0.0)


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    return _maximum(-label * (left - right) + margin, 0.0)


def rank_loss(label, left, right, name=None):
    d = left - right
    return torch.log1p(torch.exp(d)) - label * d


def kldiv_loss(x, target, reduction="mean", name=None):
    """kldiv_loss_op.cc parity: x is log-prob, target is prob."""
    loss = target * (torch.log(torch.clamp(target, min=1e-12)) - x)
    loss = torch.where(target > 0, loss, 0.0)
    if reduction == "mean":
        return torch.mean(loss)
    if reduction == "sum":
        return torch.sum(loss)
    if reduction == "batchmean":
        return torch.sum(loss) / x.shape[0]
    return loss


def bpr_loss(input, label, name=None):
    """bpr_loss_op.cc parity: Bayesian personalized ranking over the
    correct class against the others."""
    lab = _squeeze_label(label).long()
    pos = torch.gather(input, 1, lab[:, None])
    loss = torch.log1p(torch.exp(input - pos))
    n = input.shape[1]
    mask = F.one_hot(lab, n).to(loss.dtype)
    return torch.sum(loss * (1 - mask), dim=1, keepdim=True) / (n - 1)


def cos_sim(x, y, name=None):
    """cos_sim_op.cc parity: row-wise cosine similarity, y broadcastable."""
    x2 = torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
    y2 = torch.sqrt(torch.sum(torch.square(y), dim=-1, keepdim=True))
    xy = torch.sum(x * y, dim=-1, keepdim=True)
    return xy / (x2 * y2 + 1e-12)


def modified_huber_loss(input, label, name=None):
    a = (2 * label - 1) * input
    return torch.where(a < -1, -4.0 * a,
                       torch.square(torch.clamp(1.0 - a, min=0.0)))


def teacher_student_sigmoid_loss(input, label, soft_max_up_bound=15.0,
                                 soft_max_lower_bound=-15.0, name=None):
    x = _clip(input, soft_max_lower_bound, soft_max_up_bound)
    z = torch.as_tensor(label)
    sig = torch.log1p(torch.exp(-_abs(x))) + _maximum(x, 0.0)
    return sig - x * (z > 0.5).to(x.dtype)


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    lab = labels.reshape(-1)
    tgt = (lab[:, None] == lab[None, :]).to(sim.dtype)
    tgt = tgt / torch.sum(tgt, dim=1, keepdim=True)
    ce = -torch.sum(tgt * F.log_softmax(sim, dim=1), dim=1)
    l2 = torch.mean(torch.sum(torch.square(anchor) + torch.square(positive),
                              dim=1))
    return torch.mean(ce) + l2_reg * l2 * 0.25


def dice_loss(input, label, epsilon=1e-5, name=None):
    """fluid.layers.dice_loss parity: ``input`` is per-class probabilities
    [..., C], ``label`` holds class indices [..., 1];
    loss = 1 - 2*|X∩Y| / (|X|+|Y|)."""
    lab = _squeeze_label(label).long()
    one_hot = F.one_hot(lab, input.shape[-1]).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inse = torch.sum(input * one_hot, dim=dims)
    denom = torch.sum(input, dim=dims) + torch.sum(one_hot, dim=dims)
    dice = (2.0 * inse + epsilon) / (denom + epsilon)
    return torch.mean(1.0 - dice)


def sampled_softmax_with_cross_entropy(logits, label, num_samples,
                                       use_customized_samples=False,
                                       customized_samples=None,
                                       customized_probabilities=None,
                                       remove_accidental_hits=True,
                                       seed=0, rng=None, name=None):
    """fluid.layers.sampled_softmax_with_cross_entropy parity
    (sample_logits_op.cc + softmax_with_cross_entropy): softmax CE over
    {true class} ∪ {num_samples negatives} instead of the whole vocabulary;
    returns [B, 1].

    Negatives are uniform over the vocabulary, drawn with ``rng`` (a
    ``torch.Generator`` on the logits' device; default: one seeded with
    ``seed``), or given as ``customized_samples`` ([S] or [B, S]) with
    ``use_customized_samples``. The JAX package draws its own with
    ``jax.random``, so only customized samples give the same numbers in
    both. A sampled negative equal to the true class is pushed to the
    dtype's lowest value when ``remove_accidental_hits``."""
    lab = _squeeze_label(label).long()
    b, v = logits.shape
    if use_customized_samples:
        samples = torch.as_tensor(customized_samples,
                                  device=logits.device).long()
        if samples.dim() == 1:
            samples = samples[None, :].expand(b, samples.shape[0])
    else:
        if rng is None and logits.device.type != "meta":
            # (a Program's shape inference runs on meta tensors, where no
            # generator can be made; there the draw has only a shape)
            rng = torch.Generator(device=logits.device).manual_seed(seed)
        samples = torch.randint(0, v, (b, num_samples), generator=rng,
                                device=logits.device)
    classes = torch.cat([lab[:, None], samples], dim=1)      # [B, 1+S]
    picked = torch.gather(logits, 1, classes)
    if remove_accidental_hits:
        hit = classes[:, 1:] == lab[:, None]
        picked = torch.cat([picked[:, :1], torch.where(
            hit, torch.finfo(picked.dtype).min, picked[:, 1:])], dim=1)
    loss = -F.log_softmax(picked, dim=1)[:, 0]
    return loss[:, None]
