"""Detection op family: the port of ``paddle_tpu/ops/detection.py``, every
public function.

Parity targets: paddle/fluid/operators/detection/ (prior boxes, box coding,
NMS, YOLO, RoI ops, FPN proposal machinery) plus detection_map_op.cc,
roi_align_op.cc, roi_pool_op.cc and psroi_pool_op.cc, as the JAX package
computes them: fixed-shape padded outputs with a -1 sentinel instead of the
reference's ragged LoD outputs, and the batch as a tensor axis.

None of these functions reaches a Pallas kernel in the JAX package, and none
holds a kernel here: they are plain PyTorch on the device of their inputs.
Where the JAX function's result depends on an order or a tie, the port
reproduces it:

- ``lax.top_k`` puts the lower index first among equal values and
  ``jnp.argsort`` is stable; the port sorts with ``stable=True`` (a top-k is
  a stable descending sort cut to k). ``argmax`` takes the first maximum in
  both packages.
- The greedy loops (NMS and bipartite matching) run their fixed trip count
  as a Python loop, every (image, class) lane a row of one tensor (the JAX
  ``vmap`` axis): no step reads a value on the host and none ends early.
  ``_greedy_nms_mask``'s threshold decays by ``eta`` on every step, as the
  JAX loop decays it, whatever is left.
- ``yolov3_loss`` sets its box and class targets by a last-writer scatter in
  gt-row order (XLA on the CPU applies the updates in order; an unselected
  row writes back the zero it read). A scatter on the card with repeated
  indices has no defined winner, so the port takes, per (image, anchor,
  cell), the largest gt row that maps there (``scatter_reduce`` "amax") and
  gathers: the JAX CPU result, deterministically.
- ``jnp.maximum`` in a differentiated term splits the gradient 0.5/0.5 at a
  tie; so does ``torch.maximum`` (``clamp`` and ``relu`` do not), and the
  port uses it where the JAX function uses ``jnp.maximum`` or ``jnp.clip``.
  ``jnp.abs`` has gradient 1 at 0 (its JVP is a select on ``x >= 0``) where
  ``torch.abs`` has 0: the port's ``_abs`` is that select.

The sampling and label-assignment functions that the reference runs on the
CPU (``rpn_target_assign``, ``generate_proposal_labels``, ``detection_map``,
``retinanet_target_assign``, ``generate_mask_labels``) are numpy functions
in the JAX package too; the port keeps its own copy of that numpy code, with
the same ``np.random.RandomState(seed)`` draws, ``np.argsort`` kinds and
``np.nonzero`` orders. They take tensors (copied to the host once) or
arrays, and return numpy.
"""

import numpy as np
import torch

from paddle_tpu_torch.ops.math import _abs, _clip, _maximum, _minimum

__all__ = [
    "iou_similarity", "box_coder", "prior_box", "density_prior_box",
    "anchor_generator", "bipartite_match", "target_assign",
    "multiclass_nms", "detection_output", "ssd_loss",
    "yolo_box", "yolov3_loss", "box_clip", "polygon_box_transform",
    "sigmoid_focal_loss", "roi_align", "roi_pool", "psroi_pool",
    "generate_proposals", "distribute_fpn_proposals",
    "collect_fpn_proposals", "box_decoder_and_assign",
    "retinanet_detection_output", "rpn_target_assign",
    "generate_proposal_labels", "detection_map",
    "retinanet_target_assign", "roi_perspective_transform",
    "generate_mask_labels", "mine_hard_examples",
]

_INF = float("inf")


def _dev(*xs):
    """The device of the first tensor among ``xs`` (the CPU when none is)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, (list, tuple)):
            for v in x:
                if isinstance(v, torch.Tensor):
                    return v.device
    return torch.device("cpu")


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _i32(x, device):
    return torch.as_tensor(x, device=device).to(torch.int32)


def _const(values, dtype, device):
    """Small constant values (a list or array; a tensor is moved) on
    ``device`` without a blocking copy: on the card they go through pinned
    memory, so the host does not wait for the card's queue to drain (a
    blocking host-to-device copy synchronises the stream)."""
    if isinstance(values, torch.Tensor):
        return values.to(device, dtype)
    t = torch.as_tensor(np.asarray(values), dtype=dtype)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


def _c(v):
    """A Python float rounded to fp32, as a JAX weak-typed scalar enters an
    fp32 computation."""
    return float(np.float32(v))


def _top_k(x, k):
    """``lax.top_k`` over the last axis: descending, the lower index first
    among equal values."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def _argsort(x, dim=-1):
    """``jnp.argsort``: ascending and stable."""
    return torch.sort(x, dim=dim, stable=True).indices


def _take_rows(x, idx):
    """``x[b, idx[b, j]]`` for x [B, N, ...] and idx [B, J]."""
    tail = x.shape[2:]
    ix = idx.long().reshape(idx.shape + (1,) * len(tail)).expand(
        idx.shape + tail)
    return x.gather(1, ix)


# ---------------------------------------------------------------------------
# IoU / box utilities
# ---------------------------------------------------------------------------

def _box_area(boxes, normalized=True):
    off = 0.0 if normalized else 1.0
    w = _maximum(boxes[..., 2] - boxes[..., 0] + off, 0.0)
    h = _maximum(boxes[..., 3] - boxes[..., 1] + off, 0.0)
    return w * h


def _pairwise_iou(a, b, normalized=True):
    """IoU matrix [..., N, M] for corner-form boxes a [..., N, 4] and
    b [..., M, 4] (leading axes broadcast)."""
    off = 0.0 if normalized else 1.0
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = _maximum(rb - lt + off, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = _box_area(a, normalized)[..., :, None] + \
        _box_area(b, normalized)[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(inter))


def iou_similarity(x, y, box_normalized=True):
    """IoU between every box pair; x [N,4] (or [B,N,4]), y [M,4] → [N,M]
    (or [B,N,M]). Parity: detection/iou_similarity_op.{cc,h}."""
    dev = _dev(x, y)
    return _pairwise_iou(_f32(x, dev), _f32(y, dev), box_normalized)


def box_clip(input, im_info):
    """Clip boxes to image bounds. input [..., 4]; im_info [B, 3] (h, w,
    scale) or [3]. Parity: detection/box_clip_op.{cc,h} (clips to
    im_info/scale - 1)."""
    dev = _dev(input, im_info)
    boxes = _f32(input, dev)
    info = _f32(im_info, dev)
    if info.dim() == 1:
        info = info[None]
    h = info[:, 0] / info[:, 2] - 1.0
    w = info[:, 1] / info[:, 2] - 1.0
    if boxes.dim() == 2:
        h, w = h[0], w[0]
    else:
        shape = (-1,) + (1,) * (boxes.dim() - 2)
        h, w = h.reshape(shape), w.reshape(shape)
    return torch.stack([
        _clip(boxes[..., 0], 0.0, w), _clip(boxes[..., 1], 0.0, h),
        _clip(boxes[..., 2], 0.0, w), _clip(boxes[..., 3], 0.0, h)], dim=-1)


def polygon_box_transform(input):
    """Quad-point offsets → absolute coords (EAST-style text detection).
    input [N, 8k, H, W]; even channels are x offsets (from col index*4),
    odd channels y offsets (row index*4).
    Parity: detection/polygon_box_transform_op.cc."""
    x = _f32(input, _dev(input))
    n, c, h, w = x.shape
    ys = torch.arange(h, dtype=torch.float32, device=x.device)[:, None] * 4.0
    xs = torch.arange(w, dtype=torch.float32, device=x.device)[None, :] * 4.0
    even = torch.arange(c, device=x.device) % 2 == 0
    base = torch.where(even[:, None, None], xs[None], ys[None])
    return base[None] - x


# ---------------------------------------------------------------------------
# box_coder (encode/decode center-size)
# ---------------------------------------------------------------------------

def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True,
              axis=0, variance=None):
    """Encode/decode boxes against priors in center-size form.

    Parity: detection/box_coder_op.{cc,h,cu}. prior_box [M,4];
    prior_box_var [M,4] or None (then ``variance`` list or 1.0);
    encode: target [N,4] → [N,M,4]; decode: target [N,M,4] (or [N,4] with
    axis broadcast) → [N,M,4].
    """
    dev = _dev(prior_box, target_box, prior_box_var)
    prior = _f32(prior_box, dev)
    target = _f32(target_box, dev)
    off = 0.0 if box_normalized else 1.0
    pw = prior[:, 2] - prior[:, 0] + off
    ph = prior[:, 3] - prior[:, 1] + off
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph

    if prior_box_var is not None:
        var = _f32(prior_box_var, dev)
    elif variance is not None:
        var = _const(variance, torch.float32, dev).expand(prior.shape)
    else:
        var = torch.ones_like(prior)

    if code_type.lower() in ("encode_center_size", "encode"):
        tw = target[:, 2] - target[:, 0] + off
        th = target[:, 3] - target[:, 1] + off
        tcx = target[:, 0] + 0.5 * tw
        tcy = target[:, 1] + 0.5 * th
        ex = (tcx[:, None] - pcx[None, :]) / pw[None, :]
        ey = (tcy[:, None] - pcy[None, :]) / ph[None, :]
        ew = torch.log(_abs(tw[:, None] / pw[None, :]))
        eh = torch.log(_abs(th[:, None] / ph[None, :]))
        out = torch.stack([ex, ey, ew, eh], dim=-1)
        return out / var[None, :, :]
    if target.dim() == 2:
        target = target[:, None, :]
    if axis == 0:
        pw_, ph_, pcx_, pcy_ = (pw[None, :], ph[None, :],
                                pcx[None, :], pcy[None, :])
        var_ = var[None, :, :]
    else:
        pw_, ph_, pcx_, pcy_ = (pw[:, None], ph[:, None],
                                pcx[:, None], pcy[:, None])
        var_ = var[:, None, :]
    t = target * var_
    dcx = t[..., 0] * pw_ + pcx_
    dcy = t[..., 1] * ph_ + pcy_
    dw = torch.exp(t[..., 2]) * pw_
    dh = torch.exp(t[..., 3]) * ph_
    return torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                        dcx + dw * 0.5 - off, dcy + dh * 0.5 - off], dim=-1)


# ---------------------------------------------------------------------------
# prior boxes / anchors: the (w, h) lists in Python float64 as the JAX
# functions build them, cast to fp32 once; the grid in fp32 in the same order
# ---------------------------------------------------------------------------

def _grid_centers(fh, fw, step_w, step_h, offset, device):
    """[H, W, 1, 2] cell centres ((i + offset) * step) in fp32."""
    cx = (torch.arange(fw, dtype=torch.float32, device=device) + offset) \
        * _c(step_w)
    cy = (torch.arange(fh, dtype=torch.float32, device=device) + offset) \
        * _c(step_h)
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    return torch.stack([cxg, cyg], -1)[:, :, None, :]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=(1.0,),
              variance=(0.1, 0.1, 0.2, 0.2), flip=False, clip=False,
              steps=(0.0, 0.0), offset=0.5,
              min_max_aspect_ratios_order=False):
    """SSD prior boxes for one feature map.

    input [N,C,H,W] feature map, image [N,C,IH,IW]. Returns
    (boxes [H,W,P,4], variances [H,W,P,4]), normalized corner form.
    Parity: detection/prior_box_op.{cc,h} (aspect-ratio expansion with flip
    as ExpandAspectRatios in bbox_util). Only the shapes are read.
    """
    dev = input.device
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    min_sizes = [float(s) for s in np.atleast_1d(min_sizes)]
    max_sizes = [float(s) for s in np.atleast_1d(max_sizes)] \
        if max_sizes is not None else []
    ars = [1.0]
    for ar in np.atleast_1d(aspect_ratios):
        ar = float(ar)
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if flip:
                ars.append(1.0 / ar)
    step_w = float(steps[0]) or iw / fw
    step_h = float(steps[1]) or ih / fh

    whs = []
    for k, ms in enumerate(min_sizes):
        if min_max_aspect_ratios_order:
            whs.append((ms, ms))
            if k < len(max_sizes):
                d = float(np.sqrt(ms * max_sizes[k]))
                whs.append((d, d))
            for ar in ars:
                if abs(ar - 1.0) < 1e-6:
                    continue
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
        else:
            for ar in ars:
                whs.append((ms * np.sqrt(ar), ms / np.sqrt(ar)))
            if k < len(max_sizes):
                d = float(np.sqrt(ms * max_sizes[k]))
                whs.append((d, d))
    wh = _const(np.asarray(whs, np.float32), torch.float32, dev)  # [P, 2]
    c = _grid_centers(fh, fw, step_w, step_h, offset, dev)
    half = wh[None, None, :, :] / 2.0
    scale = _const([iw, ih], torch.float32, dev)
    boxes = torch.cat([(c - half) / scale, (c + half) / scale], dim=-1)
    if clip:
        boxes = _clip(boxes, 0.0, 1.0)
    var = _const(variance, torch.float32, dev).expand(boxes.shape)
    return boxes, var


def density_prior_box(input, image, densities, fixed_sizes, fixed_ratios,
                      variance=(0.1, 0.1, 0.2, 0.2), clip=False,
                      steps=(0.0, 0.0), offset=0.5, flatten_to_2d=False):
    """Densified prior boxes (face-detection style).

    For each (density d, fixed_size s), a d×d grid of shifted centers per
    cell, one box per fixed_ratio. Parity: detection/density_prior_box_op.h.
    """
    dev = input.device
    fh, fw = input.shape[2], input.shape[3]
    ih, iw = image.shape[2], image.shape[3]
    step_w = float(steps[0]) or iw / fw
    step_h = float(steps[1]) or ih / fh
    whs, shifts = [], []
    for d, s in zip(densities, fixed_sizes):
        d = int(d)
        for ar in fixed_ratios:
            bw = s * float(np.sqrt(ar))
            bh = s / float(np.sqrt(ar))
            shift = 1.0 / d
            for r in range(d):
                for c_ in range(d):
                    whs.append((bw, bh))
                    shifts.append(((c_ + 0.5) * shift - 0.5,
                                   (r + 0.5) * shift - 0.5))
    wh = _const(np.asarray(whs, np.float32), torch.float32, dev)
    sh = _const(np.asarray(shifts, np.float32), torch.float32, dev)
    c = _grid_centers(fh, fw, step_w, step_h, offset, dev)
    step = _const([step_w, step_h], torch.float32, dev)
    centers = c + sh[None, None] * step
    half = wh[None, None] / 2.0
    scale = _const([iw, ih], torch.float32, dev)
    boxes = torch.cat([(centers - half) / scale,
                       (centers + half) / scale], dim=-1)
    if clip:
        boxes = _clip(boxes, 0.0, 1.0)
    var = _const(variance, torch.float32, dev).expand(boxes.shape)
    if flatten_to_2d:
        boxes = boxes.reshape(-1, 4)
        var = var.reshape(-1, 4)
    return boxes, var


def anchor_generator(input, anchor_sizes=(64., 128., 256., 512.),
                     aspect_ratios=(0.5, 1.0, 2.0),
                     variance=(0.1, 0.1, 0.2, 0.2),
                     stride=(16.0, 16.0), offset=0.5):
    """RPN anchors for one level. input [N,C,H,W] → (anchors [H,W,A,4],
    variances [H,W,A,4]), absolute pixel corner form.
    Parity: detection/anchor_generator_op.{cc,h}.
    """
    dev = input.device
    fh, fw = input.shape[2], input.shape[3]
    sw, sh = float(stride[0]), float(stride[1])
    whs = []
    for ar in aspect_ratios:
        for s in anchor_sizes:
            area = sw * sh
            w0 = float(np.sqrt(area / ar))
            h0 = w0 * ar
            whs.append((s / sw * w0, s / sh * h0))
    wh = _const(np.asarray(whs, np.float32), torch.float32, dev)
    cx = torch.arange(fw, dtype=torch.float32, device=dev) * sw + offset * sw
    cy = torch.arange(fh, dtype=torch.float32, device=dev) * sh + offset * sh
    cxg, cyg = torch.meshgrid(cx, cy, indexing="xy")
    c = torch.stack([cxg, cyg], -1)[:, :, None, :]
    half = wh[None, None] / 2.0
    anchors = torch.cat([c - half, c + half], dim=-1)
    var = _const(variance, torch.float32, dev).expand(anchors.shape)
    return anchors, var


# ---------------------------------------------------------------------------
# matching / target assignment
# ---------------------------------------------------------------------------

def _bipartite_match(dist):
    """Greedy global-max matching of each [R, C] slice of dist [B, R, C]:
    (col→row indices [B, C] int32, matched dist [B, C]); -1 where unmatched.
    min(R, C) steps, every image a row of each step's tensors.
    Parity: detection/bipartite_match_op.cc BipartiteMatch (greedy
    max-first), incl. the dist>0 requirement."""
    b, r, c = dist.shape
    dev = dist.device
    d = dist.detach().clone()
    idx = torch.full((b, c), -1, dtype=torch.int32, device=dev)
    md = torch.zeros((b, c), dtype=torch.float32, device=dev)
    rows = torch.arange(r, device=dev)
    cols = torch.arange(c, device=dev)
    for _ in range(min(r, c)):
        flat = torch.argmax(d.reshape(b, -1), dim=1)
        i, j = flat // c, flat % c
        best = d.reshape(b, -1).gather(1, flat[:, None])[:, 0]
        ok = best > 0
        hit = ok[:, None] & (cols[None, :] == j[:, None])
        idx = torch.where(hit, i[:, None].to(torch.int32), idx)
        md = torch.where(hit, best[:, None], md)
        retire = ok[:, None, None] & (
            (rows[None, :, None] == i[:, None, None])
            | (cols[None, None, :] == j[:, None, None]))
        d = d.masked_fill(retire, -1.0)
    return idx, md


def bipartite_match(dist_matrix, match_type="bipartite",
                    dist_threshold=None):
    """Match columns (priors) to rows (ground truth) by greedy max-first
    bipartite matching; 'per_prediction' additionally matches any remaining
    column whose best row-distance exceeds dist_threshold.

    dist_matrix [R, C] or [B, R, C]. Returns (match_indices int32,
    match_dist) shaped like the column axis.
    Parity: detection/bipartite_match_op.cc.
    """
    dist = _f32(dist_matrix, _dev(dist_matrix))
    squeeze = dist.dim() == 2
    if squeeze:
        dist = dist[None]
    idx, md = _bipartite_match(dist)
    if match_type == "per_prediction":
        thr = 0.5 if dist_threshold is None else float(dist_threshold)
        best_d = dist.amax(dim=1)
        best_row = torch.argmax(dist, dim=1).to(torch.int32)
        extra = (idx < 0) & (best_d > thr)
        idx = torch.where(extra, best_row, idx)
        md = torch.where(extra, best_d, md)
    if squeeze:
        return idx[0], md[0]
    return idx, md


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0):
    """Gather rows of ``input`` by match index; mismatch (-1) slots get
    ``mismatch_value`` and weight 0. input [B, R, K] (per-batch rows),
    matched_indices [B, C] → (out [B, C, K], weight [B, C, 1]).
    Parity: detection/target_assign_op.{cc,h}.
    """
    dev = _dev(input, matched_indices)
    x = torch.as_tensor(input, device=dev)
    idx = _i32(matched_indices, dev)
    if x.dim() == 2:
        x = x[None].expand((idx.shape[0],) + tuple(x.shape))
    out = _take_rows(x, torch.clamp(idx, min=0))
    matched = idx >= 0
    out = torch.where(matched[:, :, None], out,
                      torch.as_tensor(mismatch_value, dtype=x.dtype,
                                      device=dev))
    w = matched.to(torch.float32)[:, :, None]
    if negative_indices is not None:
        # a [B, C] 0/1 mask of sampled negatives (the dense stand-in for the
        # reference's ragged NegIndices LoD input)
        neg = torch.as_tensor(negative_indices, device=dev).to(torch.float32)
        w = torch.maximum(w, neg[:, :, None])
    return out, w


# ---------------------------------------------------------------------------
# NMS family
# ---------------------------------------------------------------------------

def _greedy_nms_mask(boxes, scores, iou_threshold, normalized=True,
                     eta=1.0):
    """Greedy NMS over each lane's candidates sorted by score (desc).
    boxes [L, K, 4], scores [L, K]. Returns a keep mask [L, K] aligned to
    the sorted order, and the sort indices [L, K].

    K steps whatever is left, as the JAX ``fori_loop``: each commits every
    lane's highest unsuppressed candidate and suppresses the rest by IoU;
    no step reads the device on the host. The threshold is a function of
    the step alone, so it stays a host scalar (fp32, as in JAX)."""
    lanes, k = scores.shape
    dev = scores.device
    order = _argsort(-scores, dim=1)
    b = _take_rows(boxes, order)
    s = scores.gather(1, order)
    iou = _pairwise_iou(b, b, normalized)                  # [L, K, K]
    finite = s > -_INF
    keep = torch.zeros((lanes, k), dtype=torch.bool, device=dev)
    sup = ~finite
    pos = torch.arange(k, device=dev)
    lane = torch.arange(lanes, device=dev)
    thr = np.float32(iou_threshold)
    for _ in range(k):
        valid = ~sup & finite
        nxt = torch.argmax(valid.to(torch.int32), dim=1)   # first True
        has = valid.any(dim=1)
        pick = has[:, None] & (pos[None, :] == nxt[:, None])
        keep = keep | pick
        sup = sup | (has[:, None] & (iou[lane, nxt] > float(thr))) | pick
        if eta < 1.0 and thr > 0.5:
            thr = np.float32(thr * np.float32(eta))
    return keep, order


def multiclass_nms(bboxes, scores, background_label=0, score_threshold=0.05,
                   nms_top_k=400, nms_threshold=0.3, keep_top_k=100,
                   normalized=True, nms_eta=1.0):
    """Per-class NMS + cross-class top-k.

    bboxes [B, M, 4]; scores [B, C, M]. Returns [B, keep_top_k, 6]
    (label, score, x1, y1, x2, y2) padded with -1 rows: a fixed shape
    instead of the reference's ragged LoD output
    (detection/multiclass_nms_op.cc:70-75).
    """
    dev = _dev(bboxes, scores)
    bboxes = _f32(bboxes, dev)
    scores = _f32(scores, dev)
    bsz, ncls, m = scores.shape
    # the background class leaves before the per-class lanes are formed
    if 0 <= background_label < ncls:
        fg_cls = [c for c in range(ncls) if c != background_label]
        scores = scores.index_select(1, _const(fg_cls, torch.int64, dev))
    else:
        fg_cls = list(range(ncls))
    nfg = len(fg_cls)
    k = min(int(nms_top_k) if nms_top_k > 0 else m, m)
    keep_k = int(keep_top_k) if keep_top_k > 0 else nfg * k

    s = torch.where(scores > score_threshold, scores,
                    scores.new_full((), -_INF))
    topv, topi = _top_k(s, k)                              # [B, nfg, k]
    cand = _take_rows(bboxes, topi.reshape(bsz, nfg * k)).reshape(
        bsz * nfg, k, 4)
    topv = topv.reshape(bsz * nfg, k)
    keep, order = _greedy_nms_mask(cand, topv, nms_threshold, normalized,
                                   nms_eta)
    kept = torch.where(keep, topv.gather(1, order),
                       topv.new_full((), -_INF)).reshape(bsz, nfg * k)
    kb = _take_rows(cand, order).reshape(bsz, nfg * k, 4)
    labels = _const(fg_cls, torch.int32, dev)[
        :, None].expand(nfg, k).reshape(-1)
    kk = min(keep_k, nfg * k)
    tv, ti = _top_k(kept, kk)                              # [B, kk]
    valid = tv > -_INF
    out = torch.cat([
        torch.where(valid, labels[ti], -1).to(torch.float32)[..., None],
        torch.where(valid, tv, tv.new_full((), -1.0))[..., None],
        torch.where(valid[..., None], _take_rows(kb, ti),
                    kb.new_full((), -1.0))], dim=-1)
    if kk < keep_k:
        out = torch.cat([out, out.new_full((bsz, keep_k - kk, 6), -1.0)],
                        dim=1)
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """SSD head post-processing: decode loc against priors, then
    multiclass_nms. loc [B, M, 4], scores [B, M, C] (softmax-ed: no softmax
    is applied here, as in the JAX function), priors [M, 4]. Parity:
    fluid.layers.detection_output (python/paddle/fluid/layers/detection.py).
    """
    decoded = box_coder(prior_box, prior_box_var, loc,
                        code_type="decode_center_size")    # [B, M, 4]
    scores_t = _f32(scores, decoded.device).transpose(1, 2)
    return multiclass_nms(decoded, scores_t,
                          background_label=background_label,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, nms_eta=nms_eta)


def _mine_negatives(loss, matched, dist, neg_pos_ratio, neg_dist_threshold,
                    sample_size, mining_type):
    """Shared negative-mining core (mine_hard_examples_op.cc): rank
    unmatched low-overlap priors by loss. max_negative keeps
    neg_pos_ratio * num_pos per image; hard_example keeps
    min(sample_size, candidates) regardless of the positive count.
    loss/matched/dist: [N, P]. Returns bool neg_sel [N, P]; no gradient
    flows through the ranking."""
    loss = loss.detach()
    neg_cand = (~matched) & (dist < neg_dist_threshold)
    score = torch.where(neg_cand, loss, loss.new_full((), -_INF))
    rank = _argsort(_argsort(-score, dim=1), dim=1)
    avail = neg_cand.sum(dim=1, dtype=torch.int32)
    if mining_type == "hard_example":
        num_neg = avail if sample_size is None else \
            torch.clamp(avail, max=int(sample_size))
    else:
        num_pos = matched.sum(dim=1, dtype=torch.int32)
        num_neg = torch.minimum(
            (num_pos.to(torch.float32) * _c(neg_pos_ratio)).to(torch.int32),
            avail)
        if sample_size is not None:
            num_neg = torch.clamp(num_neg, max=int(sample_size))
    return neg_cand & (rank < num_neg[:, None])


# ---------------------------------------------------------------------------
# SSD loss (match + hard negative mining)
# ---------------------------------------------------------------------------

def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type="per_prediction",
             normalize=True, sample_size=None):
    """SSD multibox loss with per-prediction matching and max-negative
    hard mining.

    Dense-padded ground truth replaces the reference's LoD ragged input:
    gt_box [B, G, 4], gt_label [B, G] with label < 0 marking padding.
    location [B, M, 4], confidence [B, M, C], prior_box [M, 4]. Returns
    [B]. Differentiable in ``location`` and ``confidence`` only: the
    matching, the target gathers and the mining's double argsort carry no
    gradient. Parity: fluid.layers.ssd_loss (layers/detection.py) =
    iou_similarity → bipartite_match → target_assign → smooth_l1 +
    softmax cross-entropy → mine_hard_examples (max_negative mining).
    """
    dev = _dev(location, confidence)
    loc = _f32(location, dev)
    conf = _f32(confidence, dev)
    gtb = _f32(gt_box, dev)
    gtl = _i32(gt_label, dev)
    if gtl.dim() == 3:
        gtl = gtl[..., 0]
    prior = _f32(prior_box, dev)
    bsz, m, ncls = conf.shape

    gt_valid = gtl >= 0
    sim = iou_similarity(gtb, prior)                       # [B, G, M]
    sim = torch.where(gt_valid[:, :, None], sim, torch.zeros_like(sim))
    match_idx, match_dist = bipartite_match(sim, match_type,
                                            overlap_threshold)

    matched = match_idx >= 0
    safe = torch.clamp(match_idx, min=0)
    tgt_box = _take_rows(gtb, safe)                        # [B, M, 4]
    tgt_label = gtl.gather(1, safe.long())
    tgt_label = torch.where(matched, tgt_label,
                            torch.full_like(tgt_label, background_label))

    # localization targets: the matched gt encoded against its own prior
    pw = prior[:, 2] - prior[:, 0]
    ph = prior[:, 3] - prior[:, 1]
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    var = (_f32(prior_box_var, dev) if prior_box_var is not None
           else torch.ones((m, 4), device=dev))
    tw = tgt_box[..., 2] - tgt_box[..., 0]
    th = tgt_box[..., 3] - tgt_box[..., 1]
    tcx = tgt_box[..., 0] + 0.5 * tw
    tcy = tgt_box[..., 1] + 0.5 * th
    pw9, ph9 = _maximum(pw, 1e-9), _maximum(ph, 1e-9)
    loc_tgt = torch.stack([
        (tcx - pcx) / pw9,
        (tcy - pcy) / ph9,
        torch.log(_maximum(_abs(tw / pw9), 1e-9)),
        torch.log(_maximum(_abs(th / ph9), 1e-9))], dim=-1) / var[None]
    diff = loc - loc_tgt
    adiff = _abs(diff)
    smooth_l1 = torch.where(adiff < 1.0, 0.5 * diff * diff, adiff - 0.5)
    loc_loss = smooth_l1.sum(-1) * matched.to(torch.float32)

    logp = torch.log_softmax(conf, dim=-1)
    conf_all = -logp.gather(2, tgt_label.long()[:, :, None])[..., 0]

    num_pos = matched.sum(dim=1, dtype=torch.int32)
    neg_sel = _mine_negatives(conf_all, matched, match_dist,
                              neg_pos_ratio, neg_overlap, sample_size,
                              "max_negative")
    conf_loss = conf_all * (matched | neg_sel).to(torch.float32)
    total = conf_loss_weight * conf_loss.sum(1) + \
        loc_loss_weight * loc_loss.sum(1)
    if normalize:
        total = total / _maximum(num_pos.to(torch.float32), 1.0)
    return total


# ---------------------------------------------------------------------------
# YOLO
# ---------------------------------------------------------------------------

def yolo_box(x, img_size, anchors, class_num, conf_thresh,
             downsample_ratio):
    """Decode YOLOv3 head output into boxes + per-class scores.

    x [B, A*(5+C), H, W]; img_size [B, 2] (h, w). Returns
    (boxes [B, A*H*W, 4] absolute corner form, scores [B, A*H*W, C]).
    Parity: detection/yolo_box_op.{cc,h} (incl. zeroing boxes whose
    objectness <= conf_thresh).
    """
    dev = _dev(x, img_size)
    x = _f32(x, dev)
    b, c, h, w = x.shape
    na = len(anchors) // 2
    anc = _const(anchors, torch.float32, dev).reshape(na, 2)
    x = x.reshape(b, na, 5 + class_num, h, w)
    tx, ty, tw, th = x[:, :, 0], x[:, :, 1], x[:, :, 2], x[:, :, 3]
    obj = torch.sigmoid(x[:, :, 4])
    cls = torch.sigmoid(x[:, :, 5:])

    gx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    cx = (torch.sigmoid(tx) + gx) / w
    cy = (torch.sigmoid(ty) + gy) / h
    input_h = downsample_ratio * h
    input_w = downsample_ratio * w
    bw = torch.exp(tw) * anc[None, :, 0, None, None] / input_w
    bh = torch.exp(th) * anc[None, :, 1, None, None] / input_h

    size = _f32(img_size, dev)
    sh = size[:, 0][:, None, None, None]
    sw = size[:, 1][:, None, None, None]
    x1 = _clip((cx - bw / 2) * sw, 0.0, sw - 1)
    y1 = _clip((cy - bh / 2) * sh, 0.0, sh - 1)
    x2 = _clip((cx + bw / 2) * sw, 0.0, sw - 1)
    y2 = _clip((cy + bh / 2) * sh, 0.0, sh - 1)
    keep = obj > conf_thresh
    boxes = torch.stack([x1, y1, x2, y2], dim=-1)
    boxes = torch.where(keep[..., None], boxes, boxes.new_full((), 0.0))
    scores = obj[..., None] * torch.movedim(cls, 2, -1)
    scores = torch.where(keep[..., None], scores, scores.new_full((), 0.0))
    return boxes.reshape(b, -1, 4), scores.reshape(b, -1, class_num)


def _bce(logit, label):
    """Sigmoid cross-entropy as yolov3_loss_op.h:35 SigmoidCrossEntropy."""
    return _maximum(logit, 0.0) - logit * label + \
        torch.log1p(torch.exp(-_abs(logit)))


def _last_writer_targets(cell, sel, rows, n_cells, fill):
    """The JAX ``.at[cells].set(where(sel, rows, old))`` over gt rows in
    order, for one anchor: per (image, cell) the largest gt row index that
    maps there, and that row's value if it was selected, else ``fill`` (the
    zero it read). cell [B, G] int64, sel [B, G], rows [B, G, ...]."""
    bsz, g = cell.shape
    idx = torch.arange(g, device=cell.device).expand(bsz, g)
    last = torch.full((bsz, n_cells), -1, dtype=torch.int64,
                      device=cell.device)
    last = last.scatter_reduce(1, cell, idx, "amax", include_self=True)
    at = torch.clamp(last, min=0)
    hit = (last >= 0) & sel.gather(1, at)
    val = _take_rows(rows, at)
    hit = hit.reshape(hit.shape + (1,) * (val.dim() - 2))
    return torch.where(hit, val, torch.full_like(val, fill))


def yolov3_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
                ignore_thresh, downsample_ratio, gt_score=None,
                use_label_smooth=True):
    """YOLOv3 training loss (per image).

    x [B, A*(5+C), H, W]; gt_box [B, G, 4] normalized (cx, cy, w, h) with
    all-zero rows as padding; gt_label [B, G]. Loss terms follow
    detection/yolov3_loss_op.h: sigmoid-CE for x, y; L1 for w, h (scaled by
    2 - w*h); sigmoid-CE objectness with >ignore_thresh IoU slots ignored;
    per-class sigmoid-CE with optional label smoothing. Differentiable in
    ``x``. The box and class targets are the JAX function's last-writer
    scatter (see the module docstring): a zero padding row, which maps to
    cell (0, 0), erases a real target there, and two boxes in one cell give
    the later row's.
    """
    dev = _dev(x, gt_box)
    x = _f32(x, dev)
    gtb = _f32(gt_box, dev)
    gtl = _i32(gt_label, dev)
    if gtl.dim() == 3:
        gtl = gtl[..., 0]
    b, c, h, w = x.shape
    mask = [int(v) for v in np.asarray(anchor_mask).reshape(-1)]
    na = len(mask)
    anc = _const(anchors, torch.float32, dev).reshape(-1, 2)
    anc_m = _const([anchors[2 * m:2 * m + 2] for m in mask], torch.float32,
                   dev)                                    # [A, 2]
    x = x.reshape(b, na, 5 + class_num, h, w)
    input_h = float(downsample_ratio * h)
    input_w = float(downsample_ratio * w)
    gt_valid = (gtb[..., 2] > 0) & (gtb[..., 3] > 0)       # [B, G]
    if gt_score is None:
        gscore = gt_valid.to(torch.float32)
    else:
        gscore = _f32(gt_score, dev) * gt_valid

    pos, neg = 1.0, 0.0
    if use_label_smooth:
        delta = np.minimum(np.float32(1.0 / class_num), np.float32(1.0 / 40))
        pos, neg = float(np.float32(1.0) - delta), float(delta)

    # anchor responsibility: the best shape-IoU over all anchors
    gw = gtb[..., 2] * input_w
    gh = gtb[..., 3] * input_h
    aw = anc[None, None, :, 0]
    ah = anc[None, None, :, 1]
    inter = torch.minimum(gw[..., None], aw) * torch.minimum(gh[..., None],
                                                             ah)
    union = gw[..., None] * gh[..., None] + aw * ah - inter
    shape_iou = inter / _maximum(union, 1e-10)             # [B, G, Atot]
    best_anchor = torch.argmax(shape_iou, dim=-1)          # [B, G]

    gi = torch.clamp((gtb[..., 0] * w).to(torch.int32), 0, w - 1)
    gj = torch.clamp((gtb[..., 1] * h).to(torch.int32), 0, h - 1)
    cell = (gj.long() * w + gi.long())                     # [B, G]

    boxes, classes, weights = [], [], []
    for a_full in mask:
        sel = gt_valid & (best_anchor == a_full)
        weight = torch.where(sel, gscore, torch.zeros_like(gscore))
        weights.append(torch.zeros((b, h * w), device=dev).scatter_reduce(
            1, cell, weight, "amax", include_self=True))
        boxes.append(_last_writer_targets(cell, sel, gtb, h * w, 0.0))
        classes.append(_last_writer_targets(cell, sel, gtl, h * w, 0))
    tgt_box = torch.stack(boxes, 1).reshape(b, na, h, w, 4)
    tgt_cls = torch.stack(classes, 1).reshape(b, na, h, w)
    tgt_wt = torch.stack(weights, 1).reshape(b, na, h, w)

    # location loss at positive cells
    gxs = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None, :]
    gys = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :, None]
    tx_tgt = tgt_box[..., 0] * w - torch.floor(tgt_box[..., 0] * w)
    ty_tgt = tgt_box[..., 1] * h - torch.floor(tgt_box[..., 1] * h)
    tw_tgt = torch.log(_maximum(
        tgt_box[..., 2] * input_w / anc_m[None, :, 0, None, None], 1e-9))
    th_tgt = torch.log(_maximum(
        tgt_box[..., 3] * input_h / anc_m[None, :, 1, None, None], 1e-9))
    scale = tgt_wt * (2.0 - tgt_box[..., 2] * tgt_box[..., 3])
    loc = (_bce(x[:, :, 0], tx_tgt) + _bce(x[:, :, 1], ty_tgt)
           + _abs(x[:, :, 2] - tw_tgt) + _abs(x[:, :, 3] - th_tgt))
    pos_mask = tgt_wt > 0
    zero = x.new_full((), 0.0)
    loc_loss = torch.where(pos_mask, loc * scale, zero).sum((1, 2, 3))

    # objectness: predictions whose best IoU with a gt box exceeds
    # ignore_thresh are ignored (a comparison: no gradient flows here)
    xd = x.detach()
    cxp = (torch.sigmoid(xd[:, :, 0]) + gxs) / w
    cyp = (torch.sigmoid(xd[:, :, 1]) + gys) / h
    bwp = torch.exp(xd[:, :, 2]) * anc_m[None, :, 0, None, None] / input_w
    bhp = torch.exp(xd[:, :, 3]) * anc_m[None, :, 1, None, None] / input_h
    pred = torch.stack([cxp - bwp / 2, cyp - bhp / 2,
                        cxp + bwp / 2, cyp + bhp / 2], -1)  # [B,A,H,W,4]
    gcorner = torch.stack([
        gtb[..., 0] - gtb[..., 2] / 2, gtb[..., 1] - gtb[..., 3] / 2,
        gtb[..., 0] + gtb[..., 2] / 2, gtb[..., 1] + gtb[..., 3] / 2], -1)
    iou = _pairwise_iou(pred.reshape(b, -1, 4), gcorner)   # [B, AHW, G]
    iou = torch.where(gt_valid[:, None, :], iou, torch.zeros_like(iou))
    best_iou = iou.amax(-1).reshape(b, na, h, w)
    objness = torch.where(pos_mask, tgt_wt,
                          torch.where(best_iou > ignore_thresh,
                                      x.new_full((), -1.0), zero))
    obj_logit = x[:, :, 4]
    obj_loss = torch.where(
        objness > 0, _bce(obj_logit, 1.0) * objness,
        torch.where(objness == 0, _bce(obj_logit, 0.0), zero)).sum((1, 2, 3))

    # classification at positive cells
    cls_logit = torch.movedim(x[:, :, 5:], 2, -1)          # [B,A,H,W,C]
    onehot = (tgt_cls[..., None] == torch.arange(
        class_num, device=dev)).to(torch.float32)
    cls_tgt = onehot * pos + (1 - onehot) * neg
    cls_loss = _bce(cls_logit, cls_tgt).sum(-1) * tgt_wt
    cls_loss = torch.where(pos_mask, cls_loss, zero).sum((1, 2, 3))
    return loc_loss + obj_loss + cls_loss                  # [B]


# ---------------------------------------------------------------------------
# focal loss
# ---------------------------------------------------------------------------

def sigmoid_focal_loss(x, label, fg_num, gamma=2.0, alpha=0.25):
    """RetinaNet focal loss. x [N, C] logits; label [N] int (0 =
    background, 1..C = class id); fg_num scalar normalizer.
    Parity: detection/sigmoid_focal_loss_op.{cc,h,cu}.
    """
    dev = _dev(x, label, fg_num)
    x = _f32(x, dev)
    label = _i32(label, dev).reshape(-1)
    n, c = x.shape
    fg = _maximum(_f32(fg_num, dev).reshape(()), 1.0)
    cls_ids = torch.arange(1, c + 1, device=dev)[None, :]
    tgt = (label[:, None] == cls_ids).to(torch.float32)
    p = torch.sigmoid(x)
    ce = _bce(x, tgt)
    p_t = p * tgt + (1 - p) * (1 - tgt)
    alpha_t = alpha * tgt + (1 - alpha) * (1 - tgt)
    return alpha_t * torch.pow(1 - p_t, gamma) * ce / fg


# ---------------------------------------------------------------------------
# RoI ops: the JAX ``vmap`` over RoIs is a leading RoI axis of batched
# gathers (no Python loop over RoIs)
# ---------------------------------------------------------------------------

def _roi_batch(rois, roi_batch_indices, dev):
    r = rois.shape[0]
    if roi_batch_indices is None:
        return torch.zeros((r,), dtype=torch.int64, device=dev)
    return torch.as_tensor(roi_batch_indices, device=dev).long()


def _bilinear(x, bidx, yf, xf):
    """Bilinear samples of x [N, C, H, W] at the point maps yf, xf [R, I, J]
    of each RoI r in image ``bidx[r]``, the corners clipped as the JAX
    functions clip them. Returns [R, C, I, J]."""
    h, w = x.shape[2], x.shape[3]
    y0 = _clip(torch.floor(yf), 0.0, float(h - 1))
    x0 = _clip(torch.floor(xf), 0.0, float(w - 1))
    y1i = _clip(y0 + 1, 0.0, float(h - 1)).long()
    x1i = _clip(x0 + 1, 0.0, float(w - 1)).long()
    y0i, x0i = y0.long(), x0.long()
    wy = _clip(yf - y0, 0.0, 1.0)[:, None]
    wx = _clip(xf - x0, 0.0, 1.0)[:, None]
    bi = bidx[:, None, None]

    def g(yi, xi):
        return x[bi, :, yi, xi].permute(0, 3, 1, 2)
    return (g(y0i, x0i) * (1 - wy) * (1 - wx) + g(y0i, x1i) * (1 - wy) * wx
            + g(y1i, x0i) * wy * (1 - wx) + g(y1i, x1i) * wy * wx)


def roi_align(input, rois, pooled_height=1, pooled_width=1,
              spatial_scale=1.0, sampling_ratio=-1, roi_batch_indices=None):
    """RoIAlign with bilinear sampling.

    input [N, C, H, W]; rois [R, 4] (x1, y1, x2, y2) in input-image
    coords; roi_batch_indices [R] maps each roi to its batch image (the
    dense replacement for the reference's LoD roi batching). A fixed s x s
    sampling grid per bin (2 x 2 when sampling_ratio <= 0), as the JAX
    function. Parity: roi_align_op.{cc,h,cu}.
    """
    dev = _dev(input, rois)
    x = _f32(input, dev)
    rois = _f32(rois, dev)
    c = x.shape[1]
    r = rois.shape[0]
    bidx = _roi_batch(rois, roi_batch_indices, dev)
    ph, pw = int(pooled_height), int(pooled_width)
    s = int(sampling_ratio) if int(sampling_ratio) > 0 else 2
    box = rois * spatial_scale
    x1, y1, x2, y2 = box[:, 0:1], box[:, 1:2], box[:, 2:3], box[:, 3:4]
    bin_w = _maximum(x2 - x1, 1.0) / pw                   # [R, 1]
    bin_h = _maximum(y2 - y1, 1.0) / ph
    it = (torch.arange(s, device=dev) + 0.5) / s
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    yf = y1 + ((py[:, None] + it[None, :]).reshape(-1))[None] * bin_h
    xf = x1 + ((px[:, None] + it[None, :]).reshape(-1))[None] * bin_w
    n_y, n_x = yf.shape[1], xf.shape[1]
    val = _bilinear(x, bidx, yf[:, :, None].expand(r, n_y, n_x),
                    xf[:, None, :].expand(r, n_y, n_x))  # [R,C,ph*s,pw*s]
    return val.reshape(r, c, ph, s, pw, s).mean(dim=(3, 5))


def _bin_masks(x1, y1, bh, bw, ph, pw, h, w, dev):
    """The JAX functions' bin membership masks: [R, ph, H] and [R, pw, W]."""
    py = torch.arange(ph, dtype=torch.float32, device=dev)
    px = torch.arange(pw, dtype=torch.float32, device=dev)
    ys = _clip(torch.floor(y1 + py * bh), 0.0, float(h))
    ye = _clip(torch.ceil(y1 + (py + 1) * bh), 0.0, float(h))
    xs = _clip(torch.floor(x1 + px * bw), 0.0, float(w))
    xe = _clip(torch.ceil(x1 + (px + 1) * bw), 0.0, float(w))
    yg = torch.arange(h, dtype=torch.float32, device=dev)
    xg = torch.arange(w, dtype=torch.float32, device=dev)
    my = (yg[None, None, :] >= ys[..., None]) & (yg[None, None, :]
                                                 < ye[..., None])
    mx = (xg[None, None, :] >= xs[..., None]) & (xg[None, None, :]
                                                 < xe[..., None])
    return my, mx


def roi_pool(input, rois, pooled_height=1, pooled_width=1,
             spatial_scale=1.0, roi_batch_indices=None):
    """RoI max pooling (Fast R-CNN). Same I/O convention as roi_align.
    Parity: roi_pool_op.{cc,h,cu}."""
    dev = _dev(input, rois)
    x = _f32(input, dev)
    rois = _f32(rois, dev)
    h, w = x.shape[2], x.shape[3]
    bidx = _roi_batch(rois, roi_batch_indices, dev)
    ph, pw = int(pooled_height), int(pooled_width)
    q = torch.round(rois * spatial_scale)
    x1, y1, x2, y2 = q[:, 0:1], q[:, 1:2], q[:, 2:3], q[:, 3:4]
    bh = _maximum(y2 - y1 + 1, 1.0) / ph
    bw = _maximum(x2 - x1 + 1, 1.0) / pw
    my, mx = _bin_masks(x1, y1, bh, bw, ph, pw, h, w, dev)
    m = my[:, :, None, :, None] & mx[:, None, :, None, :]  # [R,ph,pw,H,W]
    feat = x[bidx]                                         # [R, C, H, W]
    masked = torch.where(m[:, None], feat[:, :, None, None],
                         feat.new_full((), -_INF))
    out = masked.amax(dim=(4, 5))                          # [R, C, ph, pw]
    return torch.where(torch.isfinite(out), out, torch.zeros_like(out))


def psroi_pool(input, rois, output_channels, spatial_scale, pooled_height,
               pooled_width, roi_batch_indices=None):
    """Position-sensitive RoI pooling (R-FCN): input channels laid out as
    [output_channels * ph * pw]; bin (i, j) averages its own channel group.
    Parity: psroi_pool_op.{cc,h,cu}."""
    dev = _dev(input, rois)
    x = _f32(input, dev)
    rois = _f32(rois, dev)
    h, w = x.shape[2], x.shape[3]
    ph, pw = int(pooled_height), int(pooled_width)
    oc = int(output_channels)
    r = rois.shape[0]
    bidx = _roi_batch(rois, roi_batch_indices, dev)
    x1 = torch.round(rois[:, 0:1]) * spatial_scale
    y1 = torch.round(rois[:, 1:2]) * spatial_scale
    x2 = torch.round(rois[:, 2:3] + 1.0) * spatial_scale
    y2 = torch.round(rois[:, 3:4] + 1.0) * spatial_scale
    bh = _maximum(y2 - y1, 0.1) / ph
    bw = _maximum(x2 - x1, 0.1) / pw
    my, mx = _bin_masks(x1, y1, bh, bw, ph, pw, h, w, dev)
    m = (my[:, :, None, :, None] & mx[:, None, :, None, :]).to(torch.float32)
    feat = x[bidx].reshape(r, oc, ph, pw, h, w)
    num = torch.einsum("rcijhw,rijhw->rcij", feat, m)
    cnt = _maximum(m.sum(dim=(3, 4)), 1.0)
    return num / cnt[:, None]                              # [R, oc, ph, pw]


# ---------------------------------------------------------------------------
# RPN proposals / FPN routing
# ---------------------------------------------------------------------------

def generate_proposals(scores, bbox_deltas, im_info, anchors, variances,
                       pre_nms_top_n=6000, post_nms_top_n=1000,
                       nms_thresh=0.5, min_size=0.1, eta=1.0):
    """RPN proposal generation.

    scores [B, A, H, W]; bbox_deltas [B, A*4, H, W]; anchors [H, W, A, 4];
    variances like anchors; im_info [B, 3]. Returns
    (rois [B, post_nms_top_n, 4], roi_probs [B, post_nms_top_n, 1],
    valid counts [B] int32): fixed shapes, invalid rows zero.
    Parity: detection/generate_proposals_op.cc (decode → clip → filter
    min_size → top-k → NMS → top-k).
    """
    dev = _dev(scores, bbox_deltas)
    scores = _f32(scores, dev)
    deltas = _f32(bbox_deltas, dev)
    info = _f32(im_info, dev)
    b, na, h, w = scores.shape
    anchors = _f32(anchors, dev).reshape(-1, 4)
    variances = _f32(variances, dev).reshape(-1, 4)
    total = na * h * w
    pre_k = min(int(pre_nms_top_n), total)
    post_k = min(int(post_nms_top_n), pre_k)

    # anchors come [H, W, A, 4]: scores and deltas in (h, w, a) order
    s = scores.permute(0, 2, 3, 1).reshape(b, -1)          # [B, HWA]
    d = deltas.reshape(b, na, 4, h, w).permute(0, 3, 4, 1, 2).reshape(
        b, -1, 4)
    topv, topi = _top_k(s, pre_k)
    anc = anchors[topi]                                    # [B, pre_k, 4]
    var = variances[topi]
    aw = anc[..., 2] - anc[..., 0] + 1.0
    ah = anc[..., 3] - anc[..., 1] + 1.0
    acx = anc[..., 0] + aw * 0.5
    acy = anc[..., 1] + ah * 0.5
    t = _take_rows(d, topi) * var
    cx = t[..., 0] * aw + acx
    cy = t[..., 1] * ah + acy
    bw = torch.exp(_minimum(t[..., 2], 10.0)) * aw
    bh = torch.exp(_minimum(t[..., 3], 10.0)) * ah
    props = torch.stack([cx - bw * 0.5, cy - bh * 0.5,
                         cx + bw * 0.5 - 1.0, cy + bh * 0.5 - 1.0], -1)
    # clip to the resized image (im_info's h, w: the reference's
    # ClipTiledBoxes with is_scale=false)
    imh = info[:, 0:1] - 1.0
    imw = info[:, 1:2] - 1.0
    props = torch.stack([
        _clip(props[..., 0], 0.0, imw), _clip(props[..., 1], 0.0, imh),
        _clip(props[..., 2], 0.0, imw), _clip(props[..., 3], 0.0, imh)],
        dim=-1)
    ms = max(min_size, 1.0) * info[:, 2:3]
    pw = props[..., 2] - props[..., 0] + 1.0
    phh = props[..., 3] - props[..., 1] + 1.0
    valid = (pw >= ms) & (phh >= ms)
    sc_f = torch.where(valid, topv, topv.new_full((), -_INF))
    keep, order = _greedy_nms_mask(props, sc_f, nms_thresh,
                                   normalized=False, eta=eta)
    kept_s = torch.where(keep, sc_f.gather(1, order),
                         sc_f.new_full((), -_INF))
    fv, fi = _top_k(kept_s, post_k)
    ok = fv > -_INF
    rois = torch.where(ok[..., None], _take_rows(_take_rows(props, order),
                                                 fi),
                       props.new_full((), 0.0))
    probs = torch.where(ok, fv, fv.new_full((), 0.0))[..., None]
    return rois, probs, ok.sum(dim=1, dtype=torch.int32)


def distribute_fpn_proposals(fpn_rois, min_level, max_level, refer_level,
                             refer_scale, rois_num=None):
    """Route RoIs to FPN levels by scale: level = floor(refer_level +
    log2(sqrt(area) / refer_scale)).

    fpn_rois [R, 4]. Returns (multi_rois: list of [R, 4] per level,
    level_masks: list of [R] bool, restore_index [R] int32): each level
    keeps the full fixed R rows with a validity mask (the static
    replacement for the reference's per-level ragged outputs,
    detection/distribute_fpn_proposals_op.h).
    """
    rois = _f32(fpn_rois, _dev(fpn_rois))
    r = rois.shape[0]
    area = _maximum(rois[:, 2] - rois[:, 0] + 1.0, 0.0) * \
        _maximum(rois[:, 3] - rois[:, 1] + 1.0, 0.0)
    scale = torch.sqrt(area)
    lvl = torch.floor(torch.log2(scale / refer_scale + 1e-6)) + refer_level
    lvl = _clip(lvl, float(min_level), float(max_level)).to(torch.int32)
    multi_rois, masks = [], []
    for level in range(int(min_level), int(max_level) + 1):
        m = lvl == level
        masks.append(m)
        multi_rois.append(torch.where(m[:, None], rois,
                                      rois.new_full((), 0.0)))
    # restore index: each roi's position in the level-sorted concatenation
    key = lvl * r + torch.arange(r, device=rois.device, dtype=torch.int32)
    restore = _argsort(_argsort(key)).to(torch.int32)
    return multi_rois, masks, restore


def collect_fpn_proposals(multi_rois, multi_scores, min_level, max_level,
                          post_nms_top_n, valid_masks=None):
    """Concat per-level RoIs and keep the global top-k by score.

    multi_rois: list of [Ri, 4]; multi_scores: list of [Ri]. Returns
    (rois [post_nms_top_n, 4], scores [post_nms_top_n]) zero-padded.
    Parity: detection/collect_fpn_proposals_op.{cc,h}.
    """
    dev = _dev(multi_rois, multi_scores)
    rois = torch.cat([_f32(v, dev) for v in multi_rois], dim=0)
    scores = torch.cat([_f32(s, dev).reshape(-1) for s in multi_scores])
    if valid_masks is not None:
        vm = torch.cat([torch.as_tensor(m, device=dev).reshape(-1)
                        for m in valid_masks])
        scores = torch.where(vm, scores, scores.new_full((), -_INF))
    k = min(int(post_nms_top_n), scores.shape[0])
    topv, topi = _top_k(scores, k)
    ok = topv > -_INF
    out_r = torch.where(ok[:, None], rois[topi], rois.new_full((), 0.0))
    out_s = torch.where(ok, topv, topv.new_full((), 0.0))
    if k < post_nms_top_n:
        pad = post_nms_top_n - k
        out_r = torch.cat([out_r, out_r.new_zeros((pad, 4))])
        out_s = torch.cat([out_s, out_s.new_zeros((pad,))])
    return out_r, out_s


def box_decoder_and_assign(prior_box, prior_box_var, target_box,
                           box_score, box_clip_value=4.135):
    """Decode per-class boxes then pick each roi's best-scoring class box.
    prior_box [R, 4]; target_box [R, C*4]; box_score [R, C].
    Parity: detection/box_decoder_and_assign_op.{cc,h}.
    """
    dev = _dev(prior_box, target_box, box_score)
    prior = _f32(prior_box, dev)
    var = _f32(prior_box_var, dev)
    tgt = _f32(target_box, dev)
    score = _f32(box_score, dev)
    r, c4 = tgt.shape
    c = c4 // 4
    t = tgt.reshape(r, c, 4) * var[:, None, :]
    pw = prior[:, 2] - prior[:, 0] + 1.0
    ph = prior[:, 3] - prior[:, 1] + 1.0
    pcx = prior[:, 0] + 0.5 * pw
    pcy = prior[:, 1] + 0.5 * ph
    clip = float(box_clip_value)
    dcx = t[..., 0] * pw[:, None] + pcx[:, None]
    dcy = t[..., 1] * ph[:, None] + pcy[:, None]
    dw = torch.exp(_minimum(t[..., 2], clip)) * pw[:, None]
    dh = torch.exp(_minimum(t[..., 3], clip)) * ph[:, None]
    decoded = torch.stack([dcx - dw * 0.5, dcy - dh * 0.5,
                           dcx + dw * 0.5 - 1.0, dcy + dh * 0.5 - 1.0], -1)
    best = torch.argmax(score[:, 1:], dim=-1) + 1   # skip background col 0
    assigned = _take_rows(decoded, best[:, None])[:, 0]
    return decoded.reshape(r, c4), assigned


def retinanet_detection_output(bboxes, scores, anchors, im_info,
                               score_threshold=0.05, nms_top_k=1000,
                               keep_top_k=100, nms_threshold=0.3,
                               nms_eta=1.0):
    """RetinaNet decode-across-levels + class-wise NMS.

    bboxes/scores/anchors: lists per FPN level; bboxes[i] [B, Ai, 4]
    deltas, scores[i] [B, Ai, C] sigmoid scores, anchors[i] [Ai, 4].
    Parity: detection/retinanet_detection_output_op.cc.
    """
    dev = _dev(bboxes, scores, anchors)
    infos = _f32(im_info, dev)
    decoded, all_scores = [], []
    for d, s, a in zip(bboxes, scores, anchors):
        decoded.append(box_coder(_f32(a, dev), None, _f32(d, dev),
                                 code_type="decode_center_size",
                                 box_normalized=False, axis=0,
                                 variance=[1.0, 1.0, 1.0, 1.0]))
        all_scores.append(_f32(s, dev))
    boxes = box_clip(torch.cat(decoded, dim=1), infos)     # [B, A, 4]
    sc_t = torch.cat(all_scores, dim=1).transpose(1, 2)    # [B, C, A]
    return multiclass_nms(boxes, sc_t, background_label=-1,
                          score_threshold=score_threshold,
                          nms_top_k=nms_top_k, nms_threshold=nms_threshold,
                          keep_top_k=keep_top_k, normalized=False,
                          nms_eta=nms_eta)


# ---------------------------------------------------------------------------
# host-side (numpy) label-assignment and metric functions: the JAX package's
# numpy code, copied; tensors are copied to the host once
# ---------------------------------------------------------------------------

def _host(x):
    """A tensor (or a list or tuple of them) as numpy; anything else as
    it is."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(v) for v in x)
    return x


def _np_iou_matrix(a, b, normalized=False):
    """Vectorized numpy IoU matrix [N, M] (host-op helper)."""
    off = 0.0 if normalized else 1.0
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.maximum(rb - lt + off, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    aa = np.maximum(a[:, 2] - a[:, 0] + off, 0.0) * \
        np.maximum(a[:, 3] - a[:, 1] + off, 0.0)
    ab = np.maximum(b[:, 2] - b[:, 0] + off, 0.0) * \
        np.maximum(b[:, 3] - b[:, 1] + off, 0.0)
    union = aa[:, None] + ab[None, :] - inter
    return np.where(union > 0, inter / np.maximum(union, 1e-10), 0.0)


def _np_encode_boxes(priors, targets, normalized=False):
    """Elementwise center-size encode of targets[i] against priors[i]
    (numpy host-op helper)."""
    off = 0.0 if normalized else 1.0
    priors = np.asarray(priors, np.float32)
    targets = np.asarray(targets, np.float32)
    pw = priors[:, 2] - priors[:, 0] + off
    ph = priors[:, 3] - priors[:, 1] + off
    pcx = priors[:, 0] + 0.5 * pw
    pcy = priors[:, 1] + 0.5 * ph
    tw = targets[:, 2] - targets[:, 0] + off
    th = targets[:, 3] - targets[:, 1] + off
    tcx = targets[:, 0] + 0.5 * tw
    tcy = targets[:, 1] + 0.5 * th
    return np.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                     np.log(np.abs(tw / pw)), np.log(np.abs(th / ph))],
                    axis=-1)


def rpn_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                      gt_boxes, is_crowd, im_info,
                      rpn_batch_size_per_im=256, rpn_straddle_thresh=0.0,
                      rpn_fg_fraction=0.5, rpn_positive_overlap=0.7,
                      rpn_negative_overlap=0.3, use_random=False,
                      seed=0):
    """Sample anchors for RPN training (host/numpy; a CPU-only kernel in the
    reference too, detection/rpn_target_assign_op.cc).

    anchor_box [A, 4]; gt_boxes [G, 4]; im_info [3]. Returns
    (loc_index, score_index, tgt_label, tgt_bbox, bbox_inside_weight) as
    numpy arrays (ragged, for the input pipeline).
    """
    anchor_box, gt_boxes, is_crowd, im_info = _host(
        (anchor_box, gt_boxes, is_crowd, im_info))
    anchors = np.asarray(anchor_box, np.float32).reshape(-1, 4)
    gts = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    if is_crowd is not None:
        crowd = np.asarray(is_crowd).reshape(-1).astype(bool)
        gts = gts[~crowd]  # crowd gt never produce positives
    info = np.asarray(im_info, np.float32).reshape(-1)[:3]
    a = anchors.shape[0]
    rng = np.random.RandomState(seed)

    if rpn_straddle_thresh >= 0:
        t = rpn_straddle_thresh
        inside = ((anchors[:, 0] >= -t) & (anchors[:, 1] >= -t) &
                  (anchors[:, 2] < info[1] + t) &
                  (anchors[:, 3] < info[0] + t))
    else:
        inside = np.ones((a,), bool)
    idx_inside = np.nonzero(inside)[0]
    if gts.shape[0] == 0 or idx_inside.size == 0:
        empty = np.zeros((0,), np.int64)
        return (empty, empty, np.zeros((0, 1), np.int32),
                np.zeros((0, 4), np.float32), np.zeros((0, 4), np.float32))
    iou = _np_iou_matrix(anchors[idx_inside], gts)
    best_gt = iou.argmax(1)
    best_iou = iou.max(1)
    labels = np.full((idx_inside.size,), -1, np.int32)
    labels[best_iou >= rpn_positive_overlap] = 1
    # anchors that are the best for some gt are positive too
    for g in range(gts.shape[0]):
        m = iou[:, g] == iou[:, g].max()
        labels[m & (iou[:, g] > 0)] = 1
    labels[(best_iou < rpn_negative_overlap) & (labels != 1)] = 0

    num_fg = int(rpn_fg_fraction * rpn_batch_size_per_im)
    fg = np.nonzero(labels == 1)[0]
    if fg.size > num_fg:
        drop = (rng.choice(fg, fg.size - num_fg, replace=False)
                if use_random else fg[num_fg:])
        labels[drop] = -1
        fg = np.nonzero(labels == 1)[0]
    num_bg = rpn_batch_size_per_im - fg.size
    bg = np.nonzero(labels == 0)[0]
    if bg.size > num_bg:
        drop = (rng.choice(bg, bg.size - num_bg, replace=False)
                if use_random else bg[num_bg:])
        labels[drop] = -1
        bg = np.nonzero(labels == 0)[0]

    loc_index = idx_inside[fg].astype(np.int64)
    score_index = idx_inside[np.concatenate([fg, bg])].astype(np.int64)
    tgt_label = np.concatenate([np.ones_like(fg), np.zeros_like(bg)]) \
        .astype(np.int32).reshape(-1, 1)
    tgt_bbox = _np_encode_boxes(anchors[loc_index], gts[best_gt[fg]])
    inw = np.ones_like(tgt_bbox, np.float32)
    return loc_index, score_index, tgt_label, tgt_bbox, inw


def generate_proposal_labels(rpn_rois, gt_classes, is_crowd, gt_boxes,
                             im_info, batch_size_per_im=256,
                             fg_fraction=0.25, fg_thresh=0.5,
                             bg_thresh_hi=0.5, bg_thresh_lo=0.0,
                             bbox_reg_weights=(0.1, 0.1, 0.2, 0.2),
                             class_nums=81, use_random=False, seed=0):
    """Sample RoIs + regression targets for Fast R-CNN head training
    (host/numpy, like the reference's CPU kernel,
    detection/generate_proposal_labels_op.cc). One image at a time.

    Returns (rois, labels_int32, bbox_targets, bbox_inside_weights,
    bbox_outside_weights).
    """
    rpn_rois, gt_classes, is_crowd, gt_boxes = _host(
        (rpn_rois, gt_classes, is_crowd, gt_boxes))
    rois = np.asarray(rpn_rois, np.float32).reshape(-1, 4)
    gts = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    gtc = np.asarray(gt_classes, np.int32).reshape(-1)
    if is_crowd is not None:
        crowd = np.asarray(is_crowd).reshape(-1).astype(bool)
        gts = gts[~crowd]
        gtc = gtc[~crowd]
    rng = np.random.RandomState(seed)
    # gt boxes participate as candidate rois
    cand = np.concatenate([rois, gts], 0) if gts.size else rois
    if gts.size:
        iou = _np_iou_matrix(cand, gts)
        best_gt = iou.argmax(1)
        best_iou = iou.max(1)
    else:
        best_gt = np.zeros((cand.shape[0],), np.int64)
        best_iou = np.zeros((cand.shape[0],), np.float32)
    fg = np.nonzero(best_iou >= fg_thresh)[0]
    bg = np.nonzero((best_iou < bg_thresh_hi) &
                    (best_iou >= bg_thresh_lo))[0]
    num_fg = min(int(fg_fraction * batch_size_per_im), fg.size)
    if fg.size > num_fg:
        fg = (rng.choice(fg, num_fg, replace=False)
              if use_random else fg[:num_fg])
    num_bg = min(batch_size_per_im - num_fg, bg.size)
    if bg.size > num_bg:
        bg = (rng.choice(bg, num_bg, replace=False)
              if use_random else bg[:num_bg])
    keep = np.concatenate([fg, bg])
    out_rois = cand[keep]
    labels = gtc[best_gt[keep]].copy() if gts.size else \
        np.zeros((keep.size,), np.int32)
    labels[num_fg:] = 0
    tgt = np.zeros((keep.size, 4 * class_nums), np.float32)
    inw = np.zeros_like(tgt)
    if num_fg and gts.size:
        matched = gts[best_gt[fg]]
        w = np.asarray(bbox_reg_weights, np.float32)
        enc = _np_encode_boxes(out_rois[:num_fg], matched) / w
        for i in range(num_fg):
            c = labels[i]
            tgt[i, 4 * c:4 * c + 4] = enc[i]
            inw[i, 4 * c:4 * c + 4] = 1.0
    outw = (inw > 0).astype(np.float32)
    return out_rois, labels.reshape(-1, 1), tgt, inw, outw


def detection_map(detect_res, gt_label, gt_box, class_num,
                  background_label=0, overlap_threshold=0.5,
                  evaluate_difficult=True, ap_type="integral"):
    """Mean average precision over one batch (host/numpy metric, parity:
    operators/detection_map_op.cc).

    detect_res: [D, 6] rows (label, score, x1, y1, x2, y2); the padded
    multiclass_nms output is accepted (label -1 rows skipped), and a
    leading batch axis is flattened with per-image gt lists.
    gt_label: [G] labels, gt_box [G, 4]; lists per image allowed.
    """
    detect_res, gt_label, gt_box = _host((detect_res, gt_label, gt_box))

    def listify(x):
        if isinstance(x, (list, tuple)):
            return [np.asarray(v) for v in x]
        x = np.asarray(x)
        return [x] if x.ndim == 2 or (x.ndim == 1) else list(x)

    dets = listify(detect_res)
    gls = listify(gt_label)
    gbs = listify(gt_box)
    scores = {c: [] for c in range(class_num)}
    tps = {c: [] for c in range(class_num)}
    npos = {c: 0 for c in range(class_num)}
    for det, gl, gb in zip(dets, gls, gbs):
        det = det[det[:, 0] >= 0]
        gl = gl.reshape(-1).astype(int)
        gb = gb.reshape(-1, 4)
        for c in set(gl.tolist()):
            npos[c] += int((gl == c).sum())
        taken = np.zeros(len(gl), bool)
        det_sorted = det[np.argsort(-det[:, 1])]
        iou_all = (_np_iou_matrix(det_sorted[:, 2:6], gb, normalized=True)
                   if len(gb) and len(det_sorted) else
                   np.zeros((len(det_sorted), len(gb)), np.float32))
        for k, row in enumerate(det_sorted):
            c = int(row[0])
            if c == background_label or c >= class_num:
                continue
            ious = iou_all[k]
            cmask = (gl == c) & ~taken
            ious = np.where(cmask, ious, 0.0)
            j = ious.argmax() if ious.size else -1
            tp = bool(ious.size and ious[j] >= overlap_threshold)
            if tp:
                taken[j] = True
            scores[c].append(row[1])
            tps[c].append(1.0 if tp else 0.0)
    aps = []
    for c in range(class_num):
        if c == background_label or npos[c] == 0:
            continue
        s = np.asarray(scores[c])
        t = np.asarray(tps[c])
        order = np.argsort(-s)
        t = t[order]
        tp_cum = np.cumsum(t)
        fp_cum = np.cumsum(1.0 - t)
        rec = tp_cum / npos[c]
        prec = tp_cum / np.maximum(tp_cum + fp_cum, 1e-9)
        if ap_type == "11point":
            ap = np.mean([prec[rec >= r].max() if (rec >= r).any() else 0.0
                          for r in np.linspace(0, 1, 11)])
        else:
            ap = 0.0
            prev_r = 0.0
            for p_, r_ in zip(prec, rec):
                ap += p_ * (r_ - prev_r)
                prev_r = r_
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


def retinanet_target_assign(bbox_pred, cls_logits, anchor_box, anchor_var,
                            gt_boxes, gt_labels, is_crowd, im_info,
                            num_classes=1, positive_overlap=0.5,
                            negative_overlap=0.4):
    """RetinaNet target assignment (host/numpy, a CPU-only kernel in the
    reference too, detection/retinanet_target_assign_op.cc).

    No fg/bg sampling: every anchor with IoU >= positive_overlap (or that is
    some gt's argmax) is foreground with its gt's class label, every anchor
    with max-IoU < negative_overlap is background (label 0), the rest are
    ignored. When no anchor is foreground, one fake foreground (anchor 0)
    with zero bbox_inside_weight keeps the focal-loss normalizer valid.

    Returns (predicted_scores [F+B, C], predicted_location [F, 4],
    target_label [F+B, 1], target_bbox [F, 4], bbox_inside_weight [F, 4],
    fg_num [1]) as numpy (ragged, like rpn_target_assign).
    """
    bbox_pred, cls_logits, anchor_box, gt_boxes, gt_labels, is_crowd = \
        _host((bbox_pred, cls_logits, anchor_box, gt_boxes, gt_labels,
               is_crowd))
    anchors = np.asarray(anchor_box, np.float32).reshape(-1, 4)
    gts = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
    glab = np.asarray(gt_labels, np.int32).reshape(-1)
    if is_crowd is not None:
        crowd = np.asarray(is_crowd).reshape(-1).astype(bool)
        gts, glab = gts[~crowd], glab[~crowd]
    a = anchors.shape[0]
    loc = np.asarray(bbox_pred, np.float32).reshape(-1, 4)
    scores = np.asarray(cls_logits, np.float32)
    scores = scores.reshape(-1, scores.shape[-1])

    labels = np.full((a,), -1, np.int32)
    best_gt = np.zeros((a,), np.int64)
    if gts.shape[0]:
        iou = _np_iou_matrix(anchors, gts)
        best_gt = iou.argmax(1)
        best_iou = iou.max(1)
        labels[best_iou >= positive_overlap] = 1
        for g in range(gts.shape[0]):      # gt argmax anchors -> fg
            m = iou[:, g] == iou[:, g].max()
            labels[m & (iou[:, g] > 0)] = 1
        labels[(best_iou < negative_overlap) & (labels != 1)] = 0
    else:
        labels[:] = 0

    fg = np.nonzero(labels == 1)[0]
    bg = np.nonzero(labels == 0)[0]
    fake = fg.size == 0
    if fake:                                # keep focal-loss denominator
        fg = np.array([0], np.int64)
    loc_index = fg.astype(np.int64)
    # the fake fg pads only the location rows (zero inside weight); the
    # score rows use real fg + bg
    score_fg = fg if not fake else np.zeros((0,), np.int64)
    score_index = np.concatenate([score_fg, bg]).astype(np.int64)
    tgt_label = np.concatenate([
        glab[best_gt[score_fg]] if gts.shape[0]
        else np.zeros((score_fg.size,), np.int32),
        np.zeros((bg.size,), np.int32)]).astype(np.int32).reshape(-1, 1)
    if gts.shape[0]:
        tgt_bbox = _np_encode_boxes(anchors[fg], gts[best_gt[fg]])
    else:
        tgt_bbox = np.zeros((fg.size, 4), np.float32)
    inw = np.zeros_like(tgt_bbox) if fake else np.ones_like(tgt_bbox)
    fg_num = np.array([fg.size], np.int32)
    return (scores[score_index], loc[loc_index], tgt_label, tgt_bbox,
            inw, fg_num)


def _perspective_matrix(xs, ys, th, tw):
    """get_transform_matrix (detection/roi_perspective_transform_op.cc:
    110-161) for each RoI: xs, ys [R, 4] → [R, 9], mapping output pixel
    (ow, oh) to source coords by a 3x3 homography."""
    x0, x1, x2, x3 = xs.unbind(-1)
    y0, y1, y2, y3 = ys.unbind(-1)
    len1 = torch.sqrt((x0 - x1) ** 2 + (y0 - y1) ** 2)
    len2 = torch.sqrt((x1 - x2) ** 2 + (y1 - y2) ** 2)
    len3 = torch.sqrt((x2 - x3) ** 2 + (y2 - y3) ** 2)
    len4 = torch.sqrt((x3 - x0) ** 2 + (y3 - y0) ** 2)
    est_h = (len2 + len4) / 2.0
    est_w = (len1 + len3) / 2.0
    nh = float(th)
    nw = _minimum(torch.round(est_w * (nh - 1) / _maximum(est_h, 1e-6))
                  + 1.0, float(tw))
    dx1, dx2, dx3 = x1 - x2, x3 - x2, x0 - x1 + x2 - x3
    dy1, dy2, dy3 = y1 - y2, y3 - y2, y0 - y1 + y2 - y3
    den = dx1 * dy2 - dx2 * dy1
    den = torch.where(torch.abs(den) < 1e-12, den.new_full((), 1e-12), den)
    nw1 = _maximum(nw - 1, 1e-6)
    nh1 = max(nh - 1, 1e-6)
    m6 = (dx3 * dy2 - dx2 * dy3) / den / nw1
    m7 = (dx1 * dy3 - dx3 * dy1) / den / nh1
    m8 = torch.ones_like(x0)
    m3 = (y1 - y0 + m6 * (nw - 1) * y1) / nw1
    m4 = (y3 - y0 + m7 * (nh - 1) * y3) / nh1
    m5 = y0
    m0 = (x1 - x0 + m6 * (nw - 1) * x1) / nw1
    m1 = (x3 - x0 + m7 * (nh - 1) * x3) / nh1
    m2 = x0
    return torch.stack([m0, m1, m2, m3, m4, m5, m6, m7, m8], -1)


def _in_quad(px, py, xs, ys):
    """Even-odd point-in-quadrilateral test over a grid per RoI:
    px/py [R, ...]; xs/ys [R, 4]. Mirrors in_quad
    (roi_perspective_transform_op.cc)."""
    lead = (xs.shape[0],) + (1,) * (px.dim() - 1) + (4,)
    x1, y1 = xs.reshape(lead), ys.reshape(lead)
    x2 = torch.roll(xs, -1, dims=-1).reshape(lead)
    y2 = torch.roll(ys, -1, dims=-1).reshape(lead)
    px = px[..., None]
    py = py[..., None]
    dy = y2 - y1
    t = (py - y1) / torch.where(torch.abs(dy) < 1e-12, dy.new_full((), 1e-12),
                                dy)
    crosses = ((y1 > py) != (y2 > py)) & (px < x1 + t * (x2 - x1))
    return crosses.to(torch.int32).sum(-1) % 2 == 1


def roi_perspective_transform(input, rois, transformed_height,
                              transformed_width, spatial_scale=1.0,
                              roi_batch_indices=None):
    """ROI perspective transform (parity:
    detection/roi_perspective_transform_op.cc): a homography per quad RoI,
    bilinear sampling, zero outside the quad or the feature bounds.

    input [N, C, H, W]; rois [R, 8] quads (x1..y4, clockwise from top
    left) in input-image coords; roi_batch_indices [R] (the dense
    replacement for LoD batching, as in roi_align). Returns
    (out [R, C, th, tw], mask [R, 1, th, tw] int32,
    transform_matrix [R, 9]).
    """
    dev = _dev(input, rois)
    x = _f32(input, dev)
    rois = _f32(rois, dev).reshape(-1, 8)
    h, w = x.shape[2], x.shape[3]
    th, tw = int(transformed_height), int(transformed_width)
    bidx = _roi_batch(rois, roi_batch_indices, dev)
    xs = rois[:, 0::2] * spatial_scale
    ys = rois[:, 1::2] * spatial_scale
    m = _perspective_matrix(xs, ys, th, tw)                # [R, 9]
    ow = torch.arange(tw, dtype=torch.float32, device=dev)[None, None, :]
    oh = torch.arange(th, dtype=torch.float32, device=dev)[None, :, None]
    mm = m[:, :, None, None]
    u = mm[:, 0] * ow + mm[:, 1] * oh + mm[:, 2]
    v = mm[:, 3] * ow + mm[:, 4] * oh + mm[:, 5]
    ww = mm[:, 6] * ow + mm[:, 7] * oh + mm[:, 8]
    ww = torch.where(torch.abs(ww) < 1e-12, ww.new_full((), 1e-12), ww)
    in_w = u / ww                                          # [R, th, tw]
    in_h = v / ww
    valid = (_in_quad(in_w, in_h, xs, ys)
             & (in_w >= -0.5) & (in_w <= w - 0.5)
             & (in_h >= -0.5) & (in_h <= h - 0.5))
    val = _bilinear(x, bidx, in_h, in_w)                   # [R, C, th, tw]
    out = torch.where(valid[:, None], val, val.new_full((), 0.0))
    return out, valid.to(torch.int32)[:, None], m


def _np_rasterize_polys(polys, box, resolution):
    """Rasterize a union of polygons (each [P, 2], image coords) over a
    resolution x resolution grid of ``box`` centers: even-odd rule per
    polygon, union across polygons (host/numpy)."""
    x1, y1, x2, y2 = [float(v) for v in box]
    gx = x1 + (np.arange(resolution) + 0.5) * max(x2 - x1, 1e-6) \
        / resolution
    gy = y1 + (np.arange(resolution) + 0.5) * max(y2 - y1, 1e-6) \
        / resolution
    px = np.broadcast_to(gx[None, :], (resolution, resolution))
    py = np.broadcast_to(gy[:, None], (resolution, resolution))
    mask = np.zeros((resolution, resolution), bool)
    for poly in polys:
        p = np.asarray(poly, np.float32).reshape(-1, 2)
        if p.shape[0] < 3:
            continue
        xa, ya = p[:, 0], p[:, 1]
        xb, yb = np.roll(xa, -1), np.roll(ya, -1)
        dy = yb - ya
        dy = np.where(np.abs(dy) < 1e-12, 1e-12, dy)
        t = (py[..., None] - ya) / dy
        crosses = ((ya > py[..., None]) != (yb > py[..., None])) \
            & (px[..., None] < xa + t * (xb - xa))
        mask |= (crosses.sum(-1) % 2 == 1)
    return mask.astype(np.int32)


def generate_mask_labels(im_info, gt_classes, is_crowd, gt_segms, rois,
                         labels_int32, num_classes, resolution):
    """Mask R-CNN mask-target generation (host/numpy, a CPU-only kernel in
    the reference too, detection/generate_mask_labels_op.cc). One image at
    a time.

    gt_segms: per-gt list of polygons (each a flat [x1,y1,x2,y2,...] or
    [P,2] array) in original image coords (scaled by im_info[2], as the
    reference does); rois [R, 4] in scaled-image coords; labels_int32 [R]
    class per roi (0 = background).

    Returns (mask_rois [F, 4], roi_has_mask_int32 [F, 1] (indices into
    ``rois``), mask_int32 [F, num_classes * resolution^2] with the matched
    class's slice in {0, 1} and every other class -1). With no foreground
    rois, the first roi gets an all -1 mask (ignore).
    """
    im_info, gt_classes, is_crowd, gt_segms, rois, labels_int32 = _host(
        (im_info, gt_classes, is_crowd, gt_segms, rois, labels_int32))
    info = np.asarray(im_info, np.float32).reshape(-1)
    scale = float(info[2]) if info.size >= 3 else 1.0
    rois = np.asarray(rois, np.float32).reshape(-1, 4)
    labels = np.asarray(labels_int32, np.int32).reshape(-1)
    segs = list(gt_segms)
    if is_crowd is not None:
        crowd = np.asarray(is_crowd).reshape(-1).astype(bool)
        segs = [s for s, k in zip(segs, crowd) if not k]

    def seg_polys(seg):
        if isinstance(seg, (list, tuple)) and seg and \
                not np.isscalar(seg[0]):
            return [np.asarray(p, np.float32).reshape(-1, 2) * scale
                    for p in seg]
        return [np.asarray(seg, np.float32).reshape(-1, 2) * scale]

    polys_per_gt = [seg_polys(s) for s in segs]
    gt_bounds = []
    for polys in polys_per_gt:
        allp = np.concatenate(polys, 0) if polys else \
            np.zeros((1, 2), np.float32)
        gt_bounds.append([allp[:, 0].min(), allp[:, 1].min(),
                          allp[:, 0].max(), allp[:, 1].max()])
    gt_bounds = np.asarray(gt_bounds, np.float32).reshape(-1, 4)

    fg = np.nonzero(labels > 0)[0]
    msize = num_classes * resolution * resolution
    if fg.size == 0 or gt_bounds.shape[0] == 0:
        sel = np.array([0], np.int64) if rois.shape[0] else \
            np.zeros((0,), np.int64)
        masks = np.full((sel.size, msize), -1, np.int32)
        return (rois[sel], sel.astype(np.int32).reshape(-1, 1), masks)

    iou = _np_iou_matrix(rois[fg], gt_bounds)
    best = iou.argmax(1)
    masks = np.full((fg.size, msize), -1, np.int32)
    for i, (ri, gi) in enumerate(zip(fg, best)):
        cls = int(labels[ri])
        m = _np_rasterize_polys(polys_per_gt[gi], rois[ri], resolution)
        s = cls * resolution * resolution
        masks[i, s:s + resolution * resolution] = m.reshape(-1)
    return (rois[fg], fg.astype(np.int32).reshape(-1, 1), masks)


def mine_hard_examples(cls_loss, loc_loss, match_indices, match_dist,
                       neg_pos_ratio=3.0, neg_dist_threshold=0.5,
                       sample_size=None, mining_type="max_negative"):
    """Standalone hard-example mining (parity:
    detection/mine_hard_examples_op.cc; ssd_loss fuses the same logic
    inline). Instead of the reference's ragged NegIndices LoD, returns
    (neg_mask [N, P] int32 0/1 of selected negatives, match_indices passed
    through as the UpdatedMatchIndices slot; unmatched entries are already
    -1 by the input contract).

    cls_loss/loc_loss [N, P]; match_indices [N, P] (-1 = unmatched);
    match_dist [N, P].
    """
    dev = _dev(cls_loss, match_indices)
    cls_loss = _f32(cls_loss, dev)
    loss = cls_loss if mining_type == "max_negative" or loc_loss is None \
        else cls_loss + _f32(loc_loss, dev)
    mi = _i32(match_indices, dev)
    dist = _f32(match_dist, dev)
    neg_sel = _mine_negatives(loss, mi >= 0, dist, neg_pos_ratio,
                              neg_dist_threshold, sample_size, mining_type)
    return neg_sel.to(torch.int32), mi
