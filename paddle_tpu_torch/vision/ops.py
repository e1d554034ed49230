"""Detection ops (counterpart of the reference's ``vision/ops.py``):
``box_iou``, ``nms``, ``box_coder``, ``yolo_box``, ``roi_align``,
``deform_conv2d`` with the ``DeformConv2D`` layer, ``read_file``/
``decode_jpeg`` and ``yolo_loss``.

Every op is a composition of torch operations with static shapes, so a
detector's step has no host read and may be captured:

- ``nms`` is greedy hard suppression over the scores sorted by a stable
  ``argsort`` of ``-scores`` (ties keep their input order), suppressing
  on IoU strictly above the threshold, in a fixed ``max_out`` trips with
  no read-back: it returns ``(indices [max_out] int64, count)``, the tail
  padded with -1 (the reference's indices are int32);
- ``roi_align`` samples ``sampling_ratio`` points a bin side (a fixed 2
  when it is <= 0), each clipped into the image; ``aligned`` shifts by
  half a pixel; ``boxes_num`` maps each RoI to its image;
- ``deform_conv2d`` reads the offsets as (dy, dx) pairs per kernel tap,
  ``[N, 2 * dg * kh * kw, Ho, Wo]``, zeroes each of the four bilinear
  corners that falls outside the image, multiplies by the mask (v2)
  before the grouped contraction; autograd differentiates it;
- ``yolo_box`` zeroes the scores of boxes under ``conf_thresh``, not the
  boxes;
- ``yolo_loss`` picks each ground truth's anchor by shape-only IoU over
  all anchors, lets the last of two ground truths on one (anchor, cell)
  win, masks padded slots (w or h 0), weights the box, class and
  objectness terms by ``gt_score``, and returns the loss per image [N].

``read_file`` and ``decode_jpeg`` run on the host (PIL, imported when
called) and return CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import InvalidArgumentError, UnavailableError
from ..framework.dispatch import make_op as _make_op
from ..nn.layer.layers import Layer

__all__ = ["box_iou", "nms", "box_coder", "yolo_box", "roi_align",
           "deform_conv2d", "DeformConv2D", "read_file", "decode_jpeg",
           "yolo_loss"]


def box_iou(boxes1, boxes2):
    """Pairwise IoU of [N, 4] and [M, 4] xyxy boxes: [N, M]."""
    b1 = boxes1[:, None, :]
    b2 = boxes2[None, :, :]
    lt = torch.maximum(b1[..., :2], b2[..., :2])
    rb = torch.minimum(b1[..., 2:], b2[..., 2:])
    wh = (rb - lt).clamp(min=0)
    inter = wh[..., 0] * wh[..., 1]
    a1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    a2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    return inter / torch.clamp(a1 + a2 - inter, min=1e-9)


def nms(boxes, scores, iou_threshold: float = 0.5,
        max_out: Optional[int] = None,
        score_threshold: Optional[float] = None) -> Tuple:
    """Greedy hard NMS in ``max_out`` fixed trips.  Returns ``(indices,
    count)``: the first ``count`` of ``indices`` [max_out] (int64) are the
    kept boxes in descending score order, the rest -1."""
    n = boxes.shape[0]
    if max_out is None:
        max_out = n
    order = torch.argsort(-scores, stable=True)
    iou = box_iou(boxes[order], boxes[order])
    alive = torch.ones(n, dtype=torch.bool, device=boxes.device)
    if score_threshold is not None:
        alive = alive & (scores[order] > score_threshold)
    pos = torch.arange(n, device=boxes.device)
    out = []
    for _ in range(max_out):
        # the first alive candidate; a trip with none alive writes -1 and
        # leaves alive all False.  The candidate stays a 1-element tensor:
        # indexing with a 0-d tensor would read it back to the host
        cand = torch.argmax(alive.to(torch.int32)).reshape(1)
        any_alive = alive.any()
        out.append(torch.where(any_alive, order.index_select(0, cand)[0],
                               -1))
        alive = alive & ~(iou.index_select(0, cand)[0] > iou_threshold) \
            & (pos != cand)
    indices = torch.stack(out) if out else order.new_empty(0)
    return indices, (indices >= 0).sum()


def box_coder(prior_box, prior_box_var, target_box,
              code_type: str = "encode_center_size",
              box_normalized: bool = True):
    """Encode [N, 4] xyxy targets against [N, 4] priors as (dx, dy, dw,
    dh) over the variances, or decode such deltas back to boxes."""
    pb = prior_box.float()
    pv = torch.as_tensor(prior_box_var, dtype=torch.float32,
                         device=pb.device)
    tb = target_box.float()
    norm = 0.0 if box_normalized else 1.0
    pw = pb[:, 2] - pb[:, 0] + norm
    ph = pb[:, 3] - pb[:, 1] + norm
    pcx = pb[:, 0] + pw * 0.5
    pcy = pb[:, 1] + ph * 0.5
    if code_type == "encode_center_size":
        tw = tb[:, 2] - tb[:, 0] + norm
        th = tb[:, 3] - tb[:, 1] + norm
        tcx = tb[:, 0] + tw * 0.5
        tcy = tb[:, 1] + th * 0.5
        out = torch.stack([(tcx - pcx) / pw, (tcy - pcy) / ph,
                           torch.log(tw / pw), torch.log(th / ph)], dim=1)
        return out / pv
    if code_type == "decode_center_size":
        d = tb * pv
        cx = d[:, 0] * pw + pcx
        cy = d[:, 1] * ph + pcy
        w = torch.exp(d[:, 2]) * pw
        h = torch.exp(d[:, 3]) * ph
        return torch.stack([cx - w * 0.5, cy - h * 0.5,
                            cx + w * 0.5 - norm, cy + h * 0.5 - norm], dim=1)
    raise InvalidArgumentError("code_type must be encode/decode_center_size")


def yolo_box(x, img_size, anchors, class_num: int, conf_thresh: float,
             downsample_ratio: int = 32, clip_bbox: bool = True,
             scale_x_y: float = 1.0):
    """Decode one YOLO head ``x`` [N, A * (5 + classes), H, W]: boxes
    [N, H * W * A, 4] xyxy in image pixels (``img_size`` [N, 2] is (h,
    w)) and scores [N, H * W * A, classes], zero where the objectness is
    not above ``conf_thresh``."""
    n, c, h, w = x.shape
    na = len(anchors) // 2
    if c != na * (5 + class_num):
        raise InvalidArgumentError("yolo_box channel mismatch: %d != %d*(5+%d)"
                                   % (c, na, class_num))
    dev = x.device
    an = torch.as_tensor(np.asarray(anchors, np.float32).reshape(na, 2),
                         device=dev)
    feats = x.reshape(n, na, 5 + class_num, h, w)
    grid_x = torch.arange(w, dtype=torch.float32, device=dev)[None, None,
                                                              None, :]
    grid_y = torch.arange(h, dtype=torch.float32, device=dev)[None, None,
                                                              :, None]
    alpha, beta = scale_x_y, -0.5 * (scale_x_y - 1.0)
    bx = (torch.sigmoid(feats[:, :, 0]) * alpha + beta + grid_x) / w
    by = (torch.sigmoid(feats[:, :, 1]) * alpha + beta + grid_y) / h
    bw = torch.exp(feats[:, :, 2]) * an[None, :, 0, None, None] / (
        w * downsample_ratio)
    bh = torch.exp(feats[:, :, 3]) * an[None, :, 1, None, None] / (
        h * downsample_ratio)
    conf = torch.sigmoid(feats[:, :, 4])
    probs = torch.sigmoid(feats[:, :, 5:]) * conf[:, :, None]
    img = torch.as_tensor(img_size, device=dev).float()
    img_h = img[:, 0][:, None, None, None]
    img_w = img[:, 1][:, None, None, None]
    x0 = (bx - bw * 0.5) * img_w
    y0 = (by - bh * 0.5) * img_h
    x1 = (bx + bw * 0.5) * img_w
    y1 = (by + bh * 0.5) * img_h
    if clip_bbox:
        zero = torch.zeros_like(img_w)
        x0 = torch.clamp(x0, zero, img_w - 1)
        y0 = torch.clamp(y0, zero, img_h - 1)
        x1 = torch.clamp(x1, zero, img_w - 1)
        y1 = torch.clamp(y1, zero, img_h - 1)
    boxes = torch.stack([x0, y0, x1, y1], dim=-1).reshape(n, -1, 4)
    keep = (conf > conf_thresh)[..., None]
    scores = torch.where(keep, probs.permute(0, 1, 3, 4, 2),
                         torch.zeros((), dtype=probs.dtype, device=dev))
    return boxes, scores.reshape(n, -1, class_num)


def roi_align(x, boxes, boxes_num, output_size, spatial_scale: float = 1.0,
              sampling_ratio: int = -1, aligned: bool = True):
    """[N, C, H, W] features and [R, 4] xyxy RoIs -> [R, C, oh, ow]: each
    bin the mean of ``s x s`` bilinear samples (``s`` =
    ``sampling_ratio``, 2 when it is <= 0), each sample clipped into the
    image.  ``boxes_num`` [N] counts the RoIs of each image, in order."""
    if isinstance(output_size, int):
        output_size = (output_size, output_size)
    oh, ow = output_size
    n, c, h, w = x.shape
    dev = x.device
    boxes = boxes.float()
    r = boxes.shape[0]
    counts = torch.as_tensor(boxes_num, device=dev).long()
    batch_idx = torch.repeat_interleave(torch.arange(n, device=dev), counts,
                                        output_size=r)
    offset = 0.5 if aligned else 0.0
    x0 = boxes[:, 0] * spatial_scale - offset
    y0 = boxes[:, 1] * spatial_scale - offset
    x1 = boxes[:, 2] * spatial_scale - offset
    y1 = boxes[:, 3] * spatial_scale - offset
    floor = 1e-3 if aligned else 1.0
    rw = torch.clamp(x1 - x0, min=floor)
    rh = torch.clamp(y1 - y0, min=floor)
    s = sampling_ratio if sampling_ratio > 0 else 2
    ys = y0[:, None] + rh[:, None] * (
        (torch.arange(oh * s, device=dev) + 0.5) / (oh * s))
    xs = x0[:, None] + rw[:, None] * (
        (torch.arange(ow * s, device=dev) + 0.5) / (ow * s))
    ys = ys.clamp(0, h - 1)
    xs = xs.clamp(0, w - 1)
    yf = torch.floor(ys).long().clamp(0, h - 1)
    xf = torch.floor(xs).long().clamp(0, w - 1)
    yc = (yf + 1).clamp(max=h - 1)
    xc = (xf + 1).clamp(max=w - 1)
    wy = (ys - yf)[:, :, None, None]
    wx = (xs - xf)[:, None, :, None]
    feat = x.permute(0, 2, 3, 1)  # [N, H, W, C]: one gather a corner
    bi = batch_idx[:, None, None]

    def g(iy, ix):
        return feat[bi, iy[:, :, None], ix[:, None, :]]  # [R, Sh, Sw, C]

    val = (g(yf, xf) * ((1 - wy) * (1 - wx)) + g(yf, xc) * ((1 - wy) * wx)
           + g(yc, xf) * (wy * (1 - wx)) + g(yc, xc) * (wy * wx))
    val = val.reshape(r, oh, s, ow, s, c).mean(dim=(2, 4))
    return val.permute(0, 3, 1, 2)


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _deform_conv2d(x, offset, weight, bias=None, mask=None, stride=1,
                   padding=0, dilation=1, deformable_groups=1, groups=1):
    """Deformable convolution v1 (``mask`` None) or v2: bilinear samples
    at each tap's offset position, then the grouped contraction with
    ``weight`` [Cout, C / groups, kh, kw] as one batched product."""
    n, c, h, w = x.shape
    cout, cpg, kh, kw = weight.shape
    sh, sw = _pair(stride)
    ph, pw = _pair(padding)
    dh, dw = _pair(dilation)
    dg = deformable_groups
    k = kh * kw
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // sh + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // sw + 1
    if c % dg:
        raise InvalidArgumentError(
            "channels %d not divisible by deformable_groups %d" % (c, dg))
    if c % groups:
        raise InvalidArgumentError(
            "channels %d not divisible by groups %d" % (c, groups))
    dev = x.device
    off = offset.reshape(n, dg, k, 2, ho, wo)
    ky = (torch.arange(kh, device=dev) * dh).repeat_interleave(kw)
    kx = (torch.arange(kw, device=dev) * dw).repeat(kh)
    oy = torch.arange(ho, device=dev) * sh - ph
    ox = torch.arange(wo, device=dev) * sw - pw
    py = ky[None, None, :, None, None] + oy[None, None, None, :, None] \
        + off[:, :, :, 0]
    px = kx[None, None, :, None, None] + ox[None, None, None, None, :] \
        + off[:, :, :, 1]
    cg = c // dg
    xg = x.reshape(n, dg, cg, h * w)
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0).to(x.dtype).reshape(n, dg, 1, -1)
    wx = (px - x0).to(x.dtype).reshape(n, dg, 1, -1)
    y0, x0 = y0.long(), x0.long()

    def corner(iy, ix):
        valid = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
        idx = (iy.clamp(0, h - 1) * w + ix.clamp(0, w - 1)).reshape(
            n, dg, 1, -1)
        v = xg.gather(3, idx.expand(n, dg, cg, idx.shape[-1]))
        return v * valid.reshape(n, dg, 1, -1).to(x.dtype)

    sampled = (corner(y0, x0) * (1 - wy) * (1 - wx)
               + corner(y0, x0 + 1) * (1 - wy) * wx
               + corner(y0 + 1, x0) * wy * (1 - wx)
               + corner(y0 + 1, x0 + 1) * wy * wx)
    sampled = sampled.reshape(n, dg, cg, k, ho, wo)
    if mask is not None:
        sampled = sampled * mask.reshape(n, dg, 1, k, ho, wo).to(x.dtype)
    # [N, G, C/G * K, Ho * Wo] against [G, Cout/G, C/G * K]
    cols = sampled.reshape(n, groups, (c // groups) * k, ho * wo)
    wg = weight.reshape(groups, cout // groups, cpg * k)
    out = torch.matmul(wg[None], cols).reshape(n, cout, ho, wo)
    if bias is not None:
        out = out + bias.reshape(1, cout, 1, 1)
    return out


deform_conv2d = _make_op(_deform_conv2d, "deform_conv2d")


class DeformConv2D(Layer):
    """``deform_conv2d``'s layer: weight [out, in / groups, kh, kw]
    (XavierUniform), bias zeros; ``forward(x, offset, mask=None)``."""

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, deformable_groups=1, groups=1,
                 weight_attr=None, bias_attr=None, device=None,
                 generator=None):
        super().__init__()
        from ..nn import initializer as I
        from ..nn.layer.layers import create_parameter

        kh, kw = _pair(kernel_size)
        self._stride = stride
        self._padding = padding
        self._dilation = dilation
        self._deformable_groups = deformable_groups
        self._groups = groups
        kwargs = dict(device=device, generator=generator)
        self.weight = create_parameter(
            [out_channels, in_channels // groups, kh, kw], weight_attr,
            default_initializer=I.XavierUniform(), **kwargs)
        self.bias = create_parameter([out_channels], bias_attr, is_bias=True,
                                     **kwargs)

    def forward(self, x, offset, mask=None):
        return deform_conv2d(
            x, offset, self.weight, self.bias, mask, stride=self._stride,
            padding=self._padding, dilation=self._dilation,
            deformable_groups=self._deformable_groups, groups=self._groups)


def read_file(filename, name=None):
    """The file's bytes as a CPU uint8 tensor."""
    with open(filename, "rb") as f:
        data = f.read()
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise UnavailableError(
            "this operation needs PIL (the Pillow package), which is not "
            "installed") from e
    return Image


def decode_jpeg(x, mode: str = "unchanged", name=None):
    """JPEG bytes (a uint8 tensor or array) -> a CHW uint8 CPU tensor;
    ``mode`` ``gray`` or ``rgb`` converts.  Decoded on the host by PIL."""
    import io

    image = _pil_image()
    raw = (x.detach().cpu().numpy() if isinstance(x, torch.Tensor)
           else np.asarray(x, np.uint8)).astype(np.uint8).tobytes()
    img = image.open(io.BytesIO(raw))
    if mode == "gray":
        img = img.convert("L")
    elif mode == "rgb":
        img = img.convert("RGB")
    arr = np.asarray(img)
    arr = arr[None] if arr.ndim == 2 else arr.transpose(2, 0, 1)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _bce_logits(logit, target):
    return (torch.clamp(logit, min=0) - logit * target
            + torch.log1p(torch.exp(-logit.abs())))


def _yolo_loss(x, gt_box, gt_label, gt_score, anchors, anchor_mask,
               class_num, ignore_thresh, downsample_ratio,
               use_label_smooth=True, scale_x_y=1.0):
    """YOLOv3's loss of one head ``x`` [N, A * (5 + C), H, W] against
    ``gt_box`` [N, B, 4] (normalized cx, cy, w, h), ``gt_label`` [N, B]
    and ``gt_score`` [N, B] (None: ones): [N].  Targets are one-hot
    algebra over [N, B, A, H, W], no data-dependent shapes."""
    n, _, h, w = x.shape
    a = len(anchor_mask)
    nc = int(class_num)
    dev = x.device
    x = x.reshape(n, a, 5 + nc, h, w)
    an_all = torch.as_tensor(np.asarray(anchors, np.float32).reshape(-1, 2),
                             device=dev)
    mask_arr = torch.as_tensor(list(anchor_mask), device=dev)
    an_sel = an_all[mask_arr]
    in_w = float(downsample_ratio * w)
    in_h = float(downsample_ratio * h)
    gt_box = gt_box.float()
    b = gt_box.shape[1]
    gw, gh = gt_box[..., 2], gt_box[..., 3]
    valid = (gw > 1e-8) & (gh > 1e-8)
    score = (gt_score.float() if gt_score is not None
             else torch.ones((n, b), device=dev))

    # the responsible anchor of each ground truth: shape-only IoU over all
    bw = gw[..., None] * in_w
    bh = gh[..., None] * in_h
    inter = torch.minimum(bw, an_all[None, None, :, 0]) \
        * torch.minimum(bh, an_all[None, None, :, 1])
    union = bw * bh + an_all[None, None, :, 0] * an_all[None, None, :, 1] \
        - inter
    best = torch.argmax(inter / torch.clamp(union, min=1e-9), dim=-1)
    on_scale = best[..., None] == mask_arr[None, None, :]      # [N, B, A]
    resp = valid[..., None] & on_scale
    a_local = torch.argmax(on_scale.to(torch.int32), dim=-1)   # [N, B]

    gi = torch.clamp((gt_box[..., 0] * w).to(torch.int32), 0, w - 1).long()
    gj = torch.clamp((gt_box[..., 1] * h).to(torch.int32), 0, h - 1).long()
    # the last of two ground truths on one (anchor, cell) keeps it
    resp_any = resp.any(-1)
    key = a_local * (h * w) + gj * w + gi
    same = (key[:, :, None] == key[:, None, :]) \
        & resp_any[:, :, None] & resp_any[:, None, :]
    later = torch.ones((b, b), dtype=torch.bool, device=dev).triu(1)[None]
    kept = resp_any & ~(same & later).any(-1)
    resp = resp & kept[..., None]
    t_x = gt_box[..., 0] * w - gi
    t_y = gt_box[..., 1] * h - gj
    p_sel = an_sel[a_local]                                    # [N, B, 2]
    t_w = torch.log(torch.clamp(gw * in_w, min=1e-9) / p_sel[..., 0])
    t_h = torch.log(torch.clamp(gh * in_h, min=1e-9) / p_sel[..., 1])
    box_w = 2.0 - gw * gh

    cell = (torch.nn.functional.one_hot(gj, h).float()[:, :, :, None]
            * torch.nn.functional.one_hot(gi, w).float()[:, :, None, :])
    sel = resp.float()[..., None, None] * cell[:, :, None]     # [N,B,A,H,W]

    def gather_pred(ch):
        return torch.einsum("nbahw,nahw->nb", sel, x[:, :, ch])

    w_pos = box_w * score
    sxy = float(scale_x_y)
    if sxy != 1.0:
        tx_eff = (t_x + 0.5 * (sxy - 1.0)) / sxy
        ty_eff = (t_y + 0.5 * (sxy - 1.0)) / sxy
    else:
        tx_eff, ty_eff = t_x, t_y
    is_resp = resp.any(-1).float()
    loss_xy = (_bce_logits(gather_pred(0), tx_eff)
               + _bce_logits(gather_pred(1), ty_eff))
    loss_wh = ((gather_pred(2) - t_w).abs() + (gather_pred(3) - t_h).abs())
    loss_box = ((loss_xy + loss_wh) * w_pos * is_resp).sum(-1)

    smooth = use_label_smooth and nc > 1
    smooth_pos = 1.0 - 1.0 / nc if smooth else 1.0
    smooth_neg = 1.0 / nc if smooth else 0.0
    cls_t = torch.nn.functional.one_hot(gt_label.long().clamp(0, nc - 1),
                                        nc).float()
    cls_t = cls_t * (gt_label.long() >= 0)[..., None].float() \
        * (gt_label.long() < nc)[..., None].float()
    cls_t = cls_t * (smooth_pos - smooth_neg) + smooth_neg
    cls_logit = torch.einsum("nbahw,nachw->nbc", sel, x[:, :, 5:])
    loss_cls = (_bce_logits(cls_logit, cls_t).sum(-1) * score
                * is_resp).sum(-1)

    cx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, None,
                                                          :]
    cy = torch.arange(h, dtype=torch.float32, device=dev)[None, None, :,
                                                          None]
    bx = (sxy * torch.sigmoid(x[:, :, 0]) - 0.5 * (sxy - 1.0) + cx) / w
    by = (sxy * torch.sigmoid(x[:, :, 1]) - 0.5 * (sxy - 1.0) + cy) / h
    pw = an_sel[:, 0][None, :, None, None] * torch.exp(x[:, :, 2]) / in_w
    ph = an_sel[:, 1][None, :, None, None] * torch.exp(x[:, :, 3]) / in_h

    def corners(cxc, cyc, ww, hh):
        return cxc - ww / 2, cyc - hh / 2, cxc + ww / 2, cyc + hh / 2

    px0, py0, px1, py1 = corners(bx, by, pw, ph)               # [N,A,H,W]
    gx0, gy0, gx1, gy1 = corners(gt_box[..., 0], gt_box[..., 1], gw, gh)
    g5 = (slice(None), slice(None), None, None, None)
    ix0 = torch.maximum(px0[:, None], gx0[g5])
    iy0 = torch.maximum(py0[:, None], gy0[g5])
    ix1 = torch.minimum(px1[:, None], gx1[g5])
    iy1 = torch.minimum(py1[:, None], gy1[g5])
    inter2 = (ix1 - ix0).clamp(min=0) * (iy1 - iy0).clamp(min=0)
    area_p = (px1 - px0) * (py1 - py0)
    area_g = ((gx1 - gx0) * (gy1 - gy0))[g5]
    iou = inter2 / torch.clamp(area_p[:, None] + area_g - inter2, min=1e-9)
    iou = torch.where(valid[g5], iou, torch.zeros((), device=dev))
    ignore = iou.amax(dim=1) > ignore_thresh                   # [N,A,H,W]

    obj_t = torch.einsum("nbahw,nb->nahw", sel, score).clamp(0.0, 1.0)
    obj_pos = sel.sum(1).clamp(0.0, 1.0)
    obj_l = _bce_logits(x[:, :, 4], obj_t)
    keep = obj_pos + (1.0 - obj_pos) * (1.0 - ignore.float())
    loss_obj = (obj_l * keep).sum((1, 2, 3))
    return loss_box + loss_cls + loss_obj


_yolo_loss_op = _make_op(_yolo_loss, "yolo_loss")


def yolo_loss(x, gt_box, gt_label, anchors, anchor_mask, class_num,
              ignore_thresh, downsample_ratio, gt_score=None,
              use_label_smooth=True, name=None, scale_x_y=1.0):
    """YOLOv3's loss of one head, per image [N] (see ``_yolo_loss``)."""
    return _yolo_loss_op(
        x, gt_box, gt_label, gt_score, list(anchors), list(anchor_mask),
        int(class_num), float(ignore_thresh), int(downsample_ratio),
        use_label_smooth=bool(use_label_smooth), scale_x_y=float(scale_x_y))
