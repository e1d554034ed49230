"""The port's detection ops (``vision/ops.py``) against the reference on
the CPU: ``box_iou``, ``nms`` (ties, all-suppressed, score threshold,
short ``max_out``), ``box_coder``, ``yolo_box``, ``roi_align`` (RoIs that
leave the image, several images, both ``aligned``s), ``deform_conv2d``
forward and gradients (v1 and v2, groups, deformable groups, strides),
``DeformConv2D``, ``yolo_loss`` and its gradient (colliding ground
truths, padded slots, ``gt_score``, label smoothing, ``scale_x_y``), and
``read_file``/``decode_jpeg``.

Inputs are made with numpy from a seed and handed to both packages; the
reference's ops are called raw (``jnp``) under ``jax.jit`` (one compile
a call, not one an op), gradients by ``jax.vjp``.
Tolerances, fp32, relative to each array's largest magnitude (at least
1): ``box_iou``, ``box_coder``, ``yolo_box`` 1e-6; ``roi_align`` and
``deform_conv2d`` forward and gradients 1e-5 (bilinear sums in another
order, the contraction a batched product); ``yolo_loss`` and its gradient
1e-5.  ``nms`` indices are equal; the port's are int64 (the reference's
int32).
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as pt
from paddle_tpu.vision import ops as rops

from paddle_tpu_torch import InvalidArgumentError, load_reference_params
from paddle_tpu_torch.vision import ops

TIGHT = 1e-6
LOOSE = 1e-5


def _rng(*key):
    return np.random.RandomState(zlib.crc32(repr(key).encode()))


def _close(got, want, tol):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * scale)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _boxes(rng, n, extent=10.0, lo=0.5, hi=3.5):
    centers = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * (hi - lo) + lo
    return np.concatenate([centers - wh / 2, centers + wh / 2],
                          axis=1).astype(np.float32)


# -- box_iou, nms, box_coder --------------------------------------------------

def test_box_iou_matches_reference():
    rng = _rng("iou")
    a, b = _boxes(rng, 7), _boxes(rng, 5)
    _close(ops.box_iou(_t(a), _t(b)).numpy(), rops.box_iou(a, b), TIGHT)


def _nms_both(boxes, scores, thr, **kw):
    want_idx, want_n = jax.jit(lambda b, s: rops.nms(b, s, thr, **kw))(
        boxes, scores)
    idx, n = ops.nms(_t(boxes), _t(scores), thr, **kw)
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert int(n) == int(want_n)
    return idx.numpy(), int(n)


@pytest.mark.parametrize("n,thr", [(20, 0.3), (50, 0.5), (50, 0.7),
                                   (200, 0.45)])
def test_nms_matches_reference(n, thr):
    rng = _rng("nms", n, thr)
    _nms_both(_boxes(rng, n), rng.rand(n).astype(np.float32), thr)


def test_nms_ties_keep_input_order():
    rng = _rng("nms-ties")
    boxes = _boxes(rng, 30, extent=30.0)
    scores = np.repeat(np.float32([0.9, 0.5, 0.2]), 10)
    idx, n = _nms_both(boxes, scores, 0.5)
    # equal scores come out in input order (a stable sort)
    kept = idx[:n]
    for s in np.unique(scores):
        sel = [i for i in kept if scores[i] == s]
        assert sel == sorted(sel)


def test_nms_all_suppressed_and_thresholds():
    box = np.float32([[0, 0, 4, 4]])
    boxes = np.repeat(box, 6, axis=0) + np.float32(
        [[0.01 * i] * 4 for i in range(6)])
    scores = np.float32([0.1, 0.6, 0.3, 0.9, 0.2, 0.5])
    idx, n = _nms_both(boxes, scores, 0.5)
    assert n == 1 and idx[0] == 3 and (idx[1:] == -1).all()
    # every score under the threshold: nothing kept
    idx, n = _nms_both(boxes, scores, 0.5, score_threshold=0.95)
    assert n == 0 and (idx == -1).all()
    # max_out below the kept count truncates; strict > at the threshold
    rng = _rng("nms-max")
    far = _boxes(rng, 12, extent=100.0)
    _nms_both(far, rng.rand(12).astype(np.float32), 0.5, max_out=4)
    _nms_both(far, rng.rand(12).astype(np.float32), 0.5, max_out=16)
    same = np.float32([[0, 0, 2, 2], [0, 0, 2, 2]])
    idx, n = _nms_both(same, np.float32([0.5, 0.4]), 1.0)
    assert n == 2  # IoU 1 is not above a threshold of 1


@pytest.mark.parametrize("normalized", [True, False])
def test_box_coder_matches_reference(normalized):
    rng = _rng("coder", normalized)
    prior = _boxes(rng, 9)
    var = np.float32([0.1, 0.1, 0.2, 0.2])
    target = _boxes(rng, 9)
    enc = ops.box_coder(_t(prior), var, _t(target), "encode_center_size",
                        normalized)
    want = rops.box_coder(prior, var, target, "encode_center_size",
                          normalized)
    _close(enc.numpy(), want, TIGHT)
    dec = ops.box_coder(_t(prior), var, enc, "decode_center_size",
                        normalized)
    _close(dec.numpy(), rops.box_coder(prior, var, np.asarray(want),
                                       "decode_center_size", normalized),
           TIGHT)
    _close(dec.numpy(), target, 1e-5)  # the round trip
    with pytest.raises(InvalidArgumentError):
        ops.box_coder(_t(prior), var, _t(target), "corner")


# -- yolo_box -----------------------------------------------------------------

@pytest.mark.parametrize("clip,sxy", [(True, 1.0), (False, 1.0),
                                      (True, 1.05)])
def test_yolo_box_matches_reference(clip, sxy):
    rng = _rng("yolo_box", clip, sxy)
    anchors = [10, 13, 16, 30, 33, 23]
    x = rng.randn(2, 3 * (5 + 4), 5, 6).astype(np.float32)
    img = np.int32([[160, 192], [150, 200]])
    got_b, got_s = ops.yolo_box(_t(x), torch.from_numpy(img), anchors, 4,
                                0.5, 32, clip, sxy)
    want_b, want_s = jax.jit(lambda a: rops.yolo_box(
        a, img, anchors, 4, 0.5, 32, clip, sxy))(x)
    _close(got_b.numpy(), want_b, TIGHT)
    _close(got_s.numpy(), want_s, TIGHT)
    # low-confidence boxes keep their coordinates, their scores are 0
    assert (got_s.numpy() == 0).all(-1).any()
    with pytest.raises(InvalidArgumentError):
        ops.yolo_box(_t(x), torch.from_numpy(img), anchors, 5, 0.5)


# -- roi_align ----------------------------------------------------------------

@pytest.mark.parametrize("aligned,ratio,scale", [(True, -1, 1.0),
                                                 (False, 2, 0.5),
                                                 (True, 3, 0.25)])
def test_roi_align_matches_reference(aligned, ratio, scale):
    rng = _rng("roi", aligned, ratio)
    x = rng.randn(3, 4, 12, 15).astype(np.float32)
    extent = 15 / scale
    boxes = _boxes(rng, 9, extent=extent, lo=1.0, hi=extent / 2)
    # RoIs that leave the image on every side
    boxes[0] = [-8.0, -6.0, 5.0, 4.0]
    boxes[1] = [extent - 3.0, extent - 4.0, extent + 9.0, extent + 7.0]
    boxes[2] = [2.0, 3.0, 2.0, 3.0]  # degenerate
    boxes_num = np.int32([4, 0, 5])

    def ref_fn(a, b):
        return rops.roi_align(a, b, boxes_num, (3, 4), scale, ratio,
                              aligned)

    want, vjp = jax.vjp(jax.jit(ref_fn), jnp.asarray(x), jnp.asarray(boxes))
    cot = rng.randn(*want.shape).astype(np.float32)
    gx, _ = vjp(jnp.asarray(cot))
    tx = _t(x, True)
    got = ops.roi_align(tx, _t(boxes), torch.from_numpy(boxes_num),
                        (3, 4), scale, ratio, aligned)
    _close(got.detach().numpy(), want, LOOSE)
    got.backward(torch.from_numpy(cot))
    _close(tx.grad.numpy(), gx, LOOSE)


# -- deform_conv2d ------------------------------------------------------------

DEFORM = [
    # (c, cout, k, stride, pad, dil, dg, groups, mask)
    (4, 6, 3, 1, 1, 1, 1, 1, False),
    (4, 6, 3, 1, 1, 1, 1, 1, True),
    (4, 6, 3, 2, 0, 1, 2, 1, True),
    (4, 4, (3, 2), 1, (1, 0), (2, 1), 2, 2, True),
    (6, 6, 1, 1, 0, 1, 3, 3, False),
]


@pytest.mark.parametrize("case", range(len(DEFORM)))
def test_deform_conv2d_matches_reference(case):
    c, cout, k, s, p, d, dg, g, with_mask = DEFORM[case]
    kh, kw = (k, k) if isinstance(k, int) else k
    ph, pw = (p, p) if isinstance(p, int) else p
    dh, dw = (d, d) if isinstance(d, int) else d
    rng = _rng("deform", case)
    h, w = 7, 8
    ho = (h + 2 * ph - (dh * (kh - 1) + 1)) // s + 1
    wo = (w + 2 * pw - (dw * (kw - 1) + 1)) // s + 1
    x = rng.randn(2, c, h, w).astype(np.float32)
    # offsets up to +-2.5 pixels: corners fall outside the image
    off = (rng.rand(2, 2 * dg * kh * kw, ho, wo) * 5 - 2.5).astype(
        np.float32)
    wt = rng.randn(cout, c // g, kh, kw).astype(np.float32) * 0.3
    b = rng.randn(cout).astype(np.float32)
    arrays = [x, off, wt, b]
    if with_mask:
        arrays.append(rng.rand(2, dg * kh * kw, ho, wo).astype(np.float32))
    kw_ = dict(stride=s, padding=p, dilation=d, deformable_groups=dg,
               groups=g)

    def ref_fn(*a):
        return rops._deform_conv2d_raw(*a[:4], a[4] if with_mask else None,
                                       **kw_)

    want, vjp = jax.vjp(jax.jit(ref_fn), *[jnp.asarray(a) for a in arrays])
    cot = rng.randn(*want.shape).astype(np.float32)
    want_grads = vjp(jnp.asarray(cot))
    ts = [_t(a, True) for a in arrays]
    got = ops.deform_conv2d(*ts[:4], ts[4] if with_mask else None, **kw_)
    _close(got.detach().numpy(), want, LOOSE)
    got.backward(torch.from_numpy(cot))
    for t, gw in zip(ts, want_grads):
        _close(t.grad.numpy(), gw, LOOSE)


def test_deform_conv2d_layer_carries_reference_weights():
    pt.seed(0)
    ref = rops.DeformConv2D(4, 5, 3, padding=1)
    port = ops.DeformConv2D(4, 5, 3, padding=1, device="cpu")
    load_reference_params(port, {n: np.asarray(p.value)
                                 for n, p in ref.named_parameters()})
    rng = _rng("deform-layer")
    x = rng.randn(2, 4, 6, 6).astype(np.float32)
    off = rng.randn(2, 18, 6, 6).astype(np.float32)
    mask = rng.rand(2, 9, 6, 6).astype(np.float32)
    want = pt.jit.to_static(ref)(pt.to_tensor(x), pt.to_tensor(off),
                                 pt.to_tensor(mask))
    got = port(_t(x), _t(off), _t(mask))
    _close(got.detach().numpy(), want.value, LOOSE)
    with pytest.raises(InvalidArgumentError):
        ops.deform_conv2d(_t(x), _t(off), port.weight, deformable_groups=3)


# -- yolo_loss ----------------------------------------------------------------

ANCHORS = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]


def _yolo_inputs(rng, n=2, b=6, h=5, w=6, classes=4):
    x = rng.randn(n, 3 * (5 + classes), h, w).astype(np.float32)
    cx = rng.rand(n, b) * 0.9 + 0.05
    cy = rng.rand(n, b) * 0.9 + 0.05
    bw = rng.rand(n, b) * 0.5 + 0.05
    bh = rng.rand(n, b) * 0.5 + 0.05
    gt = np.stack([cx, cy, bw, bh], -1).astype(np.float32)
    gt[:, -2:] = 0.0  # padded slots
    gt[0, 1] = gt[0, 0]  # two ground truths on one (anchor, cell)
    gt[1, 2, :2] = gt[1, 0, :2] + 1e-3
    gt[1, 2, 2:] = gt[1, 0, 2:]
    label = rng.randint(0, classes, (n, b)).astype(np.int32)
    score = rng.rand(n, b).astype(np.float32)
    return x, gt, label, score


@pytest.mark.parametrize("mask,smooth,sxy,use_score", [
    ([0, 1, 2], True, 1.0, False), ([3, 4, 5], False, 1.0, True),
    ([0, 2, 4], True, 1.2, True)])
def test_yolo_loss_and_gradient_match_reference(mask, smooth, sxy,
                                                use_score):
    rng = _rng("yolo", tuple(mask), smooth, sxy)
    x, gt, label, score = _yolo_inputs(rng)
    score = score if use_score else None
    args = (ANCHORS, mask, 4, 0.5, 32)

    def ref_fn(a):
        return rops._yolo_loss_raw(a, gt, label, score, *args,
                                   use_label_smooth=smooth, scale_x_y=sxy)

    want, vjp = jax.vjp(jax.jit(ref_fn), jnp.asarray(x))
    cot = rng.rand(*want.shape).astype(np.float32)
    (gx,) = vjp(jnp.asarray(cot))
    tx = _t(x, True)
    got = ops.yolo_loss(tx, _t(gt), torch.from_numpy(label), ANCHORS, mask,
                        4, 0.5, 32,
                        gt_score=None if score is None else _t(score),
                        use_label_smooth=smooth, scale_x_y=sxy)
    assert got.shape == (2,)
    _close(got.detach().numpy(), want, LOOSE)
    got.backward(torch.from_numpy(cot))
    _close(tx.grad.numpy(), gx, LOOSE)


def test_yolo_loss_padded_slots_add_nothing():
    rng = _rng("yolo-pad")
    x, gt, label, _ = _yolo_inputs(rng)
    base = ops.yolo_loss(_t(x), _t(gt), torch.from_numpy(label), ANCHORS,
                         [0, 1, 2], 4, 0.5, 32)
    label2 = label.copy()
    label2[:, -2:] = 3  # a padded slot's label and score are ignored
    more = ops.yolo_loss(_t(x), _t(gt), torch.from_numpy(label2), ANCHORS,
                         [0, 1, 2], 4, 0.5, 32)
    np.testing.assert_array_equal(base.numpy(), more.numpy())


# -- read_file / decode_jpeg --------------------------------------------------

@pytest.mark.parametrize("mode", ["unchanged", "gray", "rgb"])
def test_read_file_and_decode_jpeg(tmp_path, mode):
    from PIL import Image

    rng = _rng("jpeg")
    img = (rng.rand(12, 10, 3) * 255).astype(np.uint8)
    path = str(tmp_path / "x.jpg")
    Image.fromarray(img).save(path, quality=95)
    data = ops.read_file(path)
    assert data.dtype == torch.uint8 and data.device.type == "cpu"
    want = rops.read_file(path)
    np.testing.assert_array_equal(data.numpy(), np.asarray(want.value))
    got = ops.decode_jpeg(data, mode)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(rops.decode_jpeg(want, mode).value))
    assert got.shape[0] == (1 if mode == "gray" else 3)


def test_decode_jpeg_names_pil_when_absent(monkeypatch):
    import builtins

    real = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError("no PIL")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pil)
    from paddle_tpu_torch import UnavailableError

    with pytest.raises(UnavailableError, match="PIL"):
        ops.decode_jpeg(torch.zeros(4, dtype=torch.uint8))
