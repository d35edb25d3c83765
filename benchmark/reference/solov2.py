"""Plain float32 SOLOv2 R101-FPN and the mask band, over the state_dict under
'state_dict' of mmdetection's `solov2_r101_fpn_3x_coco_*.pth`.

Published equations (SOLOv2, arXiv:2003.10152; mmdetection's
`solov2_r101_fpn_3x_coco` config and its `SOLOV2Head`, `FPN`,
`mask_matrix_nms`): the test pipeline's keep-ratio resize to the (1333,
800) budget, normalisation by the ImageNet mean and std in [0, 255], zeros
padded at the bottom and right to multiples of 32; a pytorch-style
ResNet-101 (stride on the 3x3, batch norms from their running statistics);
the FPN (1x1 laterals, nearest top-down, 3x3 outputs, a stride-2 subsample
as the fifth level); the mask feature branch (GN-32 3x3 convolutions and x2
bilinear upsamples per level, coordinates on the deepest, a 1x1 GN
prediction); the kernel and class branches on the levels' grids (the first
level resized to the second's size and the last to the one before it,
coordinates on the kernel branch); the sigmoid class scores with the 2x2
point NMS, the score threshold, the dynamic 1x1 kernels over the mask
features, the mask threshold, the area filter by the level's stride, the
maskness rescoring, Gaussian matrix NMS (sigma 2), filter_thr and
max_per_img, the masks upsampled x4, cropped to the resized image and
resized to the frame. Around it the mask band (PRISMA's
`bands/mask_mmdet.py`): the instances of its 11 kept classes over its
confidence 0.5, their 255-white masks summed, and the snowy SDF of the
marked pixels in the green channel.

Departures from the published description, each the port's (the static
shapes of the JAX package): (1) the nms_pre (500) candidates are taken by
class score among the grid's cells and classes over the score threshold,
before the area filter and the maskness rescoring, where mmdetection
takes them after both (a random model passes most of its 3,872 x 80 cells
over the threshold, and mmdetection's order would make a mask for each);
ties go to the lower index. (2) The resize of the test pipeline stays in
float, where mmcv rounds cv2's resize of the uint8 image to uint8. (3) The
two resizes of the kept masks' probabilities are bilinear matrices applied
as products (so that the null and the control round them, as the port's
matmul resize runs in the model's dtype). (4) The SDF is the exact
Euclidean distance within 66 px of a mask edge (the green mapping clamps
beyond 64.25 px), by brute force: the nearest marked pixel of each column
within 66 rows, then the least of g^2 + dx^2 over |dx| <= 66.

Beyond the published description, for the comparison: `instances` also
decides with every continuous score that a decision reads off by a factor
within a tolerance, and gives the masks kept whichever way and those kept
some way (the band a sound program's mask lies in); and `calibrate` sets
the random model's class and kernel biases from a forward over a frame
(the configuration's init).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.common import Ops

IMG_MEAN = (123.675, 116.28, 103.53)
IMG_STD = (58.395, 57.12, 57.375)
BN_EPS = 1e-5
STAGES = (3, 4, 23, 3)  # ResNet-101's bottlenecks a stage
FPN_IN = (256, 512, 1024, 2048)
# the mask band's kept COCO classes (person and the animals) and its cut
CLASS_IDS = (0, 14, 15, 16, 17, 18, 19, 20, 21, 22, 23)
CONFIDENCE = 0.5
SDF_CAP = 66


def param_specs(cfg: dict) -> list:
    """[(name, shape, init)] of the checkpoint's state_dict (no batch-norm
    step counters: the loader fills them), with the port's random-weight
    rule (convolutions normal times fan_in^-0.5, biases zero, group norms
    the identity, batch norms the identity with variance 1 - eps), but for
    cfg['init'] (the port's rule: gains 1, biases 0): the class convolution's
    weight times `cls_gain` and the bias of the group norm before it at
    `cls_feat_bias`; the kernel convolution's weight times `kernel_gain`; the
    mask features' group-norm bias at `feat_bias`. The biases of the class
    and kernel convolutions are zero here and set by `calibrate`."""
    init = cfg.get("init", {})
    specs = []

    def conv(name, cout, cin, k, bias, gain=1.0, bias_value=0.0):
        specs.append((name + ".weight", (cout, cin, k, k),
                      ("normal", gain * (cin * k * k) ** -0.5)))
        if bias:
            specs.append((name + ".bias", (cout,), ("const", bias_value)))

    def norm(name, c, bn, bias=0.0):
        specs.append((name + ".weight", (c,), ("const", 1.0)))
        specs.append((name + ".bias", (c,), ("const", bias)))
        if bn:
            specs.append((name + ".running_mean", (c,), ("const", 0.0)))
            specs.append((name + ".running_var", (c,),
                          ("const", 1.0 - BN_EPS)))

    b = "backbone."
    conv(b + "conv1", 64, 3, 7, False)
    norm(b + "bn1", 64, True)
    cin, width = 64, 64
    for si, n in enumerate(STAGES):
        for bi in range(n):
            p = f"{b}layer{si + 1}.{bi}."
            conv(p + "conv1", width, cin, 1, False)
            norm(p + "bn1", width, True)
            conv(p + "conv2", width, width, 3, False)
            norm(p + "bn2", width, True)
            conv(p + "conv3", 4 * width, width, 1, False)
            norm(p + "bn3", 4 * width, True)
            if bi == 0:
                conv(p + "downsample.0", 4 * width, cin, 1, False)
                norm(p + "downsample.1", 4 * width, True)
            cin = 4 * width
        width *= 2

    C, fc = cfg["in_channels"], cfg["feat_channels"]
    mf, mo = cfg["mask_feat_channels"], cfg["mask_out_channels"]
    for i, c in enumerate(FPN_IN):
        conv(f"neck.lateral_convs.{i}.conv", C, c, 1, True)
        conv(f"neck.fpn_convs.{i}.conv", C, C, 3, True)
    h = "mask_head."
    m = h + "mask_feature_head."
    for i in range(4):
        for j in range(max(i, 1)):
            cin = (C + (2 if i == 3 else 0)) if j == 0 else mf
            conv(f"{m}convs_all_levels.{i}.conv{j}.conv", mf, cin, 3, False)
            norm(f"{m}convs_all_levels.{i}.conv{j}.gn", mf, False)
    conv(m + "conv_pred.conv", mo, mf, 1, False)
    norm(m + "conv_pred.gn", mo, False, init.get("feat_bias", 0.0))
    last = cfg["stacked_convs"] - 1
    for i in range(cfg["stacked_convs"]):
        conv(f"{h}kernel_convs.{i}.conv", fc, C + 2 if i == 0 else fc, 3,
             False)
        norm(f"{h}kernel_convs.{i}.gn", fc, False)
        conv(f"{h}cls_convs.{i}.conv", fc, C if i == 0 else fc, 3, False)
        norm(f"{h}cls_convs.{i}.gn", fc, False,
             init.get("cls_feat_bias", 0.0) if i == last else 0.0)
    conv(h + "conv_kernel", mo, fc, 3, True, init.get("kernel_gain", 1.0))
    conv(h + "conv_cls", cfg["num_classes"], fc, 3, True,
         init.get("cls_gain", 1.0))
    return specs


def test_size(H: int, W: int, scale) -> tuple:
    """mmcv's keep-ratio rescale of an (H, W) image into the (long, short)
    budget: round(dim * factor)."""
    long_edge, short_edge = scale
    f = min(long_edge / max(H, W), short_edge / min(H, W))
    return int(H * f + 0.5), int(W * f + 0.5)


def preprocess(frames_u8: torch.Tensor, scale) -> tuple:
    """uint8 [B, H, W, 3] -> (normalised, padded [B, 3, Hp, Wp], (h, w))."""
    H, W = frames_u8.shape[1:3]
    h, w = test_size(H, W, scale)
    img = F.interpolate(frames_u8.permute(0, 3, 1, 2).float(), size=(h, w),
                        mode="bilinear", align_corners=False)
    mean = torch.tensor(IMG_MEAN, device=img.device)[:, None, None]
    std = torch.tensor(IMG_STD, device=img.device)[:, None, None]
    img = (img - mean) / std
    return F.pad(img, (0, -w % 32, 0, -h % 32)), (h, w)


def _bn(sd, name, x):
    return F.batch_norm(x, sd[name + ".running_mean"],
                        sd[name + ".running_var"], sd[name + ".weight"],
                        sd[name + ".bias"], False, 0.0, BN_EPS)


def resnet(sd: dict, x: torch.Tensor, ops: Ops) -> list:
    """-> C2..C5."""
    b = "backbone."
    x = F.relu(_bn(sd, b + "bn1", ops.conv2d(x, sd[b + "conv1.weight"],
                                             stride=2, padding=3)))
    x = F.max_pool2d(x, 3, stride=2, padding=1)
    outs = []
    for si, n in enumerate(STAGES):
        for bi in range(n):
            p = f"{b}layer{si + 1}.{bi}."
            s = 2 if si > 0 and bi == 0 else 1
            y = F.relu(_bn(sd, p + "bn1",
                           ops.conv2d(x, sd[p + "conv1.weight"])))
            y = F.relu(_bn(sd, p + "bn2", ops.conv2d(
                y, sd[p + "conv2.weight"], stride=s, padding=1)))
            y = _bn(sd, p + "bn3", ops.conv2d(y, sd[p + "conv3.weight"]))
            if bi == 0:
                x = _bn(sd, p + "downsample.1", ops.conv2d(
                    x, sd[p + "downsample.0.weight"], stride=s))
            x = F.relu(x + y)
        outs.append(x)
    return outs


def fpn(sd: dict, feats: list, ops: Ops) -> list:
    """C2..C5 -> P2..P6."""
    lat = [ops.conv2d(f, sd[f"neck.lateral_convs.{i}.conv.weight"],
                      sd[f"neck.lateral_convs.{i}.conv.bias"])
           for i, f in enumerate(feats)]
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + F.interpolate(
            lat[i], size=lat[i - 1].shape[-2:], mode="nearest")
    outs = [ops.conv2d(x, sd[f"neck.fpn_convs.{i}.conv.weight"],
                       sd[f"neck.fpn_convs.{i}.conv.bias"], padding=1)
            for i, x in enumerate(lat)]
    return outs + [F.max_pool2d(outs[-1], 1, stride=2)]


def coords(x: torch.Tensor) -> torch.Tensor:
    """x with mmdetection's coordinate channels (x, then y, in [-1, 1])."""
    B, _, H, W = x.shape
    ys, xs = torch.meshgrid(torch.linspace(-1, 1, H, device=x.device),
                            torch.linspace(-1, 1, W, device=x.device),
                            indexing="ij")
    grid = torch.stack([xs, ys])[None].expand(B, 2, H, W)
    return torch.cat([x, grid], dim=1)


def _conv_gn_relu(sd, name, x, ops, groups, padding=1):
    y = ops.conv2d(x, sd[name + ".conv.weight"], padding=padding)
    return F.relu(F.group_norm(y, groups, sd[name + ".gn.weight"],
                               sd[name + ".gn.bias"], 1e-5))


def _up2(x):
    return F.interpolate(x, scale_factor=2, mode="bilinear",
                         align_corners=False)


def head(sd: dict, feats: list, cfg: dict, ops: Ops) -> tuple:
    """P2..P6 -> (kernel predictions [level][B, Ck, g, g], class logits
    [level][B, 80, g, g], mask features [B, Cm, H/4, W/4])."""
    g = cfg["gn_groups"]
    m = "mask_head.mask_feature_head."
    total = None
    for i in range(4):
        x = coords(feats[i]) if i == 3 else feats[i]
        for j in range(max(i, 1)):
            x = _conv_gn_relu(sd, f"{m}convs_all_levels.{i}.conv{j}", x, ops,
                              g)
            if i > 0:
                x = _up2(x)
        total = x if total is None else total + x
    mask_feats = _conv_gn_relu(sd, m + "conv_pred", total, ops, g, 0)

    feats = list(feats)
    feats[0] = F.interpolate(feats[0], size=feats[1].shape[-2:],
                             mode="bilinear", align_corners=False)
    feats[-1] = F.interpolate(feats[-1], size=feats[-2].shape[-2:],
                              mode="bilinear", align_corners=False)
    h = "mask_head."
    kernels, classes = [], []
    for lvl, x in enumerate(feats):
        n = cfg["num_grids"][lvl]
        kern = F.interpolate(coords(x), size=(n, n), mode="bilinear",
                             align_corners=False)
        cate = kern[:, :-2]
        for i in range(cfg["stacked_convs"]):
            kern = _conv_gn_relu(sd, f"{h}kernel_convs.{i}", kern, ops, g)
            cate = _conv_gn_relu(sd, f"{h}cls_convs.{i}", cate, ops, g)
        kernels.append(ops.conv2d(kern, sd[h + "conv_kernel.weight"],
                                  sd[h + "conv_kernel.bias"], padding=1))
        classes.append(ops.conv2d(cate, sd[h + "conv_cls.weight"],
                                  sd[h + "conv_cls.bias"], padding=1))
    return kernels, classes, mask_feats


def bilinear_matrix(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_out, n_in]: bilinear interpolation with half-pixel centres and
    clamped edges (F.interpolate's align_corners=False, no antialiasing)."""
    x = ((torch.arange(n_out, dtype=torch.float64) + 0.5) * (n_in / n_out)
         - 0.5).clamp(min=0.0)
    i0 = x.floor().long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    t = x - i0
    m = torch.zeros(n_out, n_in, dtype=torch.float64)
    m[torch.arange(n_out), i0] += 1 - t
    m[torch.arange(n_out), i1] += t
    return m.float().to(device)


def _resize(x: torch.Tensor, hw, ops: Ops) -> torch.Tensor:
    mh = bilinear_matrix(x.shape[-2], hw[0], x.device)
    mw = bilinear_matrix(x.shape[-1], hw[1], x.device)
    return ops.matmul(ops.matmul(mh, x), mw.T)


def calibrate(sd: dict, frame_u8: torch.Tensor, cfg: dict) -> dict:
    """The biases of the class and kernel convolutions set from the random
    model's forward over a calibration frame (data-dependent
    initialisation): each of the band's classes (CLASS_IDS) so that
    `instances_per_class` of its point-NMS maxima score over 0.5, every
    other class at `dropped_class_bias`; one kernel bias for all channels
    so that the `mask_quantile` of those maxima's masks covers `mask_share`
    of the mask features' pixels. sd: SOLOv2's state_dict, changed in
    place and returned; frame_u8 [1, H, W, 3]; cfg['init']['calibration']
    holds the numbers."""
    cal = cfg["init"]["calibration"]
    w = {k: v.float() for k, v in sd.items()}
    h = "mask_head."
    w[h + "conv_cls.bias"] = torch.zeros_like(w[h + "conv_cls.bias"])
    w[h + "conv_kernel.bias"] = torch.zeros_like(w[h + "conv_kernel.bias"])
    with torch.no_grad():
        img, _ = preprocess(frame_u8, cfg["scale"])
        kernels, classes, mask_feats = head(w, fpn(w, resnet(w, img, Ops()),
                                                   Ops()), cfg, Ops())
        logit, nbr = _scores(classes, fn=lambda x: x)
        local = (logit >= nbr).view(-1, cfg["num_classes"])
        logit = logit.view(-1, cfg["num_classes"])
        n = cal["instances_per_class"]
        bias = torch.full((cfg["num_classes"],), cal["dropped_class_bias"],
                          device=logit.device)
        cells = torch.zeros(len(logit), dtype=torch.bool,
                            device=logit.device)
        for c in CLASS_IDS:
            top = torch.sort(logit[local[:, c], c], descending=True).values
            bias[c] = -0.5 * (top[n - 1] + top[n])
            cells |= local[:, c] & (logit[:, c] + bias[c] > 0)
        kern = torch.cat([k[0].permute(1, 2, 0).reshape(-1, k.shape[1])
                          for k in kernels])[cells]
        feats = mask_feats[0].flatten(1)
        logits, total = kern @ feats, feats.sum(dim=0)
        lo, hi = -100.0, 100.0
        for _ in range(60):
            mid = 0.5 * (lo + hi)
            share = torch.quantile(((logits + mid * total) > 0).float()
                                   .mean(dim=1), cal["mask_quantile"])
            lo, hi = (lo, mid) if share > cal["mask_share"] else (mid, hi)
    for name, value in ((h + "conv_cls.bias", bias),
                        (h + "conv_kernel.bias",
                         torch.full_like(w[h + "conv_kernel.bias"], mid))):
        sd[name] = value.to(sd[name].dtype)
    return sd


def _scores(classes, fn=torch.sigmoid) -> tuple:
    """Class scores fn(logits), flat point-major then class, and for each
    the largest of its three up-left neighbours in the 2x2 point NMS's
    window (-inf off the grid): a score is a local maximum where it is not
    below them."""
    scores, nbrs = [], []
    for c in classes:
        s = fn(c[0])
        p = F.pad(s, (1, 0, 1, 0), value=-math.inf)
        nbr = torch.maximum(torch.maximum(p[:, :-1, 1:], p[:, 1:, :-1]),
                            p[:, :-1, :-1])
        scores.append(s.permute(1, 2, 0).reshape(-1))
        nbrs.append(nbr.permute(1, 2, 0).reshape(-1))
    return torch.cat(scores), torch.cat(nbrs)


def _decay_bounds(iou, same, pre, sure_ok, maybe_ok, tol, sigma):
    """Matrix NMS's decay coefficients [lo, hi] of each candidate where every
    pre-NMS score may be off by a factor in [1 - tol, 1 + tol], so that the
    order of two candidates within that of each other is open, and where a
    candidate in maybe_ok and not in sure_ok may be on the list or off it.
    lo takes every candidate that may rank above, each with the least
    compensation it may have; hi only those sure to rank above and to be
    on the list, with the most."""
    up, down = pre * (1 + tol), pre * (1 - tol)
    sure_above = (down[:, None] > up[None, :]) & same
    maybe_above = (up[:, None] >= down[None, :]) & same
    maybe_above.fill_diagonal_(False)
    sure_src = sure_above & sure_ok[:, None]
    maybe_src = maybe_above & maybe_ok[:, None]
    comp_lo = torch.where(sure_src, iou, 0.0).amax(dim=0)
    comp_hi = torch.where(maybe_src, iou, 0.0).amax(dim=0)
    lo = torch.exp(-sigma * (iou ** 2 - comp_lo[:, None] ** 2))
    hi = torch.exp(-sigma * (iou ** 2 - comp_hi[:, None] ** 2))
    lo = torch.where(maybe_src, lo, 1.0).amin(dim=0).clamp(max=1.0)
    hi = torch.where(sure_src, hi, 1.0).amin(dim=0).clamp(max=1.0)
    return lo, hi


def instances(kernels, classes, mask_feats, img_hw, ori_hw, cfg: dict,
              ops: Ops, tol: float = 0.0) -> dict:
    """One frame's head outputs (batch of one) -> the band's instances
    (classes CLASS_IDS, final score over CONFIDENCE): 'kept' [H, W] bool,
    the union of their masks; and with a tolerance `tol`, the same decided
    with every continuous score that a decision reads (class scores against
    their point-NMS neighbours, the score threshold and the nms_pre-th
    score; mask areas against the level's stride; pre-NMS scores against
    each other; final scores against the confidence and the max_per_img-th)
    off by a factor in [1 - tol, 1 + tol]: 'sure' [H, W], the union of the
    instances kept whichever way, and 'maybe' [H, W], of those kept some
    way. 'n_kept' and 'n_sure' count the instances.

    Only candidates whose class score may reach the confidence after the
    maskness and the decay (at least 0.5 (1 - tol) / (1 + tol)^2) are
    followed, at most the 2 nms_pre of highest score: a candidate of lower
    score ranks below every kept one and neither decays it nor takes its
    place among the max_per_img."""
    nc = cfg["num_classes"]
    dev = mask_feats.device
    s, nbr = _scores(classes)
    thr, conf = cfg["score_thr"], CONFIDENCE
    up, down = 1.0 + tol, 1.0 - tol
    present = (s >= nbr) & (s > thr)
    ranked = torch.sort(torch.where(present, s, 0.0), descending=True,
                        stable=True)
    rank = torch.empty_like(ranked.indices)
    rank[ranked.indices] = torch.arange(len(rank), device=dev)
    s_pre = ranked.values[cfg["nms_pre"] - 1] \
        if len(s) >= cfg["nms_pre"] else torch.zeros((), device=dev)
    s_min = conf * down / up ** 2
    cand = torch.nonzero((s * up >= s_min) & (s >= nbr * down)
                         & (s > thr * down)
                         & (s * up >= s_pre * down))[:, 0]
    cand = cand[torch.sort(s[cand], descending=True,
                           stable=True).indices[:2 * cfg["nms_pre"]]]
    empty = torch.zeros(ori_hw, dtype=torch.bool, device=dev)
    if not len(cand):
        return {"kept": empty, "sure": empty, "maybe": empty,
                "n_kept": 0, "n_sure": 0}
    s, nbr = s[cand], nbr[cand]
    point, labels = cand // nc, cand % nc
    kern = torch.cat([k[0].permute(1, 2, 0).reshape(-1, k.shape[1])
                      for k in kernels])
    strides = torch.cat([torch.full((n * n,), float(st), device=dev)
                         for n, st in zip(cfg["num_grids"], cfg["strides"])])
    stride = strides[point]
    Cm, Hm, Wm = mask_feats.shape[1:]
    probs = torch.sigmoid(ops.matmul(kern[point], mask_feats[0].reshape(
        Cm, Hm * Wm))).reshape(-1, Hm, Wm)
    masks = probs > cfg["mask_thr"]
    areas = masks.sum(dim=(1, 2)).float()
    pre = s * (probs * masks).sum(dim=(1, 2)) / areas.clamp(min=1.0)
    exact_ok = present[cand] & (rank[cand] < cfg["nms_pre"]) \
        & (areas > stride)
    sure_ok = (s > nbr * up) & (s > thr * up) & (s * down > s_pre * up) \
        & (areas * down > stride)
    maybe_ok = areas * up > stride
    flat = masks.flatten(1).float()
    inter = flat @ flat.T
    iou = inter / (areas[:, None] + areas[None, :] - inter).clamp(min=1.0)
    same = labels[:, None] == labels[None, :]

    # exact: mmdetection's matrix NMS over the list in pre-NMS order
    order = torch.sort(torch.where(exact_ok, pre, -1.0), descending=True,
                       stable=True).indices
    pos = torch.empty_like(order)
    pos[order] = torch.arange(len(order), device=dev)
    above = (pos[:, None] < pos[None, :]) & same & exact_ok[:, None] \
        & exact_ok[None, :]
    comp = torch.where(above, iou, 0.0).amax(dim=0)
    decay = torch.exp(-cfg["sigma"] * (iou ** 2 - comp[:, None] ** 2))
    final = pre * torch.where(above, decay, 1.0).amin(dim=0).clamp(max=1.0)
    final = torch.where(exact_ok, final, 0.0)
    lo, hi = _decay_bounds(iou, same, pre, sure_ok, maybe_ok, tol,
                           cfg["sigma"])
    lo, hi = pre * down * lo, pre * up * hi
    lo, hi = torch.where(sure_ok, lo, 0.0), torch.where(maybe_ok, hi, 0.0)

    band = (labels[:, None] == torch.tensor(CLASS_IDS, device=dev)).any(1)
    top = cfg["max_per_img"]
    kept = band & (final > conf) & \
        ((final[None, :] > final[:, None]).sum(dim=1) < top)
    sure = band & (lo > conf) & ((hi[None, :] >= lo[:, None]).sum(dim=1)
                                 <= top)
    maybe = band & (hi > conf) & ((lo[None, :] > hi[:, None]).sum(dim=1)
                                  < top)
    Hs, Ws = Hm * cfg["mask_stride"], Wm * cfg["mask_stride"]

    def union(sel):
        if not sel.any():
            return empty
        up_ = _resize(probs[sel], (Hs, Ws), ops)
        up_ = _resize(up_[:, :img_hw[0], :img_hw[1]], ori_hw, ops)
        return (up_ > cfg["mask_thr"]).any(dim=0)

    return {"kept": union(kept), "sure": union(sure), "maybe": union(maybe),
            "n_kept": int(kept.sum()), "n_sure": int(sure.sum())}


def _column_distance(seed: torch.Tensor) -> torch.Tensor:
    """[..., H, W] bool -> each pixel's distance to the nearest seed of its
    column within SDF_CAP rows (SDF_CAP where none)."""
    cap = float(SDF_CAP)
    H = seed.shape[-2]
    d = torch.where(seed, 0.0, cap)
    for dy in range(1, min(SDF_CAP, H - 1) + 1):
        d[..., dy:, :] = torch.minimum(d[..., dy:, :],
                                       torch.where(seed[..., :-dy, :],
                                                   float(dy), cap))
        d[..., :-dy, :] = torch.minimum(d[..., :-dy, :],
                                        torch.where(seed[..., dy:, :],
                                                    float(dy), cap))
    return d


def _distance(seed: torch.Tensor) -> torch.Tensor:
    """Euclidean distance to the nearest seed, exact up to SDF_CAP."""
    g2 = _column_distance(seed) ** 2
    W = seed.shape[-1]
    d2 = g2.clone()
    for dx in range(1, min(SDF_CAP, W - 1) + 1):
        d2[..., dx:] = torch.minimum(d2[..., dx:], g2[..., :-dx] + dx * dx)
        d2[..., :-dx] = torch.minimum(d2[..., :-dx], g2[..., dx:] + dx * dx)
    return torch.sqrt(d2)


def sdf_green(marked: torch.Tensor) -> torch.Tensor:
    """snowy's signed distance (positive outside the marked pixels,
    negative inside) mapped as the band's green channel: 1 - clip(((sdf +
    127) / 255 - 0.25) * 2, 0, 1)."""
    sdf = _distance(marked) - _distance(~marked)
    return 1.0 - (((sdf + 127.0) / 255.0 - 0.25) * 2.0).clamp(0.0, 1.0)


def band_outputs(sd: dict, frames_u8: torch.Tensor, cfg: dict,
                 ops: Ops = Ops(), batch: int = 8, tol: float = 0.0) -> dict:
    """What the mask step returns with the SDF: 'composite' [B, H, W] (255
    where a kept instance marks: the step sums their 255-white masks, and
    only composite != 0 is compared) and 'green' [B, H, W]; with the
    tolerance `tol` of `instances`, 'sure' and 'maybe' [B, H, W] bool and
    their SDF greens 'green_sure' and 'green_maybe' (a mask between the two
    has its green between theirs); and 'kept' and 'sure_kept' [B], the
    instances a frame, for the record."""
    H, W = frames_u8.shape[1:3]
    frames = []
    for i in range(0, frames_u8.shape[0], batch):
        img, img_hw = preprocess(frames_u8[i:i + batch], cfg["scale"])
        kernels, classes, mask_feats = head(sd, fpn(sd, resnet(sd, img, ops),
                                                    ops), cfg, ops)
        frames += [instances([k[b:b + 1] for k in kernels],
                             [c[b:b + 1] for c in classes],
                             mask_feats[b:b + 1], img_hw, (H, W), cfg, ops,
                             tol) for b in range(img.shape[0])]

    def stack(key):
        return torch.stack([f[key] for f in frames])

    kept, sure, maybe = stack("kept"), stack("sure"), stack("maybe")
    return {"composite": kept.float() * 255.0, "green": sdf_green(kept),
            "sure": sure, "maybe": maybe, "green_sure": sdf_green(sure),
            "green_maybe": sdf_green(maybe),
            "kept": torch.tensor([float(f["n_kept"]) for f in frames]),
            "sure_kept": torch.tensor([float(f["n_sure"]) for f in frames])}


def flops_graph(sd: dict, image: torch.Tensor, cfg: dict, ops: Ops = Ops()):
    """The network and one frame's dynamic-mask product on image [1, 3, Hp,
    Wp] (meta tensors welcome): the products a frame needs, for counting.
    The nms_pre candidates are taken as all valid."""
    kernels, classes, mask_feats = head(sd, fpn(sd, resnet(sd, image, ops),
                                                ops), cfg, ops)
    Cm, Hm, Wm = mask_feats.shape[1:]
    k = kernels[0].new_empty(cfg["nms_pre"], Cm)
    return ops.matmul(k, mask_feats[0].reshape(Cm, Hm * Wm))
