"""HuPRNet (HuPR's networks.py) as plain functions of a state dict.

The names of the state dict are HuPR's own module paths. The shapes, the
order of the layers and the places where a bfloat16 recipe rounds follow
the published model and the repository's recipes:

  MNet        Conv3d (2, 1, 1) stride (2, 1, 1) over the chirps, then max
  Encoder3D   three stages of 3x3x3 residual blocks with BatchNorm, halved
              by trilinear align-corners resizes, each squeezed over the
              frame axis by a (T, 1, 1) conv
  MSCSA       at three scales, four attentions (cross and self, per view)
              softmax(k q^T) over the keys, no scale, each fed by bias-free
              1x1 projections; residual PReLU decoder blocks, x2 resizes
  PRGCN       x0.5 bilinear, three GCN layers W (x A) + b over the 14-joint
              skeleton, x2 bilinear, sigmoid

Every function takes `P`, a dict of tensors keyed by those names, and a
`Precision`, which says how products round their operands. Resizes, the
elevation mean, BatchNorm's arithmetic, the softmax and the PRGCN are
float32 in every recipe.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from gpubench.reference.precision import Precision

PROJECTIONS = ("phi_cross_hori", "theta_cross_hori", "phi_cross_vert",
               "theta_cross_vert", "phi_self_hori", "theta_self_hori",
               "phi_self_vert", "theta_self_vert")
BN_EPS = 1e-5

# self-loops and the kinematic edges of HuPR's joint order; the shoulder
# rows mark the neck column, the neck row marks no shoulder
_EDGES = [(0, 1), (1, 2), (3, 4), (4, 5), (0, 3), (6, 7), (8, 9), (9, 10),
          (11, 12), (12, 13)]
_DIRECTED = [(8, 6), (11, 6)]


def skeleton(device=None) -> torch.Tensor:
    a = torch.eye(14, dtype=torch.float32)
    for i, j in _EDGES:
        a[i, j] = a[j, i] = 1.0
    for i, j in _DIRECTED:
        a[i, j] = 1.0
    return a.to(device)


# ---------------------------------------------------------------- shapes

def _bn_spec(name, c):
    return {f"{name}.weight": (c,), f"{name}.bias": (c,),
            f"{name}.running_mean": (c,), f"{name}.running_var": (c,),
            f"{name}.num_batches_tracked": ()}


def _block_spec(prefix, cin, cout, k, batchnorm):
    conv_in, conv_out = (cout, cin) + (3,) * k, (cout, cout) + (3,) * k
    if not batchnorm:
        return {f"{prefix}.main.0.weight": conv_in,
                f"{prefix}.main.1.weight": (1,),
                f"{prefix}.main.2.weight": conv_out,
                f"{prefix}.downsample.0.weight": conv_in,
                f"{prefix}.relu.weight": (1,)}
    return {f"{prefix}.main.0.weight": conv_in,
            **_bn_spec(f"{prefix}.main.1", cout),
            f"{prefix}.main.3.weight": conv_out,
            **_bn_spec(f"{prefix}.main.4", cout),
            f"{prefix}.downsample.0.weight": conv_in,
            **_bn_spec(f"{prefix}.downsample.1", cout)}


def state_shapes(num_filters: int = 32, group: int = 8,
                 num_keypoints: int = 14, heatmap: int = 64) -> dict:
    """{name: shape} of every entry of HuPRNet's state dict, in order
    (num_batches_tracked entries have shape () and are integers)."""
    f, spec = num_filters, {}
    for view in ("RA", "RE"):
        spec[f"{view}chirpNet.temporalConvWx1x1.weight"] = (f, 2, 2, 1, 1)
        spec[f"{view}chirpNet.temporalConvWx1x1.bias"] = (f,)
    for view in ("RA", "RE"):
        e = f"{view}radarEncoder"
        spec[f"{e}.layer1.0.weight"] = (2 * f, f, 3, 3, 3)
        spec[f"{e}.layer1.0.bias"] = (2 * f,)
        spec.update(_block_spec(f"{e}.layer1.1", 2 * f, 2 * f, 3, True))
        spec.update(_block_spec(f"{e}.layer2.1", 2 * f, 4 * f, 3, True))
        spec.update(_block_spec(f"{e}.layer2.2", 4 * f, 4 * f, 3, True))
        spec.update(_block_spec(f"{e}.layer3.1", 4 * f, 8 * f, 3, True))
        spec.update(_block_spec(f"{e}.layer3.2", 8 * f, 8 * f, 3, True))
        spec[f"{e}.l1temporalMerge.weight"] = (2 * f, 2 * f, group, 1, 1)
        spec[f"{e}.l2temporalMerge.weight"] = (4 * f, 4 * f, group // 2, 1, 1)
        spec[f"{e}.temporalMerge.weight"] = (8 * f, 8 * f, group // 4, 1, 1)
    d = "radarDecoder"
    for name in PROJECTIONS:
        for i, c in enumerate((8 * f, 4 * f, 2 * f)):
            spec[f"{d}.{name}.{i}.weight"] = (c, c, 1, 1)
    for layer, chans in (("decoderLayer3", ((32 * f, 8 * f), (8 * f, 4 * f))),
                         ("decoderLayer2", ((20 * f, 4 * f), (4 * f, 2 * f))),
                         ("decoderLayer1", ((10 * f, 2 * f), (2 * f, f)))):
        for i, (cin, cout) in enumerate(chans):
            spec.update(_block_spec(f"{d}.{layer}.{i}", cin, cout, 2, False))
    spec[f"{d}.decoderLayer1.2.weight"] = (num_keypoints, f, 1, 1)
    nodes = (heatmap // 2) ** 2
    for layer in ("L1", "L2", "L3"):
        spec[f"{d}.gcn.{layer}.weight"] = (nodes, nodes)
        spec[f"{d}.gcn.{layer}.bias"] = (nodes, num_keypoints)
    return spec


def is_parameter(name: str) -> bool:
    """A trained leaf, not a BatchNorm statistic."""
    return not name.endswith(("running_mean", "running_var",
                              "num_batches_tracked"))


# ---------------------------------------------------------------- layers

def conv(x, w, prec: Precision, bias=None, stride=1, padding=0):
    fn = F.conv3d if w.dim() == 5 else F.conv2d
    return fn(prec.operand(x), prec.operand(w),
              None if bias is None else prec.operand(bias), stride, padding)


def batch_norm(x, P, name, train: bool):
    """BatchNorm in float32 on x's values, returned in x's dtype: in train
    mode over the batch (biased variance), else on the running
    statistics."""
    xf = x.to(torch.float32)
    if train:
        axes = [0] + list(range(2, x.dim()))
        mean = xf.mean(axes)
        var = xf.var(axes, unbiased=False)
    else:
        mean, var = P[f"{name}.running_mean"], P[f"{name}.running_var"]
    shape = (1, -1) + (1,) * (x.dim() - 2)
    y = (xf - mean.reshape(shape)) * torch.rsqrt(var.reshape(shape) + BN_EPS)
    y = y * P[f"{name}.weight"].reshape(shape) \
        + P[f"{name}.bias"].reshape(shape)
    return y.to(x.dtype)


def prelu(x, slope):
    s = slope.to(x.dtype)
    return torch.where(x >= 0, x, s * x)


def resize(x, factor: float):
    """Align-corners linear resize of every spatial axis by `factor`, in
    float32 (output size floor(in * factor))."""
    x = x.to(torch.float32)
    size = [int(math.floor(s * factor)) for s in x.shape[2:]]
    mode = {3: "linear", 4: "bilinear", 5: "trilinear"}[x.dim()]
    return F.interpolate(x, size=size, mode=mode, align_corners=True)


def encoder_block(x, P, name, prec, train):
    def c(n, t):
        return conv(t, P[f"{name}.{n}.weight"], prec, padding=1)

    main = torch.relu(batch_norm(c("main.0", x), P, f"{name}.main.1", train))
    main = batch_norm(c("main.3", main), P, f"{name}.main.4", train)
    down = batch_norm(c("downsample.0", x), P, f"{name}.downsample.1", train)
    return torch.relu(main + down)


def decoder_block(x, P, name, prec):
    def c(n, t):
        return conv(t, P[f"{name}.{n}.weight"], prec, padding=1)

    main = c("main.2", prelu(c("main.0", x), P[f"{name}.main.1.weight"]))
    return prelu(main + c("downsample.0", x), P[f"{name}.relu.weight"])


# ---------------------------------------------------------------- model

def chirp_maps(P, hori, vert, prec: Precision, num_frames: int = 8):
    """Normalized inputs (B, G, C, 2, R, A, E) per view -> per-frame maps
    (B, G, R, A, F) per view, in the compute dtype."""
    out = []
    for view, x in (("RA", hori), ("RE", vert)):
        b, g, c, two, r, a, _ = x.shape
        v = x.mean(dim=6).reshape(b * g, 2, num_frames, r, a)
        name = f"{view}chirpNet.temporalConvWx1x1"
        y = conv(v, P[f"{name}.weight"], prec, P[f"{name}.bias"],
                 stride=(2, 1, 1)).amax(dim=2)
        out.append(y.reshape(b, g, *y.shape[1:]).permute(0, 1, 3, 4, 2))
    return tuple(out)


def encoder(x, P, view, prec, train):
    """(B, F, G, H, W) -> maps at H, H/2, H/4."""
    e = f"{view}radarEncoder"
    l1 = conv(x, P[f"{e}.layer1.0.weight"], prec, P[f"{e}.layer1.0.bias"],
              padding=1)
    l1 = encoder_block(l1, P, f"{e}.layer1.1", prec, train)
    l2 = resize(l1, 0.5)
    l2 = encoder_block(l2, P, f"{e}.layer2.1", prec, train)
    l2 = encoder_block(l2, P, f"{e}.layer2.2", prec, train)
    l3 = resize(l2, 0.5)
    l3 = encoder_block(l3, P, f"{e}.layer3.1", prec, train)
    l3 = encoder_block(l3, P, f"{e}.layer3.2", prec, train)
    return tuple(conv(t, P[f"{e}.{m}.weight"], prec)[:, :, 0]
                 for t, m in ((l1, "l1temporalMerge"),
                              (l2, "l2temporalMerge"),
                              (l3, "temporalMerge")))


def attention(k, q, m, prec: Precision):
    """(B, N, C): out[b, j] = sum_i m[b, i] softmax_i(k[b, i] . q[b, j]),
    the logits and the softmax float32, out in m's dtype."""
    kf, qf, mf = (prec.operand(t).to(torch.float32) for t in (k, q, m))
    a = torch.softmax(torch.einsum("bic,bjc->bij", kf, qf), dim=1)
    return torch.einsum("bic,bij->bjc", mf, prec.soft_operand(a)).to(m.dtype)


def attend_scale(P, idx, ra, re, prec):
    b, c, h, w = ra.shape
    ra_t = ra.reshape(b, c, h * w).transpose(1, 2)
    re_t = re.reshape(b, c, h * w).transpose(1, 2)

    def proj(name, x):
        wt = P[f"radarDecoder.{name}.{idx}.weight"][:, :, 0, 0]
        return F.linear(prec.operand(x), prec.operand(wt))

    def attend(kk, qq, mm):
        return attention(kk, qq, mm, prec).transpose(1, 2).reshape(
            b, c, h, w)

    ra_cross = attend(proj("phi_cross_hori", ra_t),
                      proj("theta_cross_vert", re_t), ra_t) + ra
    ra_self = attend(proj("phi_self_hori", ra_t),
                     proj("theta_self_hori", ra_t), ra_t)
    re_cross = attend(proj("phi_cross_vert", re_t),
                      proj("theta_cross_hori", ra_t), re_t) + re
    re_self = attend(proj("phi_self_vert", re_t),
                     proj("theta_self_vert", re_t), re_t)
    return ra_cross, ra_self, re_cross, re_self


def prgcn(P, logits, prec):
    x = resize(logits, 0.5)
    b, k, h, w = x.shape
    x = x.reshape(b, k, h * w).transpose(1, 2)              # (B, P, K)
    adj = prec.f32_operand(skeleton(x.device))
    for i, layer in enumerate(("L1", "L2", "L3")):
        wt = P[f"radarDecoder.gcn.{layer}.weight"]
        xa = torch.matmul(prec.f32_operand(x), adj)
        x = torch.matmul(prec.f32_operand(wt), prec.f32_operand(xa)) \
            + P[f"radarDecoder.gcn.{layer}.bias"]
        if i < 2:
            x = torch.relu(x)
    x = x.transpose(1, 2).reshape(b, k, h, w)
    return torch.sigmoid(resize(x, 2.0))


def decoder(P, ra_maps, re_maps, prec):
    d = "radarDecoder"
    maps = torch.cat(attend_scale(P, 0, ra_maps[2], re_maps[2], prec), dim=1)
    maps = decoder_block(maps, P, f"{d}.decoderLayer3.0", prec)
    maps = resize(decoder_block(maps, P, f"{d}.decoderLayer3.1", prec), 2.0)
    maps = torch.cat((maps,) + attend_scale(P, 1, ra_maps[1], re_maps[1],
                                            prec), dim=1)
    maps = decoder_block(maps, P, f"{d}.decoderLayer2.0", prec)
    maps = resize(decoder_block(maps, P, f"{d}.decoderLayer2.1", prec), 2.0)
    maps = torch.cat((maps,) + attend_scale(P, 2, ra_maps[0], re_maps[0],
                                            prec), dim=1)
    maps = decoder_block(maps, P, f"{d}.decoderLayer1.0", prec)
    maps = decoder_block(maps, P, f"{d}.decoderLayer1.1", prec)
    logits = conv(maps, P[f"{d}.decoderLayer1.2.weight"], prec)
    return logits.to(torch.float32), prgcn(P, logits, prec)


def pose_from_maps(P, ra, re, prec: Precision, train: bool = False):
    """Windows of per-frame maps (B, G, R, A, F) per view -> (heatmap
    (B, K, H, W), refined heatmap (B, K, H, W)), float32."""
    ra_maps = encoder(ra.permute(0, 4, 1, 2, 3), P, "RA", prec, train)
    re_maps = encoder(re.permute(0, 4, 1, 2, 3), P, "RE", prec, train)
    logits, gcn = decoder(P, ra_maps, re_maps, prec)
    return torch.sigmoid(logits), gcn


def forward(P, hori, vert, prec: Precision, train: bool = False,
            num_frames: int = 8):
    """Normalized windows (B, G, C, 2, R, A, E) per view -> (heatmap,
    refined heatmap), each (B, K, H, W)."""
    ra, re = chirp_maps(P, hori, vert, prec, num_frames)
    return pose_from_maps(P, ra, re, prec, train)


def max_preds(heatmaps: torch.Tensor):
    """(B, K, H, W) -> (xy of the first maximum (B, K, 2), maxvals
    (B, K, 1)); coordinates are zeroed where the peak is <= 0."""
    b, k, h, w = heatmaps.shape
    flat = heatmaps.reshape(b, k, h * w)
    idx = flat.argmax(dim=2)
    maxvals = flat.amax(dim=2)[..., None]
    preds = torch.stack([(idx % w).to(torch.float32),
                         (idx // w).to(torch.float32)], dim=-1)
    return preds * (maxvals > 0).to(torch.float32), maxvals
