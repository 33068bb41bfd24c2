"""Multi-scale cross/self attention decoder with the PRGCN head (counterpart
of `hupr_tpu/models/mscsa.py`; reference layers.py:72-184), NCHW.

At each of three scales (H/4, H/2, H), eight bias-free 1x1 projections feed
four spatial attentions (hori-cross, hori-self, vert-cross, vert-self) whose
outputs are concatenated with the upsampled coarser-scale maps into a
two-block decoder stage. The final 1x1 conv emits K keypoint logits, which
the PRGCN refines.

With a bfloat16 compute dtype the projections, the attentions' inputs and
the decoder blocks are bfloat16; the x2 resizes return float32, so the
concatenations at scales 1 and 2 are float32 and the next block casts them
back, and the PRGCN runs in float32 (as the JAX package's type promotion
places them).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F
from torch import nn

from hupr_tpu_torch.models.blocks import BasicBlock, Conv2d, Rescale
from hupr_tpu_torch.models.prgcn import PRGCN
from hupr_tpu_torch.ops.attention import spatial_attention
from hupr_tpu_torch.utils import profiling

PROJECTIONS = ("phi_cross_hori", "theta_cross_hori", "phi_cross_vert",
               "theta_cross_vert", "phi_self_hori", "theta_self_hori",
               "phi_self_vert", "theta_self_vert")

def attention_xla(k, q, m, dtype: torch.dtype = torch.float32):
    """MODEL.attention 'xla' (hupr_tpu/models/mscsa.py:spatial_attention),
    which autograd differentiates: k, q and m are cast to the compute
    `dtype`, the logits and the softmax are float32, the softmax is rounded
    to `dtype`, and the second product accumulates in float32; out comes
    back in m's dtype. In float32 every cast is the identity and this is the
    plain attention. (With bfloat16 the kernels keep the softmax in float32:
    a different function.)"""
    kf, qf, mf = (t.to(dtype).to(torch.float32) for t in (k, q, m))
    a = torch.softmax(torch.einsum("bic,bjc->bij", kf, qf), dim=1)
    out = torch.einsum("bic,bij->bjc", mf, a.to(dtype).to(torch.float32))
    return out.to(m.dtype)


# MODEL.attention -> the (B, N, C) attention it runs: 'pallas' launches the
# forward kernel, and under autograd the backward kernel too; 'pallas_bf16'
# the same kernels with bfloat16 operands; 'xla' the eager path
ATTENTION = ("xla", "pallas", "pallas_bf16")


def attention_impl(name: str, dtype: torch.dtype = torch.float32):
    if name not in ATTENTION:
        raise ValueError(f"unknown MODEL.attention {name!r}; expected one "
                         f"of {ATTENTION}")
    if name == "xla":
        return functools.partial(attention_xla, dtype=dtype)
    return functools.partial(spatial_attention,
                             bf16_ops=name == "pallas_bf16")


class MSCSADecoder(nn.Module):
    def __init__(self, num_filters: int, num_keypoints: int,
                 heatmap_size: int, attn_impl: str = "xla",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = num_filters
        self.compute_dtype = compute_dtype
        self.attention = attention_impl(attn_impl, compute_dtype)
        # ModuleList index = scale: 0 is H/4 at 8F channels, 2 is H at 2F
        for name in PROJECTIONS:
            setattr(self, name, nn.ModuleList(
                nn.Conv2d(c, c, 1, bias=False) for c in (f * 8, f * 4, f * 2)))

        def bb(cin, cout):
            return BasicBlock(cin, cout, ndim=2, batchnorm=False,
                              activation="prelu", compute_dtype=compute_dtype)

        self.decoderLayer3 = nn.Sequential(bb(f * 32, f * 8), bb(f * 8, f * 4),
                                           Rescale(2.0))
        self.decoderLayer2 = nn.Sequential(bb(f * 20, f * 4), bb(f * 4, f * 2),
                                           Rescale(2.0))
        self.decoderLayer1 = nn.Sequential(
            bb(f * 10, f * 2), bb(f * 2, f),
            Conv2d(f, num_keypoints, 1, bias=False,
                   compute_dtype=compute_dtype))
        self.gcn = PRGCN(heatmap_size, num_keypoints)

    def _attend_scale(self, idx, ra, re):
        """Four attentions at one scale -> (ra_cross, ra_self, re_cross,
        re_self), each (B, C, H, W)."""
        b, c, h, w = ra.shape
        # one (B, N, C) copy of each map; the 1x1 projections are matmuls
        # on it that write (B, N, C) directly
        ra_t = ra.reshape(b, c, h * w).transpose(1, 2).contiguous()
        re_t = re.reshape(b, c, h * w).transpose(1, 2).contiguous()

        def proj(name, x):
            w = getattr(self, name)[idx].weight[:, :, 0, 0]
            dt = self.compute_dtype
            return F.linear(x.to(dt), w.to(dt))

        def attend(k, q, m):
            out = self.attention(k, q, m)
            return out.transpose(1, 2).reshape(b, c, h, w)

        ra_cross = attend(proj("phi_cross_hori", ra_t),
                          proj("theta_cross_vert", re_t), ra_t) + ra
        ra_self = attend(proj("phi_self_hori", ra_t),
                         proj("theta_self_hori", ra_t), ra_t)
        re_cross = attend(proj("phi_cross_vert", re_t),
                          proj("theta_cross_hori", ra_t), re_t) + re
        re_self = attend(proj("phi_self_vert", re_t),
                         proj("theta_self_vert", re_t), re_t)
        return ra_cross, ra_self, re_cross, re_self

    def forward(self, ra_l1, ra_l2, ra_l3, re_l1, re_l2, re_l3):
        """Encoder maps at H, H/2, H/4 -> (logits, gcn heatmap), each
        (B, K, H, W)."""
        with profiling.annotate("hupr.decoder"):
            maps = torch.cat(self._attend_scale(0, ra_l3, re_l3), dim=1)
            maps = self.decoderLayer3(maps)
            maps = torch.cat((maps,) + self._attend_scale(1, ra_l2, re_l2),
                             dim=1)
            maps = self.decoderLayer2(maps)
            maps = torch.cat((maps,) + self._attend_scale(2, ra_l1, re_l1),
                             dim=1)
            logits = self.decoderLayer1(maps)
        with profiling.annotate("hupr.prgcn"):
            return logits, self.gcn(logits)
