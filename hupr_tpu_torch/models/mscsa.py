"""Multi-scale cross/self attention decoder with the PRGCN head (counterpart
of `hupr_tpu/models/mscsa.py`; reference layers.py:72-184), NCHW.

At each of three scales (H/4, H/2, H), eight bias-free 1x1 projections feed
four spatial attentions (hori-cross, hori-self, vert-cross, vert-self) whose
outputs are concatenated with the upsampled coarser-scale maps into a
two-block decoder stage. The final 1x1 conv emits K keypoint logits, which
the PRGCN refines.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from hupr_tpu_torch.models.blocks import BasicBlock, Rescale
from hupr_tpu_torch.models.prgcn import PRGCN
from hupr_tpu_torch.ops.attention import attention_fwd, attention_plain

PROJECTIONS = ("phi_cross_hori", "theta_cross_hori", "phi_cross_vert",
               "theta_cross_vert", "phi_self_hori", "theta_self_hori",
               "phi_self_vert", "theta_self_vert")

# MODEL.attention -> the (B, N, C) attention it runs
ATTENTION = {"xla": attention_plain, "pallas": attention_fwd}


def attention_impl(name: str):
    if name == "pallas_bf16":
        raise NotImplementedError(
            "MODEL.attention 'pallas_bf16' is not ported yet")
    if name not in ATTENTION:
        raise ValueError(f"unknown MODEL.attention {name!r}; expected one "
                         f"of {sorted(ATTENTION)}")
    return ATTENTION[name]


class MSCSADecoder(nn.Module):
    def __init__(self, num_filters: int, num_keypoints: int,
                 heatmap_size: int, attn_impl: str = "xla"):
        super().__init__()
        f = num_filters
        self.attention = attention_impl(attn_impl)
        # ModuleList index = scale: 0 is H/4 at 8F channels, 2 is H at 2F
        for name in PROJECTIONS:
            setattr(self, name, nn.ModuleList(
                nn.Conv2d(c, c, 1, bias=False) for c in (f * 8, f * 4, f * 2)))

        def bb(cin, cout):
            return BasicBlock(cin, cout, ndim=2, batchnorm=False,
                              activation="prelu")

        self.decoderLayer3 = nn.Sequential(bb(f * 32, f * 8), bb(f * 8, f * 4),
                                           Rescale(2.0))
        self.decoderLayer2 = nn.Sequential(bb(f * 20, f * 4), bb(f * 4, f * 2),
                                           Rescale(2.0))
        self.decoderLayer1 = nn.Sequential(
            bb(f * 10, f * 2), bb(f * 2, f),
            nn.Conv2d(f, num_keypoints, 1, bias=False))
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
            return F.linear(x, getattr(self, name)[idx].weight[:, :, 0, 0])

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
        maps = torch.cat(self._attend_scale(0, ra_l3, re_l3), dim=1)
        maps = self.decoderLayer3(maps)
        maps = torch.cat((maps,) + self._attend_scale(1, ra_l2, re_l2), dim=1)
        maps = self.decoderLayer2(maps)
        maps = torch.cat((maps,) + self._attend_scale(2, ra_l1, re_l1), dim=1)
        logits = self.decoderLayer1(maps)
        return logits, self.gcn(logits)
