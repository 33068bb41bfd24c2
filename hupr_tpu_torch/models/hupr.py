"""HuPRNet (counterpart of `hupr_tpu/models/hupr.py`; reference
networks.py:7-41).

Input, as the reference takes it:
  VRDAEmaps_hori, VRDAEmaps_vert: (B, G, C=8, 2, R, A, E) float32
Output:
  heatmap     (B, K, 1, H, W)  sigmoid of the decoder logits
  gcn_heatmap (B, 1, K, H, W)  PRGCN-refined heatmap

The forward is split into `chirp_maps` (per-frame MNet encoding, the
reference's forward_chirp) and `pose_from_maps` (3-D encoders and decoder),
so serving can encode each distinct frame once and window the F-channel
maps. Both keep the JAX package's channels-last layout at their boundary;
inside, the modules run NCDHW / NCHW.

`compute_dtype` (MODEL.computeDtype) is flax's `dtype`:
parameters and BN statistics stay float32, convolutions and projections run
in it. The elevation mean stays float32; the chirp maps come out in the
compute dtype; both heatmaps are float32 at the model's boundary, so the BCE
and its gradient are float32 (hupr_tpu/models/hupr.py:90-95).
"""

from __future__ import annotations

import torch
from torch import nn

from hupr_tpu_torch.models.encoder3d import Encoder3D
from hupr_tpu_torch.models.mnet import MNet
from hupr_tpu_torch.models.mscsa import MSCSADecoder
from hupr_tpu_torch.utils.device import resolve_device


class HuPRNet(nn.Module):
    def __init__(self, num_filters: int = 32, num_frames: int = 8,
                 num_group_frames: int = 8, num_keypoints: int = 14,
                 heatmap_size: int = 64, attn_impl: str = "xla",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        f, dt = num_filters, compute_dtype
        self.num_frames = num_frames
        self.RAchirpNet = MNet(f, dt)
        self.REchirpNet = MNet(f, dt)
        self.RAradarEncoder = Encoder3D(f, num_group_frames, dt)
        self.REradarEncoder = Encoder3D(f, num_group_frames, dt)
        self.radarDecoder = MSCSADecoder(f, num_keypoints, heatmap_size,
                                         attn_impl=attn_impl,
                                         compute_dtype=dt)

    def _chirp_view(self, v):
        """(B, G, C, 2, R, A) -> (B*G, 2, numFrames, R, A): the reference's
        `view`, which reinterprets the contiguous (chirp, real/imag) axes as
        (2 MNet input channels, numFrames)."""
        b, g, c, two, r, a = v.shape
        return v.reshape(b * g, 2, self.num_frames, r, a)

    def chirp_maps(self, vrdae_hori, vrdae_vert):
        """(B, G, C, 2, R, A, E) x2 -> per-frame maps (B, G, R, A, F) x2."""
        b, g = vrdae_hori.shape[:2]
        out = []
        for net, x in ((self.RAchirpNet, vrdae_hori),
                       (self.REchirpNet, vrdae_vert)):
            y = net(self._chirp_view(x.mean(dim=6)))     # (B*G, F, R, A)
            out.append(y.reshape(b, g, *y.shape[1:]).permute(0, 1, 3, 4, 2))
        return tuple(out)

    def pose_from_maps(self, ra, re):
        """(B, G, R, A, F) chirp maps x2 -> (heatmap, gcn_heatmap)."""
        ra_l = self.RAradarEncoder(ra.permute(0, 4, 1, 2, 3))
        re_l = self.REradarEncoder(re.permute(0, 4, 1, 2, 3))
        logits, gcn = self.radarDecoder(*ra_l, *re_l)
        logits, gcn = logits.to(torch.float32), gcn.to(torch.float32)
        return torch.sigmoid(logits)[:, :, None], gcn[:, None]

    def forward(self, vrdae_hori, vrdae_vert):
        return self.pose_from_maps(*self.chirp_maps(vrdae_hori, vrdae_vert))


def build_model(cfg, device=None) -> HuPRNet:
    """HuPRNet from a hupr_tpu_torch.config.Config, in eval mode (the train
    step switches it to train mode for its own call), on the card unless
    `device` says otherwise."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    if cfg.MODEL.computeDtype not in dtypes:
        raise ValueError(f"MODEL.computeDtype {cfg.MODEL.computeDtype!r}: "
                         f"expected one of {sorted(dtypes)}")
    if cfg.MODEL.remat:
        raise NotImplementedError("MODEL.remat is not ported yet")
    model = HuPRNet(
        num_filters=cfg.MODEL.numFilters,
        num_frames=cfg.DATASET.numFrames,
        num_group_frames=cfg.DATASET.numGroupFrames,
        num_keypoints=cfg.DATASET.numKeypoints,
        heatmap_size=cfg.DATASET.heatmapSize,
        attn_impl=cfg.MODEL.attention,
        compute_dtype=dtypes[cfg.MODEL.computeDtype],
    )
    return model.to(resolve_device(device)).eval()
