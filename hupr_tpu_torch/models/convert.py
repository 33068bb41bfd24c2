"""JAX HuPRNet variables -> the port's state_dict.

`state_dict_from_jax` is the exact inverse of the JAX package's
`convert_state_dict` (hupr_tpu/models/torch_convert.py): it takes the
{'params', 'batch_stats'} tree as numpy arrays and returns the reference's
state_dict keys, which are the port's.

  flax conv kernel (*k, I, O)        ->  ConvNd weight (O, I, *k)
  flax {scale, bias} + {mean, var}   ->  BatchNormNd weight, bias,
                                         running_mean, running_var
  PReLU negative_slope (1,)          ->  PReLU weight (1,)
  GCN weight (P, P) / bias (P, K)    ->  unchanged
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BLOCKS_3D = (("layer1_block", "layer1.1"),
              ("layer2_block1", "layer2.1"), ("layer2_block2", "layer2.2"),
              ("layer3_block1", "layer3.1"), ("layer3_block2", "layer3.2"))
_BLOCKS_2D = (("decoder3_block1", "decoderLayer3.0"),
              ("decoder3_block2", "decoderLayer3.1"),
              ("decoder2_block1", "decoderLayer2.0"),
              ("decoder2_block2", "decoderLayer2.1"),
              ("decoder1_block1", "decoderLayer1.0"),
              ("decoder1_block2", "decoderLayer1.1"))
_PROJECTIONS = ("phi_cross_hori", "theta_cross_hori", "phi_cross_vert",
                "theta_cross_vert", "phi_self_hori", "theta_self_hori",
                "phi_self_vert", "theta_self_vert")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _conv(sd: Dict, key: str, p: Dict) -> None:
    k = np.asarray(p["kernel"])
    nd = k.ndim
    sd[f"{key}.weight"] = _t(np.transpose(k, (nd - 1, nd - 2)
                                          + tuple(range(nd - 2))))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(sd: Dict, key: str, p: Dict, s: Dict) -> None:
    sd[f"{key}.weight"] = _t(p["scale"])
    sd[f"{key}.bias"] = _t(p["bias"])
    sd[f"{key}.running_mean"] = _t(s["mean"])
    sd[f"{key}.running_var"] = _t(s["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _prelu(sd: Dict, key: str, p: Dict) -> None:
    sd[f"{key}.weight"] = _t(p["negative_slope"]).reshape(1)


def _basic_block(sd: Dict, prefix: str, p: Dict, s: Dict) -> None:
    """With BN: main=[conv,bn,act,conv,bn], downsample=[conv,bn]; without:
    main=[conv,prelu,conv], downsample=[conv], relu=prelu."""
    _conv(sd, f"{prefix}.main.0", p["conv1"])
    _conv(sd, f"{prefix}.downsample.0", p["downsample"])
    if "bn1" in p:
        _bn(sd, f"{prefix}.main.1", p["bn1"], s["bn1"])
        _conv(sd, f"{prefix}.main.3", p["conv2"])
        _bn(sd, f"{prefix}.main.4", p["bn2"], s["bn2"])
        _bn(sd, f"{prefix}.downsample.1", p["bn_down"], s["bn_down"])
    else:
        _prelu(sd, f"{prefix}.main.1", p["act1"])
        _conv(sd, f"{prefix}.main.2", p["conv2"])
        _prelu(sd, f"{prefix}.relu", p["act_out"])


def state_dict_from_jax(variables) -> Dict[str, torch.Tensor]:
    """{'params': ..., 'batch_stats': ...} of hupr_tpu's HuPRNet (numpy or
    array leaves) -> the port's HuPRNet state_dict."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: Dict[str, torch.Tensor] = {}
    for net in ("RAchirpNet", "REchirpNet"):
        _conv(sd, f"{net}.temporalConvWx1x1", params[net]["temporalConv"])
    for enc in ("RAradarEncoder", "REradarEncoder"):
        p, s = params[enc], stats[enc]
        _conv(sd, f"{enc}.layer1.0", p["layer1_conv"])
        for name, key in _BLOCKS_3D:
            _basic_block(sd, f"{enc}.{key}", p[name], s[name])
        for name in ("l1temporalMerge", "l2temporalMerge", "temporalMerge"):
            _conv(sd, f"{enc}.{name}", p[name])
    p = params["radarDecoder"]
    for name, key in _BLOCKS_2D:
        _basic_block(sd, f"radarDecoder.{key}", p[name], {})
    _conv(sd, "radarDecoder.decoderLayer1.2", p["decoder1_out"])
    for proj in _PROJECTIONS:
        for i in range(3):
            _conv(sd, f"radarDecoder.{proj}.{i}", p[f"{proj}_{i}"])
    for layer in ("L1", "L2", "L3"):
        for leaf in ("weight", "bias"):
            sd[f"radarDecoder.gcn.{layer}.{leaf}"] = _t(p["gcn"][layer][leaf])
    return sd
