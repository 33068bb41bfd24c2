"""The memory layout serving hands the 3-D encoders' trilinear halvings.

Serving windows the per-frame chirp maps into a contiguous (F, G, R, A, C)
stack and the model moves C to the channel axis; without a copy that view
is exactly channels_last_3d, and every Encoder3D conv and halving then runs
channels-last, where the card's `upsample_trilinear3d` takes several times
as long as on the NCDHW tensors the training forward hands it. Here one
request goes through make_e2e_infer on the CPU at a small size with
F.interpolate watched: every 5-D input must be NCDHW-contiguous.
"""

import numpy as np
import torch
import torch.nn.functional as F

from hupr_tpu_torch.engine.pipeline import make_e2e_infer
from hupr_tpu_torch.models.hupr import HuPRNet
from hupr_tpu_torch.ops.dsp import RadarParams
from hupr_tpu_torch.utils.synthetic import synthetic_state_dict

SMALL = dict(num_adc_samples=128, num_chirp=48, idx_proc_chirp=16,
             num_group_chirp=2)


def test_serving_resizes_ncdhw_contiguous(monkeypatch):
    params = RadarParams(**SMALL)
    model = HuPRNet(num_filters=2, heatmap_size=32)
    run = make_e2e_infer(model, synthetic_state_dict(model, seed=0,
                                                     scale=0.1),
                         params, duration=8, device="cpu")
    rng = np.random.default_rng(0)
    adc = [rng.integers(-300, 300, (4, params.num_rx, params.num_chirp,
                                    params.num_adc_samples)).astype(np.int16)
           for _ in range(4)]
    seen, interpolate = [], F.interpolate

    def spy(x, *args, **kwargs):
        if x.dim() == 5:
            seen.append((tuple(x.shape), x.stride(), x.is_contiguous()))
        return interpolate(x, *args, **kwargs)

    monkeypatch.setattr(F, "interpolate", spy)
    pred, _ = run(*adc)
    assert pred.shape == (4, 14, 2)
    # two halvings in each of the two encoders
    assert len(seen) == 4
    assert all(contiguous for _, _, contiguous in seen), seen
