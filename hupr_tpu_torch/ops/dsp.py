"""Radar-cube DSP, batched over frames with torch.fft.

Counterpart of `hupr_tpu/ops/dsp.py` (reference
preprocessing/process_iwr1843.py):
  decode_dca1000       getadcDataFromDCA1000: the DCA1000's int16 stream
                       -> complex ADC samples (RX, chirps, ADC)
  frames_from_adc      a decoded capture -> per-frame stacks
  radar_cube_frames    generateHeatmap: one IWR1843 frame (4 RX, 192 TDM
                       chirps, 256 ADC samples) complex -> radar cube
                       (16 Doppler chirps, 64 range, 64 azimuth, 8
                       elevation) complex, batched over frames
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class RadarParams:
    """IWR1843 capture geometry (reference process_iwr1843.py:18-33)."""
    num_adc_samples: int = 256
    adc_ratio: int = 4            # range decimation: keep 256/4 = 64 range bins
    num_ele_bins: int = 8
    num_rx: int = 4
    num_lanes: int = 2
    frame_per_second: int = 10
    duration_s: int = 60
    num_chirp: int = 192          # 64 x 3 TDM TX per frame
    idx_proc_chirp: int = 64      # chirps per TX after demux
    num_group_chirp: int = 4      # keep 64/4 = 16 central Doppler bins
    range_gate_start: int = 94    # ADC bins 94 -> 31 descending

    @property
    def num_angle_bins(self) -> int:
        return self.num_adc_samples // self.adc_ratio

    @property
    def num_frames(self) -> int:
        return self.frame_per_second * self.duration_s

    @property
    def num_kept_chirps(self) -> int:
        return self.idx_proc_chirp // self.num_group_chirp


def decode_dca1000(raw: torch.Tensor,
                   params: RadarParams = RadarParams()) -> torch.Tensor:
    """DCA1000 int16 stream (..., S) -> complex64 ADC samples
    (..., RX, chirps, ADC), over any leading axes.

    The capture interleaves two LVDS lanes in rows of four int16 values,
    [l0a, l0b, l1a, l1b]: lane 0 carries I and lane 1 Q. The I/Q series
    run in blocks of num_adc_samples that cycle through RX 0..3. Integer
    reshuffling and an exact cast: equal to the JAX package's bit for bit.
    """
    p = params
    lead = raw.shape[:-1]
    quad = raw.reshape(*lead, -1, p.num_lanes * 2)
    lane_i = quad[..., 0:2].reshape(*lead, -1)
    lane_q = quad[..., 2:4].reshape(*lead, -1)
    iq = torch.complex(lane_i.to(torch.float32), lane_q.to(torch.float32))
    blocks = iq.reshape(*lead, -1, p.num_rx, p.num_adc_samples)
    return blocks.transpose(-3, -2)                   # (..., RX, chirps, ADC)


def frames_from_adc(adc: torch.Tensor,
                    params: RadarParams = RadarParams()) -> torch.Tensor:
    """A decoded capture (RX, totalChirps, ADC) -> per-frame stacks
    (F, RX, numChirp, ADC); a partial last frame is dropped (reference
    :189-191)."""
    f = adc.shape[1] // params.num_chirp
    return adc[:, :f * params.num_chirp].reshape(
        adc.shape[0], f, params.num_chirp, -1).transpose(0, 1)


def radar_cube_frames(frames: torch.Tensor,
                      params: RadarParams = RadarParams()) -> torch.Tensor:
    """(F, RX, numChirp, ADC) complex -> cubes (F, chirps, R, A, E) complex."""
    p = params
    dev = frames.device
    # TDM-MIMO demux: chirps idx%3 in {0, 2} fill the 8-element azimuth
    # array, idx%3 == 1 the 4-element elevation array
    azim = torch.cat([frames[:, :, 0::3], frames[:, :, 2::3]], dim=1)
    elev = frames[:, :, 1::3]

    # static clutter removal over the chirp axis, then range-Doppler FFT
    azim = torch.fft.fft2(azim - azim.mean(dim=2, keepdim=True), dim=(2, 3))
    elev = torch.fft.fft2(elev - elev.mean(dim=2, keepdim=True), dim=(2, 3))

    # The range gate (94..31) and the central-chirp crop are column picks
    # on axes the angle FFTs never mix, so they are taken before them: the
    # same values at a sixteenth of the angle-FFT work.
    nab = p.num_angle_bins
    gate = p.range_gate_start - torch.arange(nab, device=dev)
    half, k = p.idx_proc_chirp // 2, p.num_kept_chirps
    chirp_sel = (torch.arange(half - k // 2, half + k // 2, device=dev)
                 + half) % p.idx_proc_chirp
    azim = azim[:, :, chirp_sel][:, :, :, gate]       # (F, 8, C, R)
    elev = elev[:, :, chirp_sel][:, :, :, gate]       # (F, 4, C, R)

    # angle FFTs: azimuth array zero-padded 8 -> nab, elevation array at
    # azimuth rows 2..5, stacked on an elevation axis of num_ele_bins
    f, _, c, r = azim.shape
    merged = azim.new_zeros((f, p.num_ele_bins, nab, c, r))
    merged[:, 0, :azim.shape[1]] = azim
    merged[:, 1, 2:6] = elev
    # elevation FFT only on azimuth rows 2..5, where the vertical array is;
    # the other rows keep their values (the reference loops only over 2..5)
    merged[:, :, 2:6] = torch.fft.fft(merged[:, :, 2:6], dim=1)
    merged = torch.fft.fft(merged, dim=2)             # azimuth FFT

    # the reference's transpose/fftshift/flip chain reduces to fftshift and
    # flip over the (azimuth, elevation) axes
    cube = merged.permute(0, 3, 4, 2, 1)              # (F, C, R, A, E)
    cube = torch.fft.fftshift(cube, dim=(3, 4))
    return torch.flip(cube, dims=(3, 4))


def radar_cube_single_frame(frame: torch.Tensor,
                            params: RadarParams = RadarParams()
                            ) -> torch.Tensor:
    """One frame (RX, numChirp, ADC) complex -> its cube (C, R, A, E)."""
    return radar_cube_frames(frame[None], params)[0]
