"""Raw I/Q frames -> normalized model input, in plain torch.

The IWR1843 processing of HuPR's preprocessing/process_iwr1843.py
(generateHeatmap): TDM-MIMO demux of 192 chirps into an 8-element azimuth
and a 4-element elevation array, static clutter removal, range-Doppler FFT,
the range gate 94..31 and the 16 central Doppler bins, the elevation and
azimuth FFTs, fftshift and flip; then the 8 central chirps of each cube,
real and imaginary parts, min-max and z-normalized per (range, azimuth)
plane (datasets/base.py).
"""

from __future__ import annotations

import torch

ADC_SAMPLES = 256
ANGLE_BINS = 64          # ADC_SAMPLES / 4
ELEVATION_BINS = 8
CHIRPS_PER_TX = 64
KEPT_CHIRPS = 16
RANGE_GATE_START = 94


def radar_cubes(frames: torch.Tensor) -> torch.Tensor:
    """(F, RX=4, 192, 256) complex64 -> cubes (F, 16, R=64, A=64, E=8)."""
    dev = frames.device
    azim = torch.cat([frames[:, :, 0::3], frames[:, :, 2::3]], dim=1)
    elev = frames[:, :, 1::3]
    azim = torch.fft.fft2(azim - azim.mean(dim=2, keepdim=True), dim=(2, 3))
    elev = torch.fft.fft2(elev - elev.mean(dim=2, keepdim=True), dim=(2, 3))
    gate = RANGE_GATE_START - torch.arange(ANGLE_BINS, device=dev)
    half = CHIRPS_PER_TX // 2
    chirps = (torch.arange(half - KEPT_CHIRPS // 2, half + KEPT_CHIRPS // 2,
                           device=dev) + half) % CHIRPS_PER_TX
    azim = azim[:, :, chirps][:, :, :, gate]            # (F, 8, 16, 64)
    elev = elev[:, :, chirps][:, :, :, gate]            # (F, 4, 16, 64)
    f, _, c, r = azim.shape
    cube = azim.new_zeros((f, ELEVATION_BINS, ANGLE_BINS, c, r))
    cube[:, 0, :8] = azim
    cube[:, 1, 2:6] = elev
    cube[:, :, 2:6] = torch.fft.fft(cube[:, :, 2:6], dim=1)
    cube = torch.fft.fft(cube, dim=2)
    cube = torch.fft.fftshift(cube.permute(0, 3, 4, 2, 1), dim=(3, 4))
    return torch.flip(cube, dims=(3, 4))


def normalize_planes(x: torch.Tensor) -> torch.Tensor:
    """x (..., R, A, E): each (R, A) plane min-max scaled to [0, 1], then
    to zero mean and unit unbiased std; a constant plane gives zeros."""
    x = x.movedim(-1, -3)
    x = x - x.amin(dim=(-2, -1), keepdim=True)
    mx = x.amax(dim=(-2, -1), keepdim=True)
    x = x / torch.where(mx > 0, mx, torch.ones_like(mx))
    x = x - x.mean(dim=(-2, -1), keepdim=True)
    var = (x * x).sum(dim=(-2, -1), keepdim=True) / (
        x.shape[-1] * x.shape[-2] - 1)
    x = x / torch.sqrt(torch.where(var > 0, var, torch.ones_like(var)))
    return x.movedim(-3, -1)


def frame_input(re: torch.Tensor, im: torch.Tensor,
                num_frames: int = 8) -> torch.Tensor:
    """Raw int16 (or float) I/Q planes (F, 4, 192, 256) of one view ->
    normalized model input (F, 1, C=num_frames, 2, R, A, E) float32."""
    cube = radar_cubes(torch.complex(re.to(torch.float32),
                                     im.to(torch.float32)))
    c0 = cube.shape[1] // 2 - num_frames // 2
    sel = cube[:, c0:c0 + num_frames]
    return normalize_planes(torch.stack([sel.real, sel.imag], dim=2))[:, None]
