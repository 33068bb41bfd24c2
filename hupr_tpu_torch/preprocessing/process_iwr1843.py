"""Offline radar preprocessing CLI (counterpart of
`hupr_tpu/preprocessing/process_iwr1843.py`; parity: the reference's
preprocessing/process_iwr1843.py).

DCA1000 raw captures (hori + vert per sequence) -> per-frame radar-cube
.npy files under data/HuPR/single_N/{hori,vert}/%09d.npy, each
(16, 64, 64, 8) complex64: the directory layout and file format the
Runner's classic loader reads.

The capture is decoded on the host (integer reshuffling in NumPy, so a
multi-GB capture never reaches the card), then `batch_frames` frames at a
time go to the card, where one call of ops/dsp.radar_cube_frames (torch.fft,
batched over frames) makes their cubes; the reference runs per-frame Python
loops of FFTs (~2.4 s a frame). FFT libraries differ in the last bits, so
compare cubes relative to the cube's peak, never with an absolute
tolerance.

Run:  python -m hupr_tpu_torch.preprocessing.process_iwr1843 [--sequences 1 2 ...]

on the CUDA card, which it fails without; HUPR_PLATFORM=cpu asks for the
CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from hupr_tpu_torch.ops.dsp import (RadarParams, frames_from_adc,
                                    radar_cube_frames)
from hupr_tpu_torch.utils.device import resolve_device


def decode_dca1000_np(raw: np.ndarray,
                      params: RadarParams = RadarParams()) -> np.ndarray:
    """Host-side DCA1000 int16 stream -> (RX, chirps, ADC) complex64.
    Same layout logic as ops/dsp.decode_dca1000 (see its docstring), in
    NumPy so multi-GB captures never reach the card."""
    p = params
    quad = raw.reshape(-1, p.num_lanes * 2)
    lane_i = quad[:, 0:2].reshape(-1).astype(np.float32)
    lane_q = quad[:, 2:4].reshape(-1).astype(np.float32)
    iq = lane_i + 1j * lane_q
    blocks = iq.reshape(-1, p.num_rx, p.num_adc_samples)
    return np.transpose(blocks, (1, 0, 2)).astype(np.complex64)


class RadarPreprocessor:
    """Preprocesses whole sequences as the reference RadarObject does, on
    the card unless `device` says otherwise."""

    def __init__(self, root: str = "HuPR", save_root: str = "HuPR",
                 sensor: str = "iwr1843", num_sequences: int = 276,
                 params: RadarParams = RadarParams(),
                 raw_base: str = "preprocessing/raw_data",
                 out_base: str = "data", batch_frames: int = 30,
                 device=None):
        self.params = params
        self.batch_frames = batch_frames
        self.device = resolve_device(device)
        self.raw_dirs = []
        self.out_dirs = []
        for i in range(1, num_sequences + 1):
            self.raw_dirs.append((
                os.path.join(raw_base, sensor, root, f"single_{i}", "hori"),
                os.path.join(raw_base, sensor, root, f"single_{i}", "vert"),
            ))
            self.out_dirs.append(os.path.join(out_base, save_root,
                                              f"single_{i}"))

    def _cubes(self, frames: torch.Tensor) -> np.ndarray:
        """(F, RX, chirps, ADC) complex64 on the host -> (F, 16, 64, 64, 8)
        complex64 on the host, made on the device in one call."""
        with torch.inference_mode():
            return radar_cube_frames(frames.to(self.device),
                                     self.params).cpu().numpy()

    def process_capture(self, bin_dir: str, out_dir: str, tag: str):
        raw = np.fromfile(os.path.join(bin_dir, "adc_data.bin"),
                          dtype=np.int16)
        adc = decode_dca1000_np(raw, self.params)
        print("Shape of radar data:", adc.shape)
        p = self.params
        n_frames = min(p.num_frames, adc.shape[1] // p.num_chirp)
        frames = frames_from_adc(torch.from_numpy(adc), p)    # host views
        os.makedirs(os.path.join(out_dir, tag), exist_ok=True)
        for start in range(0, n_frames, self.batch_frames):
            stop = min(start + self.batch_frames, n_frames)
            cubes = self._cubes(frames[start:stop])
            for k, f in enumerate(range(start, stop)):
                np.save(os.path.join(out_dir, tag, f"{f:09d}.npy"), cubes[k])
            print(f"{bin_dir}, finished frame {stop - 1}", end="\r")

    def process_radar_data_hori_vert(self, sequences=None):
        for idx, ((hori_dir, vert_dir), out_dir) in enumerate(
                zip(self.raw_dirs, self.out_dirs)):
            if sequences is not None and (idx + 1) not in sequences:
                continue
            # both captures must exist; a partial copy (hori without vert)
            # skips the sequence instead of crashing the whole batch run
            if not all(os.path.exists(os.path.join(d, "adc_data.bin"))
                       for d in (hori_dir, vert_dir)):
                continue
            self.process_capture(hori_dir, out_dir, "hori")
            self.process_capture(vert_dir, out_dir, "vert")


def load_data_plot(out_dir: str, annot_path: str, rgb_dir: str,
                   vis_dir: str, num_frames: int = 600,
                   x_indices=(-45, -30, -15, 0, 15, 30, 45),
                   y_indices=tuple(i * 10 for i in range(10))):
    """Per-frame diagnostic panels from saved cubes + annotations (parity:
    reference loadDataPlot, process_iwr1843.py:198-213, dead code there).
    Magnitude maps are |cube| averaged over chirp and elevation."""
    import json

    from PIL import Image

    from hupr_tpu_torch.preprocessing.plot_utils import (
        composite_gt_heatmap, plot_maps)

    with open(annot_path) as fp:
        annots = json.load(fp)
    os.makedirs(vis_dir, exist_ok=True)
    for f in range(num_frames):
        hori = np.load(os.path.join(out_dir, "hori", f"{f:09d}.npy"))
        vert = np.load(os.path.join(out_dir, "vert", f"{f:09d}.npy"))
        hori_map = np.mean(np.abs(hori), axis=(0, 3))
        vert_map = np.mean(np.abs(vert), axis=(0, 3))
        rgb_path = os.path.join(rgb_dir, f"{f:09d}.jpg")
        if os.path.exists(rgb_path):
            img = np.asarray(Image.open(rgb_path).convert("RGB"))
        else:
            img = np.zeros((256, 256, 3), dtype=np.uint8)
        joints = np.asarray(annots[f]["joints"])
        heatmap = composite_gt_heatmap(joints)
        plot_maps(os.path.join(vis_dir, f"{f:09d}.png"), list(x_indices),
                  list(y_indices), f, hori_map, img, heatmap, vert_map)
        print(f"{out_dir}, finished frame {f}", end="\r")


def main(argv=None):
    from hupr_tpu_torch.main import requested_device
    device = requested_device()
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sequences", type=int, nargs="*", default=None,
                    help="sequence ids to process (default: all with raw data)")
    ap.add_argument("--batch-frames", type=int, default=30)
    ap.add_argument("--num-sequences", type=int, default=276)
    args = ap.parse_args(argv)
    pre = RadarPreprocessor(num_sequences=args.num_sequences,
                            batch_frames=args.batch_frames, device=device)
    pre.process_radar_data_hori_vert(
        set(args.sequences) if args.sequences else None)


if __name__ == "__main__":
    main()
