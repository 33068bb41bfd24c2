"""Raw-capture (DCA1000 .bin) frame source for raw-ADC training and eval
(counterpart of `hupr_tpu/data/adc.py`).

The reference turns every frame into a preprocessed radar-cube .npy
(preprocessing/process_iwr1843.py:180-196) that its DataLoader re-reads
per window. In raw-ADC mode the host instead ships each frame's raw int16
DCA1000 stream slice straight out of the capture file
(`single_N/{hori,vert}/adc_data.bin`, the preprocessing CLI's input), and
the card decodes it and runs the DSP (ops/dsp.py) inside the step.

Per frame and view: 192 chirps x 4 RX x 256 ADC x 2 (I/Q) int16 = 768
KiB, against ~2.1 MB of float32 centre-chirp cube planes. int16 is the
sensor's own sample format, so SETUP.transferDtype does not apply.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from hupr_tpu_torch.ops.dsp import RadarParams


def seq_frame(image_id: int) -> tuple:
    """image_id = frame + seq * 100000 (data/annot.py)."""
    return image_id // 100000, image_id % 100000


class ADCFrameSource:
    """Per-frame raw int16 stream slices memory-mapped from capture .bin
    files laid out as the preprocessing CLI reads them:
    `{adc_dir}/single_{seq}/{hori,vert}/adc_data.bin`."""

    def __init__(self, adc_dir: str, params: RadarParams = RadarParams()):
        self.adc_dir = adc_dir
        self.params = params
        # int16 samples per frame in the interleaved stream: 2 per complex
        # value (I on lane 0, Q on lane 1: ops/dsp.decode_dca1000)
        self.frame_samples = (params.num_rx * params.num_chirp
                              * params.num_adc_samples * 2)
        self._maps: dict = {}

    def bin_path(self, seq: int, view: str) -> str:
        return os.path.join(self.adc_dir, f"single_{seq}", view,
                            "adc_data.bin")

    def _map(self, seq: int, view: str) -> np.ndarray:
        key = (seq, view)
        if key not in self._maps:
            self._maps[key] = np.memmap(self.bin_path(seq, view),
                                        dtype=np.int16, mode="r")
        return self._maps[key]

    def frames_available(self, seq: int, view: str) -> int:
        try:
            return int(os.path.getsize(self.bin_path(seq, view))
                       // (2 * self.frame_samples))
        except OSError:
            return 0

    def available(self, image_ids: List[int]) -> bool:
        """Every frame of every sequence in `image_ids` exists in the
        captures of both views."""
        if not self.adc_dir:
            return False
        need: dict = {}
        for i in image_ids:
            seq, frame = seq_frame(i)
            need[seq] = max(need.get(seq, -1), frame)
        return all(self.frames_available(seq, view) > last
                   for seq, last in need.items()
                   for view in ("hori", "vert"))

    def read_frames(self, image_ids: List[int], lo: int, n: int, view: str,
                    out: np.ndarray) -> None:
        """Copy the raw stream slices of dataset rows [lo, lo+n) into
        out[:n] ((>=n, frame_samples) int16). The rows must be one
        contiguous run of one sequence (chunk_table's chunks never straddle
        sequences)."""
        seq0, f0 = seq_frame(image_ids[lo])
        seqn, fn = seq_frame(image_ids[lo + n - 1])
        if seq0 != seqn or fn != f0 + n - 1:
            raise ValueError("ADC frame rows must be one contiguous "
                             f"sequence run, got ids {image_ids[lo]}.."
                             f"{image_ids[lo + n - 1]}")
        mm = self._map(seq0, view)
        s = self.frame_samples
        out[:n] = mm[f0 * s:(f0 + n) * s].reshape(n, s)
