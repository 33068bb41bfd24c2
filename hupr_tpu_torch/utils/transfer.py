"""Half-precision host-to-device wire format for radar planes (counterpart
of `hupr_tpu/utils/transfer.py`).

SETUP.transferDtype names the dtype the loaders ship the raw radar planes
in: float32 by default (bit-faithful to the reference's DataLoader), or
bfloat16 / float16 to halve the bytes on a transfer-bound link. The cast
runs on the host, in the loader's thread; the train and eval steps cast
back to float32 before the per-plane normalize, so only the raw cube
values are quantized. The names map to torch dtypes: numpy has no
bfloat16, so a half-width plane travels as a torch tensor.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def transfer_dtype(name: str) -> torch.dtype:
    """SETUP.transferDtype string -> torch dtype (ValueError on unknown)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(
            f"SETUP.transferDtype must be one of {sorted(_DTYPES)}, "
            f"got {name!r}") from None


def cast_for_transfer(arr: np.ndarray, dtype: torch.dtype):
    """A float32 host plane in the wire dtype: the array itself for
    float32, else a torch tensor of the cast values."""
    if dtype == torch.float32:
        return arr
    return torch.from_numpy(np.ascontiguousarray(arr)).to(dtype)
