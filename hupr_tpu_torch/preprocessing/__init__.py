from hupr_tpu_torch.preprocessing.process_iwr1843 import (
    RadarPreprocessor,
    decode_dca1000_np,
)
