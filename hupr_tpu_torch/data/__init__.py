from hupr_tpu_torch.data.annot import generate_gt_annotations
from hupr_tpu_torch.data.dataset import (
    BatchLoader,
    HuPRDataset,
    get_dataset,
    window_indices,
)
