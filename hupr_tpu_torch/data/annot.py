"""COCO-format ground-truth annotation generation (a copy of
`hupr_tpu/data/annot.py`; the GT JSON is byte-identical to its).

Parity: the reference's generateGTAnnot (datasets/base.py:26-92). Reads
`hrnet_annot_{phase}.json` (a list per sequence of per-frame blocks with
'image', 'joints', 'bbox' xyxy) and writes `{phase}_gt.json` with:
  image_id = frame_number + sequence_id * 100000
  keypoints interleaved with visibility forced to 2
  bbox converted xyxy -> xywh, area = w*h/2
The reference regenerates this file inside every Dataset construction; we do
the same (cheap, idempotent) so downstream files always match.
"""

from __future__ import annotations

import json
import os

import numpy as np

CATEGORY = {
    "supercategory": "person",
    "id": 1,
    "name": "person",
    "keypoints": [
        "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
        "L_Ankle", "Neck", "Head", "L_Shoulder", "L_Elbow",
        "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist",
    ],
    "skeleton": [
        [14, 13], [13, 12], [11, 10], [10, 9], [9, 7], [12, 9], [8, 7],
        [7, 1], [7, 4], [6, 5], [5, 4], [3, 2], [2, 1],
    ],
}


def generate_gt_annotations(cfg, phase: str, verbose: bool = False) -> str:
    """Write {dataDir}/{phase}_gt.json; returns its path."""
    data_dir = cfg.DATASET.dataDir
    seq_ids = cfg.DATASET.split_names(phase)

    annot = {
        "info": {
            "description": "HuPR dataset",
            "url": "",
            "version": "1.0",
            "year": 2022,
            "contributor": "UW-NYCU-AI-Labs",
            "date_created": "2022/06/23",
        },
        "licenses": [],
        "images": [],
        "annotations": [],
        "categories": [CATEGORY],
    }

    src = os.path.join(data_dir, f"hrnet_annot_{phase}.json")
    with open(src) as fp:
        per_seq = json.load(fp)
    for i, blocks in enumerate(per_seq):
        seq_id = seq_ids[i]
        for block in blocks:
            image_id = int(block["image"][:-4]) + seq_id * 100000
            joints = np.asarray(block["joints"], dtype=np.float64)
            vis = np.full((len(joints), 1), 2.0)
            kpts = np.concatenate([joints, vis], axis=1).reshape(-1).tolist()
            x0, y0, x1, y1 = block["bbox"]
            annot["annotations"].append({
                "num_keypoints": 14,
                "area": (x1 - x0) * (y1 - y0) / 2,
                "iscrowd": 0,
                "keypoints": kpts,
                "image_id": image_id,
                "bbox": [x0, y0, x1 - x0, y1 - y0],
                "category_id": 1,
                "id": image_id,
            })
            annot["images"].append({
                "license": -1,
                "file_name": block["image"],
                "coco_url": "None",
                "height": 256,
                "width": 256,
                "date_captured": "None",
                "flickr_url": "None",
                "id": image_id,
            })
        if verbose:
            print(f"Generate GTs for single_{seq_id} for {phase} stage")

    out = os.path.join(data_dir, f"{phase}_gt.json")
    # atomic replace: concurrent writers (multi-host processes sharing the
    # data dir produce byte-identical content) and concurrent readers never
    # see a truncated file
    tmp = f"{out}.tmp.{os.getpid()}"
    with open(tmp, "w") as fp:
        json.dump(annot, fp)
    os.replace(tmp, out)
    return out
