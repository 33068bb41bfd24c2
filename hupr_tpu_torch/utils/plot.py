"""Pose visualization (a copy of `hupr_tpu/utils/plot.py`; pixel parity:
the reference's misc/plot.py:14-81). cv2 and PIL are imported inside the
functions, so only a host that draws needs them.

The reference renders each frame through torchvision's
make_grid(nrow=8, padding=2, normalize=True): a 260x260 canvas with a 2px
black border, the RGB image min-max normalized over the whole tensor, and
every joint shifted by +2px (the grid cell offset, plot.py:46-48). The bbox,
when drawn, is NOT shifted (plot.py:69-77) — a reference quirk kept as-is.
Output: visualization/<visDir>/single_N/%09d.png.

Deviation (documented in PARITY.md): the reference hard-requires an external
../frames RGB directory and crashes without it; here a black canvas is used
when the frame is missing so visualization works on radar-only installs.
"""

from __future__ import annotations

import os

import numpy as np

# joint-index edges of the HuPR skeleton (misc/plot.py:52-67)
SKELETON_EDGES = [
    (0, 1), (1, 2), (0, 3), (3, 4), (4, 5), (0, 6), (3, 6), (6, 7),
    (6, 8), (6, 11), (8, 9), (9, 10), (11, 12), (12, 13),
]


def _load_rgb(cfg, image_id: int, size):
    namestr = "%09d" % image_id
    path = os.path.join("../frames", cfg.TEST.plotImgDir,
                        "single_%d" % int(namestr[:4]), "processed/images",
                        "%09d.jpg" % int(namestr[-4:]))
    if os.path.exists(path):
        from PIL import Image
        img = Image.open(path).convert("RGB").resize(size)
        return np.asarray(img).copy()
    return np.zeros((size[1], size[0], 3), dtype=np.uint8)


def _make_grid_canvas(img: np.ndarray, padding: int) -> np.ndarray:
    """Replicate make_grid(batch, nrow=8, padding, normalize=True) for a
    single image: min-max normalize over the whole tensor (torchvision
    norm_range with range=None), then paste at (padding, padding) on a black
    (pad_value=0) grid of size (H+2*padding, W+2*padding)."""
    t = img.astype(np.float64) / 255.0
    low, high = t.min(), t.max()
    t = (t - low) / max(high - low, 1e-5)
    t = np.clip(t * 255.0, 0, 255).astype(np.uint8)
    h, w = t.shape[:2]
    canvas = np.zeros((h + 2 * padding, w + 2 * padding, 3), dtype=np.uint8)
    canvas[padding:padding + h, padding:padding + w] = t
    return canvas


def plot_human_pose(batch_joints, cfg, vis_dir: str, image_ids,
                    bbox=None, upsampling_size=(256, 256), padding: int = 2):
    import cv2

    batch_joints = np.asarray(batch_joints)
    for j in range(len(batch_joints)):
        image_id = int(image_ids[j])
        namestr = "%09d" % image_id
        image_dir = os.path.join(vis_dir, "single_%d" % int(namestr[:4]))
        os.makedirs(image_dir, exist_ok=True)
        image_path = os.path.join(image_dir, "%09d.png" % int(namestr[-4:]))

        canvas = _make_grid_canvas(_load_rgb(cfg, image_id, upsampling_size),
                                   padding)
        # grid cell offset: +padding on both axes (plot.py:46-48); the
        # skeleton edges are drawn from the same shifted coords (plot.py:51)
        joints = batch_joints[j][:, :2].astype(np.float64) + padding
        for joint in joints:
            cv2.circle(canvas, (int(joint[0]), int(joint[1])), 2,
                       [255, 0, 0], 2)
        for a, b in SKELETON_EDGES:
            cv2.line(canvas,
                     (int(joints[a][0]), int(joints[a][1])),
                     (int(joints[b][0]), int(joints[b][1])),
                     [255, 0, 0], 1)
        if bbox is not None:
            # reference quirk: bbox coords are NOT grid-shifted (plot.py:69-77)
            x, y, w, h = [int(v) for v in bbox[j]]
            cv2.rectangle(canvas, (x, y), (x + w, y + h), [0, 255, 0], 1)
        cv2.imwrite(image_path, canvas[:, :, ::-1])
