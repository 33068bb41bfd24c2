"""Preprocessing-side visualization (counterpart of
`hupr_tpu/preprocessing/plot_utils.py`, kept as a copy: NumPy only, with
matplotlib imported inside the function that draws).

plot_maps: 2x2 matplotlib panel — hori/vert radar magnitude maps (elevation/
Doppler-averaged), the RGB camera frame, and the composited GT heatmap
(reference preprocessing/plot_utils.py:7-40). composite_gt_heatmap:
max-composited unnormalized Gaussians, sigma=2, rasterized on the 64x64
grid from 256x256 coordinates (reference generate_target/:49-112).
"""

from __future__ import annotations

import numpy as np


def composite_gt_heatmap(joints, num_keypoints: int = 14,
                         heatmap_size: int = 64, img_size: int = 256,
                         sigma: float = 2.0) -> np.ndarray:
    """(K, 2) image-space joints -> (H, W) max-composited Gaussian heatmap."""
    stride = img_size / heatmap_size
    ys, xs = np.mgrid[0:heatmap_size, 0:heatmap_size]
    out = np.zeros((heatmap_size, heatmap_size), dtype=np.float32)
    tmp = int(sigma * 3)
    for k in range(num_keypoints):
        mu_x = int(joints[k][0] / stride + 0.5)
        mu_y = int(joints[k][1] / stride + 0.5)
        if (mu_x - tmp >= heatmap_size or mu_y - tmp >= heatmap_size
                or mu_x + tmp + 1 < 0 or mu_y + tmp + 1 < 0):
            continue
        g = np.exp(-((xs - mu_x) ** 2 + (ys - mu_y) ** 2)
                   / (2.0 * sigma ** 2)).astype(np.float32)
        g[np.abs(xs - mu_x) > tmp] = 0.0
        g[np.abs(ys - mu_y) > tmp] = 0.0
        out = np.maximum(out, g)
    return out


def plot_maps(vis_path: str, x_indices, y_indices, idx_frame: int,
              output_hori: np.ndarray, img: np.ndarray,
              heatmap: np.ndarray, output_vert: np.ndarray | None = None):
    """Write the 2x2 diagnostic panel PNG for one frame.

    output_*: (R, A) magnitude maps (already averaged over chirp/elevation,
    as in the reference loadDataPlot at process_iwr1843.py:203-205).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(10, 10))
    ax = axes[0, 0]
    ax.imshow(output_hori, origin="lower", aspect="auto")
    ax.set_title(f"hori map, frame {idx_frame}")
    ax.set_xticks(np.linspace(0, output_hori.shape[1] - 1, len(x_indices)))
    ax.set_xticklabels(x_indices)
    ax.set_yticks(np.linspace(0, output_hori.shape[0] - 1, len(y_indices)))
    ax.set_yticklabels(y_indices)

    ax = axes[0, 1]
    if output_vert is not None:
        ax.imshow(output_vert, origin="lower", aspect="auto")
        ax.set_title("vert map")
    else:
        ax.axis("off")

    axes[1, 0].imshow(img)
    axes[1, 0].set_title("RGB frame")
    axes[1, 1].imshow(heatmap, cmap="hot")
    axes[1, 1].set_title("GT heatmap")
    fig.tight_layout()
    fig.savefig(vis_path)
    plt.close(fig)
