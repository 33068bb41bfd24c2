"""The port's OKS keypoint evaluator and COCO facade against hupr_tpu's on
the same gt and detections (equal stats, bit for bit, whole and per
keypoint, quirks included), and the port's Runner against the golden AP
vectors of tests/test_golden_ap.py."""

import argparse
import json
import os

import numpy as np
import pytest
import torch

from hupr_tpu.eval import KeypointEvaluator as JaxEvaluator
from hupr_tpu.eval.coco_api import COCO as JaxCOCO
from hupr_tpu.eval.coco_api import COCOeval as JaxCOCOeval
from hupr_tpu_torch.eval import HUPR_OKS_SIGMAS, KeypointEvaluator
from hupr_tpu_torch.eval.coco_api import COCO, COCOeval
from test_golden_ap import (GOLDEN_CLASSIC, GOLDEN_SEQ, PROTOCOL_ATOL,
                            _golden_workspace)
from test_torch_data import port_cfg_of

torch.set_num_threads(1)


def _scenario(seed, n_img=12):
    """gt and detections with what the matcher treats specially: several
    people and detections per image, score ties, more detections than
    maxDets, invisible keypoints, crowd gts, a gt with id 0, images with
    no gt or no detection, areas across the medium / large ranges."""
    rng = np.random.default_rng(seed)
    images, anns, dets = [], [], []
    gid = 0                                  # the first gt gets id 0
    for img in range(1, n_img + 1):
        images.append({"id": img})
        for _ in range(int(rng.integers(0, 3))):
            c = rng.uniform(40, 210, 2)
            side = rng.choice([40.0, 80.0, 200.0])
            j = c + rng.normal(0, side / 4, (14, 2))
            v = np.where(rng.uniform(size=14) < 0.15, 0.0, 2.0)
            anns.append({
                "id": gid, "image_id": img, "category_id": 1,
                "iscrowd": int(rng.uniform() < 0.15),
                "num_keypoints": int((v > 0).sum()),
                "area": float(side * side / 2),
                "bbox": [float(c[0] - side / 2), float(c[1] - side / 2),
                         float(side), float(side)],
                "keypoints": np.concatenate([j, v[:, None]], 1)
                               .reshape(-1).tolist()})
            gid += 1
            for _ in range(int(rng.integers(0, 4))):
                d = j + rng.normal(0, rng.choice([2.0, 8.0, 30.0]), (14, 2))
                dets.append({"image_id": img, "category_id": 1,
                             "score": float(rng.choice([1.0, 0.9, 0.5])),
                             "keypoints": np.concatenate(
                                 [d, np.ones((14, 1))], 1)
                                 .reshape(-1).tolist()})
        if img == n_img:                    # past maxDets = 20
            for _ in range(25):
                dets.append({"image_id": img, "category_id": 1,
                             "score": float(rng.uniform()),
                             "keypoints": np.concatenate(
                                 [rng.uniform(0, 256, (14, 2)),
                                  np.ones((14, 1))], 1).reshape(-1).tolist()})
    return {"images": images, "annotations": anns,
            "categories": [{"id": 1}]}, dets


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_evaluator_stats_equal_jax(seed):
    gt, dets = _scenario(seed)
    want = JaxEvaluator(gt, [dict(d) for d in dets]).run(verbose=False)
    got = KeypointEvaluator(gt, [dict(d) for d in dets]).run(verbose=False)
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all() and (got >= -1).all()


def test_evaluator_per_keypoint_stats_equal_jax():
    gt, dets = _scenario(4)
    jev, pev = JaxEvaluator(gt, dets), KeypointEvaluator(gt, dets)
    for k in range(14):
        np.testing.assert_array_equal(
            pev.run(idx_keypoint=k, verbose=False),
            jev.run(idx_keypoint=k, verbose=False))
    np.testing.assert_array_equal(HUPR_OKS_SIGMAS,
                                  JaxEvaluator(gt, dets).params.sigmas)


def test_evaluator_quirks_equal_jax():
    """A perfect detection of the gt with id 0 counts as unmatched (the
    matched gt id is tested for truth), and a crowd gt may be matched by
    several detections: the port keeps both, as the JAX package does."""
    j = np.random.default_rng(5).uniform(50, 200, (14, 2))
    kp = np.concatenate([j, np.full((14, 1), 2.0)], 1).reshape(-1).tolist()
    gt = {"images": [{"id": 1}, {"id": 2}], "annotations": [
        {"id": 0, "image_id": 1, "iscrowd": 0, "num_keypoints": 14,
         "area": 5000.0, "bbox": [40, 40, 170, 170], "keypoints": kp},
        {"id": 7, "image_id": 2, "iscrowd": 1, "num_keypoints": 14,
         "area": 5000.0, "bbox": [40, 40, 170, 170], "keypoints": kp}]}
    dets = [{"image_id": i, "score": s, "keypoints": kp}
            for i, s in ((1, 1.0), (2, 1.0), (2, 0.5))]
    want = JaxEvaluator(gt, dets).run(verbose=False)
    got = KeypointEvaluator(gt, dets).run(verbose=False)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 0.0                     # id 0: no true positive


def test_coco_facade_equals_jax(tmp_path, capsys):
    gt, dets = _scenario(6)
    path = tmp_path / "gt.json"
    path.write_text(json.dumps(gt))
    out = []
    for coco_cls, eval_cls in ((COCO, COCOeval), (JaxCOCO, JaxCOCOeval)):
        coco = coco_cls(str(path))
        res = coco.loadRes([dict(d) for d in dets])
        ev = eval_cls(coco, res, "keypoints")
        ev.evaluate()
        ev.accumulate()
        ev.summarize()
        out.append((ev.stats, coco.getImgIds(), res.getAnnIds(imgIds=[3])))
    np.testing.assert_array_equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]
    with pytest.raises(NotImplementedError):
        COCOeval(COCO(str(path)), COCO(str(path)), "bbox")


def _port_golden_eval(tmp_path, sequence_eval: bool):
    from hupr_tpu_torch.engine.runner import Runner

    cfg = port_cfg_of(_golden_workspace(tmp_path))
    cfg.TEST.sequenceEval = sequence_eval
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        args = argparse.Namespace(seed=0, dir="golden", visDir="none",
                                  eval=True, sampling_ratio=1,
                                  keypoints=False)
        runner = Runner(args, cfg, device="cpu")
        runner.load_model_weight("model_best")
        ap = runner.eval(visualization=False)
        with open("logs/golden/test_results.json") as fp:
            dts = json.load(fp)
        stats = KeypointEvaluator(runner.test_set.gt_dataset,
                                  dts).run(verbose=False)
        assert float(stats[0]) == ap
        return stats
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("sequence_eval,golden", [
    (True, GOLDEN_SEQ), (False, GOLDEN_CLASSIC)], ids=["seq", "classic"])
def test_runner_reproduces_golden_ap(tmp_path, sequence_eval, golden):
    """The golden workspace's reference-format model_best.pth through the
    port's Runner (cube files -> eval -> keypoint JSON -> OKS). Held at
    the protocol tier, PROTOCOL_ATOL 5e-3: the goldens' exact tier pins
    XLA's float bits, which PyTorch's kernels need not reproduce."""
    stats = _port_golden_eval(tmp_path, sequence_eval)
    assert 0.0 < stats[0] < 1.0
    np.testing.assert_allclose(stats, golden, rtol=0, atol=PROTOCOL_ATOL)


def test_plot_human_pose_equals_jax(tmp_path, monkeypatch):
    """The port's visualization writes the JAX package's PNGs, pixel for
    pixel (260x260 canvas, the skeleton, the box)."""
    import cv2

    from hupr_tpu.utils.plot import plot_human_pose as jax_plot
    from hupr_tpu_torch.config import config_from_dict
    from hupr_tpu_torch.utils.plot import plot_human_pose

    rng = np.random.default_rng(8)
    joints = rng.uniform(10, 240, (3, 14, 2))
    ids = np.array([100001, 100002, 200005])
    bbox = rng.uniform(10, 100, (3, 4))
    cfg = config_from_dict({})
    # both look for the RGB frames at the relative ../frames: keep that
    # lookup inside tmp_path
    (tmp_path / "run").mkdir()
    monkeypatch.chdir(tmp_path / "run")
    plot_human_pose(joints, cfg, str(tmp_path / "port"), ids, bbox=bbox)
    jax_plot(joints, cfg, str(tmp_path / "jax"), ids, bbox=bbox)
    for i in ids:
        name = os.path.join("single_%d" % (i // 100000),
                            "%09d.png" % (i % 10000))
        a = cv2.imread(str(tmp_path / "port" / name))
        b = cv2.imread(str(tmp_path / "jax" / name))
        assert a.shape == (260, 260, 3) and a.any()
        np.testing.assert_array_equal(a, b)
