"""Config system: the YAML schema of the JAX package's config, as dataclasses.

Same sections, fields, defaults and `BASE:` include rule as
`hupr_tpu/config.py`, kept as a copy so that importing the port pulls in
neither JAX nor the JAX package. PyYAML is imported inside the loader only:
the serving path builds its config from these dataclasses and runs where
PyYAML is not installed.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import warnings
from dataclasses import dataclass, field
from typing import List


@dataclass
class DatasetConfig:
    upsamplingFactor: int = 4
    duration: int = 600
    heatmapSize: int = 64
    imgSize: int = 256
    rangeSize: int = 64
    azimuthSize: int = 64
    elevationSize: int = 8
    numKeypoints: int = 14
    numFrames: int = 8          # chirps per frame consumed by the model
    numGroupFrames: int = 8     # temporal window of frames
    numChirps: int = 16         # chirps stored per frame (center-16 of 64)
    dataDir: str = "data/HuPR"
    adcDir: str = ""            # root of raw capture files; empty = disabled
    # Field overrides for ops.dsp.RadarParams; empty = the IWR1843 defaults,
    # which produce the flagship 64x64x8 cube geometry.
    adcParams: dict = field(default_factory=dict)
    testName: List[int] = field(default_factory=list)
    valName: List[int] = field(default_factory=list)
    trainName: List[int] = field(default_factory=list)
    idxToJoints: List[str] = field(default_factory=lambda: [
        "R_Hip", "R_Knee", "R_Ankle", "L_Hip", "L_Knee",
        "L_Ankle", "Neck", "Head", "L_Shoulder", "L_Elbow",
        "L_Wrist", "R_Shoulder", "R_Elbow", "R_Wrist",
    ])

    def split_names(self, phase: str) -> List[int]:
        """The sequence ids of `phase` (the reference reads them with
        eval('cfg.DATASET.' + phase + 'Name'))."""
        if phase not in ("train", "val", "test"):
            raise ValueError(f"Invalid phase: {phase}")
        return {"train": self.trainName, "val": self.valName,
                "test": self.testName}[phase]

    def radar_params(self):
        """RadarParams for the raw-ADC paths, validated against the cube
        geometry this config declares."""
        from hupr_tpu_torch.ops.dsp import RadarParams
        rp = RadarParams(**self.adcParams)
        if rp.num_angle_bins != self.azimuthSize \
                or rp.num_angle_bins != self.rangeSize \
                or rp.num_kept_chirps != self.numChirps \
                or rp.num_ele_bins != self.elevationSize:
            raise ValueError(
                f"DATASET.adcParams geometry (angle {rp.num_angle_bins}, "
                f"chirps {rp.num_kept_chirps}, elev {rp.num_ele_bins}) does "
                f"not produce this config's cube shape ({self.rangeSize}, "
                f"{self.azimuthSize}, {self.numChirps}, "
                f"{self.elevationSize})")
        return rp


@dataclass
class ModelConfig:
    numFilters: int = 32
    computeDtype: str = "float32"   # "float32" | "bfloat16" conv/matmul compute
    remat: bool = False
    # "xla" eager | "pallas" Hopper kernels | "pallas_bf16" the kernels with
    # bfloat16 operands and float32 accumulation
    attention: str = "xla"


@dataclass
class TrainingConfig:
    batchSize: int = 20
    epochs: int = 200
    lr: float = 1e-4
    warmupEpoch: int = -1
    warmupGrowth: float = 1.005
    lrDecay: float = 0.999
    lrDecayIter: int = 2000
    lossDecay: float = -1
    optimizer: str = "adam"
    weightDecay: float = 1e-4
    chunkTrain: bool = False
    chunkSource: str = "cubes"


@dataclass
class TestConfig:
    batchSize: int = 32
    plotImgDir: str = ""
    sequenceEval: bool = True
    sequenceSource: str = "cubes"


@dataclass
class SetupConfig:
    numWorkers: int = 4
    transferDtype: str = "float32"


@dataclass
class Config:
    DATASET: DatasetConfig = field(default_factory=DatasetConfig)
    MODEL: ModelConfig = field(default_factory=ModelConfig)
    TRAINING: TrainingConfig = field(default_factory=TrainingConfig)
    TEST: TestConfig = field(default_factory=TestConfig)
    SETUP: SetupConfig = field(default_factory=SetupConfig)


_SECTIONS = {"DATASET": DatasetConfig, "MODEL": ModelConfig,
             "TRAINING": TrainingConfig, "TEST": TestConfig,
             "SETUP": SetupConfig}


def _build(dc_type, d: dict, section: str):
    """Build a dataclass from a dict; unknown keys are warned about and
    ignored, so a typo'd key cannot silently run with the default."""
    names = {f.name for f in dataclasses.fields(dc_type)}
    unknown = sorted(set(d) - names)
    if unknown:
        warnings.warn(
            f"config section {section}: unknown key(s) {unknown} ignored "
            f"(valid keys: {sorted(names)})", stacklevel=3)
    return dc_type(**{k: v for k, v in d.items() if k in names})


def config_from_dict(d: dict) -> Config:
    unknown = sorted(set(d) - set(_SECTIONS))
    if unknown:
        warnings.warn(f"config: unknown section(s) {unknown} ignored "
                      f"(valid sections: {list(_SECTIONS)})", stacklevel=2)
    return Config(**{name: _build(dc, d.get(name, {}), name)
                     for name, dc in _SECTIONS.items()})


def _deep_merge(base: dict, override: dict) -> dict:
    """Override wins; dict values merge recursively."""
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


def load_config_dict(path: str, _seen=()) -> dict:
    """YAML -> dict, honoring a top-level `BASE: <file>` include resolved
    relative to the including file (chains allowed, cycles rejected)."""
    import yaml

    real = os.path.realpath(path)
    if real in _seen:
        raise ValueError(f"config BASE include cycle at {path}")
    with open(path, "r") as f:
        d = yaml.safe_load(f) or {}
    base = d.pop("BASE", None)
    if base:
        if not os.path.isabs(base):
            base = os.path.join(os.path.dirname(path) or ".", base)
        d = _deep_merge(load_config_dict(base, _seen + (real,)), d)
    return d


def load_config(path: str) -> Config:
    return config_from_dict(load_config_dict(path))


def build_arg_parser() -> argparse.ArgumentParser:
    """The reference's 8 CLI flags (its main.py:17-30), with --gpuIDs a
    plain string (the reference evaluates it, and only tests it for
    truth)."""
    p = argparse.ArgumentParser(description="HuPR on PyTorch and CUDA")
    p.add_argument("--seed", type=int, default=0, metavar="S",
                   help="random seed (default: 0)")
    p.add_argument("--dir", type=str, default="test", metavar="B",
                   help="directory of saving/loading")
    p.add_argument("--visDir", type=str, default="none", metavar="B",
                   help="directory of visualization")
    p.add_argument("--config", type=str, default="mscsa_prgcn.yaml",
                   metavar="B", help="config file name under ./config/")
    p.add_argument("--gpuIDs", default="0", type=str,
                   help="accepted for the reference CLI's sake (ignored: "
                        "the port runs on one card)")
    p.add_argument("--eval", action="store_true")
    p.add_argument("-sr", "--sampling_ratio", type=int, default=1,
                   help="sampling ratio for training/test (default: 1)")
    p.add_argument("--keypoints", action="store_true",
                   help="print out the APs of all keypoints")
    return p


def resolve_config_path(name: str) -> str:
    """The reference loads './config/<name>'; a path that exists as given
    is taken as it is."""
    if os.path.exists(name):
        return name
    return os.path.join(".", "config", name)


def flagship_serving_config() -> Config:
    """`config/mscsa_prgcn_tpu.yaml` built without PyYAML: every field the
    serving path reads has the YAML's value (the dataset split lists, which
    serving never reads, are left empty)."""
    return Config(MODEL=ModelConfig(numFilters=32, attention="pallas"))


def flagship_training_config() -> Config:
    """`config/mscsa_prgcn_tpu.yaml`'s model and training recipe built
    without PyYAML: batch 20, Adam at lr 1e-4 with weight decay 1e-4, lr
    decay 0.999 every 2000 steps, no loss annealing. The split lists, which
    the train step never reads, are left empty."""
    cfg = flagship_serving_config()
    cfg.TRAINING = TrainingConfig(
        batchSize=20, epochs=200, lr=1e-4, warmupEpoch=-1,
        warmupGrowth=1.005, lrDecay=0.999, lrDecayIter=2000, lossDecay=-1,
        optimizer="adam", weightDecay=1e-4)
    return cfg


def fast_serving_config() -> Config:
    """`config/mscsa_prgcn_tpu_fast.yaml` built without PyYAML: the
    flagship with MODEL.computeDtype bfloat16, and the YAML's DATASET.adcDir,
    TEST.sequenceSource adc (the Runner's raw-ADC sequence eval) and
    SETUP.transferDtype bfloat16 (the cube planes' wire format). The split
    lists are left empty."""
    cfg = flagship_serving_config()
    cfg.DATASET.adcDir = "preprocessing/raw_data/iwr1843/HuPR"
    cfg.MODEL = ModelConfig(numFilters=32, attention="pallas",
                            computeDtype="bfloat16")
    cfg.TEST = TestConfig(sequenceSource="adc")
    cfg.SETUP = SetupConfig(transferDtype="bfloat16")
    return cfg


def fast_training_config() -> Config:
    """`config/mscsa_prgcn_tpu_fast.yaml`'s model and training recipe built
    without PyYAML: the flagship recipe (batch 20, Adam at lr 1e-4) with
    bfloat16 compute, chunk-mode training from the raw captures
    (TRAINING.chunkTrain, chunkSource adc) and raw-ADC sequence eval, as
    the Runner runs them (engine/chunk_train.py, engine/seq_eval.py)."""
    cfg = fast_serving_config()
    cfg.TRAINING = flagship_training_config().TRAINING
    cfg.TRAINING.chunkTrain = True
    cfg.TRAINING.chunkSource = "adc"
    return cfg
