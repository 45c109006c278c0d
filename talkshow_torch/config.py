"""Typed, validated configuration for all stages.

A copy of talkshow_tpu/config.py (pure dataclasses, held equal to it by
tests/test_torch_train.py), so the port reads the same files without
importing the JAX package.  Replaces the reference's schema-less
JSON->attr-object loader (trainer/config.py:10-22) with dataclasses +
validation, while remaining able to ingest the reference's JSON config
files (config/*.json) unchanged.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


@dataclass
class PoseConfig:
    normalization: bool = False
    convert_to_6d: bool = False
    norm_method: str = "all"
    augmentation: bool = False
    generate_length: int = 88
    pre_pose_length: int = 0
    pose_dim: int = 99
    expression: bool = True

    def __post_init__(self):
        if self.generate_length % 4 != 0:
            raise ValueError("generate_length must be divisible by 4 (VQ stride)")


@dataclass
class AudConfig:
    feat_method: str = "mfcc"
    aud_feat_dim: int = 64
    aud_feat_win_size: int | None = None
    context_info: bool = False


@dataclass
class DataConfig:
    data_root: str = ""
    pklname: str = "_3d_mfcc.pkl"
    whole_video: bool = False
    pose: PoseConfig = field(default_factory=PoseConfig)
    aud: AudConfig = field(default_factory=AudConfig)


@dataclass
class ModelConfig:
    model_type: str = "body"
    model_name: str = "s2g_body_pixel"
    composition: bool = True
    code_num: int = 2048
    bh_model: bool = True
    audio_opt: str = "Adam"          # "AudioOpt" in reference JSON
    encoder_choice: str = "mfcc"
    gan: bool = False
    vq_path: str = ""
    # architecture knobs (fixed in the reference, explicit here)
    vq_embedding_dim: int = 64
    vq_num_hiddens: int = 1024
    vq_residual_layers: int = 2
    pixelcnn_dim: int = 256
    pixelcnn_layers: int = 15
    num_speakers: int = 4

    def __post_init__(self):
        known = {"s2g_face", "s2g_body_vq", "s2g_body_pixel", "s2g_body_ae", "s2g_LS3DCG"}
        if self.model_name not in known:
            raise ValueError(f"unknown model_name {self.model_name!r}; known: {sorted(known)}")


@dataclass
class TrainConfig:
    epochs: int = 100
    max_gradient_norm: float = 5.0
    generator_learning_rate: float = 1e-4
    discriminator_learning_rate: float = 1e-4
    batch_size: int = 128
    keypoint_loss_weight: float = 1.0
    gan_loss_weight: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        if self.generator_learning_rate <= 0:
            raise ValueError("learning rate must be positive")


@dataclass
class LogConfig:
    save_every: int = 50
    print_every: int = 200
    name: str = "run"


@dataclass
class ParallelConfig:
    """Device-mesh layout. dp*tp must equal the number of devices used.
    The port reads it from a config file's "parallel" entry ({"dp": .., "tp":
    ..}; the reference files have none, so 1 x 1) and trains on dp*tp ranks
    (`torchrun --nproc_per_node dp*tp -m talkshow_torch.train ...`)."""
    dp: int = 1     # data-parallel axis size
    tp: int = 1     # tensor-parallel axis size (wide conv/ffn channels)


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    log: LogConfig = field(default_factory=LogConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    smplx_npz_path: str = ""
    extra_joint_path: str = ""
    dataset_load_mode: str = "json"

    # ----- reference-JSON ingestion -------------------------------------
    @classmethod
    def from_reference_json(cls, path: str) -> "Config":
        """Load one of the reference config/*.json files."""
        with open(path) as f:
            raw = json.load(f)
        return cls.from_reference_dict(raw)

    @classmethod
    def from_reference_dict(cls, raw: dict[str, Any]) -> "Config":
        d = raw.get("Data", {})
        pose = {k: v for k, v in d.get("pose", {}).items() if k in _fields(PoseConfig)}
        aud = {k: v for k, v in d.get("aud", {}).items() if k in _fields(AudConfig)}
        m = raw.get("Model", {})
        t = raw.get("Train", {})
        lr = t.get("learning_rate", {})
        w = t.get("weights", {})
        dl = raw.get("DataLoader", {})
        lg = raw.get("Log", {})
        par = raw.get("parallel", {})
        return cls(
            data=DataConfig(
                data_root=d.get("data_root", ""),
                pklname=d.get("pklname", "_3d_mfcc.pkl"),
                whole_video=d.get("whole_video", False),
                pose=PoseConfig(**pose),
                aud=AudConfig(**aud),
            ),
            model=ModelConfig(
                model_type=m.get("model_type", "body"),
                model_name=m.get("model_name", "s2g_body_pixel"),
                composition=m.get("composition", True),
                code_num=m.get("code_num", 2048),
                bh_model=m.get("bh_model", True),
                audio_opt=m.get("AudioOpt", "Adam"),
                encoder_choice=m.get("encoder_choice", "mfcc"),
                gan=m.get("gan", False),
                vq_path=m.get("vq_path", ""),
            ),
            train=TrainConfig(
                epochs=t.get("epochs", 100),
                max_gradient_norm=t.get("max_gradient_norm", 5.0),
                generator_learning_rate=float(lr.get("generator_learning_rate", 1e-4)),
                discriminator_learning_rate=float(lr.get("discriminator_learning_rate", 1e-4)),
                batch_size=dl.get("batch_size", 128),
                keypoint_loss_weight=float(w.get("keypoint_loss_weight", 1.0)),
                gan_loss_weight=float(w.get("gan_loss_weight", 1.0)),
            ),
            log=LogConfig(
                save_every=lg.get("save_every", 50),
                print_every=lg.get("print_every", 200),
                name=lg.get("name", "run"),
            ),
            parallel=ParallelConfig(dp=par.get("dp", 1), tp=par.get("tp", 1)),
            smplx_npz_path=raw.get("smplx_npz_path", ""),
            extra_joint_path=raw.get("extra_joint_path", ""),
            dataset_load_mode=raw.get("dataset_load_mode", "json"),
        )

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    def to_reference_dict(self) -> dict[str, Any]:
        """The reference JSON layout (config/*.json) of this config: what
        `from_reference_dict` reads back to an equal Config (the
        architecture knobs, which the reference files do not carry, keep
        their defaults).  The full schedule writes its stage configs with it."""
        m, t, lg = self.model, self.train, self.log
        return {
            "Data": {"data_root": self.data.data_root, "pklname": self.data.pklname,
                     "whole_video": self.data.whole_video,
                     "pose": dataclasses.asdict(self.data.pose),
                     "aud": dataclasses.asdict(self.data.aud)},
            "Model": {"model_type": m.model_type, "model_name": m.model_name,
                      "composition": m.composition, "code_num": m.code_num,
                      "bh_model": m.bh_model, "AudioOpt": m.audio_opt,
                      "encoder_choice": m.encoder_choice, "gan": m.gan, "vq_path": m.vq_path},
            "Train": {"epochs": t.epochs, "max_gradient_norm": t.max_gradient_norm,
                      "learning_rate": {
                          "generator_learning_rate": t.generator_learning_rate,
                          "discriminator_learning_rate": t.discriminator_learning_rate},
                      "weights": {"keypoint_loss_weight": t.keypoint_loss_weight,
                                  "gan_loss_weight": t.gan_loss_weight}},
            "DataLoader": {"batch_size": t.batch_size},
            "Log": {"save_every": lg.save_every, "print_every": lg.print_every,
                    "name": lg.name},
            "parallel": dataclasses.asdict(self.parallel),
            "smplx_npz_path": self.smplx_npz_path,
            "extra_joint_path": self.extra_joint_path,
            "dataset_load_mode": self.dataset_load_mode,
        }


def _fields(cls) -> set[str]:
    return {f.name for f in dataclasses.fields(cls)}


# Canonical per-stage configs (mirror of config/*.json in the reference).
def face_config() -> Config:
    c = Config()
    c.model = ModelConfig(model_type="face", model_name="s2g_face",
                          encoder_choice="faceformer", audio_opt="SGD")
    c.data.whole_video = True
    c.data.pklname = "_3d_wv2.pkl"
    c.train.batch_size = 1
    c.log.name = "face"
    return c


def body_vq_config() -> Config:
    c = Config()
    c.model = ModelConfig(model_type="body", model_name="s2g_body_vq")
    c.log.name = "body-vq"
    return c


def body_pixel_config() -> Config:
    c = Config()
    c.model = ModelConfig(model_type="body", model_name="s2g_body_pixel")
    c.log.name = "body-pixel"
    return c


def ls3dcg_config() -> Config:
    c = Config()
    c.model = ModelConfig(model_type="body", model_name="s2g_LS3DCG", composition=False)
    c.dataset_load_mode = "pickle"
    c.log.name = "LS3DCG"
    return c
