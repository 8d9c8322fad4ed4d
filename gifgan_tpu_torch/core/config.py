"""Typed run configuration: the six dataclasses of gifgan_tpu's
core/config.py, copied field for field.

save_config/load_config write and read the same JSON as the JAX package
(`{"__class__": name, field: value, ...}`, indent 2, sorted keys), so a run
directory's params.json loads in either package.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Optional


@dataclass(frozen=True)
class DCGANConfig:
    """Image DCGAN architecture (reference: models/recurrent_z/model.py:12-74).

    output_size must be divisible by 16 (four stride-2 stages).
    """

    output_size: int = 64          # square image resolution
    c_dim: int = 3                 # channels
    z_dim: int = 100               # latent size
    gf_dim: int = 64               # generator base filters
    df_dim: int = 64               # discriminator base filters
    noise_std: float = 0.0         # instance noise std (model.py:82,106)
    # Compute dtype for conv/matmul activations. Params stay float32.
    compute_dtype: str = "float32"
    # Phase-packed execution of the two c_dim-channel end layers (D input
    # conv space-to-depth, G output deconv subpixel): the same function as
    # the plain layers, equal up to accumulation order. The flagship
    # configuration turns it on.
    packed_c3: bool = False

    def __post_init__(self):
        # unconditional nets need 4 stride-2 stages (%16); the conditional
        # (MNIST, 28x28) variant only has 2 (%4) — checked at init time.
        if self.output_size % 4 != 0:
            raise ValueError(
                f"output_size must be divisible by 4, got {self.output_size}")


@dataclass(frozen=True)
class VidGANConfig:
    """Nested recurrent-z video GAN (reference: z_model_lib.py:15-48, z_model.py:22-65)."""

    z_input_size: int = 120        # video latent ("face" 0:100 + "expression" 100:120)
    z_output_size: int = 100       # per-frame image latent
    vid_length: int = 16           # frames per clip
    hidden_dim: int = 512          # MLP width of the z-sequence generator
    d_filters: int = 256           # video discriminator conv3d channels
    image_noise_std: float = 0.0
    activation_noise_std: float = 0.0
    first_frame_loss_scalar: float = 0.0
    image_gan: DCGANConfig = field(default_factory=DCGANConfig)
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class RecurrentImageConfig:
    """Frame-conditioned recurrent (conv-LSTM) video GAN
    (reference: models/recurrent_image/rnn_test/recurrent_DCGAN.py:156-298)."""

    image_size: int = 64
    c_dim: int = 3
    seq_length: int = 16           # predicted steps (input has seq_length+1 frames)
    base_filters: int = 32
    lstm_units: int = 100
    num_lstm_layers: int = 1       # multi-layer variant: >1 (multi-layer_recurrent_DCGAN.py)
    lstm_dropout: float = 0.0      # shared-conv+dropout variant used 0.2 drop (keep 0.8)
    share_disc_conv: bool = False  # G encoder reuses D conv filters (shared_conv variant)
    # DEVIATION from the reference's pure-adversarial loss
    # (recurrent_DCGAN.py:294-298): optional L1 next-frame pixel term. At 0
    # (default) the objective is the reference's; >0 makes the predictions
    # beat the copy-last-frame baseline at practical budgets (round-1 finding:
    # the pure GAN loss does not, docs/E2E_RESULTS.md).
    pixel_loss_scalar: float = 0.0
    # DEVIATION: predict the next-frame DELTA (pred = frame + decoded delta)
    # instead of the frame. Off by default (reference architecture); with
    # pixel_loss_scalar > 0 this beats the copy-last-frame baseline at small
    # budgets because "zero delta" IS the copy baseline and any learned
    # motion improves on it.
    residual_prediction: bool = False
    # DEVIATION: curriculum — G's adversarial term is zero-weighted until
    # this step (pixel-only warm-up; D still trains throughout so it is
    # ready when the joint phase starts). 0 = adversarial from step 0.
    adversarial_after_steps: int = 0
    # DEVIATION: weight on G's adversarial term once active (the reference
    # hard-codes 1.0, recurrent_DCGAN.py:294-298). Round-2 measured full
    # weight trading held-out MAE 0.0095 -> 0.0255 after the warm-up
    # (docs/E2E_RESULTS.md); this is the tuning lever for that trade.
    adversarial_loss_scalar: float = 1.0
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class TrainConfig:
    """GAN training hyperparameters (reference: main.py:12-17, model.py:153-156,226-239,
    z_model.py:30-39)."""

    batch_size: int = 64
    learning_rate: float = 2e-4
    # TTUR: discriminator-specific learning rate (None = learning_rate).
    # Not in the reference (it shares 2e-4); added because D saturates on
    # easy corpora (endurance run: d_loss -> 1e-9 by step 10k) and slowing
    # D is the standard two-time-scale fix alongside instance noise.
    d_learning_rate: Optional[float] = None
    beta1: float = 0.5
    disc_updates: int = 1
    gen_updates: int = 2           # "run g_optim twice" (model.py:236-239)
    epochs: int = 25
    sample_every: int = 100        # sample-grid cadence (model.py:250)
    checkpoint_every: int = 500    # (model.py:265)
    max_checkpoints_to_keep: int = 5
    train_img_gen: bool = False    # unfreeze nested image G (z_model.py:46)
    train_img_disc: bool = False   # unfreeze nested image D (z_model.py:47)
    seed: int = 0
    run_dir: str = "runs/default"
    # Mesh: data-parallel axis size 0 means "use all devices".
    data_parallel: int = 0


@dataclass(frozen=True)
class InvertConfig:
    """Latent-optimization (GAN inversion) weights and schedule
    (reference: discriminator_activation_optimizer.py:20-55, run_webcam_demo:17-43)."""

    steps: int = 1200
    learning_rate: float = 0.05
    lr_decay_every: int = 1000     # halve LR every N steps
    lr_decay_factor: float = 0.5
    pixel_l1: float = 1.0
    pixel_l2: float = 0.0
    activation_l1: float = 0.3
    activation_l2: float = 0.0
    generator_loss: float = 0.0
    use_train_mode_activations: bool = False  # D_activations vs D_activations_inf
    batch_size: int = 16


@dataclass(frozen=True)
class TrackConfig:
    """Face track pipeline parameters (reference: data_collection/track_faces.py:32-69)."""

    min_jaccard: float = 0.60
    max_skip: int = 6
    min_frame_count: int = 20
    min_total_detections: int = 10
    target_size: int = 256
    scale_factor: float = 1.1      # cascade pyramid scale
    min_neighbors: int = 5
    max_tracks: int = 32           # static capacity for padded/masked formulation
    max_detections_per_frame: int = 16
    max_frames: int = 256
    # stabilizer
    max_corners: int = 200
    corner_quality: float = 0.01
    corner_min_distance: float = 8.0
    lk_window: int = 15
    lk_levels: int = 3
    # Backend names are the JAX package's, kept so params.json files stay
    # interchangeable. "auto" and "mxu" select the device flow kernels,
    # "jax" the gather flow on the device (track/flow_gather.py); the host
    # OpenCV flow runs only when "cv2" is asked for by name.
    flow_backend: str = "auto"
    detector_backend: str = "auto"


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        d = {"__class__": type(obj).__name__}
        for f in dataclasses.fields(obj):
            d[f.name] = _to_jsonable(getattr(obj, f.name))
        return d
    if isinstance(obj, (list, tuple)):
        return [_to_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jsonable(v) for k, v in obj.items()}
    return obj


_CONFIG_CLASSES = {}


def _register_all():
    for cls in (DCGANConfig, VidGANConfig, RecurrentImageConfig, TrainConfig,
                InvertConfig, TrackConfig):
        _CONFIG_CLASSES[cls.__name__] = cls


_register_all()


def _from_jsonable(obj: Any) -> Any:
    if isinstance(obj, dict) and "__class__" in obj:
        cls = _CONFIG_CLASSES[obj["__class__"]]
        kwargs = {k: _from_jsonable(v) for k, v in obj.items() if k != "__class__"}
        return cls(**kwargs)
    if isinstance(obj, list):
        return [_from_jsonable(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _from_jsonable(v) for k, v in obj.items()}
    return obj


def save_config(config: Any, path: str) -> None:
    """Serialize a config dataclass (tree) to JSON at `path`."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(_to_jsonable(config), f, indent=2, sort_keys=True)


def load_config(path: str) -> Any:
    with open(path) as f:
        return _from_jsonable(json.load(f))
