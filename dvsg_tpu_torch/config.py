"""Configuration dataclasses of the PyTorch port.

An own copy of ``ModelConfig``/``StabilizeConfig``/``TrainConfig`` with the
same field names, defaults and checks as the JAX package's. A checkpoint's
``__config__`` record (a ``ModelConfig``) loads into either package, and
``config_to_json`` writes the record the other reads. ``io_threads`` (the
host I/O pool size) is carried as the JAX package declares it, and read by
nothing in either; so is ``mesh_shape`` (the data-parallel mesh,
``parallel/mesh.py::make_mesh``). A JAX ``StabilizeConfig`` record that
names ``warp_impl`` (the reference's warp switch; the port has one warp
route) is refused by ``stabilize_config_from_dict``. The chunk size T is a
plain default (16);
resolution-keyed chunk bands are measured per device and are not carried
over.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Motion-estimation CNN hyperparameters.

    The CNN consumes a sliding temporal window of ``window`` frames, resized
    to ``model_size``, and regresses a coarse ``grid_size`` control grid of
    normalized warp offsets, bilinearly upsampled to the output resolution.
    """

    window: int = 5                       # temporal window length N
    model_size: Tuple[int, int] = (256, 256)   # (H, W) the CNN sees
    base_features: int = 32               # encoder width at full model res
    levels: int = 4                       # stride-2 encoder stages
    blocks_per_level: int = 2             # residual conv blocks per stage
    grid_size: Tuple[int, int] = (16, 16)  # coarse control grid (gh, gw)
    max_offset: float = 0.2               # max |offset| in normalized units
    channels: int = 3                     # input channels per frame
    dtype: str = "float32"                # compute dtype: float32 | bfloat16
    arch: str = "corr"                    # corr (cost-volume) | stacked
                                          # | pwc (PWC-Net)
    corr_radius: int = 3                  # cost-volume displacement radius
                                          # (in coarse-grid cells; pwc: in
                                          # each level's pixels, 4 as
                                          # published)

    def __post_init__(self):
        gh, gw = self.grid_size
        mh, mw = self.model_size
        if mh % gh or mw % gw:
            raise ValueError(
                f"model_size {self.model_size} must be divisible by "
                f"grid_size {self.grid_size}"
            )
        if self.arch == "pwc":
            # Six stride-2 levels, and the head reads level 4 and flow₂
            # pooled 4 x 4: the grid is the model size over 16.
            if mh % 64 or mw % 64:
                raise ValueError(f"arch 'pwc' needs model_size divisible "
                                 f"by 64, got {self.model_size}")
            if (gh, gw) != (mh // 16, mw // 16):
                raise ValueError(f"arch 'pwc' needs grid_size = model_size"
                                 f" / 16, got {self.grid_size} for "
                                 f"{self.model_size}")
            if self.dtype != "float32":
                raise ValueError(f"arch 'pwc' runs in float32 only, got "
                                 f"dtype {self.dtype!r}")


@dataclasses.dataclass(frozen=True)
class StabilizeConfig:
    """End-to-end stabilization pipeline configuration."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    chunk_frames: int = 16        # frames per device step (temporal chunk T)
    border_crop: float = 0.0      # stabilized-border crop fraction, zoomed
                                  # into the warp
    strength: float = 1.0         # scale on the predicted correction:
                                  # 0 = passthrough, 1 = full, (1, 2] =
                                  # overcorrection
    mesh_shape: Tuple[int, ...] = (1,)   # data-parallel mesh ("data",)
    io_threads: int = 4           # host decode/encode thread pool size
    queue_depth: int = 3          # staging ring depth of the overlapped
                                  # stream loop (decode, compute, encode)
    path_smooth: int = 0          # cross-chunk camera-path smoothing
                                  # horizon in frames (an EMA over the
                                  # measured camera path); 0 = off
    path_smooth_max: float = 0.05  # clamp on the path correction per frame
                                   # and component (x/y normalized units,
                                   # rotation in radians, log-scale)
    path_smooth_rotation: bool = True  # also measure and smooth rotation
    path_smooth_scale: bool = True     # also measure and smooth zoom
    path_smooth_conf: float = 2.0  # confidence gate: deltas of frame pairs
                                   # whose correlation peak-to-second-peak
                                   # ratio is below it are zeroed; 0 = off
    path_smooth_lag: int = 0      # fixed-lag smoothing lookahead D in
                                  # frames (output delayed D frames, a
                                  # zero-phase FIR); 0 = causal EMA
    path_smooth_cut: float = 1.5  # scene-cut gate (<= path_smooth_conf):
                                  # below it the EMA state restarts; 0 = off

    def __post_init__(self):
        if self.chunk_frames < 1:
            raise ValueError(
                f"chunk_frames must be >= 1, got {self.chunk_frames}")
        if not 0.0 <= self.strength <= 2.0:
            raise ValueError(
                f"strength must be in [0, 2], got {self.strength}")
        if self.queue_depth < 1:
            raise ValueError(
                f"queue_depth must be >= 1, got {self.queue_depth}")
        if self.path_smooth < 0:
            raise ValueError(
                f"path_smooth must be >= 0, got {self.path_smooth}")
        if self.path_smooth > 0 and self.model.window < 2:
            # The smoother reads inter-frame deltas out of the carried
            # halo; window 1 carries no halo.
            raise ValueError("path_smooth requires model.window >= 2")
        if not 0.0 <= self.path_smooth_max <= 0.25:
            raise ValueError(f"path_smooth_max must be in [0, 0.25], got "
                             f"{self.path_smooth_max}")
        if self.path_smooth_lag < 0 or self.path_smooth_lag > 64:
            raise ValueError(
                f"path_smooth_lag must be in [0, 64], got "
                f"{self.path_smooth_lag}")
        if self.path_smooth_lag > 0:
            if self.path_smooth <= 0:
                raise ValueError(
                    "path_smooth_lag needs path_smooth > 0 (the lag is a "
                    "lookahead for the path smoother)")
            if self.path_smooth_lag > self.chunk_frames:
                # The lag step carries exactly D frames between chunks.
                raise ValueError(
                    f"path_smooth_lag ({self.path_smooth_lag}) must be "
                    f"<= chunk_frames ({self.chunk_frames})")
        if self.path_smooth_conf < 0 or not (
                0.0 <= self.path_smooth_cut <= max(self.path_smooth_conf,
                                                   0.0)):
            # A cut must also be gated (its delta zeroed), so the cut
            # threshold cannot exceed the gate threshold.
            raise ValueError(
                f"need 0 <= path_smooth_cut <= path_smooth_conf, got "
                f"cut={self.path_smooth_cut} conf={self.path_smooth_conf}")
        # border_crop >= 0.5 flips the sign of the identity-grid scale
        # (1 - 2*crop): x would decrease with pixel index.
        if not 0.0 <= self.border_crop < 0.5:
            raise ValueError(
                f"border_crop must be in [0, 0.5), got {self.border_crop}")

    def replace(self, **kw) -> "StabilizeConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Self-supervised training configuration (synthetic-jitter fixtures)."""

    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    batch_size: int = 8
    learning_rate: float = 2e-4
    weight_decay: float = 1e-5
    steps: int = 1000
    warmup_steps: int = 100
    pixel_weight: float = 1.0
    offset_weight: float = 10.0   # direct regression to the known
                                  # window-relative stabilizing offsets
    smooth_weight: float = 0.1    # temporal smoothness between frame grids
    reg_weight: float = 0.001     # offset magnitude regularizer
    seed: int = 0
    checkpoint_every: int = 200


def _to_jsonable(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {k: _to_jsonable(v)
                for k, v in dataclasses.asdict(obj).items()}
    if isinstance(obj, tuple):
        return list(obj)
    return obj


def config_to_json(cfg: Any) -> str:
    return json.dumps(_to_jsonable(cfg), indent=2, sort_keys=True)


def _tuplify(d: dict, keys=("model_size", "grid_size", "mesh_shape")
             ) -> dict:
    out = dict(d)
    for k in keys:
        if k in out and isinstance(out[k], list):
            out[k] = tuple(out[k])
    return out


def model_config_from_dict(d: dict) -> ModelConfig:
    return ModelConfig(**_tuplify(d))


def stabilize_config_from_dict(d: dict) -> StabilizeConfig:
    d = _tuplify(d)
    if isinstance(d.get("model"), dict):
        d["model"] = model_config_from_dict(d["model"])
    return StabilizeConfig(**d)
