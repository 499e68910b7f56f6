"""Typed configuration for the port (counterpart of
``deeplio_tpu/config/schema.py``).

Reads the same YAML keys as the JAX package (hyphenated or underscored)
for the settings the port computes: the three model archs (``deepio``,
``deeplo``, ``deeplio``) with their blocks, the projection with every
backend (``pallas-ring``, ``pallas``, ``ring``, ``sort``,
``sort-sentinel``), the channel stack with its surface normals and its
normalization, the window (``sequence-size``,
``combinations``, ``window-stride``), yaw augmentation, the KITTI
``root-path`` and split lists (``{date: [drive | {drive, start, end},
...]}`` or ``{sequences: ["00", ...]}``), the synthetic drives and their
world, the segmentation labels of PointSeg pretraining (``labels-path``,
``label-map``, ``labels-num-classes``), the LiDAR towers (PointSeg with
its ``classic``, ``cheap``, ``stride`` and ``stride-fold`` pools, its
``classic`` and ``pair-split`` stems and its ``encoder+decoder`` part,
``lidar-feat-simple-0`` and ``-1``, and the port's own
``lidar-feat-darknet``, RangeNet++'s Darknet-21 or -53 encoder, and
``lidar-feat-rangevit``, RangeViT's convolutional stem and ViT encoder,
which the JAX package does not have), the IMU and odometry nets (LSTM or
GRU, the IMU one also bidirectional, or the FC nets), their dropout and
warm starts, the slot-aligned projection
routes (``kernel-aligned: auto | on | trust | halves``) and host slot
binning (``slot-bin``), the pose loss, the optimizer (Adam, AdamW or
SGD with momentum) with its plateau schedule, ``param-dtype`` (parsed
and never read, as in the JAX package), and the ``train`` block of the training loop
with its projection cache, device-resident dataset and data parallelism.
Every setting the JAX package parses is ported; a malformed one raises
``ConfigError`` (a ``ValueError``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

CHANNEL_ORDER = ("x", "y", "z", "remission", "depth", "normals")

# KITTI odometry sequence -> (date, raw drive, first frame, last frame)
ODOMETRY_SEQUENCES: Dict[str, Tuple[str, int, int, int]] = {
    "00": ("2011_10_03", 27, 0, 4540),
    "01": ("2011_10_03", 42, 0, 1100),
    "02": ("2011_10_03", 34, 0, 4660),
    "04": ("2011_09_30", 16, 0, 270),
    "05": ("2011_09_30", 18, 0, 2760),
    "06": ("2011_09_30", 20, 0, 1100),
    "07": ("2011_09_30", 27, 0, 1100),
    "08": ("2011_09_30", 28, 1100, 5170),
    "09": ("2011_09_30", 33, 0, 1590),
    "10": ("2011_09_30", 34, 0, 1200),
}

BACKENDS = ("pallas-ring", "pallas", "ring", "sort", "sort-sentinel")
POOLS = ("classic", "cheap", "stride", "stride-fold")
STEMS = ("classic", "pair-split", "s2d", "s2d-pre", "factorized")
# the stems the stride-fold pool can fold: the (maybe input-split)
# strided 3x3
FOLD_STEMS = ("classic", "pair-split")
FIRES = ("classic", "fused", "mixed")
OPTIMIZERS = ("adam", "sgd")
LIDAR_NETS = ("lidar-feat-pointseg", "lidar-feat-simple-0",
              "lidar-feat-simple-1", "lidar-feat-darknet",
              "lidar-feat-rangevit")
# Darknet depths of RangeNet++ (models/darknet.py)
DARKNET_LAYERS = (21, 53)
ARCHS = ("deepio", "deeplo", "deeplio")
IMU_NETS = ("imu-feat-rnn", "imu-feat-fc")
ODOM_NETS = ("odom-feat-rnn", "odom-feat-fc")
RNN_CELLS = ("lstm", "gru")


class ConfigError(ValueError):
    pass


def _get(d: Dict[str, Any], key: str, default=None):
    """Fetch a key accepting both hyphenated (YAML) and underscored names."""
    for k in (key, key.replace("-", "_"), key.replace("_", "-")):
        if k in d:
            return d[k]
    return default


def _require(d: Dict[str, Any], key: str, ctx: str):
    v = _get(d, key, None)
    if v is None:
        raise ConfigError(f"missing required config key '{key}' in {ctx}")
    return v


def _rate(v, what: str) -> float:
    r = float(v)
    if not 0.0 <= r < 1.0:
        raise ConfigError(f"{what} must be in [0, 1), got {r}")
    return r


def num_channels(channels) -> int:
    """Image channels of a channel list: ``normals`` counts 3."""
    return sum(3 if c == "normals" else 1 for c in channels)


@dataclass(frozen=True)
class ProjectionConfig:
    """Spherical range-image projection (SqueezeSeg convention)."""
    height: int = 64
    width: int = 1024
    fov_up_deg: float = 3.0
    fov_down_deg: float = -25.0
    max_points: int = 131072
    # The pallas and pallas-ring routes always carry packed-f16 payloads,
    # so ``packed`` does not change their result (as in the JAX package);
    # ``ring``, ``sort`` and ``sort-sentinel`` carry packed-f16 words when
    # it is set, exact float32 channels when not.
    packed: bool = False
    # pallas-ring and ring: ring-ordered scans (ops/projection_ring.py);
    # pallas, sort and sort-sentinel: scans in any order
    # (ops/projection_scatter.py).
    backend: str = "sort"
    # scans per chunk of the JAX package's batched projector: it only
    # schedules the work (the winners are the same), so the port projects
    # a batch in one launch whatever it is
    chunk: int = 16
    # ``kernel-spb`` and ``kernel-packed`` only choose how the TPU kernel
    # schedules and encodes its work; its results are bit-identical either
    # way. They are parsed and validated here and have no effect in the
    # port, whose CUDA kernel has one schedule.
    kernel_spb: int = 1
    kernel_packed: str = "auto"
    # pallas-ring only: ``off`` runs the ring kernel; ``auto`` and ``on``
    # take the slot-aligned route when every valid point sits on its
    # slot's pixel and the ring kernel otherwise; ``trust`` takes it
    # unchecked; ``halves`` takes the dual-half route (ops/projection.py)
    kernel_aligned: str = "off"


def _split(block) -> Dict[str, List]:
    """A split: ``{date: [drive | {drive, start, end}, ...]}``, or
    ``{sequences: ["00", ...]}`` through ``ODOMETRY_SEQUENCES``."""
    block = block or {}
    seqs = _get(block, "sequences", None)
    if seqs is None:
        return {str(k): list(v) for k, v in block.items()}
    out: Dict[str, List] = {}
    for s in seqs:
        s = f"{int(s):02d}" if str(s).isdigit() else str(s)
        if s not in ODOMETRY_SEQUENCES:
            raise ConfigError(f"unknown KITTI odometry sequence '{s}'")
        date, drive, start, end = ODOMETRY_SEQUENCES[s]
        out.setdefault(date, []).append(
            {"drive": drive, "start": start, "end": end})
    return out


@dataclass(frozen=True)
class DatasetConfig:
    # KITTI raw devkit root and the drives of each split, {date: [drive |
    # {drive, start, end}, ...]} (data/dataset.py::build_drives)
    root_path: str = ""
    train: Dict[str, List] = field(default_factory=dict)
    validation: Dict[str, List] = field(default_factory=dict)
    test: Dict[str, List] = field(default_factory=dict)
    channels: Tuple[str, ...] = ("x", "y", "z", "remission", "depth")
    projection: ProjectionConfig = field(default_factory=ProjectionConfig)
    mean: Tuple[float, ...] = ()
    std: Tuple[float, ...] = ()
    max_imu_per_pair: int = 16
    # temporal window: S frames, the P (i, j) frame pairs (default: the
    # consecutive ones) and the stride between window starts in a drive
    sequence_size: int = 2
    combinations: Tuple[Tuple[int, int], ...] = ()
    window_stride: int = 1
    # training only: one random global yaw per window, applied inside the
    # step before the projection (ops/augment.py)
    augment_yaw: bool = False
    # synthetic drives instead of KITTI (data/dataset.py::build_drives):
    # frames per drive (eval drives: synthetic_eval_frames, 0 = the same)
    # and drives per split (train seeds 0.., validation 100.., test 200..)
    synthetic: bool = False
    synthetic_frames: int = 64
    synthetic_eval_frames: int = 0
    synthetic_train_drives: int = 2
    synthetic_eval_drives: int = 1
    synthetic_world: str = "origin"
    # bin every KITTI scan on the host onto the slot grid the aligned
    # routes read (data/synthetic.py::slot_bin_scan): each pixel keeps its
    # best max_points / (H * W) points, the winner first
    slot_bin: bool = False
    # SemanticKITTI-format per-point labels for PointSeg pretraining
    # (train/pretrain.py): <labels-path>/<drive name>/<frame>.label, one
    # uint32 a point, the low 16 bits the semantic id; empty = geometric
    # pseudo-labels. ``label-map`` remaps raw ids to train ids (ids not
    # listed map to 0, unlabeled).
    labels_path: str = ""
    label_map: Dict[int, int] = field(default_factory=dict)
    labels_num_classes: int = 20

    @property
    def num_image_channels(self) -> int:
        return num_channels(self.channels)

    @property
    def effective_combinations(self) -> Tuple[Tuple[int, int], ...]:
        if self.combinations:
            return self.combinations
        return tuple((i, i + 1) for i in range(self.sequence_size - 1))

    @property
    def num_pairs(self) -> int:
        return len(self.effective_combinations)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "DatasetConfig":
        proj = ProjectionConfig(
            height=int(_get(d, "image-height", 64)),
            width=int(_get(d, "image-width", 1024)),
            fov_up_deg=float(_get(d, "fov-up", 3.0)),
            fov_down_deg=float(_get(d, "fov-down", -25.0)),
            max_points=int(_get(d, "max-points", 131072)),
            packed=bool(_get(d, "packed", False)),
            backend=str(_get(d, "backend", "sort")),
            chunk=int(_get(d, "projection-chunk", 16)),
            kernel_spb=int(_get(d, "kernel-spb", 1)),
            kernel_packed=str(_get(d, "kernel-packed", "auto")),
            kernel_aligned=str(_get(d, "kernel-aligned", "off")),
        )
        if proj.kernel_packed not in ("auto", "on", "off"):
            raise ConfigError(f"kernel-packed must be auto|on|off, got "
                              f"{proj.kernel_packed!r}")
        if proj.kernel_spb < 1:
            raise ConfigError(f"kernel-spb must be >= 1, got "
                              f"{proj.kernel_spb}")
        if proj.kernel_aligned not in ("auto", "on", "off", "trust",
                                       "halves"):
            raise ConfigError(
                f"kernel-aligned must be auto|on|off|trust|halves, got "
                f"{proj.kernel_aligned!r}")
        if proj.backend not in BACKENDS:
            raise ConfigError(f"projection backend must be "
                              f"{'|'.join(BACKENDS)}, got {proj.backend!r}")
        slot_bin = bool(_get(d, "slot-bin", False))
        if slot_bin and proj.max_points % (proj.height * proj.width):
            raise ConfigError(
                f"slot-bin needs max-points ({proj.max_points}) to be a "
                f"multiple of H*W ({proj.height * proj.width})")
        if proj.kernel_aligned in ("trust", "halves"):
            # no runtime check on these routes: the data must sit on the
            # slot grid by construction
            if not bool(_get(d, "synthetic", False)) and not slot_bin:
                raise ConfigError(
                    f"kernel-aligned={proj.kernel_aligned} requires "
                    "grid-aligned data by construction: set "
                    "datasets.synthetic or datasets.slot-bin (or use "
                    "kernel-aligned=auto, which keeps the runtime "
                    "predicate)")
            if bool(_get(d, "augment-yaw", False)):
                # the rotation moves points off their azimuth slots
                raise ConfigError(
                    f"kernel-aligned={proj.kernel_aligned} is "
                    "incompatible with augment-yaw (rotation breaks the "
                    "slot grid); use kernel-aligned=auto or off")
        world = str(_get(d, "synthetic-world", "origin"))
        if world not in ("origin", "corridor"):
            raise ConfigError(f"synthetic-world must be origin|corridor, "
                              f"got {world!r}")
        channels = tuple(_get(d, "channels",
                              ["x", "y", "z", "remission", "depth"]))
        for c in channels:
            if c not in CHANNEL_ORDER:
                raise ConfigError(f"unknown projection channel '{c}'")
        mean = tuple(float(x) for x in (_get(d, "mean", []) or []))
        std = tuple(float(x) for x in (_get(d, "std", []) or []))
        if bool(mean) != bool(std):
            raise ConfigError(
                "normalization requires both mean and std (or neither)")
        for name, vals in (("mean", mean), ("std", std)):
            if vals and len(vals) != num_channels(channels):
                raise ConfigError(f"normalization {name} has {len(vals)} "
                                  f"entries for {num_channels(channels)} "
                                  f"channels (normals count 3)")
        if any(v == 0 for v in std):
            raise ConfigError("normalization std contains a zero")
        seq = int(_get(d, "sequence-size", 2))
        combos = tuple(tuple(int(i) for i in c)
                       for c in (_get(d, "combinations", None) or ()))
        for c in combos:
            if len(c) != 2 or not all(0 <= i < seq for i in c):
                raise ConfigError(
                    f"combination {c} out of range for sequence-size {seq} "
                    f"(frame indices are 0..{seq - 1})")
        kitti = _get(d, "kitti", {}) or {}
        return DatasetConfig(
            root_path=str(_get(kitti, "root-path", _get(d, "root-path", ""))),
            train=_split(_get(kitti, "train", {})),
            validation=_split(_get(kitti, "validation", {})),
            test=_split(_get(kitti, "test", {})),
            channels=channels,
            projection=proj,
            mean=mean,
            std=std,
            max_imu_per_pair=int(_get(d, "max-imu-per-pair", 16)),
            sequence_size=seq,
            combinations=combos,
            window_stride=int(_get(d, "window-stride", 1)),
            augment_yaw=bool(_get(d, "augment-yaw", False)),
            synthetic=bool(_get(d, "synthetic", False)),
            synthetic_frames=int(_get(d, "synthetic-frames", 64)),
            synthetic_eval_frames=int(_get(d, "synthetic-eval-frames", 0)),
            synthetic_train_drives=int(_get(d, "synthetic-train-drives", 2)),
            synthetic_eval_drives=int(_get(d, "synthetic-eval-drives", 1)),
            synthetic_world=world,
            slot_bin=slot_bin,
            labels_path=str(_get(d, "labels-path", "")),
            label_map={int(k): int(v)
                       for k, v in (_get(d, "label-map", {}) or {}).items()},
            labels_num_classes=int(_get(d, "labels-num-classes", 20)),
        )


@dataclass(frozen=True)
class LidarFeatConfig:
    name: str = "lidar-feat-pointseg"
    # encoder: the bottleneck map feeds the tower's head; encoder+decoder
    # (also ``bypass: true``, as in the JAX package) runs the PointSeg
    # decoder and feeds its per-pixel map
    part: str = "encoder"
    bypass: bool = False
    feature_size: int = 512
    base_channels: int = 64    # the simple towers' first width
    h_stride: int = 1
    w_stride: int = 2
    se: bool = True
    el_squeeze: int = 0
    # pair-split: the stem conv takes frames i and j apart, its kernel
    # split along the input channels (models/blocks.py::SplitInputConv);
    # s2d: space-to-depth of the (h, w) block, then a 2x2 conv at stride
    # 1; s2d-pre: the same conv on input the data side laid out so;
    # factorized: the stem per frame, each pair summed on its output grid
    # (models/blocks.py::FactorizedStem; the model takes ``frames``)
    stem: str = "classic"
    # fused: each Fire one 3x3 ConvBN to expand1 + expand3 channels;
    # mixed: fused for the four shallow Fires, classic for the deep ones
    fire: str = "classic"
    # classic: 3x3 max-pools at stride (1, 2) after the stem and the first
    # two Fire stages; cheap: (1, 2) windows; stride: no pools, the
    # stages' entry Fires carry the stride; stride-fold: stride with the
    # first entry's stride folded into the stem (models/pointseg.py)
    pool: str = "classic"
    dropout: float = 0.0       # after the tower's Dense, training only
    # lidar-feat-darknet: the Darknet depth (21 or 53) and the channel
    # dropout after each of its five stages, training only
    layers: int = 53
    stage_dropout: float = 0.01
    # lidar-feat-rangevit (models/rangevit.py): the ViT's token width,
    # blocks, heads and MLP ratio, the (rows, columns) of a patch, the
    # stem's widths (its context blocks', then its last block's) and the
    # largest drop-path rate (the last block's), training only
    embed_dim: int = 384
    depth: int = 12
    heads: int = 6
    mlp_ratio: int = 4
    patch: Tuple[int, int] = (2, 8)
    stem_width: int = 32
    stem_hidden: int = 256
    drop_path: float = 0.1
    # warm start of the PointSeg encoder from a snapshot
    # (train/checkpoint.py::load_pointseg_backbone)
    pretrained: bool = False
    model_path: str = ""

    @staticmethod
    def from_dict(name: str, d: Dict[str, Any]) -> "LidarFeatConfig":
        if name not in LIDAR_NETS:
            raise ConfigError(f"lidar-feat-net must be "
                              f"{'|'.join(LIDAR_NETS)}, got {name!r}")
        bypass = bool(_get(d, "bypass", False))
        part = str(_get(d, "part",
                        "encoder+decoder" if bypass else "encoder"))
        stem = str(_get(d, "stem", "classic"))
        fire = str(_get(d, "fire", "classic"))
        pool = str(_get(d, "pool", "classic"))
        if part not in ("encoder", "encoder+decoder"):
            raise ConfigError(
                f"part must be encoder|encoder+decoder, got {part!r}")
        if stem not in STEMS:
            raise ConfigError(
                "stem must be classic|pair-split|s2d|s2d-pre|factorized, "
                f"got {stem!r}")
        if stem == "pair-split" and part != "encoder":
            raise ConfigError(
                "stem=pair-split is encoder-only (the seg decoder reads "
                "the concatenated pair input the split never builds)")
        if fire not in FIRES:
            raise ConfigError(
                f"fire must be classic|fused|mixed, got {fire!r}")
        if pool not in POOLS:
            raise ConfigError(f"pool must be classic|cheap|stride|"
                              f"stride-fold, got {pool!r}")
        if pool == "stride-fold" and (part != "encoder"
                                      or stem not in FOLD_STEMS):
            # the fold is exact only while the skips are unused and the
            # stem is the (maybe input-split) strided 3x3
            raise ConfigError(
                "pool=stride-fold requires part=encoder and a classic or "
                f"pair-split stem (got part={part!r}, stem={stem!r})")
        layers = int(_get(d, "layers", 53))
        if layers not in DARKNET_LAYERS:
            raise ConfigError(f"darknet layers must be "
                              f"{'|'.join(map(str, DARKNET_LAYERS))}, got "
                              f"{layers}")
        vit = {k: int(_get(d, k, v)) for k, v in (
            ("embed-dim", 384), ("depth", 12), ("heads", 6),
            ("mlp-ratio", 4), ("stem-width", 32), ("stem-hidden", 256))}
        patch = tuple(int(v) for v in _get(d, "patch", (2, 8)))
        if min(vit.values()) < 1 or len(patch) != 2 or min(patch) < 1:
            raise ConfigError(f"rangevit sizes must be positive, got "
                              f"{vit} and patch {list(patch)}")
        if vit["embed-dim"] % vit["heads"]:
            raise ConfigError(f"rangevit heads ({vit['heads']}) must divide "
                              f"embed-dim ({vit['embed-dim']})")
        return LidarFeatConfig(
            name=name,
            part=part,
            bypass=bypass,
            feature_size=int(_get(d, "feature-size", 512)),
            base_channels=int(_get(d, "base-channels", 64)),
            h_stride=int(_get(d, "h-stride", 1)),
            w_stride=int(_get(d, "w-stride", 2)),
            se=bool(_get(d, "se", True)),
            el_squeeze=int(_get(d, "el-squeeze", 0)),
            stem=stem,
            fire=fire,
            pool=pool,
            dropout=_rate(_get(d, "dropout", 0.0), "lidar dropout"),
            layers=layers,
            stage_dropout=_rate(_get(d, "stage-dropout", 0.01),
                                "darknet stage dropout"),
            embed_dim=vit["embed-dim"],
            depth=vit["depth"],
            heads=vit["heads"],
            mlp_ratio=vit["mlp-ratio"],
            patch=patch,
            stem_width=vit["stem-width"],
            stem_hidden=vit["stem-hidden"],
            drop_path=_rate(_get(d, "drop-path", 0.1), "rangevit drop-path"),
            pretrained=bool(_get(d, "pretrained", False)),
            model_path=str(_get(d, "model-path", "")),
        )


def _net_checks(kind: str, name: str, names: Tuple[str, ...],
                d: Dict[str, Any]) -> str:
    """The net's name among ``names`` and its cell among ``RNN_CELLS``
    (the JAX package reads the cell for the FC nets too, and ignores
    it); returns the cell."""
    if name not in names:
        raise ConfigError(f"{kind} must be {'|'.join(names)}, got {name!r}")
    cell = str(_get(d, "type", "lstm"))
    if cell not in RNN_CELLS:
        raise ConfigError(f"{kind} type must be {'|'.join(RNN_CELLS)}, "
                          f"got {cell!r}")
    return cell


@dataclass(frozen=True)
class ImuFeatConfig:
    # imu-feat-rnn: a masked LSTM or GRU, optionally bidirectional, over
    # each pair's IMU window (its final state, both directions'
    # concatenated); imu-feat-fc: the zero-masked window flattened through
    # num-layers Dense + ReLU
    name: str = "imu-feat-rnn"
    rnn_type: str = "lstm"
    input_size: int = 6
    hidden_size: int = 128
    num_layers: int = 2
    bidirectional: bool = False

    @property
    def feature_size(self) -> int:
        """Width of the net's output feature."""
        if self.name == "imu-feat-rnn" and self.bidirectional:
            return 2 * self.hidden_size
        return self.hidden_size

    @staticmethod
    def from_dict(name: str, d: Dict[str, Any]) -> "ImuFeatConfig":
        return ImuFeatConfig(
            name=name,
            rnn_type=_net_checks("imu-feat-net", name, IMU_NETS, d),
            input_size=int(_get(d, "input-size", 6)),
            hidden_size=int(_get(d, "hidden-size", 128)),
            num_layers=int(_get(d, "num-layers", 2)),
            bidirectional=bool(_get(d, "bidirectional", False)),
        )


@dataclass(frozen=True)
class FusionConfig:
    kind: str = "soft"  # soft | hard

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "FusionConfig":
        kind = str(_get(d, "type", "soft"))
        if kind not in ("soft", "hard"):
            raise ConfigError(f"fusion-net type must be soft|hard, got {kind}")
        return FusionConfig(kind=kind)


@dataclass(frozen=True)
class OdomFeatConfig:
    # odom-feat-rnn: a masked LSTM or GRU over the window's pairs, one
    # direction (the JAX package reads no ``bidirectional`` here);
    # odom-feat-fc: num-layers Dense + ReLU per pair
    name: str = "odom-feat-rnn"
    rnn_type: str = "lstm"
    hidden_size: int = 256
    num_layers: int = 2

    @staticmethod
    def from_dict(name: str, d: Dict[str, Any]) -> "OdomFeatConfig":
        return OdomFeatConfig(
            name=name,
            rnn_type=_net_checks("odom-feat-net", name, ODOM_NETS, d),
            hidden_size=int(_get(d, "hidden-size", 256)),
            num_layers=int(_get(d, "num-layers", 2)),
        )


@dataclass(frozen=True)
class ModelConfig:
    arch: str = "deeplio"      # deepio | deeplo | deeplio
    lidar: Optional[LidarFeatConfig] = None
    imu: Optional[ImuFeatConfig] = None
    fusion: Optional[FusionConfig] = None
    odom: OdomFeatConfig = field(default_factory=OdomFeatConfig)
    compute_dtype: str = "bfloat16"
    # parsed as the JAX package parses it, and never read: JAX passes it
    # to no module, so its parameters are float32 whatever it says, and
    # so are the port's
    param_dtype: str = "float32"
    dropout: float = 0.25      # before the pose heads, training only
    # whole-model warm start from a parameter snapshot
    # (train/checkpoint.py::load_params)
    pretrained: bool = False
    model_path: str = ""

    @property
    def uses_lidar(self) -> bool:
        return self.arch in ("deeplo", "deeplio")

    @property
    def uses_imu(self) -> bool:
        return self.arch in ("deepio", "deeplio")


@dataclass(frozen=True)
class LossConfig:
    """Pose loss: ``hws`` (fixed beta) or ``lws`` (learned sx, sq)."""
    active: str = "lws"
    x_norm: str = "l2"         # l1 | l2
    q_norm: str = "l2"         # l1 | l2 | geodesic
    beta: float = 1120.0
    sx: float = 0.0
    sq: float = -2.5

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "LossConfig":
        hws = _get(d, "hws", {}) or {}
        lws = _get(d, "lws", {}) or {}
        cfg = LossConfig(
            active=str(_get(d, "active", _get(d, "type", "lws"))).lower(),
            x_norm=str(_get(d, "x-norm", "l2")),
            q_norm=str(_get(d, "q-norm", "l2")),
            beta=float(_get(hws, "beta", _get(d, "beta", 1120.0))),
            sx=float(_get(lws, "sx", _get(d, "sx", 0.0))),
            sq=float(_get(lws, "sq", _get(d, "sq", -2.5))),
        )
        for what, got, allowed in (("loss", cfg.active, ("hws", "lws")),
                                   ("x-norm", cfg.x_norm, ("l1", "l2")),
                                   ("q-norm", cfg.q_norm,
                                    ("l1", "l2", "geodesic"))):
            if got not in allowed:
                raise ConfigError(f"{what} must be {'|'.join(allowed)}, "
                                  f"got {got!r}")
        return cfg


@dataclass(frozen=True)
class OptimConfig:
    """Adam (AdamW with ``weight-decay``) or SGD with momentum, a
    learning-rate schedule and optax's global-norm gradient clip."""
    name: str = "adam"         # adam | sgd
    lr: float = 1e-4
    # adam: optax's adamw, the decay inside the learning-rate scale; sgd:
    # ``wd * p`` added to the clipped gradient before the momentum trace
    weight_decay: float = 0.0
    momentum: float = 0.9      # sgd only
    scheduler: str = "none"    # none | step | cosine | plateau
    step_size: int = 20        # epochs per decay (step) or decay length
    gamma: float = 0.5
    warmup_steps: int = 0
    grad_clip: float = 0.0     # 0 = off
    # the clip's global norm over one flattened gradient vector instead of
    # per-tensor partial sums (the JAX package's raveled update; both
    # optimizers are elementwise, so only the norm's rounding order differs)
    flat_update: bool = False
    # plateau (torch ReduceLROnPlateau semantics, applied by the trainer
    # after each validation): lr *= gamma after ``patience`` validations
    # without an improvement of more than ``threshold``, never below min_lr
    patience: int = 3
    min_lr: float = 0.0
    threshold: float = 1e-4

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "OptimConfig":
        sched = _get(d, "scheduler", {}) or {}
        if isinstance(sched, str):
            sched = {"name": sched}
        cfg = OptimConfig(
            name=str(_get(d, "name", _get(d, "type", "adam"))).lower(),
            lr=float(_get(d, "lr", 1e-4)),
            weight_decay=float(_get(d, "weight-decay", 0.0)),
            momentum=float(_get(d, "momentum", 0.9)),
            scheduler=str(_get(sched, "name", "none")).lower(),
            step_size=int(_get(sched, "step-size", 20)),
            gamma=float(_get(sched, "gamma", 0.5)),
            warmup_steps=int(_get(sched, "warmup-steps", 0)),
            grad_clip=float(_get(d, "grad-clip", 0.0)),
            flat_update=bool(_get(d, "flat-update", False)),
            patience=int(_get(sched, "patience", 3)),
            min_lr=float(_get(sched, "min-lr", 0.0)),
            threshold=float(_get(sched, "threshold", 1e-4)),
        )
        if cfg.name not in OPTIMIZERS:
            raise ConfigError(f"optimizer must be adam|sgd, got {cfg.name!r}")
        if cfg.scheduler not in ("none", "step", "cosine", "plateau"):
            raise ConfigError(f"scheduler must be none|step|cosine|plateau, "
                              f"got {cfg.scheduler!r}")
        if cfg.scheduler == "plateau" and cfg.warmup_steps > 0:
            # the controller rewrites a constant learning rate, which a
            # step-indexed warm-up cannot share
            raise ConfigError(
                "scheduler=plateau is incompatible with warmup-steps (the "
                "plateau controller rewrites a constant lr)")
        return cfg


@dataclass(frozen=True)
class TrainConfig:
    """The ``train`` block: the batch, the loop's cadence and its
    checkpoints."""
    batch_size: int = 8
    epochs: int = 50
    seed: int = 42
    log_every: int = 25
    eval_every_epochs: int = 1
    checkpoint_dir: str = "checkpoints"
    checkpoint_every_steps: int = 500
    keep_checkpoints: int = 3
    # data-parallel size: the processes of a torch.distributed run, one
    # device each (-1 = all of them; 1 in a plain single process)
    data_parallel: int = -1
    prefetch: int = 2
    # optimizer steps per group: k sequential steps, saves only at group
    # ends, the epoch tail shorter than k dropped (as in the JAX package,
    # whose k-step program is bit-identical to k steps)
    steps_per_call: int = 1
    # project every frame once into f16 memmaps under <workdir>/proj_cache
    # and train on the cached images (data/proj_cache.py); incompatible
    # with augment-yaw, which rotates the raw points
    cache_projections: bool = False
    # stage the split's scans on the card once and gather each batch there
    # (data/device_bank.py): the same batches, no per-step copy
    device_dataset: bool = False

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "TrainConfig":
        return TrainConfig(
            batch_size=int(_get(d, "batch-size", 8)),
            epochs=int(_get(d, "epochs", 50)),
            seed=int(_get(d, "seed", 42)),
            log_every=int(_get(d, "log-every", 25)),
            eval_every_epochs=int(_get(d, "eval-every-epochs", 1)),
            checkpoint_dir=str(_get(d, "checkpoint-dir", "checkpoints")),
            checkpoint_every_steps=int(_get(d, "checkpoint-every-steps",
                                            500)),
            keep_checkpoints=int(_get(d, "keep-checkpoints", 3)),
            data_parallel=int(_get(d, "data-parallel", -1)),
            prefetch=int(_get(d, "prefetch", 2)),
            steps_per_call=int(_get(d, "steps-per-call", 1)),
            cache_projections=bool(_get(d, "cache-projections", False)),
            device_dataset=bool(_get(d, "device-dataset", False)))


def _net_name(block: Dict[str, Any], key: str, default: str) -> str:
    spec = _get(block, key, default)
    if isinstance(spec, str):
        return spec
    return str(_get(spec or {}, "name", default))


@dataclass(frozen=True)
class Config:
    datasets: DatasetConfig
    model: ModelConfig
    loss: LossConfig = field(default_factory=LossConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "Config":
        datasets = DatasetConfig.from_dict(_get(d, "datasets", {}) or {})
        arch = str(_get(d, "arch", "deeplio")).lower()
        if arch not in ARCHS:
            raise ConfigError(
                f"arch must be deepio|deeplo|deeplio, got {arch}")
        block: Dict[str, Any] = _get(d, arch, {}) or {}
        # the blocks each arch has, as in the JAX package: DeepIO no LiDAR
        # net, DeepLO no IMU net, only DeepLIO a fusion
        lidar = imu = fusion = None
        if arch in ("deeplo", "deeplio"):
            lspec = _require(block, "lidar-feat-net", f"'{arch}' block")
            lname = str(lspec if isinstance(lspec, str)
                        else _get(lspec or {}, "name", "lidar-feat-pointseg"))
            lidar = LidarFeatConfig.from_dict(lname, _get(d, lname, {}) or {})
        if arch in ("deepio", "deeplio"):
            iname = _net_name(block, "imu-feat-net", "imu-feat-rnn")
            imu = ImuFeatConfig.from_dict(iname, _get(d, iname, {}) or {})
        if arch == "deeplio":
            if _get(block, "fusion-net") is None:
                raise ConfigError("arch deeplio requires a fusion-net block")
            fusion = FusionConfig.from_dict(_get(block, "fusion-net", {})
                                            or {})
        oname = _net_name(block, "odom-feat-net", "odom-feat-rnn")
        compute = str(_get(d, "compute-dtype", "bfloat16"))
        if compute not in ("bfloat16", "float32", "float16"):
            raise ConfigError(f"compute-dtype must be bfloat16|float32|"
                              f"float16, got {compute!r}")
        model = ModelConfig(
            arch=arch,
            lidar=lidar,
            imu=imu,
            fusion=fusion,
            odom=OdomFeatConfig.from_dict(oname, _get(d, oname, {}) or {}),
            compute_dtype=compute,
            param_dtype=str(_get(d, "param-dtype", "float32")),
            dropout=_rate(_get(block, "dropout", 0.25), "model dropout"),
            pretrained=bool(_get(block, "pretrained", False)),
            model_path=str(_get(block, "model-path", "")),
        )
        if lidar is not None and lidar.name == "lidar-feat-rangevit":
            proj = datasets.projection
            ph, pw = lidar.patch
            if proj.height % ph or proj.width % pw:
                raise ConfigError(
                    f"rangevit patch {ph}x{pw} must divide the image "
                    f"{proj.height}x{proj.width}")
        train = TrainConfig.from_dict(_get(d, "train", {}) or {})
        if train.cache_projections and datasets.augment_yaw:
            raise ConfigError(
                "cache-projections is incompatible with augment-yaw: the "
                "yaw augmentation rotates raw points, which cached images "
                "bypass. Disable one of them.")
        return Config(
            datasets=datasets, model=model,
            loss=LossConfig.from_dict(_get(d, "losses", {}) or {}),
            optim=OptimConfig.from_dict(_get(d, "optimizer", {}) or {}),
            train=train)

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)
