"""Typed configuration with an INI-compatible front-end.

The port's own copy of `fullycnnspeechenhancement_tpu/config.py`: the same
dataclasses, the same fields and the same `load_ini_config`, so both
packages read the same `work/*/cfg/*.cfg` files into equal values.  The
port imports nothing of the JAX package, so it keeps this copy.

The reference drives everything from `configparser` INI files.  This module
keeps that surface (same sections, same key names) but normalises it into
typed dataclasses so the rest of the package never touches raw string
lookups.

Known reference quirks handled here (SURVEY.md Appendix A.1/A.2):
  * ``[data] windows`` and ``[data] nfft`` are parsed by no reference code
    path -- analysis nfft is hardcoded to 256 and the window is always
    Hamming.  We honour the keys, but default to the *behavioural* values
    (hamming / 256) and warn when an INI file asks for something the
    reference would silently ignore.

Every field has a consumer in the port: `[training] data_parallel` runs
the Trainer as one rank of a data-parallel group (`parallel/dp.py`), the
`[data] use_device_cache` fields select the GPU-resident corpus cache.
"""

from __future__ import annotations

import configparser
import dataclasses
import logging
from typing import Optional

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class DSPConfig:
    """Analysis/synthesis chain parameters (SURVEY.md Appendix B)."""

    sample_rate: int = 8000
    window_ms: float = 32.0
    stride_ms: float = 16.0
    # Analysis rFFT size.  The reference hardcodes 256
    # (data_utils/data_loader.py:59) regardless of the cfg `nfft` key.
    analysis_nfft: int = 256
    # Synthesis irFFT size.  The reference's AudioReBuild defaults to 512 and
    # is always constructed with no args (model_utils/utils.py:94,
    # trainer.py:253) -- i.e. a 512-point irfft over 129-bin spectra, cropped
    # to the first frame_length samples.  Not a faithful inverse; kept as the
    # parity path.
    synthesis_nfft: int = 512
    window_name: str = "hamming"
    preemphasis: float = 0.97

    @property
    def frame_length(self) -> int:
        return int(round(self.window_ms / 1000.0 * self.sample_rate))

    @property
    def frame_step(self) -> int:
        return int(round(self.stride_ms / 1000.0 * self.sample_rate))

    @property
    def num_bins(self) -> int:
        return self.analysis_nfft // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frame count for an utterance, matching the reference's formula
        ``ceil(|L - frame_length| / frame_step + 1)``
        (data_utils/audio_feature.py:70)."""
        import math

        return int(
            math.ceil(abs(num_samples - self.frame_length) / self.frame_step + 1)
        )

    def padded_samples(self, num_frames: int) -> int:
        """Samples needed so that `num_frames` frames can be gathered."""
        return (num_frames - 1) * self.frame_step + self.frame_length


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # "RCED" in the reference ([model] net_arch); kept for config parity.
    net_arch: str = "RCED"
    # FullyCNN | FullyCNNV2 | FullyCNNV3 (reference [model] net_work).
    net_work: str = "FullyCNNV2"
    feature_dim: int = 129
    # Compute dtype for conv stacks.  float32 matches the reference;
    # bfloat16 is the fast path (params stay f32, activations bf16) of the
    # train and eval steps.  The engine and the fused stack serve float32
    # whatever it says, as in the JAX package.
    compute_dtype: str = "float32"
    # Serve inference through the fused inner-stack kernel
    # (ops/rced_stack.py, CUDA source ops/csrc/rced_stack.cu): one
    # device-memory read and one write for the inner conv layers instead
    # of a round trip per layer, with layer 1 and the projection in the
    # kernels of ops/csrc/rced_edges.cu.  Float32 operands and
    # accumulation.
    fused_inference: bool = False
    # Run the train step's conv stack through the freq-to-depth "blocked"
    # forward (models/blocked.py): an exact reparametrization that folds
    # `blocked_fb` frequency bins into channels.  Same math and params;
    # only the float32 reduction order differs.
    blocked_compute: bool = False
    blocked_fb: int = 8
    # With blocked_compute: the inner (1, k) layers' weight gradient runs
    # in the hand-written CUDA kernel (ops/blocked_dw.py, CUDA source
    # ops/csrc/blocked_dw.cu) instead of cuDNN's autograd.  The name is
    # the JAX package's, whose kernel was a Pallas one.
    dw_pallas: bool = False


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 5
    batch_size: int = 2
    lr: float = 1.5e-3
    warmup_steps: int = 10000
    continue_train: bool = True
    checkpoints_path: str = "checkpoints"
    base_checkpoint_file: str = ""
    num_iter_print: int = 100
    log_dir: str = "checkpoints/log"
    # Also the seed of the inference engine's random init when no
    # checkpoint is configured.
    seed: int = 0
    # Loss over zero-padded frames, divided by *configured* batch size --
    # faithful to trainer.py:143-147 / Appendix A.12-13.  Set mask_loss=True
    # for the corrected masked-loss mode (documented departure).
    mask_loss: bool = False
    # Validation cadence: reference validates every 5 epochs
    # (trainer.py:242-243).
    valid_every_epochs: int = 5
    max_checkpoints_to_keep: int = 10
    data_parallel: int = 1
    # Optimizer steps per dispatch: the trainer stacks K same-bucket
    # batches and runs them in one `make_multi_step` call.
    steps_per_call: int = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_manifest_path: str = ""
    val_manifest_path: str = ""
    test_manifest_path: str = ""
    train_noise_manifest: Optional[str] = None
    val_noise_manifest: Optional[str] = None
    test_noise_manifest: Optional[str] = None
    snr: float = 0.0
    min_duration: float = 0.4
    max_duration: float = float("inf")
    # Where `InferenceEngine.denoise` writes `<name>_de.wav`.
    audio_save_path: str = "denoise"
    num_workers: int = 4
    prefetch_batches: int = 4
    use_native: bool = False
    bucket_frames: tuple = (64, 128, 192, 256, 384, 512, 768, 1024)
    seed: int = 0
    use_device_cache: bool = False
    device_cache_budget_gb: float = 0.0
    device_cache_spill_dir: str = ""
    int16_transport: bool = False


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    checkpoint_filepath: str = ""
    batch_size: int = 2
    num_iter_print: int = 1


@dataclasses.dataclass(frozen=True)
class Config:
    dsp: DSPConfig = dataclasses.field(default_factory=DSPConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    eval: EvalConfig = dataclasses.field(default_factory=EvalConfig)


def _get(cp: configparser.ConfigParser, section: str, key: str, default=None):
    if cp.has_option(section, key):
        return cp.get(section, key)
    return default


def _flag(value) -> bool:
    return str(value).lower() in ("1", "true", "yes")


def load_ini_config(path: str) -> Config:
    """Load a reference-format INI file into a typed `Config`.

    Accepts the exact section/key layout of the reference's cfg files
    (`Work/*/cfg/*.cfg`): ``[training] [testing] [inference] [model] [data]``.
    """
    cp = configparser.ConfigParser()
    read = cp.read(path)
    if not read:
        raise FileNotFoundError(f"config file not found: {path}")

    dsp_kwargs = {}
    if cp.has_option("data", "sample_rate"):
        dsp_kwargs["sample_rate"] = int(cp.get("data", "sample_rate"))
    if cp.has_option("data", "window_ms"):
        dsp_kwargs["window_ms"] = float(cp.get("data", "window_ms"))
    if cp.has_option("data", "stride_ms"):
        dsp_kwargs["stride_ms"] = float(cp.get("data", "stride_ms"))
    if cp.has_option("data", "windows"):
        win = cp.get("data", "windows")
        if win != "hamming":
            # Reference quirk: cfg says hanning but the code never reads the
            # key and always uses Hamming (Appendix A.1).  We follow the
            # *behaviour* unless the new-style key `windows_effective` is set.
            logger.warning(
                "[data] windows=%s requested, but the reference behaviour is "
                "hamming (the key is dead in the reference); using hamming. "
                "Set [data] windows_effective to override.",
                win,
            )
    if cp.has_option("data", "windows_effective"):
        dsp_kwargs["window_name"] = cp.get("data", "windows_effective")
    if cp.has_option("data", "nfft"):
        raw_nfft = cp.get("data", "nfft")
        try:
            # exact float compare: "256.9" must warn, not truncate to 256
            nfft = float(raw_nfft)
        except (ValueError, OverflowError):
            # the key is dead in the reference, so even junk values must
            # not abort config load -- warn like any other non-256 value
            nfft = None
        if nfft != 256.0:
            # Reference quirk: like `windows`, `nfft` is parsed by no
            # reference code path -- analysis FFT size is hardcoded to
            # 256 (Appendix A.2).  Follow the behaviour and say so.
            logger.warning(
                "[data] nfft=%s requested, but the reference behaviour is "
                "256 (the key is dead in the reference); using 256.",
                raw_nfft,
            )
    dsp = DSPConfig(**dsp_kwargs)

    model = ModelConfig(
        net_arch=_get(cp, "model", "net_arch", "RCED"),
        net_work=_get(cp, "model", "net_work", "FullyCNN"),
        feature_dim=int(_get(cp, "data", "feature_dim", dsp.num_bins)),
        compute_dtype=_get(cp, "model", "compute_dtype", "float32"),
        fused_inference=_flag(_get(cp, "model", "fused_inference", "False")),
        blocked_compute=_flag(_get(cp, "model", "blocked_compute", "False")),
        blocked_fb=int(_get(cp, "model", "blocked_fb", 8)),
        dw_pallas=_flag(_get(cp, "model", "dw_pallas", "False")),
    )

    train_kwargs = {}
    if cp.has_section("training"):
        g = lambda k, d: _get(cp, "training", k, d)  # noqa: E731
        train_kwargs = dict(
            epochs=int(g("epochs", 5)),
            batch_size=int(g("batch_size", 2)),
            lr=float(g("lr", 1.5e-3)),
            warmup_steps=int(g("warmup_steps", 10000)),
            continue_train=_flag(g("continue_train", "True")),
            checkpoints_path=g("checkpoints_path", "checkpoints"),
            base_checkpoint_file=g("base_checkpoint_file", ""),
            num_iter_print=int(g("num_iter_print", 100)),
            log_dir=g("log_dir", "checkpoints/log"),
            seed=int(g("seed", 0)),
            mask_loss=_flag(g("mask_loss", "False")),
            data_parallel=int(g("data_parallel", 1)),
            steps_per_call=int(g("steps_per_call", 1)),
            valid_every_epochs=int(g("valid_every_epochs", 5)),
        )
    train = TrainConfig(**train_kwargs)

    def opt(section, key):
        return cp.get(section, key) if cp.has_option(section, key) else None

    data = DataConfig(
        train_manifest_path=_get(cp, "data", "train_manifest_path", ""),
        val_manifest_path=_get(cp, "data", "val_manifest_path", ""),
        test_manifest_path=_get(cp, "data", "test_manifest_path", ""),
        train_noise_manifest=opt("data", "train_noise_manifest"),
        val_noise_manifest=opt("data", "val_noise_manifest"),
        test_noise_manifest=opt("data", "test_noise_manifest"),
        snr=float(_get(cp, "data", "snr", 0.0)),
        min_duration=float(_get(cp, "data", "min_duration", 0.4)),
        max_duration=float(_get(cp, "data", "max_duration", "inf")),
        audio_save_path=_get(cp, "data", "audio_save_path", "denoise"),
        num_workers=int(_get(cp, "data", "num_workers", 4)),
        use_native=_flag(_get(cp, "data", "use_native", "False")),
        seed=int(_get(cp, "data", "seed", 0)),
        use_device_cache=_flag(_get(cp, "data", "use_device_cache", "False")),
        device_cache_budget_gb=float(
            _get(cp, "data", "device_cache_budget_gb", 0.0)
        ),
        device_cache_spill_dir=_get(cp, "data", "device_cache_spill_dir", ""),
        int16_transport=_flag(_get(cp, "data", "int16_transport", "False")),
    )

    eval_section = "testing" if cp.has_section("testing") else "inference"
    eval_cfg = EvalConfig(
        checkpoint_filepath=_get(cp, eval_section, "checkpoint_filepath", "") or "",
        batch_size=int(_get(cp, eval_section, "batch_size", 2)),
        num_iter_print=int(_get(cp, eval_section, "num_iter_print", 1)),
    )

    return Config(dsp=dsp, model=model, train=train, data=data, eval=eval_cfg)
