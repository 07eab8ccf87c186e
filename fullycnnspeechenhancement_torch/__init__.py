"""PyTorch/CUDA port of the fully-convolutional speech-enhancement system.

The R-CED / CR-CED spectral-mapping denoisers (V1/V2/V3) on an NVIDIA
H100.  Serving: STFT analysis, the conv stack in eval mode (layer by layer
through cuDNN, or its inner layers fused into one hand-written CUDA
kernel), and the reference's waveform rebuild; a streaming denoiser
(`streaming.py`, `cli/stream`) and export to npz and `torch.export`
(`export.py`, `cli/export`).  Training in float32 or bf16: the host
loader or the GPU-resident corpus cache (`data/device_cache.py`, batches
rebuilt on the card), training-mode BN, the freq-to-depth (blocked) model
whose weight gradient can run in a second hand-written CUDA kernel, TF
Adam under the Noam schedule, checkpoints and `cli/train`, on one card or
data-parallel over `torch.distributed` ranks with sync BN (`parallel/`).
Time-sharded serving of long recordings over a device mesh
(`parallel/halo.py`) and the dataset preparation scripts
(`data/prepare/`).  Evaluation: STOI,
SDR and PESQ (the native P.862 runtime, built with g++ on first use) in
a fork-based scoring pool, for `cli/test` and in-training validation.
The JAX package `fullycnnspeechenhancement_tpu` beside it is the
reference this package is tested against; this package imports nothing
of it.

Public shapes follow the JAX package: magnitudes are [B, T, F], waveforms
[B, L] with lengths [B].  NCHW is used only inside the conv stack.
"""

__version__ = "0.1.0"

from fullycnnspeechenhancement_torch.config import (  # noqa: F401
    DSPConfig,
    ModelConfig,
    TrainConfig,
    DataConfig,
    EvalConfig,
    Config,
    load_ini_config,
)
