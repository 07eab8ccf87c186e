"""Single-utterance inference engine.

Counterpart of `fullycnnspeechenhancement_tpu/infer.py` (the reference's
`InferenceEngine(config).denoise(audio_file)`, which writes
`<name>_de.wav`).  One call runs analysis -> model (BN in inference mode)
-> rebuild on the engine's device, with the waveform zero-padded up to a
length bucket (2, 4, 8, 16, 32 s; longer inputs to a multiple of 32 s) so
that the shapes a card sees stay few.

Weights come from an npz bridge file, or from a checkpoint of this
package (an `epoch_<N>.pt` file, or a run directory: its latest epoch).
`config.model.fused_inference` selects the fused inner-stack kernel
(`ops/rced_stack.py`) over the layer-by-layer cuDNN path.  With `mesh`
(`parallel.mesh.make_mesh`), an utterance longer than the top bucket
runs its model through the time-sharded halo forward
(`parallel/halo.py`) over the mesh's devices instead, as the JAX
engine's `mesh=` path does.

Numerics: the engine serves float32 and turns TF32 off for cuDNN convs
and cuBLAS matmuls when it is built (`disable_tf32`).  cuDNN's default is
TF32, which keeps about three decimal digits; the de-emphasis IIR of the
rebuild amplifies spectral error about 33x, so TF32 would cost waveform
parity with the float32 reference.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from fullycnnspeechenhancement_torch.config import Config
from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
from fullycnnspeechenhancement_torch.device import disable_tf32, resolve_device
from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor
from fullycnnspeechenhancement_torch.dsp.rebuild import WaveformRebuilder
from fullycnnspeechenhancement_torch.models import get_model
from fullycnnspeechenhancement_torch.ops.rced_stack import (
    fused_inference_forward,
    pack_inference_stack,
)
from fullycnnspeechenhancement_torch.telemetry import span
from fullycnnspeechenhancement_torch.train.checkpoint import (
    find_checkpoint,
    import_reference_npz,
    load_params,
)

logger = logging.getLogger(__name__)


class InferenceEngine:
    """Single-utterance denoiser on one device (the card unless the caller
    asks for the CPU).

    Pass `mesh` (a `parallel.mesh.Mesh` with a 'data' axis) to route
    utterances LONGER than the top padded-length bucket through the
    time-sharded halo forward (`parallel.halo.make_time_sharded_forward`):
    analysis and rebuild stay on the engine's device, the model (plain,
    BN in inference mode, as in the JAX package) runs one time shard on
    each device of the mesh with a 7-frame halo, and its output equals
    the single-device forward's.  Shorter utterances keep the bucketed
    path whatever the mesh."""

    def __init__(
        self,
        config: Config,
        checkpoint: Optional[str] = None,
        bucket_seconds: Sequence[float] = (2.0, 4.0, 8.0, 16.0, 32.0),
        device="cuda",
        mesh=None,
    ):
        self.device = resolve_device(device)
        disable_tf32()
        self.config = config
        self.model = get_model(config.model.net_work)
        self.ext = SpectrogramExtractor(config.dsp)
        self.reb = WaveformRebuilder(config.dsp)
        self.bucket_samples = [
            int(s * config.dsp.sample_rate) for s in bucket_seconds
        ]
        self.mesh = mesh
        self._sharded_model = None
        if mesh is not None:
            from fullycnnspeechenhancement_torch.parallel.halo import make_time_sharded_forward

            self._sharded_model = make_time_sharded_forward(self.model, mesh)
        self.params, self.bn_state = self._load(checkpoint)
        # Folded and packed once; every call launches the kernel once.
        self._packed = (
            pack_inference_stack(self.model, self.params, self.bn_state)
            if config.model.fused_inference
            else None
        )

    def _load(self, checkpoint: Optional[str]):
        ckpt_path = checkpoint or self.config.eval.checkpoint_filepath
        if ckpt_path:
            if ckpt_path.endswith(".npz"):
                logger.info("importing reference npz weights: %s", ckpt_path)
                return import_reference_npz(ckpt_path, self.model, self.device)
            found = find_checkpoint(ckpt_path)
            if found is None:
                raise NotImplementedError(
                    f"{ckpt_path}: neither an npz file nor a checkpoint (file or "
                    "run directory) of this package; the JAX package's orbax "
                    "directories need JAX to read: export them to npz with its "
                    "export_params_npz"
                )
            logger.info("loading checkpoint: %s", found)
            return load_params(found, self.device)
        logger.warning(
            "no checkpoint configured; using random init (seed %d)",
            self.config.train.seed,
        )
        generator = torch.Generator().manual_seed(self.config.train.seed)
        return self.model.init(generator, device=self.device)

    def _pad_len(self, n: int) -> int:
        for b in self.bucket_samples:
            if n <= b:
                return b
        top = self.bucket_samples[-1]
        return ((n + top - 1) // top) * top

    @torch.inference_mode()
    def _denoise(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        with span("infer.features"):
            mag, pre, pim = self.ext.magnitude_and_phase(wav, lengths)
        with span("infer.model"):
            if self._packed is not None:
                pred = fused_inference_forward(
                    self.model, self.params, self.bn_state, mag, packed=self._packed
                )
            else:
                pred = self.model.apply(self.params, self.bn_state, mag[..., None])[0][..., 0]
        with span("infer.rebuild"):
            return self.reb(pred, pre, pim)

    @torch.inference_mode()
    def _denoise_time_sharded(self, wav: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """Over-top-bucket utterances: analysis on the engine's device, the
        model over the mesh's time shards, rebuild on the engine's device.
        The frame axis zero-pads up to a multiple of the shard count:
        exact, because TF SAME time padding is zeros too."""
        from fullycnnspeechenhancement_torch.parallel.mesh import DATA_AXIS

        with span("infer.features"):
            mag, pre, pim = self.ext.magnitude_and_phase(wav, lengths)
        with span("infer.model"):
            t = mag.shape[1]
            n_shards = self.mesh.shape[DATA_AXIS]
            t_pad = -(-t // n_shards) * n_shards
            if t_pad != t:
                mag = torch.nn.functional.pad(mag, (0, 0, 0, t_pad - t))
            pred = self._sharded_model(self.params, self.bn_state, mag)[:, :t]
        with span("infer.rebuild"):
            return self.reb(pred, pre, pim)

    def denoise_array(self, signal: np.ndarray) -> np.ndarray:
        """float32 waveform -> denoised float32 waveform (same length)."""
        with span("infer.request"):
            n = len(signal)
            L = self._pad_len(n)
            with span("infer.upload"):
                wav = torch.zeros(1, L, dtype=torch.float32, device=self.device)
                wav[0, :n] = torch.as_tensor(np.asarray(signal, np.float32), device=self.device)
                lengths = torch.tensor([n], dtype=torch.int32, device=self.device)
            if self._sharded_model is not None and L > self.bucket_samples[-1]:
                out = self._denoise_time_sharded(wav, lengths)
            else:
                out = self._denoise(wav, lengths)
            with span("infer.download"):
                return out[0, :n].cpu().numpy()

    def denoise(self, audio_file: str, save_path: Optional[str] = None) -> str:
        signal, _ = read_wav(audio_file, self.config.dsp.sample_rate)
        out = self.denoise_array(signal)
        save_dir = save_path or self.config.data.audio_save_path
        os.makedirs(save_dir, exist_ok=True)
        out_path = os.path.join(
            save_dir, os.path.basename(audio_file).replace(".wav", "_de.wav")
        )
        write_wav(out_path, out, self.config.dsp.sample_rate)
        logger.info("saved denoised audio to %s", out_path)
        return out_path
