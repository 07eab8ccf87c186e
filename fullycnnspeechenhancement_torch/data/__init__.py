"""Host data pipeline: audio I/O, manifests, SNR mixing, bucketed loading.

The host decodes, resamples and mixes raw waveforms only; all DSP runs on
the device inside the train step.  Batches are padded to static bucket
shapes.  `native.py` binds the native host runtime (decode, resample,
mixing, PESQ), built from `runtime/*.cc` on first use.  The GPU-resident
corpus cache (`device_cache.py`) of the JAX package is not ported yet
(ROADMAP.md).
"""

from fullycnnspeechenhancement_torch.data.audio_io import (  # noqa: F401
    read_wav,
    resample,
    write_wav,
)
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset  # noqa: F401
from fullycnnspeechenhancement_torch.data.loader import (  # noqa: F401
    BucketSampler,
    DataLoader,
    LoaderBatch,
)
from fullycnnspeechenhancement_torch.data.manifest import (  # noqa: F401
    ManifestEntry,
    read_manifest,
    shard_for_host,
    write_manifest,
)
from fullycnnspeechenhancement_torch.data.mixing import mix_at_snr  # noqa: F401
