"""Dataset preparation: download/unpack corpora and emit JSONL manifests.

Counterpart of `fullycnnspeechenhancement_tpu/data/prepare/`, over the
port's own `audio_io` and `manifest`.  Each script runs as
`python -m fullycnnspeechenhancement_torch.data.prepare.<name>` with the
JAX package's arguments (`aishell_1`, `aishell_2`, `voicebank`, `noise`).

Covers the reference's `Work/datasets/*_prepare.py` tooling (SURVEY.md
SS2.1 components 15-19): aishell_1 (openslr-33), aishell_2 (local
tarball + gender-balanced speaker split), VoiceBank-DEMAND (pre-mixed
clean/noisy pairs), and generic noise corpora.  All use the shared
resample-and-manifest core in `common.py` with a process pool instead of
per-directory joblib fan-out.
"""

from fullycnnspeechenhancement_torch.data.prepare.common import (  # noqa: F401
    download,
    unpack,
    md5file,
    resample_tree_entry,
)
