"""The port's dataset preparation (`data/prepare/*`) against the JAX
package's: the unpack round trip and checksum (tests/test_aux.py:48), the
aishell_2 speaker split (tests/test_aux.py:71), and each prepare script's
manifests (and the resampled wavs they point at) equal to the JAX
package's on two copies of the same small local tree.  `download` is
never called."""

import json
import os
import shutil
import tarfile
import zipfile

import numpy as np
import pytest

from fullycnnspeechenhancement_tpu.data import prepare as j_prepare
from fullycnnspeechenhancement_tpu.data.prepare import aishell_1 as j_a1
from fullycnnspeechenhancement_tpu.data.prepare import aishell_2 as j_a2
from fullycnnspeechenhancement_tpu.data.prepare import noise as j_noise
from fullycnnspeechenhancement_tpu.data.prepare import voicebank as j_vb

from fullycnnspeechenhancement_torch.data import prepare
from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
from fullycnnspeechenhancement_torch.data.prepare import aishell_1, aishell_2, noise, voicebank

SR_IN, SR_OUT = 16000, 8000


def test_unpack_roundtrip_and_md5(tmp_path):
    src = tmp_path / "payload.txt"
    src.write_text("hello")
    tar_path = str(tmp_path / "a.tar")
    with tarfile.open(tar_path, "w") as tar:
        tar.add(str(src), arcname="payload.txt")
    prepare.unpack(tar_path, str(tmp_path / "out_tar"))
    assert (tmp_path / "out_tar" / "payload.txt").read_text() == "hello"
    zip_path = str(tmp_path / "a.zip")
    with zipfile.ZipFile(zip_path, "w") as zf:
        zf.write(str(src), arcname="payload.txt")
    prepare.unpack(zip_path, str(tmp_path / "out_zip"), remove=True)
    assert (tmp_path / "out_zip" / "payload.txt").read_text() == "hello"
    assert not os.path.exists(zip_path)
    assert prepare.md5file(tar_path) == j_prepare.md5file(tar_path)
    assert len(prepare.md5file(tar_path)) == 32
    with pytest.raises(ValueError, match="unpack"):
        prepare.unpack(str(src), str(tmp_path / "x"))


def test_aishell2_speaker_split(tmp_path):
    lines = [f"S{i:04d}\tage\t女\tother" for i in range(25)]
    lines += [f"S{i:04d}\tage\t男\tother" for i in range(25, 55)]
    p = tmp_path / "spk_info.txt"
    p.write_text("\n".join(lines))
    dev, test = aishell_2.read_speaker_split(str(p))
    assert len(dev) == 20 and len(test) == 20
    assert "S0000" in dev and "S0025" in dev
    assert "S0010" in test and "S0035" in test
    assert "S0020" not in dev and "S0020" not in test
    assert (dev, test) == j_a2.read_speaker_split(str(p))


def _tone(rng, seconds):
    n = int(seconds * SR_IN)
    return (0.3 * np.sin(2 * np.pi * rng.uniform(200, 900) * np.arange(n) / SR_IN)
            + 0.05 * rng.standard_normal(n)).astype(np.float32)


def _w(path, sig):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    write_wav(path, sig, SR_IN)


def _tree(root, kind, seed=0):
    """A small local tree in the layout `kind`'s script walks."""
    rng = np.random.default_rng(seed)
    if kind == "aishell_1":
        for split, spks in (("train", ["S0002", "S0003"]), ("dev", ["S0724"]), ("test", ["S0764"])):
            for spk in spks:
                for u in range(2):
                    _w(f"{root}/ASR/data_aishell/wav/{split}/{spk}/B{spk}W{u}.wav", _tone(rng, 0.3 + 0.2 * u))
        _w(f"{root}/ASR/data_aishell/wav/train/S0002/tiny.wav", np.zeros(50, np.float32))
    elif kind == "aishell_2":
        base = f"{root}/ASR/aishell_2"
        info = [f"S{i:04d}\tage\t{'女' if i < 22 else '男'}\tother" for i in range(44)]
        os.makedirs(f"{base}/iOS/data", exist_ok=True)
        with open(f"{base}/iOS/data/spk_info.txt", "w", encoding="utf-8") as f:
            f.write("\n".join(info))
        for i in (0, 10, 21, 22, 33, 43):
            _w(f"{base}/iOS/data/wav/S{i:04d}/I{i}W0.wav", _tone(rng, 0.25))
    elif kind == "voicebank":
        for ds in ("trainset", "testset"):
            for u in range(3):
                c = _tone(rng, 0.2 + 0.1 * u)
                _w(f"{root}/SE/dataset/clean_{ds}/clean_{ds}_wav/p{u}.wav", c)
                _w(f"{root}/SE/dataset/noisy_{ds}/noisy_{ds}_wav/p{u}.wav",
                   c + 0.1 * rng.standard_normal(len(c)).astype(np.float32))
    else:
        for split in ("train", "dev", "test"):
            for u in range(2):
                _w(f"{root}/Noise/{split}/n{u}.wav", (0.2 * rng.standard_normal(3000 + 500 * u)).astype(np.float32))


def _run(kind, pkg, root, prefix):
    a1, a2, vb, nz = pkg
    if kind == "aishell_1":
        a1.create_manifests(f"{root}/ASR/data_aishell", prefix, SR_OUT, workers=2)
    elif kind == "aishell_2":
        a2.prepare(f"{root}/ASR/aishell_2", None, prefix, SR_OUT, workers=2)
    elif kind == "voicebank":
        vb.create_manifests(f"{root}/SE/dataset", prefix, SR_OUT, workers=2)
    else:
        nz.prepare(f"{root}/Noise", prefix, SR_OUT, workers=2)


@pytest.mark.parametrize("kind", ["aishell_1", "aishell_2", "voicebank", "noise"])
def test_manifests_equal_the_jax_packages(tmp_path, kind):
    """Both packages' prepare scripts on two copies of one tree: the same
    manifests, line for line (paths relative to each copy), and the same
    resampled samples behind each path."""
    _tree(str(tmp_path / "src"), kind)
    out = {}
    for tag, pkg in (("jax", (j_a1, j_a2, j_vb, j_noise)), ("port", (aishell_1, aishell_2, voicebank, noise))):
        root = str(tmp_path / tag)
        shutil.copytree(str(tmp_path / "src"), root)
        prefix = f"{root}/manifests/m"
        _run(kind, pkg, root, prefix)
        out[tag] = {}
        for name in sorted(os.listdir(f"{root}/manifests")):
            out[tag][name] = [json.loads(line) for line in open(f"{root}/manifests/{name}")]
    assert sorted(out["port"]) == sorted(out["jax"]) and out["port"]
    n_entries = 0
    for name, rows in out["jax"].items():
        got = out["port"][name]
        assert len(got) == len(rows), name
        for g, r in zip(got, rows):
            assert g.keys() == r.keys()
            assert g["duration"] == r["duration"]
            for k in g:
                if not k.endswith("filepath"):
                    continue
                rel = os.path.relpath(g[k], str(tmp_path / "port"))
                assert rel == os.path.relpath(r[k], str(tmp_path / "jax"))
                assert "8K" in rel
                np.testing.assert_array_equal(read_wav(g[k])[0], read_wav(r[k])[0])
                assert read_wav(g[k])[1] == SR_OUT
            n_entries += 1
    assert n_entries >= 4
