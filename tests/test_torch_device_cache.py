"""The port's GPU-resident corpus cache on the CPU, against the JAX
package's and against the host loader: the same corpora, manifests and
seeds give identical metadata (indices, chunks, offsets, scales), and
`materialize_batch` gives the host loader's batches (clean bit for bit,
the mix within its float32 roundings) and JAX's (within one float32 ulp,
where XLA may contract the multiply-add; `_assert_mix_close`).  Also the chunked packing, the
raises, premixed and clean-only corpora, the rotating loader's shards,
spill memmaps and `generation`, and its commits."""

import glob

import numpy as np
import pytest
import torch

from fullycnnspeechenhancement_tpu.data import device_cache as J

from fullycnnspeechenhancement_torch.config import DSPConfig
from fullycnnspeechenhancement_torch.data import device_cache as T
from fullycnnspeechenhancement_torch.data import write_manifest, write_wav
from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
from fullycnnspeechenhancement_torch.data.loader import DataLoader
from fullycnnspeechenhancement_torch.data.manifest import read_manifest
from test_torch_cuda import one_cpu_thread_per_worker  # noqa: F401

SR = 8000
DSP = DSPConfig()
META = ("clean_chunk", "clean_off", "other_chunk", "other_off", "scale", "lengths", "indices")


def _sine(duration_s, freq, gain=0.4):
    t = np.arange(int(duration_s * SR)) / SR
    return (gain * np.sin(2 * np.pi * freq * t)).astype(np.float32)


@pytest.fixture(scope="module")
def corpus_dir(tmp_path_factory):
    """tests/test_device_cache.py's corpus: clean utterances over three
    buckets, two long noise recordings, and premixed pairs."""
    root = tmp_path_factory.mktemp("torch_cache_corpus")
    durations = [0.5, 0.9, 1.3, 0.5, 2.1, 0.7, 1.3, 0.9]
    entries = []
    for i, d in enumerate(durations):
        p = str(root / f"c{i}.wav")
        write_wav(p, _sine(d, 250 + 60 * i), SR)
        entries.append({"audio_filepath": p, "duration": d})
    rng = np.random.default_rng(7)
    noise_entries = []
    for i, d in enumerate([3.0, 2.5]):
        p = str(root / f"n{i}.wav")
        write_wav(p, (0.25 * rng.standard_normal(int(d * SR))).astype(np.float32), SR)
        noise_entries.append({"audio_filepath": p, "duration": d})
    pre_entries = []
    for i, d in enumerate(durations[:4]):
        p = str(root / f"mix{i}.wav")
        write_wav(p, _sine(d, 250 + 60 * i) + _sine(d, 1000 + 10 * i, 0.1), SR)
        pre_entries.append({"clean_audio_filepath": str(root / f"c{i}.wav"),
                            "mix_audio_filepath": p, "duration": d})
    paths = {k: str(root / f"manifest.{k}") for k in ("clean", "noise", "premixed")}
    write_manifest(paths["clean"], entries)
    write_manifest(paths["noise"], noise_entries)
    write_manifest(paths["premixed"], pre_entries)
    return paths


def _host_batches(manifest, noise, batch_size, epoch, seed=0):
    loader = DataLoader(SpeechDataset(manifest, noise, SR, seed=seed), DSP, batch_size,
                        shuffle=True, num_workers=1, seed=seed)
    loader.set_epoch(epoch)
    return list(loader)


def _loaders(manifest, noise, batch_size, seed=0, **kw):
    """(port loader committed to the CPU, JAX loader) over one corpus."""
    tc = T.build_device_corpus(manifest, noise, DSP, **kw)
    jc = J.build_device_corpus(manifest, noise, DSP, commit=False, **kw)
    tl = T.DeviceCacheLoader(tc, DSP, batch_size, shuffle=True, seed=seed)
    jl = J.DeviceCacheLoader(jc, DSP, batch_size, shuffle=True, seed=seed)
    tl.activate("cpu")
    return tl, jl


def _assert_meta_equal(tb, jb):
    assert tb.bucket_frames == jb.bucket_frames
    for f in META:
        a, b = getattr(tb, f), getattr(jb, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _materialize(loader, b, premixed=False):
    mix, clean = T.materialize_batch(*loader.flats(), b, loader.pad_len(b.bucket_frames), premixed)
    assert mix.dtype == clean.dtype == torch.float32
    return mix.numpy(), clean.numpy()


def _j_materialize(loader, b, premixed=False):
    mix, clean = J.materialize_batch(*loader.flats(), b, loader.pad_len(b.bucket_frames), premixed)
    return np.asarray(mix), np.asarray(clean)


def _assert_mix_close(got, ref, clean, ulps):
    """|got - ref| within `ulps` float32 spacings of the mix's largest term
    (clean, the scaled noise or the sum), elementwise.  Against JAX: 1,
    for a multiply-add XLA may contract into one rounding.  Against the
    host loader, which mixes in float64 and casts once: 2, for the four
    roundings of half a spacing each (the scale to float32, the product,
    the sum, the host's cast).  Both also within the JAX test's absolute
    1e-6 (tests/test_device_cache.py)."""
    big = np.maximum(np.maximum(np.abs(clean), np.abs(got - clean)), np.abs(got))
    err = np.abs(got - ref)
    assert np.all(err <= ulps * np.spacing(big.astype(np.float32))), err.max()
    assert err.max() <= 1e-6


@pytest.mark.parametrize("epoch", [0, 1])
def test_cached_batches_match_jax_and_host_loader(corpus_dir, epoch):
    """Noise mixing: identical metadata to JAX's cache; the clean batch
    bit for bit and the mix within `_assert_mix_close` of the host
    loader's and of JAX's; noise was really added."""
    tl, jl = _loaders(corpus_dir["clean"], corpus_dir["noise"], 3)
    assert tl.corpus.clean.dtype == torch.int16 and tl.corpus.clean.device.type == "cpu"
    np.testing.assert_array_equal(tl.corpus.clean.numpy(), jl.corpus.clean)
    host = _host_batches(corpus_dir["clean"], corpus_dir["noise"], 3, epoch)
    tl.set_epoch(epoch)
    jl.set_epoch(epoch)
    cached, jbatches = list(tl), list(jl)
    assert len(cached) == len(jbatches) == len(host) == len(tl)
    for hb, tb, jb in zip(host, cached, jbatches):
        _assert_meta_equal(tb, jb)
        np.testing.assert_array_equal(hb.indices, tb.indices)
        mix, clean = _materialize(tl, tb)
        j_mix, j_clean = _j_materialize(jl, jb)
        np.testing.assert_array_equal(clean, hb.clean_wav)
        np.testing.assert_array_equal(clean, j_clean)
        _assert_mix_close(mix, hb.mix_wav, clean, 2)
        _assert_mix_close(mix, j_mix, clean, 1)
        assert np.abs(mix - clean).max() > 1e-3


def test_cached_batches_match_premixed(corpus_dir):
    tl, jl = _loaders(corpus_dir["premixed"], None, 2)
    assert tl.premixed and jl.premixed
    host = _host_batches(corpus_dir["premixed"], None, 2, 0)
    for hb, tb, jb in zip(host, list(tl), list(jl)):
        _assert_meta_equal(tb, jb)
        mix, clean = _materialize(tl, tb, premixed=True)
        np.testing.assert_array_equal(clean, hb.clean_wav)
        np.testing.assert_array_equal(mix, hb.mix_wav)
        np.testing.assert_array_equal(mix, _j_materialize(jl, jb, True)[0])


def test_short_noise_rejected(corpus_dir, tmp_path):
    """The tile-short-noise branch is not a slice: building raises."""
    p = str(tmp_path / "short_noise.wav")
    write_wav(p, (0.1 * np.ones(int(0.3 * SR))).astype(np.float32), SR)
    m = str(tmp_path / "manifest.shortnoise")
    write_manifest(m, [{"audio_filepath": p, "duration": 0.3}])
    with pytest.raises(ValueError, match="shortest noise recording"):
        T.build_device_corpus(corpus_dir["clean"], m, DSP)


def test_tail_pad_guard_raises(corpus_dir):
    corpus = T.DeviceCorpus(read_manifest(corpus_dir["clean"]), None, SR, pad_samples=16,
                            snr_db=0.0, seed=0)
    with pytest.raises(ValueError, match="tail pad"):
        T.DeviceCacheLoader(corpus, DSP, 2)


def test_chunked_packing_matches_jax(corpus_dir):
    """A shrunken chunk_limit packs several rows: the same rows, chunks
    and offsets as JAX's, int32 offsets under the budget, every entry
    read back bit for bit, a zero tail on every row."""
    paths = [e.audio_filepath for e in read_manifest(corpus_dir["clean"])]
    pad, limit = 64, int(2.5 * SR)
    fc = T.FlatCorpus.build(paths, SR, pad, chunk_limit=limit)
    jfc = J.FlatCorpus.build(paths, SR, pad, chunk_limit=limit)
    assert fc.flat.shape[0] >= 3 and fc.flat.shape[1] <= limit
    assert fc.offsets.dtype == np.int32 and fc.chunks.dtype == np.int32
    assert int(fc.offsets.max()) + pad < limit
    for f in ("flat", "chunks", "offsets", "lengths"):
        np.testing.assert_array_equal(getattr(fc, f), getattr(jfc, f))
    ref = T.FlatCorpus.build(paths, SR, pad)
    assert ref.flat.shape[0] == 1
    for i in range(len(paths)):
        np.testing.assert_array_equal(fc.segment(i), ref.segment(i))
    assert not fc.flat[:, -pad:].any()


def test_chunked_corpus_matches_host_loader(corpus_dir):
    """Across chunk boundaries too."""
    tl, jl = _loaders(corpus_dir["clean"], corpus_dir["noise"], 2, max_bucket_frames=192,
                      chunk_limit=int(7.0 * SR))
    assert tl.corpus.clean.shape[0] > 1
    host = _host_batches(corpus_dir["clean"], corpus_dir["noise"], 2, 0)
    for hb, tb, jb in zip(host, list(tl), list(jl)):
        _assert_meta_equal(tb, jb)
        mix, clean = _materialize(tl, tb)
        np.testing.assert_array_equal(clean, hb.clean_wav)
        _assert_mix_close(mix, hb.mix_wav, clean, 2)


def test_equal_length_noise_start_zero_crop(tmp_path):
    """A crop at start 0 of a non-first noise recording in a row uses that
    recording's own power: every scale positive, the mix the host's."""
    entries, noise_entries = [], []
    for i in range(4):
        p = str(tmp_path / f"c{i}.wav")
        write_wav(p, _sine(1.0, 300 + 50 * i), SR)
        entries.append({"audio_filepath": p, "duration": 1.0})
    rng = np.random.default_rng(5)
    for i in range(3):
        p = str(tmp_path / f"n{i}.wav")
        write_wav(p, (0.2 * rng.standard_normal(SR)).astype(np.float32), SR)
        noise_entries.append({"audio_filepath": p, "duration": 1.0})
    write_manifest(str(tmp_path / "m.clean"), entries)
    write_manifest(str(tmp_path / "m.noise"), noise_entries)
    tl, jl = _loaders(str(tmp_path / "m.clean"), str(tmp_path / "m.noise"), 2)
    assert len(set(tl.corpus.noise_host.chunks.tolist())) == 1
    host = _host_batches(str(tmp_path / "m.clean"), str(tmp_path / "m.noise"), 2, 0)
    for hb, tb, jb in zip(host, list(tl), list(jl)):
        assert (tb.scale > 0).all()
        _assert_meta_equal(tb, jb)
        mix, clean = _materialize(tl, tb)
        _assert_mix_close(mix, hb.mix_wav, clean, 2)


def test_clean_only_corpus_materializes(corpus_dir):
    """No noise, not premixed: mix == clean through the placeholder flat,
    as wide as the clean rows."""
    tl, jl = _loaders(corpus_dir["clean"], None, 2)
    assert tl.corpus.other.shape[1] == tl.corpus.clean.shape[1]
    tb, jb = next(iter(tl)), next(iter(jl))
    _assert_meta_equal(tb, jb)
    mix, clean = _materialize(tl, tb)
    np.testing.assert_array_equal(mix, clean)
    assert np.abs(clean).max() > 0


def test_parallel_and_native_build_match_sequential(corpus_dir):
    paths = [e.audio_filepath for e in read_manifest(corpus_dir["clean"])]
    seq = T.FlatCorpus.build(paths, SR, 64)
    par = T.FlatCorpus.build(paths, SR, 64, num_workers=4)
    np.testing.assert_array_equal(seq.flat, par.flat)
    np.testing.assert_array_equal(seq.offsets, par.offsets)
    from fullycnnspeechenhancement_torch.data import native

    if native.native_available():
        nat = T.FlatCorpus.build(paths, SR, 64, num_workers=4, use_native=True)
        np.testing.assert_array_equal(seq.flat, nat.flat)


def test_oversize_recording_rejected(tmp_path):
    p = str(tmp_path / "long.wav")
    write_wav(p, np.zeros(SR, np.float32), SR)
    with pytest.raises(ValueError, match="chunk budget"):
        T.FlatCorpus.build([p], SR, pad_samples=16, chunk_limit=SR // 2)


def test_commit_defaults_to_cuda(corpus_dir):
    if torch.cuda.is_available():
        pytest.skip("CUDA is present: the default device is usable here")
    corpus = T.build_device_corpus(corpus_dir["clean"], None, DSP)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        corpus.commit()


# ---- the rotating loader ------------------------------------------------


def _rotating(mod, manifest, noise, tmp_path, tag, **kw):
    loader = mod.RotatingDeviceCacheLoader(
        manifest, noise, DSP, batch_size=2, seed=0,
        spill_dir=str(tmp_path / f"spill_{tag}"), **kw,
    )
    if mod is T:
        loader.activate("cpu")
    return loader


@pytest.mark.parametrize("epoch", [0, 1])
def test_rotating_loader_matches_jax(corpus_dir, tmp_path, epoch):
    """A small budget splits the corpus into shards spilled to memmaps;
    per epoch every item is in one shard, and every batch's metadata,
    `generation` and materialized waveforms equal JAX's rotating
    loader's (after its commit at the common padded shape)."""
    kw = dict(hbm_budget_bytes=64_000, shuffle=True)
    rot = _rotating(T, corpus_dir["clean"], corpus_dir["noise"], tmp_path, f"t{epoch}", **kw)
    jrot = _rotating(J, corpus_dir["clean"], corpus_dir["noise"], tmp_path, f"j{epoch}", **kw)
    assert rot.num_shards == jrot.num_shards >= 3 and len(rot) == len(jrot)
    assert isinstance(rot._corpora[0].clean, np.memmap)
    assert sum(len(c.entries) for c in rot._corpora) == 8
    rot.set_epoch(epoch)
    jrot.set_epoch(epoch)
    n = 0
    for tb, jb in zip(rot, jrot):
        assert rot.generation == jrot.generation
        _assert_meta_equal(tb, jb)
        mix, clean = _materialize(rot, tb)
        j_mix, j_clean = _j_materialize(jrot, jb)
        np.testing.assert_array_equal(clean, j_clean)
        _assert_mix_close(mix, j_mix, clean, 1)
        assert tuple(rot.flats()[0].shape) == rot._clean_shape
        n += 1
    assert n == len(rot)
    assert rot.generation == rot.num_shards


def test_rotating_single_shard_equals_plain_loader(corpus_dir):
    """One shard: the plain loader over the whole corpus with the derived
    shard seed, batch for batch."""
    rot = T.RotatingDeviceCacheLoader(corpus_dir["clean"], corpus_dir["noise"], DSP, batch_size=2,
                                      hbm_budget_bytes=1 << 30, shuffle=True, seed=3)
    rot.activate("cpu")
    assert rot.num_shards == 1
    derived = (3 * 1_000_003) & 0x7FFFFFFF
    plain_corpus = T.DeviceCorpus(read_manifest(corpus_dir["clean"], 0.4),
                                  read_manifest(corpus_dir["noise"]), SR,
                                  pad_samples=DSP.padded_samples(1024), snr_db=0.0, seed=derived)
    plain = T.DeviceCacheLoader(plain_corpus, DSP, 2, shuffle=True, seed=derived)
    for rb, pb in zip(list(rot), list(plain)):
        for f in META:
            np.testing.assert_array_equal(getattr(rb, f), getattr(pb, f))


def test_rotating_loader_premixed_mode(corpus_dir, tmp_path):
    """Premixed shards: both flats are shard-specific and spill per
    shard; batches are the per-shard corpora's, mix and clean apart."""
    rot = _rotating(T, corpus_dir["premixed"], None, tmp_path, "pre",
                    hbm_budget_bytes=40_000, shuffle=False)
    jrot = _rotating(J, corpus_dir["premixed"], None, tmp_path, "jpre",
                     hbm_budget_bytes=40_000, shuffle=False)
    assert rot.premixed and rot.num_shards >= 2
    assert glob.glob(str(tmp_path / "spill_pre" / "other_*.npy"))
    seen = 0
    for tb, jb in zip(rot, jrot):
        _assert_meta_equal(tb, jb)
        mix, clean = _materialize(rot, tb, premixed=True)
        np.testing.assert_array_equal(mix, _j_materialize(jrot, jb, True)[0])
        assert np.abs(mix - clean).max() > 1e-4 and np.abs(clean).max() > 0
        seen += 1
    assert seen == len(rot)


def test_rotating_generation_and_shared_noise_commit(corpus_dir, tmp_path):
    """`generation` is bumped once per shard commit and never reused; the
    shared noise flat commits once and every rotation reuses it."""
    rot = _rotating(T, corpus_dir["clean"], corpus_dir["noise"], tmp_path, "gen",
                    hbm_budget_bytes=64_000, shuffle=True)
    assert rot.num_shards >= 3 and rot.generation == 0
    with pytest.raises(RuntimeError, match="no shard resident"):
        rot.flats()
    gens, others = [], []
    for _ in rot:
        gens.append(rot.generation)
        others.append(rot.flats()[1])
    assert sorted(set(gens)) == list(range(1, rot.num_shards + 1))
    assert gens == sorted(gens)
    assert all(o is others[0] for o in others)


def test_no_two_shard_commits_share_a_staging_buffer(corpus_dir, tmp_path, monkeypatch):
    """Every commit copies each flat into a buffer of its own, straight
    from its host source (a spilled memmap or the shared noise flat), and
    the copy is complete when the commit returns: refilling the source
    right after it, as a reused staging buffer would be refilled, leaves
    the committed flat whole; no two commits' flats share memory; each
    holds its zero-padded shard."""
    commits = []
    real = T.commit_flats

    def keep(flats, device, shapes=None):
        out = real(flats, device, shapes)
        for t, src in zip(out, flats):
            snap = np.array(src)
            src[...] = -1  # the refill
            got = t.numpy()
            src[...] = snap
            np.testing.assert_array_equal(got[: snap.shape[0], : snap.shape[1]], snap)
            assert not got[snap.shape[0]:].any() and not got[:, snap.shape[1]:].any()
            assert not np.shares_memory(got, src)
            commits.append(t)
        return out

    monkeypatch.setattr(T, "commit_flats", keep)
    for premixed in (False, True):
        manifest, noise = ((corpus_dir["premixed"], None) if premixed
                           else (corpus_dir["clean"], corpus_dir["noise"]))
        rot = _rotating(T, manifest, noise, tmp_path, f"stage{premixed}",
                        hbm_budget_bytes=40_000 if premixed else 64_000, shuffle=True)
        for epoch in range(2):
            rot.set_epoch(epoch)
            for _ in rot:
                pass
    assert len(commits) >= 8
    ptrs = [t.data_ptr() for t in commits]
    assert len(set(ptrs)) == len(ptrs)
