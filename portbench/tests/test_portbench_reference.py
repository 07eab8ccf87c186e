"""The plain reference against the program's plain CPU path at a tiny
size: weights from a seed, analysis and rebuild, the forward pass in
both BN modes, the training mixes, and three training steps."""

import numpy as np
import pytest
import torch

from portbench.reference import dsp, mixing, model, train
from portbench.reference.specs import MODELS


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.max(np.abs(a - b)) <= tol * max(np.max(np.abs(b)), 1e-30)


@pytest.mark.parametrize("net", sorted(MODELS))
def test_weights_from_a_seed_are_the_programs(net):
    from fullycnnspeechenhancement_torch.models import get_model

    seed = 2**31 + 5
    p, bn = model.init_params(MODELS[net], seed)
    q, bq = get_model(net).init(torch.Generator().manual_seed(seed))
    assert all(torch.equal(p[n][k], q[n][k]) for n in q for k in q[n])
    assert all(torch.equal(bn[n][k], bq[n][k]) for n in bq for k in bq[n])


def _signals(rng, lengths):
    return [0.3 * rng.standard_normal(n) for n in lengths]


def test_analysis_and_rebuild_are_the_references_dsp():
    from fullycnnspeechenhancement_torch.dsp import reference_dsp

    rng = np.random.default_rng(0)
    for s in _signals(rng, [300, 1000, 2345]):
        mag, pre, pim = dsp.analyze([s])
        golden = reference_dsp.analyze(s, 8000, 0.032, 0.016, 256, return_complex=True).T
        _close(mag[0], np.abs(golden), 1e-12)
        phase = reference_dsp.unit_phase(golden)
        _close(pre[0], phase.real, 1e-9)
        _close(pim[0], phase.imag, 1e-9)
        out = dsp.rebuild(mag[0], pre[0], pim[0], len(s))
        want = reference_dsp.rebuild_audio([len(s)], np.abs(golden)[None], phase[None], 8000, 32, 16)[0]
        _close(out, want, 1e-9)


def test_batched_analysis_is_the_programs_extractor():
    from fullycnnspeechenhancement_torch.config import DSPConfig
    from fullycnnspeechenhancement_torch.dsp.features import SpectrogramExtractor

    rng = np.random.default_rng(1)
    lengths = [900, 2000, 1500]
    sig = _signals(rng, lengths)
    wav = np.zeros((3, 2600))
    for i, s in enumerate(sig):
        wav[i, : len(s)] = s
    mag, _, _ = dsp.analyze(sig)
    got = SpectrogramExtractor(DSPConfig())(torch.tensor(wav, dtype=torch.float32), torch.tensor(lengths))
    _close(got[:, : mag.shape[1]].numpy(), mag, 1e-5)
    assert float(got[:, mag.shape[1]:].abs().max()) == 0.0


@pytest.mark.parametrize("net", sorted(MODELS))
@pytest.mark.parametrize("training", [False, True])
def test_forward_is_the_programs_plain_model(net, training):
    from fullycnnspeechenhancement_torch.models import get_model

    m = get_model(net)
    p, bn = model.init_params(MODELS[net], 3)
    x = torch.rand(2, 12, 129, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    ours, stats = model.forward(MODELS[net], model.cast(p, torch.float64, "cpu"), model.cast(bn, torch.float64, "cpu"),
                                x, training=training)
    theirs, new_bn = m.apply(model.cast(p, torch.float64, "cpu"), model.cast(bn, torch.float64, "cpu"),
                             x[..., None], is_training=training)
    _close(ours.numpy(), theirs[..., 0].numpy(), 1e-12)
    for name, (mean, var) in stats.items():
        want = 0.99 * bn[name]["mean"].double() + 0.01 * mean
        _close(new_bn[name]["mean"].numpy(), want.numpy(), 1e-12)


def test_training_mixes_are_the_loaders(tmp_path):
    """The seeded noise choice and crop of the host loader and of the
    device cache, and the mix at the SNR."""
    from fullycnnspeechenhancement_torch.config import DSPConfig
    from fullycnnspeechenhancement_torch.data.dataset import SpeechDataset
    from fullycnnspeechenhancement_torch.data.device_cache import build_device_corpus

    from portbench import gen

    rng = np.random.default_rng(2)
    clean = [gen._to_i16(0.3 * rng.standard_normal(n)) for n in (4000, 5100, 3500, 6000)]
    noise = [gen._to_i16(0.1 * rng.standard_normal(9000)) for _ in range(3)]
    corpus = gen.write_corpus(str(tmp_path), clean, noise)
    seed, epoch = 2**31 + 9, 2
    c64 = [c / 32768.0 for c in clean]
    n64 = [c / 32768.0 for c in noise]
    pairs = mixing.training_pairs(c64, n64, range(4), seed, epoch, 0.0)
    ds = SpeechDataset(corpus.clean_manifest, corpus.noise_manifest, 8000, seed=seed)
    ds.set_epoch(epoch)
    dc = build_device_corpus(corpus.clean_manifest, corpus.noise_manifest, DSPConfig(), max_bucket_frames=64)
    dc.data_seed = seed
    dc.seed = seed
    assignment = dc.noise_assignment(epoch)
    for i, (mix, c) in enumerate(pairs):
        got, got_clean = ds[i]
        _close(got, mix, 1e-6)
        _close(got_clean, c, 0)
        cc, co, oc, oo, scale = dc.item_meta(i, epoch, assignment)
        n = len(clean[i])
        crop = dc.other[oc, oo: oo + n].astype(np.float64) / 32768.0
        _close(dc.clean[cc, co: co + n] / 32768.0 + scale * crop, mix, 1e-9)


def test_three_training_steps_are_the_programs():
    """float32 program steps against the float64 reference from the same
    seed: losses, the first gradient and the parameters after three."""
    from fullycnnspeechenhancement_torch.config import Config, ModelConfig, TrainConfig
    from fullycnnspeechenhancement_torch.models import V1
    from fullycnnspeechenhancement_torch.train.step import Batch, create_train_state, make_train_step

    config = Config(model=ModelConfig(net_work="FullyCNN"), train=TrainConfig(batch_size=2, seed=6))
    state = create_train_state(config, V1, device="cpu")
    step = make_train_step(config, V1)
    rng = np.random.default_rng(3)
    batches, losses = [], []
    for t in range(3):
        lengths = [1200 + 300 * t, 900]
        mix, clean = _signals(rng, lengths), _signals(rng, lengths)
        batches.append((dsp.analyze(mix)[0], dsp.analyze(clean)[0]))
        wav = np.zeros((2, 2, 2000), np.float32)
        for i in range(2):
            wav[0, i, : lengths[i]], wav[1, i, : lengths[i]] = mix[i], clean[i]
        state, m = step(state, Batch(torch.tensor(wav[0]), torch.tensor(wav[1]), torch.tensor(lengths, dtype=torch.int32)))
        losses.append(float(m["loss"]))
        if t == 0:
            mu1 = {n: {k: v.clone() for k, v in d.items()} for n, d in state.opt_state.mu.items()}
    p0, bn0 = model.init_params(MODELS["FullyCNN"], 6)
    ref = train.run_steps(MODELS["FullyCNN"], p0, bn0, batches, 2, 1.5e-3, 1e4)
    _close(losses, ref.losses, 1e-5)
    # the leaves under the rule of check.py: the conv biases under a
    # training-mode BN have a gradient of zero but for rounding, and Adam
    # moves them by their rounding alone
    from portbench import check

    prog = {"losses": losses, "params0": p0, "bn0": bn0, "mu1": mu1, "params3": state.params,
            "bn3": state.bn_state}
    numbers = check.train_numbers(prog, p0, bn0, ref)
    assert numbers["grad_gap"] < 1e-4 and numbers["grad_err"] < 1e-4 and numbers["bn_gap"] < 1e-4
    assert numbers["change_gap"] < 0.2  # the change is a few float32 ulps of each parameter


def test_the_serving_number_leaves_out_one_undefined_phase_and_not_a_wrong_answer():
    """A thousand samples off (one frame whose DC phase flipped, and its
    de-emphasis tail) move the maximum and not the 99.9th percentile of a
    390 s request; an answer 1% off throughout moves both."""
    from portbench import check

    t = np.arange(390 * 8000) / 8000.0
    ref = np.sin(2 * np.pi * 3.0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 0.1 * t))
    noise = 1e-7 * np.random.default_rng(1).standard_normal(len(t))
    flipped = ref + noise
    flipped[100_000:101_000] += 0.008 * 0.97 ** np.arange(1000)
    one_frame = check.serve_numbers([(flipped, ref)])
    assert one_frame["wave_err"] > 5e-3 and one_frame["wave_err_q999"] < 1e-6
    wrong = check.serve_numbers([(1.01 * ref, ref)])
    assert wrong["wave_err_q999"] > 5e-3
