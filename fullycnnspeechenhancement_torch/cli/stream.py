"""Streaming CLI: simulate real-time chunked denoising of a wav file.

Counterpart of `fullycnnspeechenhancement_tpu/cli/stream.py`.  The file is
pushed through `StreamingDenoiser` one chunk at a time, as a live
microphone loop would, the denoised stream is written to `<name>_de.wav`
beside the input, and the real-time report is printed as one JSON line:
`out`, `rtf` (audio seconds per wall second), `budget_ms` (a push's audio
duration), `push_p50_ms`, `push_p95_ms` and `latency_ms` (lookahead plus
one chunk).

    python -m fullycnnspeechenhancement_torch.cli.stream \\
        --cfg work/aishell_1/cfg/fully_cnn_infer.cfg \\
        --audio-file noisy.wav [--chunk-frames 8] [--checkpoint ...]

Runs on the card; `--device cpu` runs on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from fullycnnspeechenhancement_torch.config import load_ini_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Denoise a wav file in simulated real time")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--audio-file", required=True)
    parser.add_argument("--checkpoint", default=None)
    parser.add_argument(
        "--chunk-frames",
        default=8,
        type=int,
        help="frames per push (8 = 128 ms at the reference's 16 ms stride)",
    )
    parser.add_argument("--device", default="cuda", help="torch device to run on (default: cuda)")
    args = parser.parse_args(argv)

    config = load_ini_config(args.cfg)

    from fullycnnspeechenhancement_torch.data.audio_io import read_wav, write_wav
    from fullycnnspeechenhancement_torch.infer import InferenceEngine
    from fullycnnspeechenhancement_torch.streaming import StreamingDenoiser

    # the engine resolves the checkpoint (npz, epoch_<N>.pt or run directory)
    engine = InferenceEngine(config, checkpoint=args.checkpoint, device=args.device)
    den = StreamingDenoiser(
        config, engine.params, engine.bn_state, chunk_frames=args.chunk_frames, device=args.device
    )

    sr = config.dsp.sample_rate
    wav, _ = read_wav(args.audio_file, sr)
    push = args.chunk_frames * config.dsp.frame_step

    # one priming pass, so the report reflects steady state
    den.push(wav[: 4 * push])
    den.reset()

    out, times = [], []
    t0 = time.perf_counter()
    for i in range(0, len(wav), push):
        c0 = time.perf_counter()
        out.append(den.push(wav[i : i + push]))
        times.append(time.perf_counter() - c0)
    out.append(den.flush())
    wall = time.perf_counter() - t0

    denoised = np.concatenate(out)[: len(wav)]
    # splitext never touches directory components and keeps an input
    # without a ".wav" extension from being overwritten
    base, ext = os.path.splitext(args.audio_file)
    out_path = base + "_de" + (ext or ".wav")
    write_wav(out_path, denoised, sr)

    times_ms = np.asarray(times) * 1e3
    report = {
        "out": out_path,
        "rtf": round(len(wav) / sr / wall, 2),
        "budget_ms": round(push / sr * 1e3, 1),
        "push_p50_ms": round(float(np.percentile(times_ms, 50)), 2),
        "push_p95_ms": round(float(np.percentile(times_ms, 95)), 2),
        "latency_ms": round((den.latency_samples + push) / sr * 1e3, 1),
    }
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
