"""Readings that the correctness limits are set from, on the card, at the
cell's own size (never run by the benchmark's runs):

    python3 portbench/calibrate.py --workload <cell> --seeds <n> ... [--controls 3]

For each seed, the program's numbers (the lower readings), as a run of
the cell computes them: a training cell's checked steps through
`Trainer.train`, a serving cell's checked requests from a closed loop
that sends its pool once.  For the first `--controls` seeds also the
control's (the reference one precision below the configuration's,
`check.CONTROL_BITS`, put in the program's place) and, for training,
the fault that leaves half of each batch out (the mean over the rest),
planted in the reference put in the program's place.  A state left
unchanged reads 1 on grad_gap, grad_err, change_gap and bn_err and needs no
run.  One JSON line a seed; for training also each leaf's gap, and its
‖g - g_ref‖ and ‖g_ref‖ (which leaves carry grad_err).
"""

import os
import sys

sys.path[:] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))] + sys.path[1:]

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from portbench import check, gen, spec  # noqa: E402
from portbench.drivers import denoise, train  # noqa: E402
from portbench.reference import train as ref_train  # noqa: E402
from portbench.reference.specs import MODELS  # noqa: E402
from portbench.run import ROOT, cache_dirs  # noqa: E402


def as_program(p0, bn0, steps) -> dict:
    """A reference run in the shape `check.train_numbers` reads the
    program in."""
    mu1 = {n: {k: (1.0 - ref_train.B1) * g for k, g in d.items()} for n, d in steps.grads.items()}
    return {"losses": steps.losses, "params0": p0, "bn0": bn0, "mu1": mu1,
            "params3": steps.params, "bn3": steps.bn}


def leaf_gaps(prog: dict, ref) -> dict:
    """{leaf: |‖g‖ - ‖g_ref‖| over the larger of ‖g_ref‖ and the median
    leaf's} of the first gradient, for the leaves grad_gap keeps."""
    g_ref = check._leaves(ref.grads)
    g = {k: v / (1.0 - ref_train.B1) for k, v in check._leaves(prog["mu1"]).items()}
    norms = {k: float(np.linalg.norm(v)) for k, v in g_ref.items()}
    med = float(np.median(list(norms.values())))
    return {
        "/".join(k): abs(float(np.linalg.norm(g[k])) - norms[k]) / max(norms[k], med)
        for k in g_ref if norms[k] >= check.EXCLUDE_BELOW * med
    }


def leaf_errs(prog: dict, ref) -> dict:
    """{leaf: [‖g - g_ref‖, ‖g_ref‖]} of the first gradient, for the
    leaves grad_err keeps."""
    g_ref = check._leaves(ref.grads)
    g = {k: v / (1.0 - ref_train.B1) for k, v in check._leaves(prog["mu1"]).items()}
    med = float(np.median([np.linalg.norm(v) for v in g_ref.values()]))
    return {
        "/".join(k): [float(np.linalg.norm(g[k] - v)), float(np.linalg.norm(v))]
        for k, v in g_ref.items() if np.linalg.norm(v) >= check.EXCLUDE_BELOW * med
    }


def bn_errs(prog: dict, p0, bn0, ref) -> dict:
    """{statistic: [‖b - b_ref‖, ‖b_ref‖]} of the running statistics'
    change over the checked steps."""
    b0, b3 = check._leaves(prog["bn0"]), check._leaves(prog["bn3"])
    q0, q3 = check._leaves(bn0), check._leaves(ref.bn)
    return {"/".join(k): [float(np.linalg.norm((b3[k] - b0[k]) - (q3[k] - q0[k]))),
                          float(np.linalg.norm(q3[k] - q0[k]))] for k in q0}


def train_seed(cell, seed: int, device, control: bool) -> dict:
    ini = cell.config["ini"]
    layers = MODELS[ini["model"]["net_work"]]
    tmp = tempfile.mkdtemp(prefix="portbench-cal-")
    try:
        pacer, corpus, _ = train.train_program(cell, seed, 0.0, False, device, tmp, check_only=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    p0, bn0, ref = check.training_reference(layers, seed, ini, corpus, pacer.check_batches, device)
    prog = pacer.program()
    out = {"seed": seed, "program": check.train_numbers(prog, p0, bn0, ref), "leaves": leaf_gaps(prog, ref),
           "leaf_errs": leaf_errs(prog, ref), "bn_errs": bn_errs(prog, p0, bn0, ref),
           "losses": [float(x) for x in prog["losses"]], "ref_losses": ref.losses,
           "longest_samples": [int(max(len(corpus.clean[i]) for i in b)) for b in pacer.check_batches]}
    if control:
        prec = ini["model"].get("compute_dtype", "float32")
        c = check.training_reference(layers, seed, ini, corpus, pacer.check_batches, device,
                                     dsp_bits=check.CONTROL_BITS["float32"],
                                     model_bits=check.CONTROL_BITS[prec])
        out["control"] = check.train_numbers(as_program(*c), p0, bn0, ref)
        out["control_leaves"] = leaf_gaps(as_program(*c), ref)
        out["control_leaf_errs"] = leaf_errs(as_program(*c), ref)
        out["control_bn_errs"] = bn_errs(as_program(*c), p0, bn0, ref)
        out["control_losses"] = c[2].losses
        h = check.training_reference(layers, seed, ini, corpus, pacer.check_batches, device, half_batch=True)
        out["half_batch"] = check.train_numbers(as_program(*h), p0, bn0, ref)
        out["half_batch_leaves"] = leaf_gaps(as_program(*h), ref)
        out["half_batch_leaf_errs"] = leaf_errs(as_program(*h), ref)
        out["half_batch_bn_errs"] = bn_errs(as_program(*h), p0, bn0, ref)
        out["half_batch_losses"] = h[2].losses
    return out


def serve_seed(cell, seed: int, device, control: bool) -> dict:
    from fullycnnspeechenhancement_torch.infer import InferenceEngine

    layers = MODELS[cell.config["ini"]["model"]["net_work"]]
    tmp = tempfile.mkdtemp(prefix="portbench-cal-")
    try:
        config = denoise.program_config(cell, seed, tmp, {"data": {"audio_save_path": f"{tmp}/denoise"}})
        engine = InferenceEngine(config, device=device)
        requests = gen.request_pool(cell.traffic, seed)
        keep = denoise.checked_indices(requests.pool, seed, cell.traffic["checked"])
        _, _, failed, kept, _ = denoise.serve(engine, requests, 0.0, keep)
        del engine
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    refs = {i: check.serving_reference(layers, seed, requests.pool[i], device) for i in keep}
    out = {"seed": seed, "failed": failed,
           "program": check.serve_numbers([(kept[i], refs[i]) for i in keep])}
    if control:
        bits = check.CONTROL_BITS["float32"]
        out["control"] = check.serve_numbers(
            [(check.serving_reference(layers, seed, requests.pool[i], device, bits, bits), refs[i]) for i in keep])
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--controls", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cache_dirs(ROOT)
    cell = spec.load(ROOT, args.workload)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    one = train_seed if cell.traffic["driver"] == "train" else serve_seed
    for i, seed in enumerate(args.seeds):
        t0 = time.perf_counter()
        line = one(cell, seed, device, i < args.controls)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps({"workload": cell.name} | line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
