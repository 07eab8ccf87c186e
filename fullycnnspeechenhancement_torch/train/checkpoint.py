"""Checkpoints of the port, the npz bridge and the state carrier.

Counterpart of `fullycnnspeechenhancement_tpu/train/checkpoint.py`.

The port's own format (`CheckpointManager`): one `torch.save` file per
epoch, `<checkpoints_path>/<run_name>/epoch_<N>.pt`, holding the params
(OIHW kernels), BN state, TF-Adam moments and count, the step and the
epoch, all as CPU tensors.  The JAX package writes orbax directories in
the same place; those cannot be read without JAX.

The npz layout is the reference's TF variable names with HWIO kernels, the
same file both packages read and write:

  {scope}/kernel                     -> params[scope]['w']  (HWIO <-> OIHW)
  {scope}/bias                       -> params[scope]['b']
  {scope}/batch_norm/gamma           -> params[scope]['gamma']
  {scope}/batch_norm/beta            -> params[scope]['beta']
  {scope}/batch_norm/moving_mean     -> bn_state[scope]['mean']
  {scope}/batch_norm/moving_variance -> bn_state[scope]['var']

`params_from_numpy` and `train_state_from_numpy` carry the JAX package's
pytrees (as numpy arrays) into the port, so the two can start from one
state.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
from typing import Optional, Tuple

import numpy as np
import torch

from fullycnnspeechenhancement_torch.models.rced import ModelDef
from fullycnnspeechenhancement_torch.train.optim import TFAdamState
from fullycnnspeechenhancement_torch.train.step import TrainState, state_from_tensors

FORMAT = "fullycnnspeechenhancement_torch/1"
_EPOCH_FILE = re.compile(r"^epoch_(\d+)\.pt$")


def hwio_to_oihw(w) -> torch.Tensor:
    return torch.tensor(np.asarray(w, np.float32)).permute(3, 2, 0, 1).contiguous()


def oihw_to_hwio(w: torch.Tensor) -> np.ndarray:
    return w.detach().cpu().permute(2, 3, 1, 0).numpy()


def params_from_numpy(params, bn_state, device="cpu") -> Tuple[dict, dict]:
    """The JAX package's (params, bn_state) pytrees, as numpy arrays with
    HWIO kernels, -> the port's dicts of float32 tensors with OIHW kernels."""

    def tensor(v):
        return torch.tensor(np.asarray(v, np.float32), device=device)

    out_p = {
        name: {
            k: (hwio_to_oihw(v).to(device) if k == "w" else tensor(v))
            for k, v in p.items()
        }
        for name, p in params.items()
    }
    out_s = {name: {k: tensor(v) for k, v in s.items()} for name, s in bn_state.items()}
    return out_p, out_s


def train_state_from_numpy(params, bn_state, mu, nu, step, device="cpu") -> TrainState:
    """The JAX package's TrainState parts, as numpy pytrees with HWIO
    kernels (params, bn_state, TF-Adam `mu` and `nu`, and the step, which
    is also the Adam count) -> the port's TrainState on `device`."""
    p, s = params_from_numpy(params, bn_state, device)
    m, _ = params_from_numpy(mu, {}, device)
    v, _ = params_from_numpy(nu, {}, device)
    count = torch.tensor(int(np.asarray(step)), dtype=torch.int64, device=device)
    return state_from_tensors(p, s, TFAdamState(count, m, v), count.clone())


def import_reference_npz(npz_path: str, model: ModelDef, device="cpu") -> Tuple[dict, dict]:
    """Load a reference TF-checkpoint npz dump into (params, bn_state)."""
    blob = dict(np.load(npz_path))
    params, bn_state = {}, {}
    for spec in model.layers:
        name = spec.name
        p = {"w": blob[f"{name}/kernel"], "b": blob[f"{name}/bias"]}
        if spec.use_norm:
            p["gamma"] = blob[f"{name}/batch_norm/gamma"]
            p["beta"] = blob[f"{name}/batch_norm/beta"]
            bn_state[name] = {
                "mean": blob[f"{name}/batch_norm/moving_mean"],
                "var": blob[f"{name}/batch_norm/moving_variance"],
            }
        params[name] = p
    return params_from_numpy(params, bn_state, device)


def export_params_npz(path: str, params: dict, bn_state: dict) -> None:
    """Inverse of `import_reference_npz`: write the port's dicts in the
    reference's TF variable-name layout, kernels back in HWIO."""
    out = {}
    for name, p in params.items():
        out[f"{name}/kernel"] = oihw_to_hwio(p["w"])
        out[f"{name}/bias"] = p["b"].detach().cpu().numpy()
        if "gamma" in p:
            out[f"{name}/batch_norm/gamma"] = p["gamma"].detach().cpu().numpy()
            out[f"{name}/batch_norm/beta"] = p["beta"].detach().cpu().numpy()
    for name, s in bn_state.items():
        out[f"{name}/batch_norm/moving_mean"] = s["mean"].detach().cpu().numpy()
        out[f"{name}/batch_norm/moving_variance"] = s["var"].detach().cpu().numpy()
    np.savez(path, **out)


def _to_cpu(tree):
    return {n: {k: v.detach().cpu().clone() for k, v in d.items()} for n, d in tree.items()}


def _to_device(tree, device):
    return {n: {k: v.to(device) for k, v in d.items()} for n, d in tree.items()}


def _state_dict(state: TrainState, epoch: int) -> dict:
    """The file contents for `state`: CPU tensors and plain numbers."""
    return {
        "format": FORMAT,
        "epoch": epoch,
        "step": state.step.detach().cpu(),
        "params": _to_cpu(state.params),
        "bn_state": _to_cpu(state.bn_state),
        "opt_state": {
            "count": state.opt_state.count.detach().cpu(),
            "mu": _to_cpu(state.opt_state.mu),
            "nu": _to_cpu(state.opt_state.nu),
        },
    }


def read_checkpoint_file(path: str) -> dict:
    """Load one checkpoint file of this package (tensors only, so
    `weights_only` loading)."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(blob, dict) or blob.get("format") != FORMAT:
        raise ValueError(f"{path} is not a checkpoint of this package ({FORMAT})")
    return blob


def _state_from_dict(blob: dict, device) -> TrainState:
    opt = blob["opt_state"]
    return state_from_tensors(
        _to_device(blob["params"], device),
        _to_device(blob["bn_state"], device),
        TFAdamState(
            opt["count"].to(device), _to_device(opt["mu"], device), _to_device(opt["nu"], device)
        ),
        blob["step"].to(device),
    )


def _epoch_files(run_dir: str) -> dict:
    """{epoch: path} of the checkpoint files in `run_dir`."""
    if not os.path.isdir(run_dir):
        return {}
    out = {}
    for name in os.listdir(run_dir):
        m = _EPOCH_FILE.match(name)
        if m:
            out[int(m.group(1))] = os.path.join(run_dir, name)
    return out


def find_checkpoint(path: str) -> Optional[str]:
    """`path` if it is a checkpoint file of this package, the latest epoch's
    file if it is a run directory holding some, else None."""
    if os.path.isfile(path) and path.endswith(".pt"):
        return path
    files = _epoch_files(path)
    return files[max(files)] if files else None


def load_params(path: str, device="cpu") -> Tuple[dict, dict]:
    """(params, bn_state) from a checkpoint file or run directory of this
    package, as plain tensors on `device`."""
    found = find_checkpoint(path)
    if found is None:
        raise FileNotFoundError(f"{path}: no checkpoint of this package")
    blob = read_checkpoint_file(found)
    return _to_device(blob["params"], device), _to_device(blob["bn_state"], device)


class CheckpointManager:
    """One checkpoint file per epoch under `<root>/<run_name>/`, keeping
    the newest `max_to_keep`.

    `save` snapshots the state to host memory at once and writes the file
    on a background thread, so the next epoch's steps overlap the write;
    `wait`, `restore`, `latest_epoch` and `close` wait for pending writes
    and raise what they raised.  Each file is written under a temporary
    name and renamed, so a reader sees a whole file or none."""

    def __init__(self, root: str, run_name: str, max_to_keep: int = 10):
        self.dir = os.path.abspath(os.path.join(root, run_name))
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=1)
        self._pending = []

    def save(self, epoch: int, state: TrainState) -> None:
        blob = _state_dict(state, epoch)
        self._pending.append(self._pool.submit(self._write, epoch, blob))

    def _write(self, epoch: int, blob: dict) -> None:
        path = os.path.join(self.dir, f"epoch_{epoch}.pt")
        tmp = f"{path}.tmp"
        torch.save(blob, tmp)
        os.replace(tmp, path)
        files = _epoch_files(self.dir)
        for old in sorted(files)[: max(0, len(files) - self.max_to_keep)]:
            os.unlink(files[old])

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for fut in pending:
            fut.result()

    def latest_epoch(self) -> Optional[int]:
        self.wait()
        files = _epoch_files(self.dir)
        return max(files) if files else None

    def restore(self, state_like: TrainState, epoch: Optional[int] = None):
        """(state, epoch) from the given or the latest epoch, on the
        device of `state_like`; (None, None) when there is none."""
        self.wait()
        files = _epoch_files(self.dir)
        if epoch is None:
            epoch = max(files) if files else None
        if epoch is None:
            return None, None
        blob = read_checkpoint_file(files[epoch])
        return _state_from_dict(blob, state_like.step.device), epoch

    def close(self) -> None:
        try:
            self.wait()
        finally:
            self._pool.shutdown(wait=True)
