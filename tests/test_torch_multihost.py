"""The port's process-group glue (`parallel/multihost.py`): the
single-host identity (tests/test_aux.py:12), an explicitly configured pod
that fails to start raises instead of running alone
(tests/test_multihost.py:321), and FCSE_MULTIHOST=1 initialisation in
spawned ranks on one node and as two one-rank hosts, and a data-parallel
run over two hosts that trains the items a single process trains."""

import os
import socket

import pytest
import torch
import torch.distributed as dist

from conftest import make_corpus
from fullycnnspeechenhancement_torch.cli import train as train_cli
from fullycnnspeechenhancement_torch.config import load_ini_config
from fullycnnspeechenhancement_torch.parallel import multihost
from torch_dp_ranks import env_ranks, epoch_rows, spawn

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
        "FCSE_MULTIHOST")


@pytest.fixture
def clean_env(monkeypatch):
    for k in _ENV:
        monkeypatch.delenv(k, raising=False)


def test_multihost_identity_single_host(clean_env):
    multihost.maybe_initialize_from_env(device="cpu")
    multihost.initialize_multihost(device="cpu")  # nothing configured: stays single
    assert not dist.is_initialized()
    assert multihost.host_index() == 0
    assert multihost.host_count() == 1
    assert multihost.local_rank() == 0
    assert multihost.local_batch_size(8) == 8
    assert multihost.default_backend("cuda:1") == "nccl"
    assert multihost.default_backend("cpu") == "gloo"


def test_explicit_pod_config_failure_raises(clean_env, monkeypatch):
    """A pod named by arguments, or by the environment, that cannot start
    raises RuntimeError; the process is left without a group."""
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.initialize_multihost("tcp://127.0.0.1:1", 2, 1, backend="gloo", device="cpu",
                                       timeout_s=2)
    assert not dist.is_initialized()
    monkeypatch.setenv("FCSE_MULTIHOST", "1")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setenv("FCSE_DIST_TIMEOUT_S", "2")
    with pytest.raises(RuntimeError, match="refusing to fall back"):
        multihost.maybe_initialize_from_env(device="cpu")
    assert not dist.is_initialized()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("local_world", [2, 1], ids=["one_node", "two_hosts"])
def test_env_initialisation_in_spawned_ranks(tmp_path, local_world):
    """Two spawned processes join one gloo group from FCSE_MULTIHOST=1 and
    the torchrun variables alone; on one node they are host 0 of 1 with
    local ranks 0 and 1, as two one-rank nodes hosts 0 and 1 of 2, each
    feeding half the global batch."""
    spawn(env_ranks, 2, tmp_path, (_free_port(), local_world, str(tmp_path)), join_group=False)
    seen = [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(2)]
    for r, s in enumerate(seen):
        assert (s["backend"], s["rank"], s["world"], s["sum"]) == ("gloo", r, 2, 3.0)
        if local_world == 2:
            assert (s["host_index"], s["host_count"], s["local_rank"], s["local_batch"]) == (0, 1, r, 8)
        else:
            assert (s["host_index"], s["host_count"], s["local_rank"], s["local_batch"]) == (r, 2, 0, 4)


@pytest.mark.parametrize("use_device_cache", [False, True], ids=["host_loader", "device_cache"])
def test_two_hosts_train_the_single_process_epoch(tmp_path, use_device_cache):
    """`data_parallel=2` over two one-rank hosts: each rank's rows of
    `cli.train`'s train loader over an epoch, together, are the items a
    single process trains in that epoch, as often (a manifest split by
    host would leave each host a half of its own batches and drop the
    rest)."""
    corpus = make_corpus(str(tmp_path))
    ini = tmp_path / "dp.cfg"
    # the cache mixes by random crops of noise longer than every utterance;
    # this corpus's noise is shorter, so the cache trains on its premixed pairs
    data = (f"train_manifest_path={corpus['premixed']}\n" if use_device_cache else
            f"train_manifest_path={corpus['clean']}\ntrain_noise_manifest={corpus['noise']}\n")
    ini.write_text(f"[training]\nbatch_size=2\ndata_parallel=2\n[data]\n{data}use_device_cache={use_device_cache}\n")
    spawn(epoch_rows, 2, tmp_path, (str(ini), str(tmp_path)))
    seen = [torch.load(os.path.join(tmp_path, f"rank{r}.pt")) for r in range(2)]
    assert [s["hosts"] for s in seen] == [(0, 2), (1, 2)]
    single = train_cli.build_loaders(load_ini_config(str(ini)), 1)[0]
    single.set_epoch(0)
    want = sorted(int(i) for b in single for i in b.indices)
    assert set(want) == set(range(6))  # every item (a bucket's last batch repeats some)
    assert sorted(seen[0]["indices"] + seen[1]["indices"]) == want
