"""The port's tool gates (celestia_tpu_torch/tools/) as a set: each twin
runs on the card unless asked for the CPU, and without a card and without
``--device cpu`` it exits 1 naming the card, before any work.  The twins'
own runs are in tests/test_torch_<name>_smoke.py, one file a twin."""

import importlib
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from celestia_tpu_torch import tools

REPO = Path(__file__).resolve().parents[1]

TWINS = ["das_smoke", "swarm_smoke", "ingress_smoke", "device_resident_smoke",
         "profile_smoke", "trace_smoke", "critpath_smoke", "incident_smoke",
         "multichip_smoke"]


@pytest.mark.parametrize("name", TWINS)
def test_twin_without_a_card_exits_1_naming_the_card(name, monkeypatch, capsys):
    monkeypatch.delenv(tools.ENV_DEVICE, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"celestia_tpu_torch.tools.{name}")
    assert mod.main([]) == 1
    err = capsys.readouterr().err
    assert "no CUDA card" in err and "--device cpu" in err
    # an explicit CUDA device fails the same way; the switch does not help it
    monkeypatch.setenv(tools.ENV_DEVICE, "cpu")
    assert mod.main(["--device", "cuda:0"]) == 1
    assert "no CUDA card" in capsys.readouterr().err


def test_python_m_without_a_card_exits_1_naming_the_card():
    env = {k: v for k, v in __import__("os").environ.items() if k != tools.ENV_DEVICE}
    env["CUDA_VISIBLE_DEVICES"] = ""  # no card, here or on a machine with one
    out = subprocess.run([sys.executable, "-m", "celestia_tpu_torch.tools.das_smoke"],
                         capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 1 and out.stdout == ""
    assert "no CUDA card" in out.stderr


def test_the_device_resolves_from_the_flag_then_the_switch(monkeypatch):
    monkeypatch.setenv(tools.ENV_DEVICE, "cpu")
    assert tools.resolve(None) == torch.device("cpu")
    assert tools.resolve("cpu") == torch.device("cpu")
    with pytest.raises(SystemExit, match="unsupported device"):
        tools.resolve("meta")
    assert tools.device_label(torch.device("cuda")) == "cuda:0"


def test_exposition_counts_reads_launches_and_the_work_that_predicts_them():
    text = "\n".join([
        'celestia_tpu_kernel_launches_total{kernel="rs_extend"} 4',
        'celestia_tpu_kernel_launches_total{kernel="das_proof_gather"} 3',
        "celestia_tpu_eds_cache_miss_prepare_total 1",
        "celestia_tpu_eds_cache_miss_process_total 1",
        "celestia_tpu_block_artifacts_rebuilt_total 0",
        'celestia_tpu_das_latency_light_seconds_count 2',
        'celestia_tpu_das_latency_bulk_seconds_count 1',
    ]) + "\n"
    assert tools.exposition_counts(text) == {
        "launches": {"rs_extend": 4, "das_proof_gather": 3},
        "misses": 2, "rebuilt": 0, "chunks": 3}
    assert tools.thread_share(3)["CELESTIA_TPU_TORCH_CPU_THREADS"] == str(
        max(1, (__import__("os").cpu_count() or 1) // 3))
