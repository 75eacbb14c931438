"""The command itself: without a card it fails and prints no result; on
the card (marked ``cuda``, skipped without one) a short run of the first
cell is correct and names the card."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

COMMAND = [sys.executable, os.path.join(ROOT, "raybench", "run.py"),
           "--workload", "bunny-1080p.static", "--seed", str(2**35 + 1),
           "--seconds", "1", "--trace", "0"]


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(COMMAND, capture_output=True, text=True, cwd=ROOT,
                          env=env, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    proc = subprocess.run(COMMAND, capture_output=True, text=True, cwd=ROOT,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(result)[-1] == "compared"
