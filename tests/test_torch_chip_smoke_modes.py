"""``chip_smoke.py``'s command line on a host without a CUDA device: each
mode exits non-zero before printing any result, and an unknown argument
is refused."""

import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [["--measure"], ["--serve-split"],
                                  ["--measure", "--serve-split"],
                                  ["--serve"]])
def test_modes_fail_without_a_card(argv):
    r = subprocess.run(
        [sys.executable, "chip_smoke.py", *argv], cwd=REPO,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and '"kernels"' not in r.stdout
    if argv in (["--measure"], ["--serve-split"]):
        assert "no CUDA device" in r.stderr
    else:
        assert "unknown arguments" in r.stderr
