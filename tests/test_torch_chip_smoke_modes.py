"""``chip_smoke.py``'s command line on a host without a CUDA device: each
mode exits non-zero before printing any result, and an unknown argument
is refused; and its report of the K7 kernels from readings shaped as the
card's."""

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


def test_chain_kernel_lines_take_the_b16_bf16_headline():
    """``chain_kernel_lines`` on rows shaped as ``check_block_chain``
    returns them: one entry a K7 kernel, its times from the bf16 row at
    B/16's rows, ``max_abs_err`` the largest of the checks, and the slice's
    launches."""
    sys.path.insert(0, REPO)
    import chip_smoke as C

    def timing(n_rows, dtype, ms):
        return {"n_rows": n_rows, "E": 768, "dtype": dtype, "ms": ms,
                "device_ms": ms, "plain_ms": 4 * ms, "library_ms": 4 * ms,
                "plain_device_ms": 4 * ms, "vs_plain": 0.25,
                "bound_ms": ms / 2, "bound_by": "bytes"}

    rows = {fn.__name__: [
        {"n_rows": 12800, "E": 768, "dtype": "float32", "max_abs_err": 0.5},
        {"n_rows": 50432, "E": 768, "dtype": "bfloat16", "max_abs_err": 2.0},
        timing(50432, "float32", 3.0), timing(12800, "bfloat16", 1.0),
        timing(50432, "bfloat16", 2.0)] for fn in C.K7.KERNELS}
    launched = {name: i for i, name in enumerate(rows)}
    lines = C.chain_kernel_lines(rows, launched)
    assert [line["name"] for line in lines] == [
        "block_ln", "block_bias", "block_bias_residual_ln", "block_bias_gelu",
        "block_bias_residual"]
    for i, line in enumerate(lines):
        assert (line["ms"], line["library_ms"], line["bound_ms"]) == \
            (2.0, 8.0, 1.0)
        assert line["max_abs_err"] == 2.0 and line["launches"] == i
        assert line["source"] == "msclip_torch/csrc/block_chain.cu"
        assert line["shape"] == "rows=50432 E=768 bfloat16"
