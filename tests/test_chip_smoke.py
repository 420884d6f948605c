"""chip_smoke.py: the contract of its exit code and last line, and each
phase at a small size on CPU devices."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from descriptools_jax.pipeline import PipelineConfig
from descriptools_jax.verify import sample_checks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PipelineConfig()


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_refuses_a_cpu_device():
    p = _run_script(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert p.returncode != 0
    assert "no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_fails_without_the_rest_of_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    p = _run_script(str(tmp_path), "chip_smoke.py")
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


def test_result_line_has_exactly_the_contract_keys():
    line = json.loads(chip_smoke.result_line(jax.devices()[:1]))
    assert set(line) == {"ok", "device"}
    assert line["ok"] is True
    assert set(line["device"]) == {"platform", "kind", "count"}
    dev = jax.devices()[0]
    assert line["device"] == {"platform": dev.platform,
                              "kind": dev.device_kind, "count": 1}


@pytest.fixture(scope="module")
def small():
    inp = chip_smoke.make_inputs(96, seed=2)
    out = chip_smoke.phase_suite(inp, CFG, jax.devices()[0], n_windows=3,
                                 win=32, halo=16)
    return inp, out


def test_phase_suite_small(small):
    inp, out = small
    assert out["hand"].shape == inp["dem"].shape
    assert (out["indices"] != -100).any()


def test_phase_tiled_small(small):
    inp, out = small
    chip_smoke.phase_tiled(inp, CFG, out, tile=48)


def test_phase_four_on_virtual_devices():
    inp = chip_smoke.make_inputs(64, seed=3)
    chip_smoke.phase_four(inp, CFG, jax.devices()[:4])


def test_compare_outputs_catches_a_differing_cell(small):
    _, out = small
    bad = dict(out, hand=out["hand"].copy())
    bad["hand"][40, 40] += 1
    with pytest.raises(chip_smoke.CheckFailed, match="hand"):
        chip_smoke.compare_outputs(bad, out, "injected")


@pytest.mark.parametrize("key,delta", [
    ("hand", 1), ("indices", 1), ("slope", 0.01), ("downslope", 0.01),
    ("fdist", 5.0), ("gfi", 0.01),
])
def test_window_check_catches_injected_error(small, key, delta):
    inp, out = small
    loaders = chip_smoke._loaders(inp)

    def run(o):
        return sample_checks(loaders, inp["dem"].shape, o, CFG,
                             np.random.default_rng(7), n_windows=2, win=32,
                             halo=16)

    clean = run(out)
    assert clean["ok"], clean["failures"]
    ys, xs = clean["windows"][0]["ys"], clean["windows"][0]["xs"]
    bad = dict(out)
    bad[key] = out[key].copy()
    region = bad[key][ys:ys + 32, xs:xs + 32]
    live = region != -100
    region[live] = region[live] + np.asarray(delta, region.dtype)
    got = run(bad)
    assert not got["ok"]
    assert any(key in f for f in got["failures"])
