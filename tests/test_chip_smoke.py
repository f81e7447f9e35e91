"""chip_smoke.py on the CPU: every phase at a tiny size against its
reference, the four-card phase on 4 virtual devices, the device check, the
contract line, and the compile-cache helper.  The full-size phases are
marked ``gpu`` and run on the card."""

import json
import os
import sys
from types import SimpleNamespace

import jax
import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from htool_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# tiny sizes of each one-card phase: same code path, CPU-sized
TINY = {
    "matvec": dict(n=1500, max_leaf_size=64),
    "precision": dict(n=1500, max_leaf_size=64),
    "complex": dict(n=1200, max_leaf_size=64),
    "blr2_lu": dict(n=1200, max_leaf_size=64, coarse_size=512),
    "ddm": dict(n=1500, P=4, max_leaf_size=64, overlap_radius=0.15),
    "geneo": dict(n=1200, P=4, max_leaf_size=64, overlap_radius=0.15),
}
PHASES = dict(chip_smoke.ONE_CARD_PHASES)


@pytest.mark.parametrize("name", list(TINY))
def test_phase_matches_reference(name):
    result = PHASES[name](**TINY[name])
    assert result["checks"], name
    assert chip_smoke.failed_checks(result) == [], result
    line = chip_smoke.format_phase(name, result, 0.0)
    assert line.startswith(f"phase {name}: ok ") and "(compile included)" in line


def test_four_card_phase_on_virtual_devices():
    devices = jax.devices("cpu")[:4]
    assert len(devices) == 4
    result = chip_smoke.phase_four_cards(
        n=1200, max_leaf_size=64, overlap_radius=0.15, devices=devices
    )
    assert chip_smoke.failed_checks(result) == [], result
    assert result["sizes"]["devices"] == 4


def test_main_refuses_cpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert "needs a GPU" in str(exc.value.code)
    out = capsys.readouterr().out
    assert "platform=cpu" in out and '"ok"' not in out


def test_contract_line_for_a_gpu():
    fake = [SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")]
    summary = chip_smoke.device_summary(fake)
    chip_smoke.require_gpu(summary)
    line = chip_smoke.contract_line(summary)
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    assert json.loads(line)["device"]["count"] == 1
    with pytest.raises(SystemExit):
        chip_smoke.require_gpu(summary, min_count=4)


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_dir(tmp_path, monkeypatch, env_set):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "env"))
            assert enable_compile_cache(str(tmp_path)) == str(tmp_path / "env")
            # JAX reads the variable itself: the helper sets nothing
            assert jax.config.jax_compilation_cache_dir == before
            assert not (tmp_path / ".jax_cache").exists()
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = enable_compile_cache(str(tmp_path))
            assert got == str(tmp_path / ".jax_cache")
            assert os.path.isdir(got)
            assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(TINY))
def test_phase_full_size_on_gpu(gpu, name):
    result = PHASES[name]()
    assert chip_smoke.failed_checks(result) == [], result
    assert np.isfinite([v for _, v, _ in result["checks"]]).all()
