"""chip_smoke.py's phase functions at tiny sizes on the CPU (the same
comparisons the script makes at 1080p on the card), and its refusals: no
GPU, or no package beside it, means a non-zero exit and no result line."""

import importlib.util
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

from hevcasm_tpu.encode import EncodeConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402

CFG = EncodeConfig(search_range=8, qp=32)


@pytest.fixture(scope="module")
def clip_path(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("clip") / "clip.y4m")
    clip = chip_smoke.write_clip(path, 3, 3, 128, 192)
    return path, clip


def test_ops_phase_tiny():
    assert chip_smoke.check_ops((1, 2), seed=5) == {"ctus": 2, "intra_blocks": 8}


def test_clip_roundtrip_is_seeded(clip_path, tmp_path):
    path, clip = clip_path
    assert clip.y.shape == (3, 128, 192) and clip.cb.shape == (3, 64, 96)
    again = chip_smoke.write_clip(str(tmp_path / "again.y4m"), 3, 3, 128, 192)
    np.testing.assert_array_equal(np.asarray(again.y), np.asarray(clip.y))
    other = chip_smoke.write_clip(str(tmp_path / "other.y4m"), 4, 3, 128, 192)
    assert not np.array_equal(np.asarray(other.y), np.asarray(clip.y))


def test_gop_phase_tiny(clip_path):
    out = chip_smoke.check_gop(clip_path[1], CFG)
    assert len(out["psnr_y"]) == 3


def test_cli_phase_tiny(clip_path):
    out = chip_smoke.check_cli(clip_path[0], 3)
    assert out["size"] == "192x128"


@pytest.mark.parametrize("phase", ["check_b_frame", "check_pu_decision",
                                   "check_rate_control"])
def test_reference_phases_tiny(clip_path, phase):
    getattr(chip_smoke, phase)(clip_path[1], CFG)


def test_first_times_tiny(clip_path, capsys):
    out = chip_smoke.first_times(clip_path[1], CFG, "label", reps=1)
    assert set(out["ms"]) >= {"P frame luma", "B frame 4:2:0", "ssd_grid alone"}
    assert "[label] peak_bytes_in_use" in capsys.readouterr().out


def test_four_cards_phase_on_cpu_mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    out = chip_smoke.check_four_cards(1, CFG, sizes=((128, 192), (256, 192)))
    assert out["dp_frames"] == 4 and len(out["closed_loop_psnr"]) == 3


def test_assert_same_counts_mismatches():
    chip_smoke.assert_same("eq", np.arange(4), np.arange(4))
    with pytest.raises(AssertionError, match="1 of 4 elements differ"):
        chip_smoke.assert_same("ne", np.arange(4), np.array([0, 1, 2, 4]))
    with pytest.raises(AssertionError, match="shape"):
        chip_smoke.assert_same("shape", np.arange(4), np.arange(5))


def test_phases_record_failures(capsys):
    phases = chip_smoke.Phases("card")
    assert phases.run("good", lambda: {"x": 1}) == {"x": 1}
    assert phases.run("array", lambda: np.zeros(3)).shape == (3,)
    assert phases.run("bad", lambda: 1 / 0) is None
    assert phases.failed == ["bad"]
    assert "FAIL bad" in capsys.readouterr().out


def test_main_refuses_the_cpu(capsys):
    assert chip_smoke.main([]) == 1
    out = capsys.readouterr()
    assert "needs 1 GPU" in out.err and '"ok"' not in out.out


@pytest.mark.parametrize("script", ["bench.py", "tools/bench_rdo.py",
                                    "tools/trace_frame.py"])
def test_timing_scripts_refuse_the_cpu(script, capsys):
    spec = importlib.util.spec_from_file_location(
        "timed_script", os.path.join(ROOT, script))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    with pytest.raises(SystemExit) as exc:
        module.main()
    assert exc.value.code == 1
    out = capsys.readouterr()
    assert "needs 1 GPU" in out.err and out.out == ""


def test_script_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert not any(line.startswith("{") for line in proc.stdout.splitlines())
    assert "hevcasm_tpu" in proc.stderr


@pytest.mark.gpu
def test_ops_at_1080p_on_the_card(gpu_device):
    assert chip_smoke.check_ops((17, 30), seed=0)["ctus"] == 510


@pytest.mark.gpu
def test_main_path_at_1080p_on_the_card(gpu_device, tmp_path):
    clip = chip_smoke.write_clip(str(tmp_path / "clip.y4m"), 0, 3, 1088, 1920)
    chip_smoke.check_gop(clip, EncodeConfig(search_range=32, qp=32))
