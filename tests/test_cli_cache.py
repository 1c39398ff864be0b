"""The command line's platform choice and the compilation-cache rule."""

import os

import pytest

from hevcasm_tpu import cli
from hevcasm_tpu.utils import cache


@pytest.mark.parametrize("platform", ["auto", "cpu", "gpu"])
def test_platform_choices(platform):
    args = cli.build_parser().parse_args(["--platform", platform, "info"])
    assert args.platform == platform and args.cmd == "info"


def test_platform_rejects_unknown():
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["--platform", "metal", "info"])


def test_encode_input_arguments():
    args = cli.build_parser().parse_args(
        ["encode", "--input", "clip.y4m", "--frames", "8", "--search-range", "32"])
    assert (args.input, args.frames, args.search_range) == ("clip.y4m", 8, 32)


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.cache_dir() == os.path.join(root, ".jax_cache")


def test_enable_sets_no_dir_when_env_is_set(monkeypatch, tmp_path):
    import jax

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert cache.enable_persistent_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before
