"""Platform plumbing: the compile-cache directory, the device record every
measurement prints, and the entry points that must refuse to run without a
GPU (-gpu:<id>, bench.py, chip_smoke.py, the multi-device dry run)."""

import os
import sys

import jax
import pytest

from dualsphysics_multilayer import cli
from dualsphysics_multilayer.utils import compilecache, device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_honours_env(tmp_path, monkeypatch, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    compilecache.enable_cache()
    assert compilecache.cache_dir() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_compile_cache_default_is_checkout_root(monkeypatch,
                                                restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    compilecache.enable_cache()
    assert jax.config.jax_compilation_cache_dir == os.path.join(
        ROOT, ".jax_cache")


def test_device_record_names_the_device():
    rec = device.device_record()
    assert rec == {"platform": "cpu", "kind": jax.devices()[0].device_kind,
                   "count": len(jax.devices())}


def test_require_gpu_refuses_the_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        device.require_gpu()


def test_gpu_name_power_without_nvidia_smi(monkeypatch):
    monkeypatch.setattr(device.shutil, "which", lambda name: None)
    assert device.gpu_name_power() == "not available"


@pytest.mark.parametrize("gid,msg", [("3", "no GPU"), ("x", "integer")])
def test_cli_gpu_id_rejected(gid, msg):
    with pytest.raises(SystemExit, match=msg):
        cli._use_gpu(gid)


def test_cli_start_line_prints_path(tmp_path, capsys):
    rc = cli.main(["-builtin", "dambreak2d", "-dp", "0.09",
                   "-tmax:0.002", "-tout:0.002", "-dirout",
                   str(tmp_path / "out")])
    assert rc == 0
    start = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[dsphjax] case=")]
    assert len(start) == 1 and "path=bucket" in start[0]
    assert "device=" in start[0]


def test_bench_requires_gpu(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    import bench
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()


def test_chip_smoke_fails_without_gpu(monkeypatch, capsys):
    monkeypatch.syspath_prepend(ROOT)
    import chip_smoke
    with pytest.raises(SystemExit) as e:
        chip_smoke.main([])
    assert e.value.code != 0
    assert '"ok"' not in capsys.readouterr().out


def test_dryrun_refuses_missing_devices():
    from dualsphysics_multilayer.parallel.sharding import dryrun
    with pytest.raises(RuntimeError, match="needs 64 devices"):
        dryrun(64)
