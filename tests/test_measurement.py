"""Measurement plumbing: compile cache location, the peak table, the
profiler-trace reduction, per-pass timing, and chip_smoke.py's refusal to
run without a GPU."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from tpu_pathtracer.render import benchmark
from tpu_pathtracer.render.timing import PassTimer
from tpu_pathtracer.utils import compcache, devtime
from tpu_pathtracer.utils.devtime import WINDOW, Event, reduce_events

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# --- compile cache ---------------------------------------------------------


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compcache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compcache.cache_dir() == os.path.join(ROOT, ".jax_cache")
    assert ".jax_cache/" in open(os.path.join(ROOT, ".gitignore")).read()


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_sets_only_the_one_directory(tmp_path, env_set):
    """In a fresh process: with the variable set, JAX's own reading of it
    stands and the code sets no path; without it, the fixed default."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path)
    code = ("import jax\n"
            "from tpu_pathtracer.utils.compcache import enable_compilation_cache\n"
            "print(enable_compilation_cache())\n"
            "print(jax.config.jax_compilation_cache_dir)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    used, configured = out.stdout.split()
    expect = str(tmp_path) if env_set else os.path.join(ROOT, ".jax_cache")
    assert used == configured == expect


def test_no_other_cache_path_in_code():
    hits = []
    for dirpath, _, files in os.walk(os.path.join(ROOT, "tpu_pathtracer")):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                if "jax_compilation_cache_dir" in open(path).read():
                    hits.append(os.path.relpath(path, ROOT))
    assert hits == [os.path.join("tpu_pathtracer", "utils", "compcache.py")]


# --- peak table -------------------------------------------------------------


class _FakeDevice:
    def __init__(self, platform, kind):
        self.platform = platform
        self.device_kind = kind


def test_peak_table_has_h100():
    peaks = benchmark.PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks == {"flops_f32": 67e12, "hbm_bps": 3.35e12}
    assert benchmark.device_peaks(
        _FakeDevice("gpu", "NVIDIA H100 80GB HBM3")) is peaks


def test_unknown_accelerator_raises():
    with pytest.raises(ValueError, match="no published peaks"):
        benchmark.device_peaks(_FakeDevice("gpu", "Some Future Card"))


def test_cpu_has_no_peaks():
    assert benchmark.device_peaks() is None  # tests run on the CPU
    assert benchmark.device_peaks(_FakeDevice("cpu", "cpu")) is None


# --- trace reduction --------------------------------------------------------

GPU = "/device:GPU:0"
STREAM = "Stream #13(Compute,MemcpyD2D)"


def _op(start, dur, plane=GPU, line=STREAM, name="fusion"):
    return Event(plane, line, name, float(start), float(dur))


def test_busy_is_the_union_of_overlapping_ops():
    events = [_op(0, 100), _op(50, 100), _op(300, 100, name="mt_kernel"),
              Event("/host:CPU", "python", WINDOW, 0.0, 500.0)]
    r = reduce_events(events)
    assert r["ok"]
    assert r["busy_s"] == pytest.approx(250e-9)
    assert r["window_s"] == pytest.approx(500e-9)
    assert r["idle_share"] == pytest.approx(0.5)
    assert r["ops"] == {"fusion": pytest.approx(200e-9),
                        "mt_kernel": pytest.approx(100e-9)}


def test_ops_are_clipped_to_the_window():
    events = [_op(-100, 200), _op(900, 200),
              Event("/host:CPU", "python", WINDOW, 0.0, 1000.0)]
    r = reduce_events(events)
    assert r["busy_s"] == pytest.approx(200e-9)
    assert r["idle_share"] == pytest.approx(0.8)


def test_derived_lines_and_host_planes_are_skipped():
    """'XLA Modules'/'XLA Ops' lines span whole programs; host threads are
    not the device: neither counts as busy."""
    events = [_op(0, 100),
              _op(0, 1000, line="XLA Modules", name="jit_step"),
              _op(0, 1000, line="XLA Ops", name="fusion"),
              Event("/host:CPU", "tf_XLAPjRtCpuClient/1", "dot", 0.0, 900.0),
              Event("/host:CPU", "python", WINDOW, 0.0, 1000.0)]
    r = reduce_events(events)
    assert r["busy_s"] == pytest.approx(100e-9)
    assert list(r["ops"]) == ["fusion"]


def test_two_devices_are_averaged_and_window_defaults_to_op_span():
    events = [_op(0, 100), _op(100, 300, plane="/device:GPU:1")]
    r = reduce_events(events)
    assert r["window_s"] == pytest.approx(400e-9)
    assert r["devices"] == {GPU: pytest.approx(100e-9),
                            "/device:GPU:1": pytest.approx(300e-9)}
    assert r["busy_s"] == pytest.approx(200e-9)


def test_no_device_ops_is_not_ok():
    r = reduce_events([Event("/host:CPU", "python", WINDOW, 0.0, 10.0)])
    assert not r["ok"] and r["busy_s"] == 0.0


def test_device_time_on_cpu_trace():
    """A real profiler trace on the CPU backend: loaded from its xplane,
    the window annotation is found, and there is no device plane."""
    f = jax.jit(lambda x: (x @ x).sum())
    x = jnp.ones((64, 64))
    f(x)
    r = devtime.device_time(lambda: f(x))
    assert not r["ok"] and r["devices"] == {}
    assert r["window_s"] > 0
    assert float(r["out"]) == 64.0 ** 3


# --- per-pass timing --------------------------------------------------------


def test_pass_timer_cpu_records_wall_time():
    t = PassTimer("raytrace")
    out = t.time_device(lambda a: a + 1, jnp.ones(4))
    assert float(out[0]) == 2.0
    assert t.value > 0


def test_pass_timer_refuses_empty_trace_on_accelerator(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(devtime, "device_time",
                        lambda fn: {"ok": False, "busy_s": 0.0, "out": fn()})
    with pytest.raises(RuntimeError, match="no device operations"):
        PassTimer("raytrace").time_device(lambda: jnp.ones(2))


# --- chip_smoke.py ----------------------------------------------------------


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
