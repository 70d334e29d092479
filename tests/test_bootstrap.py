"""Process setup shared by every entry point: the one compile-cache rule,
and no silent fallback to the host CPU."""

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _py(code, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO, env=env)


_SETUP = ("from coherent_rtlsdr_tpu._bootstrap import setup_compile_cache;"
          "import os; p = setup_compile_cache();"
          "print(p); print(os.environ['JAX_COMPILATION_CACHE_DIR'])")


def test_cache_honours_environment(tmp_path):
    want = str(tmp_path / "cache")
    r = _py(_SETUP, {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]


def test_cache_default_is_checkout_path():
    r = _py(_SETUP, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert r.returncode == 0, r.stderr
    want = os.path.join(REPO, ".jax_cache")
    assert r.stdout.split() == [want, want]


def test_cache_updates_jax_config_when_imported(tmp_path):
    want = str(tmp_path / "c2")
    r = _py("import jax; " + _SETUP
            + "; print(jax.config.jax_compilation_cache_dir)",
            {"JAX_COMPILATION_CACHE_DIR": want})
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want, want]


def test_report_backend_refuses_cpu_unless_allowed():
    code = ("import jax; jax.config.update('jax_platforms', 'cpu');"
            "from coherent_rtlsdr_tpu._bootstrap import report_backend;"
            "report_backend(allow_cpu={})")
    ok = _py(code.format(True))
    assert ok.returncode == 0 and "platform=cpu" in ok.stdout, ok.stderr
    bad = _py(code.format(False))
    assert bad.returncode != 0
    assert "platform=cpu" in bad.stdout and "no accelerator" in bad.stderr


def _app(name, *args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, os.path.join(REPO, "apps", name), *args],
        capture_output=True, text=True, timeout=300, cwd=REPO, env=env)


def test_server_without_cpu_flag_exits_on_cpu_host():
    r = _app("coherent_server.py", "-n", "2", "-b", "2048", "--blocks", "1",
             "-A", "tcp://127.0.0.1:0", "--ctrl-address", "tcp://127.0.0.1:0",
             "--debug-address", "tcp://127.0.0.1:0")
    assert r.returncode != 0
    assert "platform=cpu" in r.stdout
    assert "no accelerator" in r.stderr and "--cpu" in r.stderr
    assert "published" not in r.stdout


def test_align_offline_without_cpu_flag_exits_on_cpu_host(tmp_path):
    out = str(tmp_path / "a.npz")
    r = _app("align_offline.py", "--synth", "2", "--blocks", "4",
             "--block-len", "2048", "-o", out)
    assert r.returncode != 0
    assert "platform=cpu" in r.stdout and "no accelerator" in r.stderr
    assert not os.path.exists(out)
