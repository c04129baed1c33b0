"""The runs that must print no result: no CUDA device, too few devices, a
checkout without the program, a module of JAX loaded once the window and
the reference have run."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
ARGS = ["--workload", "mnist20k-dense.ee-sd", "--seed", "2147483911",
        "--seconds", "1", "--trace", "0"]


def _run(cwd: Path):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    return subprocess.run([sys.executable, "bench/run.py", *ARGS], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_no_device_no_result():
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "refused" in p.stderr


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_missing_program_is_refused(monkeypatch, tmp_path):
    from harness import env
    monkeypatch.setattr(env, "ROOT", tmp_path)
    with pytest.raises(env.Refusal):
        env.import_program()


def test_too_few_devices_is_refused(monkeypatch):
    import torch
    from harness import env
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(env.Refusal):
        env.check_devices(4)


def test_jax_loaded_by_the_reference_no_result(monkeypatch, capsys):
    """A forbidden module that appears after the window, while the
    reference judges, still keeps the result from being printed."""
    import importlib.util
    import types
    spec = importlib.util.spec_from_file_location("bench_run",
                                                  ROOT / "bench" / "run.py")
    run = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(run)
    from harness import cell as cell_run

    def fake_run(*args, **kwargs):
        monkeypatch.setitem(sys.modules, "jax",
                            types.ModuleType("jax"))
        return {"correct": True, "checks": {}}
    monkeypatch.setattr(cell_run, "run", fake_run)
    monkeypatch.setattr(run, "prepare_environment", lambda: None)
    assert run.main(ARGS) != 0
    out = capsys.readouterr()
    assert out.out.strip() == "" and "jax" in out.err
