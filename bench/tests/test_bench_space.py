"""A run writes only inside its checkout (`build/`) and the HOME,
XDG_CACHE_HOME and TMPDIR it is given: nothing in /dev/shm and nothing at
a fixed path under /tmp.  Driven at the CPU smoke size in a process of its
own."""
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

DRIVER = """
import sys, time
sys.path.insert(0, "bench"); sys.path.insert(0, "bench/tests")
from helpers import cpu_run
res = cpu_run(sys.argv[1])
print(res["correct"])
"""


def _listing(d: Path) -> set[str]:
    try:
        return set(os.listdir(d))
    except OSError:
        return set()


def _written_since(root: Path, t0: float) -> list[str]:
    out = []
    for dirpath, dirnames, files in os.walk(root):
        dirnames[:] = [d for d in dirnames if d not in (".git",)]
        for f in files:
            p = Path(dirpath) / f
            try:
                if p.stat().st_mtime >= t0:
                    out.append(str(p.relative_to(root)))
            except OSError:
                pass
    return out


def test_run_writes_only_its_own_places(tmp_path):
    home, cache, tmp = (tmp_path / n for n in ("home", "cache", "tmp"))
    for d in (home, cache, tmp):
        d.mkdir()
    shm, slash_tmp = _listing(Path("/dev/shm")), _listing(Path("/tmp"))
    t0 = time.time() - 1
    env = {**os.environ, "HOME": str(home), "XDG_CACHE_HOME": str(cache),
           "TMPDIR": str(tmp), "CUDA_VISIBLE_DEVICES": ""}
    for cell in ("mnist20k-dense.ee-sd", "tenx1m3-sparse.tsne-sd"):
        p = subprocess.run([sys.executable, "-c", DRIVER, cell], cwd=ROOT,
                           env=env, capture_output=True, text=True,
                           timeout=600)
        assert p.returncode == 0, p.stderr[-2000:]
    assert _listing(Path("/dev/shm")) - shm == set()
    new_tmp = _listing(Path("/tmp")) - slash_tmp
    assert all(n.startswith("pytest-of-") for n in new_tmp), new_tmp
    stray = [f for f in _written_since(ROOT, t0)
             if not f.startswith("build/")
             and "__pycache__" not in f and ".pytest_cache" not in f]
    assert stray == [], stray
