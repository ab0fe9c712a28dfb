"""The port is packaged: every non-Python file it opens at run time (the
kernels' CUDA sources, the native sources, the spelling table, the model
schemas) is matched by a ``pyproject.toml`` package-data glob of a
``caiman_asr_tpu_torch`` package, and a wheel built offline from the tree
carries them, with the port's console scripts."""

import configparser
import fnmatch
import shutil
import subprocess
import sys
import tomllib
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "caiman_asr_tpu_torch"
# what the port reads at run time: the globs its code opens
RUNTIME_FILES = ("ops/csrc/*.cu", "ops/csrc/*.cuh", "native/src/*.cpp",
                 "data/text/english.json", "export/schemas/*.json")
SCRIPTS = {"caiman-torch-train": "caiman_asr_tpu_torch.train:main",
           "caiman-torch-val": "caiman_asr_tpu_torch.val:validate",
           "caiman-torch-val-multiple": "caiman_asr_tpu_torch.val_multiple:main"}


def _runtime_files():
    files = sorted({p for g in RUNTIME_FILES for p in PORT.glob(g)})
    assert len(files) >= 20, files
    return files


def _package_data():
    return tomllib.loads((REPO / "pyproject.toml").read_text())["tool"]["setuptools"][
        "package-data"]


def test_every_runtime_file_is_package_data():
    data = _package_data()
    unmatched = []
    for path in _runtime_files():
        rel = path.relative_to(REPO)
        ok = False
        for pkg, globs in data.items():
            if not pkg.startswith("caiman_asr_tpu_torch"):
                continue
            pkg_dir = Path(*pkg.split("."))
            if pkg_dir in rel.parents:
                inner = str(rel.relative_to(pkg_dir))
                ok = ok or any(fnmatch.fnmatch(inner, g) for g in globs)
        if not ok:
            unmatched.append(str(rel))
    assert not unmatched


def test_the_port_has_its_console_scripts():
    scripts = tomllib.loads((REPO / "pyproject.toml").read_text())["project"]["scripts"]
    assert {k: scripts.get(k) for k in SCRIPTS} == SCRIPTS


def test_a_wheel_carries_the_port_s_files(tmp_path):
    """pip wheel, offline and without build isolation, from a copy of the
    packages and pyproject.toml (the build writes its own directories)."""
    src = tmp_path / "src"
    src.mkdir()
    shutil.copy(REPO / "pyproject.toml", src)
    for pkg in ("caiman_asr_tpu", "caiman_asr_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__"))
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "pip", "wheel", ".", "--no-deps", "--no-build-isolation",
             "--no-index", "-w", str(tmp_path / "out"), "-q"],
            cwd=src, capture_output=True, text=True, timeout=120)
    except subprocess.TimeoutExpired:
        pytest.skip("pip wheel took over 120 s here")
    if proc.returncode != 0 and "No module named" in proc.stderr:
        pytest.skip(f"no offline wheel build here: {proc.stderr.strip()[-300:]}")
    assert proc.returncode == 0, proc.stderr[-2000:]
    (wheel,) = (tmp_path / "out").glob("*.whl")
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        entry = next(n for n in names if n.endswith("entry_points.txt"))
        points = configparser.ConfigParser()
        points.read_string(z.read(entry).decode())
    missing = [str(p.relative_to(REPO)) for p in _runtime_files()
               if str(p.relative_to(REPO)) not in names]
    assert not missing
    assert {k: points["console_scripts"].get(k) for k in SCRIPTS} == SCRIPTS
