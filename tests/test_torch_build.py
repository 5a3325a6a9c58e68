"""The CUDA build path of cudabrot_tpu_torch (``ops/_build.py``) on the CPU.

No nvcc is needed: the digest that names a library, the missing-compiler
error and ``build_all``'s error report are held here, with the compiler
calls replaced where a test needs them.
"""

import shutil

import pytest

from cudabrot_tpu_torch.ops import _build


@pytest.fixture
def csrc(tmp_path, monkeypatch):
    """A copy of csrc/ that ``_build`` reads in place of the package's."""
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    return copy


def _touch(path):
    path.write_bytes(path.read_bytes() + b"\n// edited\n")


@pytest.mark.parametrize("name", _build.LIBS)
def test_lib_path_follows_its_sources_only(csrc, name):
    """A library's digest changes with its own source and with every
    shared header, and not with another library's source."""
    first = _build.lib_path(name)
    assert first.parent == _build.BUILD_DIR
    assert first.name.startswith(f"lib{name}-") and first.suffix == ".so"
    for other in _build.LIBS:
        if other != name:
            _touch(csrc / f"{other}.cu")
    assert _build.lib_path(name) == first
    seen = {first}
    for f in (f"{name}.cu", *_build._HEADERS):
        _touch(csrc / f)
        now = _build.lib_path(name)
        assert now not in seen, f
        seen.add(now)


def test_nvcc_path_names_the_sources_when_nvcc_is_missing(tmp_path,
                                                          monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(shutil, "which", lambda _: None)
    with pytest.raises(_build.BuildError, match="nvcc not found") as e:
        _build.nvcc_path()
    assert str(_build.CSRC) in str(e.value)


def test_build_all_reports_every_failed_library(monkeypatch):
    """Every build is started before any is waited for, every one is waited
    for, and one BuildError names each library that failed."""
    failing = {"classify_ext", "bigtiles"}
    started, finished = [], []

    def start(name):
        assert not finished
        started.append(name)
        return name

    def finish(name):
        finished.append(name)
        if name in failing:
            raise _build.BuildError(f"nvcc failed on {name}.cu (exit 1)")

    monkeypatch.setattr(_build, "start_build", start)
    monkeypatch.setattr(_build, "finish_build", finish)
    with pytest.raises(_build.BuildError) as e:
        _build.build_all()
    assert started == finished == list(_build.LIBS)
    for name in _build.LIBS:
        assert (f"nvcc failed on {name}.cu" in str(e.value)) == (
            name in failing)
    finished.clear()
    started.clear()
    failing.clear()
    _build.build_all()
    assert finished == list(_build.LIBS)


def test_ptxas_report_reads_the_current_build_log(csrc, tmp_path,
                                                  monkeypatch):
    """The report is the log beside the library its sources name now:
    empty before a build, and again once a source changed."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.ptxas_report("deposit") == ""
    _build.BUILD_DIR.mkdir()
    _build.lib_path("deposit").with_suffix(".log").write_text(
        "ptxas info    : Used 40 registers\n")
    assert "Used 40 registers" in _build.ptxas_report("deposit")
    _touch(csrc / "deposit.cu")
    assert _build.ptxas_report("deposit") == ""
