"""The port's kernel build (``repro_torch.kernels._build``) without nvcc.

A stand-in compiler script takes nvcc's place: it writes the output it
is asked for and logs each call.  ``build_all`` must start one compile
for each library, also where two sources of the same text (two
checkouts of one kernel) map to the same library, report every source,
and start none for a library that exists.
"""

import os
import stat

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import _build  # noqa: E402

FAKE_NVCC = """#!/bin/sh
echo "$@" >> "{log}"
while [ "$#" -gt 0 ]; do
  if [ "$1" = "-o" ]; then echo built > "$2"; fi
  shift
done
echo "ptxas info    : Used 32 registers"
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    log = tmp_path / "calls.log"
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(_build, "nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_BUILT", {})

    def calls():
        return log.read_text().splitlines() if log.exists() else []

    return tmp_path, calls


@pytest.mark.parametrize("n_copies", [1, 2, 3])
def test_build_all_compiles_each_library_once(fake_build, n_copies):
    tmp_path, calls = fake_build
    sources = []
    for i in range(n_copies):  # checkouts holding the same kernel text
        src = tmp_path / f"checkout{i}" / "kern.cu"
        src.parent.mkdir()
        src.write_text("extern \"C\" int f() { return 0; }\n")
        sources.append(src)
    other = tmp_path / "other.cu"
    other.write_text("extern \"C\" int g() { return 1; }\n")
    specs = [(s, ()) for s in sources] + [(other, ("-fmad=false",))]
    built = _build.build_all(specs)
    assert len(calls()) == 2
    assert set(built) == {str(s) for s, _ in specs}
    assert all("registers" in log for _, log in built.values())
    for s, flags in specs:
        out = _build.library_path(s, flags)
        assert out.read_text() == "built\n"
    assert not [p for p in os.listdir(_build.BUILD_DIR)
                if p.endswith(".tmp")]
    # built once: a second call compiles nothing
    _build.build_all(specs)
    assert len(calls()) == 2
