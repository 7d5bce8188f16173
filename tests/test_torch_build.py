"""The kernel build (``ops/_build.py``) against a stand-in ``nvcc``.

There is no ``nvcc`` on a CPU-only machine, so a small script takes its
place: it logs each call with its start and end time, sleeps a little, and
writes its ``-o`` file (or fails for a source named in ``FAIL_ON``). The
build must compile every ``csrc/*.cu`` in its own ``nvcc -c``, all started
before any has finished, link the objects once, and leave only the library
and ``build.log`` behind.
"""

import json
import os
import stat
import sys

import pytest

from pytorch_scalablefhvae_tpu_torch.ops import _build

FAKE_NVCC = """\
#!{python}
import json, os, sys, time
t0 = time.time()
args = sys.argv[1:]
fail = os.environ.get("FAIL_ON")
if fail and any(a.endswith(fail) for a in args):
    sys.stderr.write("error: " + fail + "\\n")
    sys.exit(2)
time.sleep(0.3 if "-c" in args else 0.0)
with open(args[args.index("-o") + 1], "w") as f:
    f.write("built")
if "-c" in args:
    sys.stderr.write("ptxas info : " + os.path.basename(args[-1]) + "\\n")
with open(os.environ["NVCC_LOG"], "a") as f:
    f.write(json.dumps({{"args": args, "t0": t0, "t1": time.time()}}) + "\\n")
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("NVCC_LOG", str(log))
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_ROOT", tmp_path / "build")
    return log


def calls(log):
    return [json.loads(line) for line in log.read_text().splitlines()]


def test_sources_compile_together_then_link_once(fake):
    out = _build.build()
    assert out == _build.library_path() and out.read_text() == "built"
    srcs = _build.sources()
    assert [s.name for s in srcs] == [
        "discriminative_bwd.cu", "discriminative_fwd.cu", "fbank_logmel.cu",
        "lstm2_bwd.cu", "lstm2_fwd.cu", "window_gather.cu"]
    runs = calls(fake)
    compiles = [r for r in runs if "-c" in r["args"]]
    links = [r for r in runs if "-shared" in r["args"]]
    assert sorted(r["args"][-1] for r in compiles) == sorted(map(str, srcs))
    assert max(r["t0"] for r in compiles) < min(r["t1"] for r in compiles)
    assert len(links) == 1 and len(runs) == len(srcs) + 1
    assert links[0]["t0"] >= max(r["t1"] for r in compiles)
    # nvcc takes a link input for an object only by its suffix
    objs = [r["args"][r["args"].index("-o") + 1] for r in compiles]
    assert all(o.endswith(".o") for o in objs)
    assert sorted(objs) == sorted(links[0]["args"][-len(objs):])
    log = (out.parent / "build.log").read_text()
    assert all(s.name in log for s in srcs)
    assert sorted(os.listdir(out.parent)) == sorted([out.name, "build.log"])
    _build.build()  # an unchanged build is not compiled again
    assert len(calls(fake)) == len(runs)


def test_a_failed_compile_raises_and_leaves_nothing(fake, monkeypatch):
    monkeypatch.setenv("FAIL_ON", "window_gather.cu")
    with pytest.raises(RuntimeError, match="error: window_gather.cu"):
        _build.build()
    assert not any(p.is_file() for p in _build.BUILD_ROOT.rglob("*"))


def test_every_c_entry_has_a_signature_and_every_signature_an_entry():
    """The ctypes table and the sources' ``extern "C"`` entries name the same
    functions: a missing signature would pass pointers as 32-bit ints."""
    import re

    declared = set()
    for src in _build.sources():
        body = src.read_text().split('extern "C" {', 1)[1]
        declared |= set(re.findall(r"^(?:int|long long|const char\*) (sfhvae_\w+)\(",
                                   body, flags=re.M))
    assert declared == set(_build._SIGNATURES)
