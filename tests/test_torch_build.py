"""The kernels' build (``repro_torch/kernels/build.py``) driven through a
fake ``nvcc``: a small script that writes its ``-o`` target, prints a
ptxas-like line and logs when it started and ended. No CUDA toolkit is
needed. The libraries it makes are never loaded."""
import json
import os
import sys
import time

import pytest

from repro_torch.kernels import build

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
part = next((a for a in args if a.startswith("-DREPRO_PART=")), "")
kind = "link" if "-shared" in args else "compile"
src = args[-1] if kind == "compile" else ""


def note(event):
    with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
        f.write(json.dumps(dict(event=event, kind=kind, part=part, src=src,
                                out=out, t=time.time())) + "\\n")


note("start")
time.sleep(float(os.environ.get("FAKE_NVCC_SLEEP", "0")))
if os.environ.get("FAKE_NVCC_FAIL") in args:
    print("error: the fake compiler refused " + part)
    note("end")
    sys.exit(1)
print("ptxas info    : Used 42 registers (" + (part or kind) + " "
      + os.path.basename(src) + ")")
with open(out, "w") as f:
    f.write("fake")
note("end")
"""


@pytest.fixture
def fake(tmp_path, monkeypatch):
    """A fake nvcc first on PATH, two sources ("a" in the four KV parts,
    "b" whole) and a fresh build state; returns the event log's reader."""
    bin_dir, csrc = tmp_path / "bin", tmp_path / "csrc"
    bin_dir.mkdir()
    csrc.mkdir()
    nvcc = bin_dir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    for f in ("a.cu", "b.cu") + build.HEADERS:
        (csrc / f).write_text(f"// {f}\n")
    log = tmp_path / "events.jsonl"
    monkeypatch.setenv("PATH", f"{bin_dir}{os.pathsep}{os.environ['PATH']}")
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "0.3")
    monkeypatch.setattr(build, "CSRC", csrc)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "PARTS", {"a": build.KV_PARTS})
    monkeypatch.setattr(build, "jobs", lambda: 8)
    for name, value in (("_BUILDS", {}), ("_LIBS", {}), ("_POOL", None)):
        monkeypatch.setattr(build, name, value)

    def events():
        if not log.exists():
            return []
        return [json.loads(line) for line in log.read_text().splitlines()]
    return events


def _span(events, kind, src=None):
    """(first start, last end) of the jobs of ``kind`` (of source ``src``)."""
    mine = [e for e in events if e["kind"] == kind
            and (src is None or e["src"].endswith(src))]
    return (min(e["t"] for e in mine if e["event"] == "start"),
            max(e["t"] for e in mine if e["event"] == "end"))


def test_parts_start_together_and_the_link_waits_for_them(fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "1.0")   # outlasts every start
    build.start_all(("a", "b"))
    # every part's process starts before anything is waited on
    deadline = time.time() + 0.8
    while len([e for e in fake() if e["event"] == "start"]) < 5 and (
            time.time() < deadline):
        time.sleep(0.02)
    assert not [e for e in fake() if e["event"] == "end"]
    secs = build.wait(("a", "b"))
    events = fake()
    compiles = [e for e in events if e["kind"] == "compile"]
    assert sorted(e["part"] for e in compiles if e["event"] == "start") == [
        "", "-DREPRO_PART=0", "-DREPRO_PART=1", "-DREPRO_PART=2",
        "-DREPRO_PART=3"]
    assert max(e["t"] for e in compiles if e["event"] == "start") < min(
        e["t"] for e in compiles if e["event"] == "end")
    links = [e for e in events if e["kind"] == "link"]
    assert len(links) == 4                       # a start and an end each
    for src in ("a.cu", "b.cu"):
        lib = "liba-" if src == "a.cu" else "libb-"
        link_start = min(e["t"] for e in links if e["event"] == "start"
                         and lib in e["out"])
        assert link_start >= _span(events, "compile", src)[1]
    for name in ("a", "b"):
        assert build._lib_path(name).exists()
        assert secs[name] > 0.3
    assert sorted(build.part_seconds(("a",))["a"]) == sorted(
        build.KV_PARTS + ("link",))
    assert build.wall_seconds(("a", "b")) >= max(secs.values())
    # no object or temporary file is left beside the library
    left = sorted(p.suffix for p in build.BUILD_DIR.iterdir())
    assert set(left) == {".so", ".log"}


def test_build_log_holds_every_part(fake):
    build.build_all(("a",))
    text = build.build_log("a")
    for part in build.KV_PARTS:
        assert f"# part {part}\n" in text
    for i in range(len(build.KV_PARTS)):
        assert f"Used 42 registers (-DREPRO_PART={i} a.cu)" in text
    assert "# part link\n" in text


def test_no_more_processes_than_jobs(fake, monkeypatch):
    monkeypatch.setattr(build, "jobs", lambda: 2)
    monkeypatch.setenv("FAKE_NVCC_SLEEP", "0.15")
    build.build_all(("a", "b"))
    points = sorted((e["t"], 1 if e["event"] == "start" else -1)
                    for e in fake())
    running = peak = 0
    for _, step in points:
        running += step
        peak = max(peak, running)
    assert peak <= 2
    assert build._lib_path("a").exists() and build._lib_path("b").exists()


def test_a_failing_part_fails_the_build_with_its_log(fake, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "-DREPRO_PART=2")
    build.start_all(("a",))
    with pytest.raises(RuntimeError) as err:
        build.wait(("a",))
    msg = str(err.value)
    assert "nvcc failed for a part int8" in msg
    assert "error: the fake compiler refused -DREPRO_PART=2" in msg
    assert not build._lib_path("a").exists()
    assert not [e for e in fake() if e["kind"] == "link"]
    # the other parts ran to their end; nothing is left running
    assert all(f.done() for f in build._BUILDS["a"].futures)
    events = fake()
    assert len([e for e in events if e["event"] == "start"]) == len(
        [e for e in events if e["event"] == "end"]) == 4


def test_the_library_name_follows_sources_and_part_flags(fake, monkeypatch):
    first = build._lib_path("a")
    monkeypatch.setattr(build, "PARTS", {"a": ("f32", "bf16")})
    fewer = build._lib_path("a")
    monkeypatch.setattr(build, "PARTS", {})
    whole = build._lib_path("a")
    monkeypatch.setattr(build, "PARTS", {"a": build.KV_PARTS})
    assert build._lib_path("a") == first
    (build.CSRC / "a.cu").write_text("// a.cu, edited\n")
    edited = build._lib_path("a")
    (build.CSRC / "tile.cuh").write_text("// tile.cuh, edited\n")
    header = build._lib_path("a")
    assert len({first, fewer, whole, edited, header}) == 5


def test_a_second_start_all_rebuilds_nothing(fake, monkeypatch):
    build.build_all(("a", "b"))
    n = len(fake())
    monkeypatch.setattr(build, "_BUILDS", {})    # as a new process finds it
    build.start_all(("a", "b"))
    assert build.wait(("a", "b")) == {"a": 0.0, "b": 0.0}
    time.sleep(0.1)
    assert len(fake()) == n


def test_forced_walk_and_launch_counts(monkeypatch):
    monkeypatch.setattr(build, "COUNTS", build.collections.Counter(
        paged_decode=3, paged_decode_whole=2, paged_prefill_plain=1))
    assert build.launch_counts() == {"paged_decode": 3,
                                     "paged_prefill_plain": 1}
    assert build.walk_code() == build.WALKS["auto"]
    with build.forced_walk("general"):
        assert build.walk_code() == build.WALKS["general"]
        with build.forced_walk("whole"):
            assert build.walk_code() == build.WALKS["whole"]
        assert build.walk_code() == build.WALKS["general"]
    assert build.walk_code() == build.WALKS["auto"]
