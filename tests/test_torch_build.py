"""The kernel build on the CPU, with a stand-in for nvcc: one compiler
process per source, all started together, then one link; a failed compile
raises and leaves nothing behind.  (The real build runs where nvcc is.)"""

import json
import os
import re
import stat
import sys

import pytest

from aqp_tpu_torch.ops.kernels import build

FAKE_NVCC = """#!{python}
import os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
kind = "link" if "-shared" in args else "compile"
src = args[args.index("-c") + 1] if kind == "compile" else ""
if src.endswith(os.environ.get("FAKE_NVCC_FAIL", "-")):
    sys.stderr.write("error: refused " + src)
    sys.exit(1)
t0 = time.time()
if kind == "compile":
    time.sleep(1.0)
if "-Xptxas" in args:
    name = os.path.basename(src)
    sys.stderr.write(
        "ptxas info    : Compiling entry function 'k' for 'sm_90a'\\n"
        "ptxas info    : Function properties for k\\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\\n"
        "ptxas info    : Used 32 registers (" + name + ")\\n"
        "nvcc note     : not a ptxas line\\n")
with open(os.environ["FAKE_NVCC_LOG"], "a") as f:
    f.write(f"{{kind}} {{t0}} {{time.time()}} {{' '.join(args)}}\\n")
with open(out, "w") as f:
    f.write("built")
"""


@pytest.fixture
def fake_nvcc(tmp_path, monkeypatch):
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    log = tmp_path / "nvcc.log"
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "_build")
    return log


def _entries(log):
    out = []
    for line in log.read_text().splitlines():
        kind, t0, t1, args = line.split(" ", 3)
        out.append((kind, float(t0), float(t1), args.split()))
    return out


def test_each_source_compiles_in_parallel_then_one_link(fake_nvcc):
    sources = [p for p in build.sources() if p.suffix == ".cu"]
    assert {p.name for p in sources} >= {"rho3.cu", "compact.cu",
                                         "lanecompact.cu"}
    path, secs = build.build()
    assert path.is_file() and path.parent == build.BUILD_DIR
    assert secs > 0
    entries = _entries(fake_nvcc)
    compiles = [e for e in entries if e[0] == "compile"]
    links = [e for e in entries if e[0] == "link"]
    assert len(compiles) == len(sources) and len(links) == 1
    assert sorted(a[a.index("-c") + 1] for *_, a in compiles) == sorted(
        str(p) for p in sources)
    # all compilers ran at once: each started before any finished
    assert max(t0 for _, t0, _, _ in compiles) < min(
        t1 for _, _, t1, _ in compiles)
    for *_, args in compiles + links:
        assert "arch=compute_90a,code=sm_90a" in args
        assert "--use_fast_math" not in args
    link_args = links[0][3]
    objs = [a for a in link_args if a.endswith(".o")]
    assert len(objs) == len(sources)
    assert links[0][1] >= max(t1 for _, _, t1, _ in compiles)
    # the objects and the temporary files are gone; the library and its
    # ptxas report stay
    assert sorted(os.listdir(build.BUILD_DIR)) == sorted(
        [path.name, build.report_path().name])
    # built once: a second call compiles nothing
    assert build.build() == (path, 0.0)
    assert len(_entries(fake_nvcc)) == len(entries)


def test_a_failed_compile_raises_and_leaves_nothing(fake_nvcc, monkeypatch):
    monkeypatch.setenv("FAKE_NVCC_FAIL", "/compact.cu")
    with pytest.raises(RuntimeError, match="(?s)nvcc failed.*refused"):
        build.build()
    assert os.listdir(build.BUILD_DIR) == []


def test_time_build_times_both_forms_and_cleans_up(fake_nvcc, capsys):
    from aqp_tpu_torch.ops.kernels import time_build
    time_build.main()
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    secs = out["build_seconds"]
    assert len(secs["parallel"]) == 2 and len(secs["single"]) == 2
    assert all(s > 0 for s in secs["parallel"] + secs["single"])
    n_cu = sum(name.endswith(".cu") for name in out["sources"])
    entries = _entries(fake_nvcc)
    # two parallel builds (a compile per source and a link each), and two
    # single calls that name every source
    assert sum(e[0] == "compile" for e in entries) == 2 * n_cu
    singles = [a for kind, _, _, a in entries
               if kind == "link" and any(x.endswith(".cu") for x in a)]
    assert len(singles) == 2
    assert all(sum(x.endswith(".cu") for x in a) == n_cu for a in singles)
    assert not (build.BUILD_DIR / "timing").exists()


def test_the_build_keeps_each_sources_ptxas_report(fake_nvcc):
    """Every compile runs with -Xptxas -v; its ptxas lines are kept beside
    the library, read back for one source, also once the library is
    built."""
    path, _ = build.build()
    compiles = [a for kind, _, _, a in _entries(fake_nvcc)
                if kind == "compile"]
    assert compiles and all(a[a.index("-Xptxas") + 1] == "-v"
                            for a in compiles)
    want = ["ptxas info    : Compiling entry function 'k' for 'sm_90a'",
            "ptxas info    : Function properties for k",
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
            "ptxas info    : Used 32 registers (blocksort.cu)"]
    assert build.ptxas_report("blocksort.cu") == want
    assert build.ptxas_report("rho3.cu")[-1].endswith("(rho3.cu)")
    assert build.build() == (path, 0.0)
    assert build.ptxas_report("blocksort.cu") == want


def test_spill_bytes_sums_what_ptxas_reports():
    report = [
        "ptxas info    : Compiling entry function '_Z4tileILb1EEvPKi' for "
        "'sm_90a'",
        "ptxas info    : Function properties for _Z4tileILb1EEvPKi",
        "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, 164864 bytes smem",
        "ptxas info    : Function properties for _Z5mergeILb0EEvPKy",
        "24 bytes stack frame, 16 bytes spill stores, 8 bytes spill loads"]
    assert build.spill_bytes(report[:4]) == 0
    assert build.spill_bytes(report) == 24


def test_every_signature_is_defined_by_a_source():
    """Each function that load() declares is defined in some csrc/*.cu,
    so a misnamed entry fails here, not when the card loads the library."""
    text = "".join(p.read_text() for p in build.CSRC_DIR.glob("*.cu"))
    for name in build.SIGNATURES:
        assert re.search(rf"\b{name}\(", text), name
