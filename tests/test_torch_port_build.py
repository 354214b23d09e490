"""The port's kernel build (`ops/_cuda.py`) on the CPU, through a stand-in
nvcc that records its arguments and writes its output file: a source in
`PARTS` is compiled once a part with its macro and linked from the
objects, the others in one call, every process started before the first
is waited for. The real nvcc runs on the GPU machine
(`tests/test_torch_port_cuda.py`, chip_smoke.py's phase 2).
"""

import json
import os
import stat
import sys

import pytest

from distributed_model_parallel_tpu_torch.ops import _cuda

FAKE_NVCC = """#!{python}
import json, os, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
log = os.environ["FAKE_NVCC_LOG"]
with open(log, "a") as f:
    f.write(json.dumps(args) + "\\n")
# wait (20 s at most) until every compile of the build has started
end = time.time() + 20
while time.time() < end:
    with open(log) as f:
        seen = sum(1 for _ in f)
    if seen >= int(os.environ["FAKE_NVCC_STARTS"]):
        break
    time.sleep(0.01)
with open(out, "w") as f:
    f.write("built")
print(f"ptxas info    : report of {{os.path.basename(out)}}, {{seen}} started")
"""


@pytest.fixture()
def fake_nvcc(tmp_path, monkeypatch):
    root = tmp_path / "cuda"
    (root / "bin").mkdir(parents=True)
    exe = root / "bin" / "nvcc"
    exe.write_text(FAKE_NVCC.format(python=sys.executable))
    exe.chmod(exe.stat().st_mode | stat.S_IEXEC)
    log = tmp_path / "calls.jsonl"
    monkeypatch.setenv("CUDA_HOME", str(root))
    monkeypatch.setenv("FAKE_NVCC_LOG", str(log))
    # the int8 source and flash_attention.cu's parts
    monkeypatch.setenv("FAKE_NVCC_STARTS",
                       str(1 + _cuda.PARTS["flash_attention.cu"][1]))
    monkeypatch.setattr(_cuda, "BUILD", tmp_path / "build")
    monkeypatch.setattr(_cuda, "build_info", {})

    def calls():
        return [json.loads(line) for line in log.read_text().splitlines()]

    return calls


def test_a_parted_source_compiles_each_part_and_links_them(fake_nvcc):
    sources = ["int8_matmul.cu", "flash_attention.cu"]
    _cuda.build(sources)
    calls = fake_nvcc()
    macro, parts = _cuda.PARTS["flash_attention.cu"]
    compiles = [a for a in calls if "-c" in a]
    links = [a for a in calls if "-c" not in a and not a[-1].endswith(".cu")]
    whole = [a for a in calls if a[-1].endswith("int8_matmul.cu")]
    assert sorted(a[a.index("-c") + 1] for a in compiles) == [
        f"-D{macro}={p}" for p in range(parts)]
    assert all("-shared" not in a and a[-1].endswith("flash_attention.cu")
               for a in compiles)
    assert len(whole) == 1 and "-shared" in whole[0]
    assert len(links) == 1 and "-shared" in links[0]
    objs = [a[a.index("-o") + 1] for a in compiles]
    assert sorted(links[0][-parts:]) == sorted(objs)
    assert calls[-1] == links[0]  # linked once every part is built
    for source in sources:
        assert _cuda.library_path(source).read_text() == "built"
    assert not any(os.path.exists(o) for o in objs)
    report = _cuda.build_info["flash_attention.cu"][1]
    # the parts' reports and the link's; each part found every compile
    # started (none was waited for before the next began)
    assert report.count("ptxas info") == parts + 1
    assert report.count(f"{1 + parts} started") == parts


def test_an_edited_part_count_names_another_library(monkeypatch):
    before = _cuda.library_path("flash_attention.cu")
    monkeypatch.setitem(_cuda.PARTS, "flash_attention.cu",
                        ("DMP_FLASH_PART", 1))
    assert _cuda.library_path("flash_attention.cu") != before
