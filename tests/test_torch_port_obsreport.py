"""The port's run report (`distributed_model_parallel_tpu_torch/
observability/attribution.py` and `report.py`) against the reference's
(`distributed_model_parallel_tpu/observability/`).

* Attribution parity: seeded random traces in the tracer's format
  (nested spans, several thread tracks, named tracks at 1000 and above,
  counters, shuffled order; written as an object, a bare event list and
  `.json.gz`) give equal `attribute().as_dict()` and `reconcile()` rows
  in both packages, a combo absent from the ledger included.
* Golden bytes: the port's golden copies equal `tests/golden/`'s; the
  rendered report and its JSON twin equal the committed report and the
  reference's output.
* The CLI: `--pregate` exits 0; a golden with one changed line exits 5
  naming the line; `--update-golden` writes the port's copy only; every
  flag prints the reference's bytes on the same files; the exit-2 cases
  are the reference's.
* A real tracer trace: an in-process port Trainer (GPT, dim 32, 2
  layers, sharded async saves) renders the same bytes through both
  packages against the port's `cost_ledger.json`.
* torch.profiler: the mapping of device streams and host threads on a
  synthetic Kineto trace, and `cli.lm --device cpu --profile-dir` at
  dim 32, 2 layers, 3 steps, whose `trace_epoch0.json` the port's
  `--profile-dir` finds: every row equals an independent tally of the
  raw JSON, the whole-window `Trace` event is left out, and the main
  track is the process's main thread.
"""

import gzip
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distributed_model_parallel_tpu.observability import (
    attribution as jattr,
)
from distributed_model_parallel_tpu.observability import report as jreport
from distributed_model_parallel_tpu_torch.observability import (
    attribution as tattr,
)
from distributed_model_parallel_tpu_torch.observability import (
    metrics,
    trace,
)
from distributed_model_parallel_tpu_torch.observability import (
    report as treport,
)
from distributed_model_parallel_tpu_torch.observability.costgate import (
    DEFAULT_LEDGER,
    load_ledger,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

REPO = Path(__file__).resolve().parent.parent
GOLDEN = REPO / "tests" / "golden"
GOLDEN_FILES = ("obsreport_trace.json", "obsreport_metrics.json",
                "obsreport_ledger.json", "obsreport_calibration.json",
                "obsreport_report.txt")
LEDGER = {"combos": {"a/S2": {"predicted_step_s": 0.0031},
                     "b/S4": {"alpha_s": 1e-5}}}
COMBOS = ["a/S2", "b/S4", "absent/S8"]


# ----------------------------------------------------------- attribution


def _span(name, t0, dur, tid):
    return {"name": name, "ph": "X", "ts": round(t0, 3),
            "dur": round(dur, 3), "pid": 0, "tid": tid}


def _random_trace(seed: int) -> dict:
    """A tracer-format timeline: 1-3 thread tracks of spans with gaps
    (the residual) and children nested inside them, 0-2 named request
    tracks, counter samples, events in a shuffled order."""
    rng = np.random.RandomState(seed)
    names = sorted(metrics.TRACE_EVENT_NAMES)
    events = []
    for tid in range(rng.randint(1, 4)):
        t = rng.uniform(0, 5e4)
        for _ in range(rng.randint(3, 12)):
            t += rng.uniform(0, 5e3)
            dur = rng.uniform(5e2, 2e4)
            events.append(_span(names[rng.randint(len(names))], t, dur, tid))
            if rng.rand() < 0.4:
                a = t + rng.uniform(0, dur / 2)
                events.append(_span(names[rng.randint(len(names))], a,
                                    rng.uniform(0, t + dur - a), tid))
            t += dur
    for k in range(rng.randint(0, 3)):
        tid = 1000 + k
        events.append({"name": "thread_name", "ph": "M", "pid": 0,
                       "tid": tid, "args": {"name": f"request 'r{k}'"}})
        t = rng.uniform(0, 1e4)
        for name in ("queued", "prefill", "decode"):
            dur = rng.uniform(1e2, 1e4)
            events.append(_span(name, t, dur, tid))
            t += dur
    for _ in range(rng.randint(0, 4)):
        events.append({"name": "batch_occupancy", "ph": "C",
                       "ts": round(rng.uniform(0, 1e5), 3), "pid": 0,
                       "args": {"batch_occupancy": int(rng.randint(8))}})
    order = rng.permutation(len(events))
    return {"traceEvents": [events[i] for i in order],
            "displayTimeUnit": "ms"}


def _edge_trace(kind: str) -> dict:
    if kind == "empty":
        return {"traceEvents": []}
    # named tracks only: the main track falls back to them
    return {"traceEvents": [_span("queued", 0.0, 4e3, 1001),
                            _span("decode", 2e3, 9e3, 1000)]}


def _write(chrome: dict, path: Path, form: str) -> str:
    if form == "gz":
        path = path.with_suffix(".json.gz")
        with gzip.open(path, "wt") as f:
            json.dump(chrome, f)
    else:
        body = chrome["traceEvents"] if form == "list" else chrome
        path.write_text(json.dumps(body))
    return str(path)


@pytest.mark.parametrize("form", ["object", "list", "gz"])
@pytest.mark.parametrize("case", [0, 1, 2, 3, 4, 5, "empty", "named_only"])
def test_attribution_and_reconcile_equal_the_reference(case, form,
                                                       tmp_path):
    chrome = (_random_trace(case) if isinstance(case, int)
              else _edge_trace(case))
    path = _write(chrome, tmp_path / "t.json", form)
    got_trace, want_trace = tattr.load_trace(path), jattr.load_trace(path)
    assert got_trace == want_trace
    got, want = tattr.attribute(got_trace), jattr.attribute(want_trace)
    assert got.as_dict() == want.as_dict()
    assert tattr.reconcile(got, LEDGER, COMBOS) == jattr.reconcile(
        want, LEDGER, COMBOS)
    if isinstance(case, int):
        assert got.n_events > 0 and got.main_tid < 1000


def test_a_tracer_trace_is_read_as_it_is():
    chrome = _random_trace(7)
    assert tattr.profiler_tracks(chrome) is chrome
    assert tattr._union_ms([(0, 3e3), (1e3, 2e3), (5e3, 6e3)]) == \
        jattr._union_ms([(0, 3e3), (1e3, 2e3), (5e3, 6e3)]) == 4.0


# --------------------------------------------------------- golden bytes


def _golden_inputs(directory: Path) -> dict:
    load = lambda name: json.loads((directory / name).read_text())  # noqa
    return dict(metrics=load("obsreport_metrics.json"),
                ledger=load("obsreport_ledger.json"),
                combos=treport.PREGATE_COMBOS,
                calibration=load("obsreport_calibration.json"))


def test_golden_copies_equal_the_reference_files():
    for name in GOLDEN_FILES:
        assert (Path(treport.GOLDEN_DIR) / name).read_bytes() == \
            (GOLDEN / name).read_bytes(), name
    assert treport.PREGATE_COMBOS == jreport.PREGATE_COMBOS
    assert Path(treport.PREGATE_INPUTS["golden"]).parent == Path(
        treport.GOLDEN_DIR)


def test_golden_report_and_json_equal_the_reference():
    chrome = tattr.load_trace(treport.PREGATE_INPUTS["trace"])
    kw = _golden_inputs(Path(treport.GOLDEN_DIR))
    got = treport.render_report(chrome, **kw)
    assert got == (GOLDEN / "obsreport_report.txt").read_text()
    assert got == jreport.render_report(
        jattr.load_trace(str(GOLDEN / "obsreport_trace.json")),
        **_golden_inputs(GOLDEN))
    got_json = treport.report_json(chrome, **kw)
    assert got_json == jreport.report_json(chrome, **kw)
    assert json.dumps(got_json) == json.dumps(
        jreport.report_json(chrome, **kw))


# ------------------------------------------------------------------ CLI


def test_pregate_exits_0(capsys):
    assert treport.main(["--pregate"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == {"obsreport": {"pregate": "ok", "bytes": len(
        (GOLDEN / "obsreport_report.txt").read_text()),
        "combos": ["golden/S2"]}}


def test_pregate_names_a_changed_line_and_updates_its_own_copy(
        tmp_path, monkeypatch, capsys):
    golden = tmp_path / "obsreport_report.txt"
    lines = (GOLDEN / "obsreport_report.txt").read_text().splitlines(True)
    i = next(i for i, line in enumerate(lines) if line.startswith("fetch"))
    lines[i] = lines[i].replace("40.000", "40.001")
    golden.write_text("".join(lines))
    monkeypatch.setitem(treport.PREGATE_INPUTS, "golden", str(golden))
    assert treport.main(["--pregate"]) == treport.EXIT_GOLDEN_MISMATCH == 5
    out = capsys.readouterr().out
    assert f"golden mismatch at line {i + 1}:" in out
    assert f"want: {lines[i].rstrip()}" in out
    assert json.loads(out.strip().splitlines()[-1])["obsreport"][
        "pregate"] == "fail"
    reference = (GOLDEN / "obsreport_report.txt").read_bytes()
    assert treport.main(["--pregate", "--update-golden"]) == 0
    assert golden.read_bytes() == reference
    assert (GOLDEN / "obsreport_report.txt").read_bytes() == reference
    assert treport.main(["--pregate"]) == 0


def _both(argv, capsys):
    """(port rc, port stdout), (reference rc, reference stdout)."""
    got = treport.main(argv), capsys.readouterr().out
    want = jreport.main(argv), capsys.readouterr().out
    return got, want


@pytest.mark.parametrize("json_twin", [False, True])
@pytest.mark.parametrize("which", ["trace", "trace+metrics",
                                   "trace+ledger", "all"])
def test_cli_prints_the_reference_bytes(which, json_twin, tmp_path, capsys):
    argv = ["--trace", str(GOLDEN / "obsreport_trace.json")]
    if which in ("trace+metrics", "all"):
        argv += ["--metrics", str(GOLDEN / "obsreport_metrics.json")]
    if which in ("trace+ledger", "all"):
        argv += ["--ledger", str(GOLDEN / "obsreport_ledger.json"),
                 "--combo", "golden/S2", "--combo", "absent/S8"]
    if which == "all":
        argv += ["--calibration",
                 str(GOLDEN / "obsreport_calibration.json")]
    if json_twin:
        argv.append("--json")
    (rc, out), (jrc, jout) = _both(
        argv + ["--out", str(tmp_path / "port.txt")], capsys)
    jreport.main(argv + ["--out", str(tmp_path / "jax.txt")])
    capsys.readouterr()
    assert rc == jrc == 0 and out == jout != ""
    assert (tmp_path / "port.txt").read_text() == out == (
        tmp_path / "jax.txt").read_text()


@pytest.mark.parametrize("case", ["no_trace", "missing", "not_a_trace",
                                  "empty_dir"])
def test_cli_exit_2_cases_are_the_reference(case, tmp_path, capsys):
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"events": []}))
    (tmp_path / "prof").mkdir()
    argv = {"no_trace": [],
            "missing": ["--trace", str(tmp_path / "nothing.json")],
            "not_a_trace": ["--trace", str(bad)],
            "empty_dir": ["--profile-dir", str(tmp_path / "prof")]}[case]
    (rc, out), (jrc, jout) = _both(argv, capsys)
    assert rc == jrc == 2 and out == jout == ""


def test_report_imports_without_torch():
    code = ("import sys\n"
            "sys.modules['torch'] = None\n"
            "sys.modules['jax'] = None\n"
            "from distributed_model_parallel_tpu_torch.observability "
            "import report\n"
            "sys.exit(report.main(['--pregate']))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    assert '"pregate": "ok"' in proc.stdout


# ------------------------------------------------- a real tracer trace


def test_trainer_trace_renders_the_reference_bytes(tmp_path):
    from distributed_model_parallel_tpu_torch.models.gpt import GPTConfig
    from distributed_model_parallel_tpu_torch.parallel import (
        CausalLMSequenceParallelEngine,
    )
    from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
    from distributed_model_parallel_tpu_torch.training import (
        SGD,
        Trainer,
        TrainerConfig,
    )

    tracer = trace.Tracer(enabled=True)
    trace.set_tracer(tracer)
    reg = metrics.MetricsRegistry(enabled=True)
    metrics.set_metrics(reg)
    try:
        cfg = GPTConfig(vocab_size=64, dim=32, num_layers=2, num_heads=4,
                        ffn_dim=64, max_position=32, dropout_rate=0.0)
        engine = CausalLMSequenceParallelEngine(
            cfg, SGD(), device="cpu", mesh=Mesh(1, None))
        rng = np.random.RandomState(0)
        batches = [(rng.randint(1, 64, size=(4, 32)).astype(np.int64),
                    np.zeros(4, np.int64)) for _ in range(2)]
        config = TrainerConfig(
            epochs=1, print_freq=1, save_best=False, save_last=True,
            checkpoint_format="sharded", async_save=True,
            checkpoint_dir=str(tmp_path), log_dir=str(tmp_path))
        Trainer(engine, batches, None, config).fit()
    finally:
        trace.set_tracer(None)
        metrics.set_metrics(None)
    chrome = tracer.to_chrome()
    exported = reg.to_json()
    attr = tattr.attribute(chrome)
    assert {"fetch", "step", "sync", "checkpoint_blocked",
            "ckpt_snapshot"} <= {p.name for p in attr.phases}
    assert attr.phase("step").count == 2
    assert 0.0 <= attr.residual_share < 1.0
    kw = dict(metrics=exported, ledger=load_ledger(DEFAULT_LEDGER),
              combos=["ddp/S4/dcn2/bucketed"])
    got = treport.render_report(chrome, **kw)
    assert got == jreport.render_report(chrome, **kw)
    assert "ddp/S4/dcn2/bucketed" in got and "train_step_s" in got
    assert treport.report_json(chrome, **kw) == jreport.report_json(
        chrome, **kw)


# ------------------------------------------------------- torch.profiler


def _kineto(pid=4242):
    """A torch.profiler export's shape on the card: host ops on the
    process's threads, kernels and a memcpy on two streams of device 0,
    and the whole-window `Trace` event."""
    def x(cat, name, ts, dur, p, t):
        return {"ph": "X", "cat": cat, "name": name, "pid": p, "tid": t,
                "ts": ts, "dur": dur}

    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": pid,
         "args": {"name": "thread 4242 (python)"}},
        x("Trace", "PyTorch Profiler (0)", 0.0, 1e5, "Spans",
          "PyTorch Profiler"),
        x("cpu_op", "aten::mm", 10.0, 40.0, pid, pid),
        x("cuda_runtime", "cudaLaunchKernel", 20.0, 5.0, pid, pid),
        x("kernel", "flash_fwd_kernel<f32>", 30.0, 90.0, 0, 7),
        x("cpu_op", "aten::add", 60.0, 20.0, pid, pid),
        x("cpu_op", "pt_gloo", 5.0, 2.0, pid, pid + 1),
        x("kernel", "flash_fwd_kernel<f32>", 130.0, 90.0, 0, 7),
        x("gpu_memcpy", "Memcpy DtoH", 125.0, 3.0, 0, 20),
        {"ph": "s", "cat": "ac2g", "name": "launch", "id": 1,
         "pid": pid, "tid": pid, "ts": 20.0},
    ]}


def test_profiler_tracks_put_streams_on_named_tracks():
    chrome = _kineto()
    mapped = [e for e in tattr.profiler_tracks(chrome)["traceEvents"]
              if e.get("ph") == "X"]
    assert "Trace" not in {e["cat"] for e in mapped}
    tracks = {(e["pid"], e["tid"]) for e in chrome["traceEvents"]
              if e.get("ph") == "X" and e["cat"] != "Trace"}
    assert {e["tid"] for e in mapped} == {0, 1, 1000, 1001}
    assert len(tracks) == 4
    attr = tattr.attribute(chrome)
    assert attr.main_tid == 0  # the python thread, not a stream
    assert attr.n_events == 7
    assert attr.wall_ms == pytest.approx(0.07, abs=1e-9)  # 10 .. 80 us
    assert attr.residual_ms == pytest.approx(0.01, abs=1e-9)
    k = attr.phase("flash_fwd_kernel<f32>")
    assert (k.count, k.total_ms) == (2, 0.18)
    with pytest.raises(ValueError):  # why the port maps the tracks
        jattr.attribute(chrome)


def _tally(events):
    """{name: (count, summed dur in us)} over the complete events a
    profile holds, the whole-window Trace event left out."""
    out = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") != "Trace":
            n, total = out.get(e["name"], (0, 0.0))
            out[e["name"]] = (n + 1, total + float(e["dur"]))
    return out


def test_lm_profile_dir_trace_rows_equal_a_raw_tally(tmp_path, capsys,
                                                     monkeypatch):
    import torch.distributed as dist

    from distributed_model_parallel_tpu_torch.cli import lm

    monkeypatch.chdir(tmp_path)
    try:
        lm.main(["--device", "cpu", "--dim", "32", "--layers", "2",
                 "--heads", "4", "--seq-len", "32", "-b", "4",
                 "--epochs", "1", "--steps-per-epoch", "3",
                 "--vocab-size", "64", "--corpus-tokens", "4096",
                 "--profile-dir", "prof"])
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    capsys.readouterr()
    hits = tattr.profile_dir_traces(str(tmp_path / "prof"))
    assert hits == [str(tmp_path / "prof" / "trace_epoch0.json")]
    raw = json.loads(Path(hits[0]).read_text())["traceEvents"]
    assert sum(1 for e in raw if e.get("cat") == "Trace") == 1
    tally = _tally(raw)
    rc = treport.main(["--profile-dir", str(tmp_path / "prof"), "--json"])
    got = json.loads(capsys.readouterr().out)["attribution"]
    assert rc == 0
    assert got["n_events"] == sum(n for n, _ in tally.values())
    assert {p["name"] for p in got["phases"]} == set(tally)
    for p in got["phases"]:
        n, total_us = tally[p["name"]]
        assert p["count"] == n
        assert p["total_ms"] == pytest.approx(total_us / 1e3, abs=1e-6)
    host = {}  # (pid, tid) in first-seen order, as profiler_tracks keys
    for e in raw:
        if e.get("ph") == "X" and e.get("cat") != "Trace":
            host.setdefault((e["pid"], e["tid"]), len(host))
    main = [key for key, tid in host.items() if tid == got["main_tid"]]
    assert got["main_tid"] < 1000 and main[0][0] == main[0][1]
    assert 0 < got["wall_ms"] and 0 <= got["residual_share"] < 1
    shutil.rmtree(tmp_path / "prof")
