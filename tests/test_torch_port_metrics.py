"""The port's metrics registry (`observability/metrics.py`) held against
the JAX package's: the same observations give the same streaming
histogram quantiles and byte-equal Prometheus and JSON exports. Then the
Trainer's wiring: `train_step_s` / `train_fetch_s` samples per dispatch
group, `--metrics-out` in both formats, and a CPU run with
`profile_dir` that writes a torch.profiler trace."""

import json

import numpy as np
import pytest

from distributed_model_parallel_tpu.observability import metrics as jm
from distributed_model_parallel_tpu_torch.models.tinycnn import tiny_cnn
from distributed_model_parallel_tpu_torch.observability import metrics as tm
from distributed_model_parallel_tpu_torch.observability import trace
from distributed_model_parallel_tpu_torch.parallel.data_parallel import (
    DDPEngine,
)
from distributed_model_parallel_tpu_torch.runtime.mesh import Mesh
from distributed_model_parallel_tpu_torch.training.optim import SGD
from distributed_model_parallel_tpu_torch.training.trainer import (
    Trainer,
    TrainerConfig,
)
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402


def _feed(mod, n):
    """The same calls into a fresh registry of either package."""
    reg = mod.MetricsRegistry(enabled=True)
    rng = np.random.RandomState(7)
    for x in rng.lognormal(-4.0, 1.5, size=n):
        reg.observe("train_step_s", float(x))
    for x in (0.0, 1e-12, 3.5, 2.0):
        reg.observe("serve_ttft_s", x)
    reg.inc("train_batches_total", 3)
    reg.inc("train_batches_total")
    reg.gauge("serve_goodput", 0.75)
    return reg


@pytest.mark.parametrize("n", [10, 4096, 9000])
def test_histograms_and_exports_equal_jax(n):
    """Exact below the 4096-sample cap, streaming buckets above it:
    quantiles, snapshots and both exports equal the JAX package's."""
    got, want = _feed(tm, n), _feed(jm, n)
    h, hj = got.histogram("train_step_s"), want.histogram("train_step_s")
    assert h.streaming == hj.streaming == (n > 4096)
    for q in (0, 1, 50, 90, 99, 99.9, 100):
        assert h.quantile(q) == hj.quantile(q)
    assert got.to_prometheus() == want.to_prometheus()
    assert got.to_json() == want.to_json()
    if n > 4096:  # the documented streaming bound
        exact = np.percentile(np.random.RandomState(7).lognormal(
            -4.0, 1.5, size=n), 90)
        assert abs(h.quantile(90) / exact - 1) <= tm.GROWTH ** 0.5 - 1


def test_export_picks_the_format_by_extension(tmp_path):
    got, want = _feed(tm, 20), _feed(jm, 20)
    for name in ("m.prom", "m.json"):
        a = got.export(str(tmp_path / f"port_{name}"))
        b = want.export(str(tmp_path / f"jax_{name}"))
        assert open(a).read() == open(b).read()
    text = (tmp_path / "port_m.prom").read_text()
    assert "# TYPE train_step_s summary" in text
    assert 'train_step_s{quantile="0.99"}' in text
    assert json.loads((tmp_path / "port_m.json").read_text())[
        "counters"]["train_batches_total"] == 4


def test_disabled_registry_allocates_nothing_and_every_name_is_known():
    reg = tm.MetricsRegistry()
    reg.observe("train_step_s", 1.0)
    reg.inc("train_batches_total")
    assert len(reg) == 0
    assert tm.scan_emitted_names() == {}
    assert set(tm.METRIC_NAMES) == set(jm.METRIC_NAMES)
    assert set(tm.TRACE_EVENT_NAMES) == set(jm.TRACE_EVENT_NAMES)


class _Batches:
    def __init__(self, n, seed=0):
        rng = np.random.RandomState(seed)
        self.batches = [(rng.randn(8, 8, 8, 3).astype(np.float32),
                         rng.randint(0, 10, size=8).astype(np.int32))
                        for _ in range(n)]

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


@pytest.mark.parametrize("k", [1, 3])
def test_trainer_metrics_and_profiler_trace(k, tmp_path, capsys):
    """Seven batches, steps_per_dispatch k: one `train_step_s` and one
    `train_fetch_s` sample per dispatch group, seven batches counted;
    `profile_dir` (an epoch too short for step 10) traces the first
    dispatch and at least three steps, into a Chrome JSON file whose
    path is printed."""
    registry = tm.MetricsRegistry(enabled=True)
    tm.set_metrics(registry)
    tracer = trace.enable()
    try:
        eng = DDPEngine(tiny_cnn(10), SGD(), mesh=Mesh(1, None),
                        device="cpu")
        cfg = TrainerConfig(epochs=1, print_freq=0, log_dir=str(tmp_path),
                            checkpoint_dir=str(tmp_path / "ck"),
                            save_best=False, steps_per_dispatch=k,
                            profile_dir=str(tmp_path / "prof"))
        trainer = Trainer(eng, _Batches(7), None, cfg)
        trainer.fit()
    finally:
        tm.set_metrics(None)
        trace.set_tracer(None)
    groups = -(-7 // k)
    assert registry.histogram("train_step_s").count == groups
    assert registry.histogram("train_fetch_s").count == groups
    assert registry.to_json()["counters"]["train_batches_total"] == 7
    steps = [e for e in tracer.to_chrome()["traceEvents"]
             if e["name"] == "step"]
    assert [e["args"]["n"] for e in steps] == [k] * (7 // k) + (
        [7 % k] if 7 % k else [])
    path = trainer.profile_path
    assert path == str(tmp_path / "prof" / "trace_epoch0.json")
    assert f"wrote profiler trace to {path}" in capsys.readouterr().out
    events = json.loads(open(path).read())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("autograd" in n or "aten::" in n for n in names)
    assert sum(1 for e in events
               if e.get("name", "").startswith("aten::convolution")) >= 3
