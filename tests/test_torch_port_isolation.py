"""The PyTorch port stands alone: no file of
`distributed_model_parallel_tpu_torch/` (nor `chip_smoke.py`) imports
jax or the JAX package, every port module imports in a process where
jax cannot be imported, and the port's serve and data-parallel CLIs
run on the GPU by default, refuse to start without one unless
`--device cpu` is given, and refuse the flags of later port slices by
name.
"""

import ast
import importlib
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_model_parallel_tpu_torch.cli import serve
from distributed_model_parallel_tpu_torch.observability import (
    metrics,
    trace,
)

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "distributed_model_parallel_tpu_torch"
FORBIDDEN = ("jax", "distributed_model_parallel_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.lineno, node.module or ""
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", None)
        ) in ("import_module", "__import__") and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            yield node.lineno, str(node.args[0].value)


def test_no_file_of_the_port_imports_jax_or_the_jax_package():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 10
    bad = [
        f"{f.relative_to(REPO)}:{line} imports {name}"
        for f in files for line, name in _imports(f) if _forbidden(name)
    ]
    assert bad == []


def test_scanner_catches_the_forbidden_forms():
    assert _forbidden("jax") and _forbidden("jax.numpy")
    assert _forbidden("distributed_model_parallel_tpu.ops.quant_matmul")
    assert not _forbidden("distributed_model_parallel_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_every_port_module_imports_without_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['distributed_model_parallel_tpu'] = None\n"
        "import distributed_model_parallel_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__,"
        " pkg.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "import distributed_model_parallel_tpu_torch.cli.serve\n"
        "print(len(names))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 15


def test_cli_defaults_to_cuda_and_refuses_without_a_gpu():
    assert serve.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        serve.main([])


def test_cli_serves_on_cpu_when_asked(capsys, tmp_path):
    trace_path, metrics_path = tmp_path / "t.json", tmp_path / "m.json"
    try:
        out = serve.main([
            "--device", "cpu", "--compute-dtype", "int8",
            "--vocab-size", "50", "--dim", "32", "--layers", "2",
            "--heads", "4", "--num-slots", "2", "--max-len", "32",
            "--prefill-len", "8", "--prompt-len-max", "8",
            "--num-requests", "3", "--max-new-tokens", "4",
            "--trace-out", str(trace_path),
            "--metrics-out", str(metrics_path),
        ])
    finally:  # the CLI enabled the process-wide tracer and registry
        trace.set_tracer(None)
        metrics.set_metrics(None)
    stdout = capsys.readouterr().out
    printed = json.loads(stdout[stdout.index("\n{\n") + 1:])  # the report
    assert printed == json.loads(json.dumps(out))
    names = {e["name"] for e in json.loads(trace_path.read_text())
             ["traceEvents"]}
    assert {"prefill", "decode_step", "queued", "decode"} <= names
    exported = json.loads(metrics_path.read_text())
    assert exported["counters"]["serve_tokens_total"] == 12
    assert exported["histograms"]["serve_ttft_s"]["count"] == 3
    rep = out["serving"]
    assert rep["device"] == "cpu" and rep["compute_dtype"] == "int8"
    assert rep["requests"] == 3 and rep["generated_tokens"] == 12
    assert [r["generated"] for r in out["requests"]] == [4, 4, 4]


@pytest.mark.parametrize("flags", [
    ["--layout", "tp", "--model-shards", "2"],
    ["--layout", "sp", "--seq-shards", "2"],
    ["--collective-matmul"],
    ["--page-size", "16"],
    ["--prefill-chunk", "8"],
    ["--prefix-cache"],
    ["--speculative-k", "2"],
    ["--compute-dtype", "bf16"],
    ["--dtype", "bfloat16"],
    ["--speculative-draft", "ckpt"],
])
def test_cli_refuses_out_of_slice_flags(flags):
    with pytest.raises(SystemExit, match="not ported.*slice"):
        serve.main(["--device", "cpu", *flags])


class _Prologue(Exception):
    """Raised where a CLI, its device picked, builds its first object."""


@pytest.mark.parametrize("cli,first", [
    ("serve", "ServingEngine"),
    ("lm", "CausalLMSequenceParallelEngine"),
    ("data_parallel", "build_loaders"),
])
def test_clis_turn_tf32_off_and_cudnn_deterministic(cli, first,
                                                     monkeypatch):
    """After each CLI's prologue the card's f32 arithmetic is the f32
    path the tests hold: no TF32 in matmuls or cuDNN, cuDNN's
    deterministic algorithms, no autotuning (the flags are process-wide
    and settable on a CPU build)."""
    mod = importlib.import_module(
        f"distributed_model_parallel_tpu_torch.cli.{cli}")

    def stop(*args, **kwargs):
        raise _Prologue

    monkeypatch.setattr(mod, first, stop)
    flags = ((torch.backends.cuda.matmul, "allow_tf32", True),
             (torch.backends.cudnn, "allow_tf32", True),
             (torch.backends.cudnn, "deterministic", False),
             (torch.backends.cudnn, "benchmark", True))
    for obj, name, value in flags:
        monkeypatch.setattr(obj, name, value)
    with pytest.raises(_Prologue):
        mod.main(["--device", "cpu"])
    assert [getattr(obj, name) for obj, name, _ in flags] == [
        False, False, True, False]


def test_data_parallel_cli_defaults_to_cuda_and_refuses_without_a_gpu():
    from distributed_model_parallel_tpu_torch.cli import data_parallel

    assert data_parallel.build_parser().parse_args([]).device == "cuda"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal needs its absence")
    with pytest.raises(SystemExit, match="--device cpu"):
        data_parallel.main([])


@pytest.mark.parametrize("flags,slice_", [
    (["--engine", "fsdp"], "FSDP"),
    (["--engine", "tp"], "tensor-parallel"),
    (["--model-shards", "2"], "tensor-parallel"),
    (["--collective-matmul"], "collective-matmul"),
    (["--plan", "dp2"], "composed-parallel-plan"),
    (["--grad-reduction", "bucketed"], "gradient-reduction"),
    (["--bucket-mb", "4"], "gradient-reduction"),
    (["--dcn-slices", "2"], "gradient-reduction"),
    (["--overlap-stages", "2"], "gradient-reduction"),
    (["--dcn-compression", "bf16"], "gradient-reduction"),
    (["--device-cache"], "device-cache"),
    (["--checkpoint-format", "sharded"], "sharded-checkpoint"),
    (["--async-save"], "sharded-checkpoint"),
    (["--max-restarts", "2"], "elastic-restart"),
    (["--auto-tune", "search"], "auto-tuning"),
    (["--auto-tune-out", "plan.json"], "auto-tuning"),
    (["--remat"], "activation-rematerialization"),
    (["--steps-per-dispatch", "4"], "multi-step dispatch"),
    (["--profile-dir", "prof"], "profiler-capture"),
    (["--model", "vit"], "transformer-classifier"),
    (["--model", "bert_tiny"], "transformer-classifier"),
    (["--dataset-type", "Imagenet"], "image-folder"),
    (["--dataset-type", "SyntheticText"], "transformer-classifier"),
])
def test_data_parallel_cli_refuses_out_of_slice_flags(flags, slice_):
    from distributed_model_parallel_tpu_torch.cli import data_parallel

    with pytest.raises(SystemExit, match=f"not ported.*{slice_} slice"):
        data_parallel.main(["--device", "cpu", *flags])
