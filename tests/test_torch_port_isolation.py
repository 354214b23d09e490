"""The PyTorch port stands alone: no file of
`distributed_model_parallel_tpu_torch/` (nor `chip_smoke.py`,
`chip_smoke_probe.py` or `pp_host_probe.py`) imports jax or the JAX package, every port module
imports in a process where
jax cannot be imported (the linter's `analysis/` modules and its fake
process group included), and the port's serve and data-parallel CLIs
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
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

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
    files = sorted(PORT.rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "chip_smoke_probe.py",
        REPO / "pp_host_probe.py"]
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
        "assert pkg.__name__ + '.serving.speculative' in names\n"
        "for m in ('training.multistep', 'models.vit', 'models.bert',\n"
        "          'observability.metrics', 'ops.grad_reduction',\n"
        "          'ops.wire_codec', 'parallel.tensor_parallel',\n"
        "          'data.device_cache', 'parallel.fsdp',\n"
        "          'training.elastic', 'checkpointing.manifest',\n"
        "          'checkpointing.sharded', 'checkpointing.writer',\n"
        "          'checkpointing.save', 'checkpointing.restore',\n"
        "          'ops.ring_attention', 'parallel.sequence_parallel',\n"
        "          'ops.collective_matmul', 'analysis.record',\n"
        "          'analysis.collectives', 'analysis.rules',\n"
        "          'analysis.lint', 'observability.cost',\n"
        "          'observability.calibrate', 'observability.costgate',\n"
        "          'observability.attribution', 'observability.report',\n"
        "          'tuning.plan', 'tuning.space', 'tuning.search',\n"
        "          'tuning.apply', 'tuning.plangate'):\n"
        "    assert pkg.__name__ + '.' + m in names, m\n"
        "import distributed_model_parallel_tpu_torch.cli.serve\n"
        "from distributed_model_parallel_tpu_torch.analysis import record\n"
        "with record.fake_world(1, 2):\n"
        "    pass\n"
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


class _Built(Exception):
    """Raised where the serve CLI builds its engine."""


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
def test_cli_refuses_out_of_slice_flags(flags, monkeypatch):
    """Every serving flag passes the reference CLI's own checks: where
    the reference's `check_serving_args` accepts a flag the port builds
    its engine with it; where it refuses one (a paged knob without
    --page-size, a draft without --speculative-k, --collective-matmul
    without --layout tp) the port's message is the reference's
    (tests/test_torch_port_serving_paged.py and tests/
    test_torch_port_serving_layouts.py compare the two packages' checks
    on more flag sets). The tp and sp flags (refused before the tp/sp
    serving slice) join the process group and build the engine on the
    mesh of their axis."""
    built, meshes = {}, []

    def build(cfg, **kw):
        built.update(kw)
        raise _Built

    def mesh_of(spec):
        meshes.append(spec)
        return "mesh"

    monkeypatch.setattr(serve, "ServingEngine", build)
    monkeypatch.setattr(serve, "initialize_backend", lambda *a: "cpu")
    monkeypatch.setattr(serve, "make_mesh", mesh_of)
    try:
        serve.main(["--device", "cpu", *flags])
    except _Built:
        pass
    except SystemExit as e:
        built["refused"] = str(e)
    want = {
        "--page-size": ("page_size", 16),
        "--compute-dtype": ("compute_dtype", "bf16"),
        "--dtype": ("compute_dtype", "bf16"),
    }.get(flags[0])
    if flags[0] == "--layout":
        want = ("layout", flags[1])
    if want is not None:
        assert built[want[0]] == want[1]
        if flags[0] == "--layout":
            axis = {"tp": "model", "sp": "seq"}[flags[1]]
            assert built["mesh"] == "mesh" and built["device"] == "cpu"
            assert [(m.data, getattr(m, axis)) for m in meshes] == [(1, 2)]
    else:
        assert "set --page-size" in built["refused"] or \
            "requires --page-size" in built["refused"] or \
            "set --speculative-k" in built["refused"] or \
            "requires --layout tp" in built["refused"]


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


def reference_reject_explicit():
    """The reference's `tuning/apply._reject_explicit` and its flag lists
    a hook, read from its source (no jax import): {hook: [flag, ...]},
    and the function that raises its message."""
    tree = ast.parse((REPO / "distributed_model_parallel_tpu" / "tuning"
                      / "apply.py").read_text())
    fns = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    ns = {}
    exec(compile(ast.Module([fns["_reject_explicit"]], []), "apply.py",
                 "exec"), ns)
    lists = {}
    for name, fn in fns.items():
        for node in ast.walk(fn):
            if (isinstance(node, ast.Call)
                    and getattr(node.func, "id", "") == "_reject_explicit"):
                lists[name] = [e.elts[0].value for e in node.args[0].elts]
    return lists, ns["_reject_explicit"]


def reference_reject_message(reject, flag) -> str:
    with pytest.raises(SystemExit) as e:
        reject([(flag, True)])
    return str(e.value.code)


# what sets each of the tuner's knob flags on the command line
KNOB_ARGV = {
    "--grad-reduction": ["--grad-reduction", "bucketed"],
    "--bucket-mb": ["--bucket-mb", "4"],
    "--overlap-stages": ["--overlap-stages", "2"],
    "--dcn-compression": ["--dcn-compression", "bf16"],
    "--collective-matmul": ["--collective-matmul"],
    "--plan": ["--plan", "dp2"],
}


REDUCER_EXITS = {
    "--grad-reduction": "no explicit reduction site to bucket or overlap",
    "--bucket-mb": "only applies under --grad-reduction bucketed",
    "--dcn-slices": r"dcn=2 must divide the data axis \(1\)",
    "--overlap-stages": "only applies under --grad-reduction overlapped",
    "--dcn-compression": "--dcn-slices >= 2",
}


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
def test_data_parallel_cli_refuses_out_of_slice_flags(flags, slice_,
                                                     monkeypatch, tmp_path):
    """Flags of later slices exit naming the slice. --remat,
    --steps-per-dispatch, --profile-dir, --model vit / bert_tiny and
    --dataset-type SyntheticText, refused before the transformer-
    classifier and training-knob slice, now build what the JAX CLI
    builds: the model with remat, the trainer's dispatch group and
    profiler directory, the ViT and BERT classifiers, raw token-id
    loaders. --engine tp, --model-shards, --device-cache and
    --dataset-type Imagenet, refused before the tensor-parallel,
    device-cache and image-folder slice, now meet the JAX CLI's checks,
    build index loaders, and read the image tree. --engine fsdp,
    --checkpoint-format sharded and --max-restarts, refused before the
    FSDP / sharded-checkpoint / elastic slice, now build the FSDP engine,
    the sharded trainer configuration and the per-epoch 'last' snapshot
    that elastic restarts resume from; --async-save alone exits with the
    JAX CLI's message (it needs the sharded format). --collective-matmul,
    refused before the collective-matmul slice, meets the JAX CLI's
    check (it needs --engine tp). --plan, refused before the composed-
    parallel-plan slice, meets the JAX CLI's world check. --auto-tune and
    --auto-tune-out, refused before the auto-tuning slice, meet the
    reference's knob-flag refusals and write the applied plan."""
    from distributed_model_parallel_tpu_torch.cli import data_parallel

    if slice_ in ("tensor-parallel", "image-folder", "collective-matmul"):
        # Ported: the reference CLI's checks now apply (tp shards only the
        # transformer models; --model-shards and --collective-matmul need
        # --engine tp), and an image-folder type reads its tree under
        # --data.
        exits = {"--engine": "--model mobilenetv2 has none",
                 "--model-shards": "only applies under --engine tp",
                 "--collective-matmul": "decomposes the Megatron TP "
                                        "projections; it only applies "
                                        "under --engine tp"}
        monkeypatch.chdir(tmp_path)
        if flags[0] in exits:
            with pytest.raises(SystemExit, match=exits[flags[0]]):
                data_parallel.main(["--device", "cpu", *flags])
        else:
            with pytest.raises(FileNotFoundError, match="data/train"):
                data_parallel.main(["--device", "cpu", *flags])
        return
    if slice_ == "gradient-reduction":
        # Ported: the flags pass the reference CLI's checks, and these
        # lines fail them (gspmd has no reduction site; --bucket-mb and
        # --overlap-stages need their mode; one rank has no second slice;
        # compression needs one).
        with pytest.raises(SystemExit, match=REDUCER_EXITS[flags[0]]):
            data_parallel.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--async-save":
        with pytest.raises(SystemExit,
                           match="requires --checkpoint-format sharded"):
            data_parallel.main(["--device", "cpu", *flags])
        return
    if flags[0] == "--plan":
        # Ported with the composed-parallel-plan slice: dp2 spells
        # --engine ddp on a two-rank world, and one rank is refused with
        # the JAX CLI's message.
        with pytest.raises(SystemExit, match=r"--plan dp2 factors 2 "
                                             r"device\(s\); this world has 1"):
            data_parallel.main(["--device", "cpu", *flags])
        return
    if slice_ == "auto-tuning":
        # Ported with the auto-tuning slice (tuning/apply.py): the plan
        # owns the knobs, and each knob flag beside --auto-tune exits with
        # the reference's message; --auto-tune-out writes the applied
        # plan (here tp's at 2 model shards, before the one-rank world
        # refuses the mesh).
        import torch.distributed as dist

        monkeypatch.chdir(tmp_path)
        if flags[0] == "--auto-tune":
            lists, reject = reference_reject_explicit()
            for flag in lists["auto_tune_data_parallel"]:
                with pytest.raises(SystemExit) as e:
                    data_parallel.main(["--device", "cpu", *flags,
                                        "--engine", "ddp", *KNOB_ARGV[flag]])
                assert str(e.value.code) == reference_reject_message(
                    reject, flag)
            return
        from distributed_model_parallel_tpu_torch.tuning.plan import (
            load_plan,
        )

        if dist.is_initialized():  # the search needs a process without one
            dist.destroy_process_group()
        with pytest.raises(SystemExit, match="--model-shards 2"):
            data_parallel.main(["--device", "cpu", *flags, "--auto-tune",
                                "search", "--engine", "tp", "--model-shards",
                                "2", "--model", "bert_tiny", "-type",
                                "SyntheticText"])
        plan = load_plan(str(tmp_path / flags[1]))
        assert plan["cell"]["family"] == "tp" and plan["combo"] in (
            "tp/S2", "tp/S2/cm")
        return
    if slice_ not in ("activation-rematerialization", "multi-step dispatch",
                      "profiler-capture", "transformer-classifier",
                      "device-cache", "FSDP", "sharded-checkpoint",
                      "elastic-restart"):
        with pytest.raises(SystemExit, match=f"not ported.*{slice_} slice"):
            data_parallel.main(["--device", "cpu", *flags])
        return
    seen = {}

    class Stop(BaseException):  # not an Exception: no elastic retry
        pass

    def build_model(name, num_classes, **kw):
        seen.update(model=name, classes=num_classes, **kw)
        return build(name, num_classes, **kw)

    def trainer(engine, train, val, cfg, **kw):
        seen.update(cfg=cfg, train=train, engine=engine)
        raise Stop

    build = data_parallel.build_model
    monkeypatch.setattr(data_parallel, "build_model", build_model)
    monkeypatch.setattr(data_parallel, "Trainer", trainer)
    with pytest.raises(Stop):
        data_parallel.main(["--device", "cpu", "-b", "64", *flags])
    cfg = seen["cfg"]
    assert seen["remat"] is (flags[0] == "--remat")
    assert cfg.steps_per_dispatch == (4 if flags[0] ==
                                      "--steps-per-dispatch" else 1)
    assert cfg.profile_dir == ("prof" if flags[0] == "--profile-dir"
                               else None)
    if flags[0] == "--model":
        assert seen["model"] == flags[1]
    if flags[-1] == "SyntheticText":
        assert seen["train"].raw and seen["classes"] == 4
    assert (type(seen["engine"]).__name__ == "FSDPEngine") is \
        (slice_ == "FSDP")
    assert cfg.checkpoint_format == ("sharded" if slice_ ==
                                     "sharded-checkpoint" else "legacy")
    assert cfg.save_last is (slice_ == "elastic-restart")
    if flags[0] == "--device-cache":  # index loaders, on-device pixels
        assert type(seen["train"]).__name__ == "IndexLoader"
        assert seen["engine"].input_transform.wants_ctx
