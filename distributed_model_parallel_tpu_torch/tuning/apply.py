"""`--auto-tune`: the training CLIs' entry into the tuner (port of
`tuning/apply.py`, with the reference's messages).

Two modes, one flag:

* `--auto-tune search` runs `search.search_cell` for the cell this
  launch describes (the engine family from the CLI's own flags, the
  mesh factorization from the rank world and `--dcn-slices`, the lint
  proxy model) and applies the argmin knobs;
* `--auto-tune PLAN.json` loads a plan, refuses it naming the exact
  field when its cell disagrees with this run, and applies its knobs.

Either way the plan owns the knobs: an explicit knob flag beside
`--auto-tune` fails naming the flag. The knobs land on the parsed args
before the CLIs' own guards run, so an inconsistent plan still meets
every existing check. `cli.lm --plan auto` searches the plan family:
the argmin spec lands on `args.plan`.

The device world is the port's rank world, read from the launch
(`WORLD_SIZE` / `RANK` under torchrun; 1 and 0 without) before any
process group exists: the search records its finalists as rank 0 of
each finalist's world on torch's fake process group
(`analysis/record.fake_world`), which refuses a process that already
has a group, so the CLIs call these hooks before `initialize_backend`.
Every rank searches (the search is deterministic, so every rank applies
the same knobs); rank 0 alone prints and writes `--auto-tune-out`.
"""

from __future__ import annotations

import argparse
import os

from distributed_model_parallel_tpu_torch.tuning.plan import Cell, load_plan

# CLI model families whose lint proxy is the BN tinycnn (the ddp / fsdp
# builders' CNN twin); everything else prices on the staged MLP.
_CNN_MODELS = ("tinycnn", "mobilenetv2", "mobilenetv2_nobn", "resnet18",
               "resnet50")


def launch_world() -> "tuple[int, int]":
    """(rank, world) of this launch, from the launcher's environment:
    the port's ranks are its devices."""
    return (int(os.environ.get("RANK", "0")),
            int(os.environ.get("WORLD_SIZE", "1")))


def add_auto_tune_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--auto-tune", default=None, metavar="PLAN|search",
        help="let the cost-engine tuner (tuning/) pick the performance "
             "knobs: 'search' enumerates the engine family's knob space, "
             "prices every candidate through the alpha-beta cost engine "
             "(recorded steps for the argmin finalists), verifies the "
             "winner against the linter's full rule registry and applies "
             "it; a PLAN.json path applies a plan after checking its cell "
             "(family/mesh/model) matches this run. Mutually exclusive "
             "with every explicit knob flag the plan owns")
    parser.add_argument(
        "--auto-tune-out", default=None, metavar="PATH",
        help="write the applied plan.json here (canonical bytes; what "
             "--auto-tune PLAN and plangate consume)")
    parser.add_argument(
        "--auto-tune-calibration", default=None, metavar="JSON",
        help="price the search under the fitted constants in this "
             "calibration artifact (observability/calibrate.py) instead "
             "of the committed constants (search mode only)")


def _reject_explicit(flags) -> None:
    """One knob flag set alongside --auto-tune = fail with it named."""
    for flag, is_set in flags:
        if is_set:
            raise SystemExit(
                f"--auto-tune owns the tuned knobs; {flag} sets one "
                "explicitly — drop the flag (or drop --auto-tune and "
                "hand-set everything)")


def _check_cell_match(plan: dict, cell: Cell, path: str) -> None:
    """Refuse a plan whose cell disagrees with this run, naming the
    plan field that mismatches."""
    rec = plan["cell"]
    checks = (("cell.family", rec["family"], cell.family),
              ("cell.mesh.data", rec["mesh"]["data"], cell.size),
              ("cell.mesh.dcn", rec["mesh"]["dcn"], cell.dcn),
              ("cell.model", rec["model"], cell.model))
    for field, got, want in checks:
        if got != want:
            raise SystemExit(
                f"--auto-tune {path}: plan {field} is {got!r} but "
                f"this run's cell is {want!r} ({cell.name}) — the "
                "plan was searched for a different configuration; "
                "re-search with --auto-tune search or pass the "
                "matching plan")


def _search_device(device: str) -> str:
    """This rank's device for the finalists' steps (`runtime/dist`'s
    choice: cuda:LOCAL_RANK), refused when the card is missing."""
    import torch

    if device == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit(
            "--device cuda (the default): no CUDA device is available; "
            "pass --device cpu to train on the CPU")
    return f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"


def _resolve_plan(args, cell: Cell, allow_cm: bool) -> dict:
    rank, _ = launch_world()
    if args.auto_tune_calibration and args.auto_tune != "search":
        raise SystemExit(
            "--auto-tune-calibration swaps the SEARCH's pricing "
            "physics; a committed plan was already priced — use "
            "--auto-tune search with it")
    if args.auto_tune == "search":
        from distributed_model_parallel_tpu_torch.tuning.search import (
            search_cell,
        )

        constants = None
        constants_source = "hand"
        if args.auto_tune_calibration:
            from distributed_model_parallel_tpu_torch.observability.cost \
                import load_calibration

            try:
                constants = load_calibration(args.auto_tune_calibration)
            except (OSError, ValueError) as e:
                raise SystemExit(f"--auto-tune-calibration: {e}") from e
            constants_source = f"calibration:{args.auto_tune_calibration}"
        plan = search_cell(cell, constants=constants,
                           constants_source=constants_source,
                           allow_cm=allow_cm,
                           device=_search_device(args.device),
                           emit=print if rank == 0 else None)
    else:
        try:
            plan = load_plan(args.auto_tune)
        except (OSError, ValueError) as e:
            raise SystemExit(f"--auto-tune: {e}") from e
        _check_cell_match(plan, cell, args.auto_tune)
    if args.auto_tune_out and rank == 0:
        from distributed_model_parallel_tpu_torch.tuning.plan import (
            save_plan,
        )

        save_plan(args.auto_tune_out, plan)
        print(f"==> wrote plan to {args.auto_tune_out}", flush=True)
    if rank == 0:
        print(f"==> auto-tune [{cell.name}] applied {plan['combo']}: "
              f"predicted {plan['predicted']['predicted_step_s'] * 1e3:.4f}"
              " ms/step comm", flush=True)
    return plan


def _apply_reducer_knobs(args, knobs: dict) -> None:
    """The reducer-family knobs onto the parsed args, in the shapes
    `cli/common.check_grad_reduction_args` expects (None = the flag's
    unset / auto value)."""
    args.grad_reduction = knobs["grad_reduction"]
    args.bucket_mb = knobs["bucket_mb"]
    args.overlap_stages = knobs["overlap_stages"] or None
    args.dcn_compression = knobs["dcn_compression"]


def auto_tune_data_parallel(args) -> dict:
    """The image CLI's hook (`cli/data_parallel.py`): families ddp and
    fsdp (reducer knobs) and tp (collective_matmul)."""
    if args.engine == "gspmd":
        raise SystemExit(
            "--auto-tune searches the explicit-knob engines (ddp, "
            "fsdp, tp); the declarative --engine gspmd step has no "
            "tunable knobs — pick an engine or drop --auto-tune")
    _reject_explicit((
        ("--grad-reduction", args.grad_reduction != "monolithic"),
        ("--bucket-mb", args.bucket_mb is not None),
        ("--overlap-stages", args.overlap_stages is not None),
        ("--dcn-compression", args.dcn_compression != "none"),
        ("--collective-matmul", args.collective_matmul),
        ("--plan", getattr(args, "plan", None) is not None),
    ))
    if args.engine == "tp":
        if args.model_shards < 2:
            raise SystemExit(
                "--auto-tune under --engine tp searches the 'model'-"
                "axis ring knobs; --model-shards must be >= 2")
        cell = Cell("tp", args.model_shards)
    else:
        _, size = launch_world()
        if size < 2:
            raise SystemExit(
                "--auto-tune needs a >= 2-way data world (one device "
                "has no collectives to tune)")
        cell = Cell(args.engine, size, dcn=args.dcn_slices,
                    model="tinycnn" if args.model in _CNN_MODELS else "mlp")
    plan = _resolve_plan(args, cell, allow_cm=True)
    knobs = plan["knobs"]
    if args.engine == "tp":
        args.collective_matmul = knobs["collective_matmul"]
    else:
        _apply_reducer_knobs(args, knobs)
    return plan


def _lm_proxy_size(data_world: int, dcn: int, device_count: int) -> int:
    """The sp_lm lint proxy runs on a (data=s, seq=2) mesh, so it needs
    2s devices: cap the proxy's data axis at the largest dcn-divisible
    power-of-two cut that fits (the same cap for 'search' and a plan
    file's cell check)."""
    s = data_world
    while 2 * s > device_count and s > 1:
        s //= 2
    if s < 2 or s % dcn:
        raise SystemExit(
            f"--auto-tune: cannot fit the sequence-parallel lint "
            f"proxy (data {data_world}, dcn {dcn}) on "
            f"{device_count} device(s) — the proxy needs a >= 2-way, "
            "dcn-divisible data axis at half the device world")
    return s


def auto_tune_lm(args) -> dict:
    """The LM CLI's hook (`cli/lm.py`): family plan under `--plan auto`,
    ep when --moe-experts is set (dispatch / overlap / wire knobs),
    sp_lm otherwise (reducer knobs + collective_matmul when a 'seq' ring
    axis exists)."""
    if args.pipeline_stages > 1:
        raise SystemExit(
            "--auto-tune searches the reducer/ring/MoE-dispatch/plan "
            "knob spaces; hand-set pipeline schedules are not in "
            "them — drop --pipeline-stages or --auto-tune (pipeline "
            "factorizations ARE searched via --plan auto)")
    _reject_explicit((
        ("--grad-reduction", args.grad_reduction != "monolithic"),
        ("--bucket-mb", args.bucket_mb is not None),
        ("--overlap-stages", args.overlap_stages is not None),
        ("--dcn-compression", args.dcn_compression != "none"),
        ("--collective-matmul", args.collective_matmul),
        ("--moe-dispatch", args.moe_dispatch != "gspmd"),
        ("--moe-overlap", args.moe_overlap),
        ("--plan", args.plan not in (None, "auto")),
    ))
    _, device_count = launch_world()
    if args.plan == "auto":
        # the searched knob is the whole mesh factorization: the argmin
        # spec lands on args.plan and the CLI's plan path runs it
        if args.dcn_slices != 1:
            raise SystemExit(
                "--plan auto searches single-slice factorizations "
                "(the stage-major plan mesh lays pp across the slice "
                "boundary by construction) — drop --dcn-slices")
        if args.moe_experts > 0:
            raise SystemExit(
                "--plan auto searches pp/sp/dp/fsdp factorizations; "
                "MoE LMs tune the ep family (drop --plan auto and "
                "keep --moe-experts with --auto-tune)")
        if device_count < 2:
            raise SystemExit(
                "--plan auto needs a >= 2-way device world (one "
                "device has nothing to factor)")
        cell = Cell("plan", device_count)
        plan = _resolve_plan(args, cell, allow_cm=True)
        args.plan = plan["knobs"]["plan"]
        return plan
    if args.moe_experts > 0:
        if args.expert_shards != 1:
            raise SystemExit(
                "--auto-tune owns the MoE dispatch layout; "
                "--expert-shards sets it explicitly — drop the flag")
        size = device_count
        if size < 2:
            raise SystemExit(
                "--auto-tune needs a >= 2-way data world (one device "
                "has no exchange to tune)")
        cell = Cell("ep", size, dcn=args.dcn_slices)
        plan = _resolve_plan(args, cell, allow_cm=True)
        knobs = plan["knobs"]
        args.moe_dispatch = knobs["dispatch"]
        args.moe_overlap = knobs["overlap"]
        args.dcn_compression = knobs["dcn_compression"]
        if knobs["dispatch"] == "gspmd":
            # the gspmd layout shards experts over an 'expert' axis sized
            # to the same fabric the hierarchical path rides
            args.expert_shards = size
        return plan
    data_world = device_count // args.seq_shards
    size = _lm_proxy_size(data_world, args.dcn_slices, device_count)
    cell = Cell("sp_lm", size, dcn=args.dcn_slices)
    plan = _resolve_plan(args, cell, allow_cm=args.seq_shards >= 2)
    knobs = plan["knobs"]
    _apply_reducer_knobs(args, knobs)
    args.collective_matmul = bool(knobs.get("collective_matmul"))
    return plan


__all__ = ["add_auto_tune_flags", "auto_tune_data_parallel", "auto_tune_lm",
           "launch_world"]
