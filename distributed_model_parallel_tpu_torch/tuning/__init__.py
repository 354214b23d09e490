"""tuning/: the auto-tuner over the port's own cost engine (port of the
reference's `tuning/`).

A declarative search space over the engines' knob cross-product a
family (`space.py`); a deterministic enumerate-and-score search that
prunes with the closed-form alpha-beta formulas and records only the
argmin finalists' steps through the linter's builders (`search.py`);
the versioned `plan.json` artifact both training CLIs accept through
`--auto-tune PLAN|search` and `cli.lm --plan auto` (`plan.py`,
`apply.py`); and a costgate-style gate over the committed grid of tuned
plans (`plangate.py`, exit 6).

Every applied plan is verified, not trusted: the search runs the
linter's full rule registry over the chosen configuration's recorded
step, so a plan that picks `dcn_compression=int8` must issue an int8
wire before anyone trains under it.
"""

from distributed_model_parallel_tpu_torch.tuning.plan import (  # noqa: F401
    PLAN_SCHEMA,
    Cell,
    load_plan,
    save_plan,
    validate_plan,
)
from distributed_model_parallel_tpu_torch.tuning.space import (  # noqa: F401
    SPACES,
    candidates,
    scan_knob_surface,
)
