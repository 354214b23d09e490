"""The port's MobileNetV2 torch-checkpoint bridge
(`distributed_model_parallel_tpu_torch/models/torch_import.py`), with the
cases of `tests/test_torch_import.py` and one more: the port's import
equals the JAX package's import followed by `models/convert.
from_jax_params`, leaf for leaf.

Ground truth is the JAX package's own test helpers: a reference-layout
state_dict drawn from a numpy seed (`make_state_dict`) and a functional
`torch.nn.functional` interpreter of it (`torch_forward`). The port's
logits are held to that interpreter at the JAX test's bar, rtol/atol
5e-4 (a 52-BN-layer net in f32; the port normalizes as the reference
does, E[x^2] - E[x]^2, where the interpreter calls F.batch_norm).
"""

import numpy as np
import pytest
import torch

from distributed_model_parallel_tpu.models.torch_import import (
    mobilenetv2_from_torch_state_dict as j_from_torch,
)
from distributed_model_parallel_tpu_torch.cli import data_parallel as dp_cli
from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models.convert import (
    from_jax_params,
    to_jax_params,
)
from distributed_model_parallel_tpu_torch.models.mobilenetv2 import (
    mobilenet_v2,
)
from distributed_model_parallel_tpu_torch.models.torch_import import (
    load_torch_checkpoint,
    mobilenetv2_from_torch_state_dict,
    mobilenetv2_to_torch_state_dict,
    normalize_state_dict,
    save_reference_checkpoint,
)
from distributed_model_parallel_tpu_torch.training import checkpoint as ckpt
from distributed_model_parallel_tpu_torch.training.trainer import Trainer
from test_torch_import import make_state_dict, torch_forward
from _torch_port_ranks import torch_port_worker  # noqa: F401,E402

LOGIT_TOL = dict(rtol=5e-4, atol=5e-4)


def _init(seed=0):
    model = mobilenet_v2(10)
    params, state = model.init(torch.Generator().manual_seed(seed))
    return model, params, state


def _assert_trees_equal(a, b):
    la, lb = ckpt.flatten_tree(a), ckpt.flatten_tree(b)
    assert la.keys() == lb.keys()
    for k in la:
        assert torch.equal(la[k], lb[k]), k
        cl = torch.channels_last
        assert la[k].dim() != 4 or (la[k].is_contiguous(memory_format=cl)
                                    and lb[k].is_contiguous(
                                        memory_format=cl)), f"{k} layout"


def test_transplant_logits_match_torch():
    sd = make_state_dict()
    model, params, state = _init()
    params, state = mobilenetv2_from_torch_state_dict(params, state, sd)
    x = np.random.RandomState(3).rand(4, 32, 32, 3).astype(np.float32)
    want = torch_forward(sd, np.transpose(x, (0, 3, 1, 2)))
    with torch.no_grad():
        got, _ = model.apply(params, state, torch.from_numpy(x),
                             L.Context(train=False))
    np.testing.assert_allclose(got.numpy(), want, **LOGIT_TOL)


def test_reference_checkpoint_wrapper_and_dataparallel_prefix():
    sd = make_state_dict()
    wrapped = {"net": {f"module.{k}": v for k, v in sd.items()},
               "acc": 93.8, "epoch": 41}
    assert set(normalize_state_dict(wrapped)) == set(sd)
    _, params, state = _init()
    p1, s1 = mobilenetv2_from_torch_state_dict(params, state, wrapped)
    p2, s2 = mobilenetv2_from_torch_state_dict(params, state, sd)
    _assert_trees_equal(p1, p2)
    _assert_trees_equal(s1, s2)


def test_head_mismatch_keeps_the_fresh_classifier():
    sd = make_state_dict(num_classes=1000)
    _, params, state = _init()
    p, _ = mobilenetv2_from_torch_state_dict(params, state, sd)
    assert p["head"]["linear"]["w"].shape == (1280, 10)
    assert torch.equal(p["head"]["linear"]["w"],
                       params["head"]["linear"]["w"])
    assert torch.equal(p["stem"]["conv1"]["w"],
                       torch.from_numpy(sd["conv1.weight"]))
    with pytest.raises(ValueError, match="classes"):
        mobilenetv2_from_torch_state_dict(params, state, sd,
                                          allow_head_mismatch=False)


@pytest.mark.parametrize("edit,error,match", [
    (lambda sd: sd.update({"layers.3.mystery.weight":
                           np.zeros((1,), np.float32)}),
     ValueError, "not consumed"),
    (lambda sd: sd.pop("layers.5.conv2.weight"), KeyError,
     "layers.5.conv2.weight"),
    (lambda sd: sd.update({"bn1.weight": np.ones(3, np.float32)}),
     ValueError, "'bn1.weight' has shape"),
], ids=["unknown", "missing", "misshapen"])
def test_schema_drift_fails_loudly(edit, error, match):
    sd = make_state_dict()
    edit(sd)
    _, params, state = _init()
    with pytest.raises(error, match=match):
        mobilenetv2_from_torch_state_dict(params, state, sd)


def test_import_equals_the_jax_import_then_from_jax_params():
    sd = make_state_dict(seed=4)
    model, params, state = _init()
    got_p, got_s = mobilenetv2_from_torch_state_dict(params, state, sd)
    # The JAX import's templates in the JAX layout (its values are all
    # replaced, the head's too: the class counts match).
    jp, js = j_from_torch(*to_jax_params(params, model=model, state=state),
                          sd)
    want_p, want_s = from_jax_params(jp, model=model, state=js)
    _assert_trees_equal(got_p, want_p)
    _assert_trees_equal(got_s, want_s)


def test_export_round_trip_is_bit_exact(tmp_path):
    _, params, state = _init(seed=3)
    path = str(tmp_path / "export.pth")
    save_reference_checkpoint(path, params, state, acc=93.8, epoch=17)
    loaded = torch.load(path, map_location="cpu", weights_only=True)
    assert (loaded["acc"], loaded["epoch"]) == (93.8, 17)
    assert all(k.startswith("module.") for k in loaded["net"])
    _, fresh_p, fresh_s = _init(seed=5)
    p2, s2 = mobilenetv2_from_torch_state_dict(
        fresh_p, fresh_s, load_torch_checkpoint(path))
    _assert_trees_equal(p2, params)
    _assert_trees_equal(s2, state)
    sd = mobilenetv2_to_torch_state_dict(params, state, module_prefix=False)
    assert set(sd) == set(make_state_dict())


FINETUNE = ["--device", "cpu", "--model", "mobilenetv2", "--dataset-type",
            "Synthetic", "-b", "16", "--val-batch-size", "256",
            "--epochs", "1", "--steps-per-epoch", "2", "--lr", "0.001"]


def test_cli_finetune_starts_from_the_torch_checkpoint(tmp_path,
                                                       monkeypatch, capsys):
    """--finetune loads a reference-layout checkpoint with an
    ImageNet-style head into the DP CLI, which trains from it."""
    sd = make_state_dict(num_classes=1000)
    np.savez(tmp_path / "pre.npz", **sd)
    monkeypatch.chdir(tmp_path)
    started = {}
    fit = Trainer.fit

    def recording(self):
        started["stem"] = self.state.params["stem"]["conv1"]["w"].detach()\
            .clone()
        started["step"] = self.state.step
        return fit(self)

    monkeypatch.setattr(Trainer, "fit", recording)
    out = dp_cli.main(FINETUNE + ["--finetune", str(tmp_path / "pre.npz"),
                                  "--checkpoint-dir", "ck"])
    assert len(out["history"]) == 1
    assert torch.equal(started["stem"], torch.from_numpy(sd["conv1.weight"]))
    assert started["step"] == 0
    assert "Transplanted torch weights" in capsys.readouterr().out


@pytest.mark.parametrize("extra,match", [
    (["--resume"], "conflicts with --resume"),
    (["--model", "tinycnn"], "supports the BN MobileNetV2"),
], ids=["resume", "model"])
def test_cli_finetune_refusals(extra, match, tmp_path):
    np.savez(tmp_path / "pre.npz", **make_state_dict())
    with pytest.raises(SystemExit, match=match):
        dp_cli.main(FINETUNE + ["--finetune", str(tmp_path / "pre.npz"),
                                *extra])
    with pytest.raises(SystemExit, match="no such file"):
        dp_cli.main(FINETUNE + ["--finetune", str(tmp_path / "none.pth")])
