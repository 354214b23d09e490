"""The port's FSDP on the BERT classifier held against the JAX package's
`FSDPEngine` (tinycnn and the specs are `tests/test_torch_port_fsdp.py`).

A tiny BERT (hidden 32, two layers so that the overlapped step has two
stages, 4 heads, FFN 64, vocabulary 97), from the JAX engine's initial
weights, 3 steps on 3 seeded batches of 16 sequences of 12 tokens (3 pad
positions each); 2 and 4 gloo ranks against `MeshSpec(data=2|4)`;
monolithic, bucketed and overlapped x SGD (lr 0.05) / AdamW (lr 1e-3);
the default `min_shard_elems` (1024: the projections, the embeddings and
the head shard; the LN scales and the biases replicate).

Bars: the f32 transformer bar, rtol 1e-5 / atol 1e-6; counts equal.
"""

import numpy as np
import pytest

import _torch_port_ranks as ranks
import test_torch_port_fsdp as base
from distributed_model_parallel_tpu.models.bert import (
    BertConfig as JBertConfig,
)
from distributed_model_parallel_tpu.models.bert import (
    bert_for_classification as j_bert,
)

F32 = dict(rtol=1e-5, atol=1e-6)
TINY = dict(vocab_size=97, hidden_size=32, num_layers=2, num_heads=4,
            intermediate_size=64, max_position=16, dropout_rate=0.0)
BATCH, SEQ, CLASSES = 16, 12, 4


def _batches():
    rng = np.random.RandomState(0)
    out = []
    for _ in range(base.STEPS):
        ids = rng.randint(1, 97, size=(BATCH, SEQ)).astype(np.int32)
        ids[:, -3:] = 0  # pad tail: the attention mask
        out.append((ids, rng.randint(0, CLASSES, BATCH).astype(np.int32)))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    batches = _batches()
    ref = {case: base.jax_run(
        base.jax_engine(j_bert(CLASSES, JBertConfig(**TINY)), *case),
        batches, base.LR[case[2]]) for case in base.CASES}
    params, state = ref[base.CASES[0]][0]
    port = {}
    for n in (2, 4):
        payload = {"model": "bert", "bert": TINY, "classes": CLASSES,
                   "params": params, "state": state, "batches": batches,
                   "runs": [{"name": (gr, opt), "gr": gr, "opt": opt,
                             "lr": base.LR[opt], "bucket_mb": base.BUCKET_MB}
                            for m, gr, opt in base.CASES if m == n]}
        got = ranks.spawn(n, "fsdp_suite", payload,
                          tmp_path_factory.mktemp(f"fsdp_bert{n}"))
        for case in base.CASES:
            if case[0] == n:
                port[case] = [g[case[1:]] for g in got]
    return ref, port


@pytest.mark.parametrize("case", base.CASES, ids=[
    f"n{n}-{gr}-{opt}" for n, gr, opt in base.CASES])
def test_fsdp_bert_matches_the_reference_engine(runs, case):
    ref, port = runs
    _, sums, canonical, shapes = ref[case]
    for r, rank_out in enumerate(port[case]):
        for g, w in zip(rank_out["sums"], sums):
            assert {k: g[k] for k in ("correct1", "correct5", "count")} == \
                {k: w[k] for k in ("correct1", "correct5", "count")}
            np.testing.assert_allclose(g["loss_sum"], w["loss_sum"], **F32)
        assert rank_out["shapes"] == shapes[r]
    base.assert_trees(port[case][0]["canonical"], canonical, **F32)
