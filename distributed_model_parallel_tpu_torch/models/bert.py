"""BERT classifier family (port of `models/bert.py`).

The standard BERT encoder: word, position and token-type embeddings,
LayerNorm (eps 1e-12) and dropout, post-LN encoder blocks
(`models/transformer.py`), and a tanh pooler over [CLS] with a linear
classifier, computed in f32. Inputs are int token ids (B, T), pad id 0;
the attention mask is `ids != pad_token_id`, a (B, T) key mask riding
beside the hidden states, so the model is a plain `Layer` that every
engine drives like the image models (`staging.staged_model(...,
nhwc=False)`), and it splits into pipeline stages the same way
(`split_stages`: embeddings on stage 0, the blocks spread, the head on
the last; the wire carries the (hidden, mask) pair).

Mixture-of-Experts: `num_experts > 0` makes every `moe_every`-th encoder
layer (1-based) a routed MoE block (`models/moe.py`), the reference's
alternating recipe; its state carries the load-balance loss.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.moe import moe_encoder_layer
from distributed_model_parallel_tpu_torch.models.transformer import (
    AttentionFn,
    encoder_layer_block,
    norm_params,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    intermediate_size: int = 3072
    max_position: int = 512
    type_vocab_size: int = 2
    dropout_rate: float = 0.1
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # Mixture-of-Experts: num_experts > 0 swaps the FFN of every
    # `moe_every`-th encoder layer for a routed MoE (`models/moe.py`).
    num_experts: int = 0
    moe_every: int = 2
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25


BERT_BASE = BertConfig()


def embed_apply(params, ids, cfg: BertConfig, ctx: L.Context, *,
                positions=None):
    """word + position + token-type(0) embeddings, LayerNorm, dropout.
    Returns (hidden, mask), mask = ids != pad_token_id."""
    mask = ids != cfg.pad_token_id
    if positions is None:
        positions = params["position"][: ids.shape[1]]
    h = (params["word"][ids] + positions[None, :, :]
         + params["token_type"][0][None, None, :])
    if ctx.dtype is not None:  # mixed precision enters here (int inputs)
        h = h.to(ctx.dtype)
    h = L.layernorm(params["ln"], h, cfg.layer_norm_eps)
    return L.dropout(h, cfg.dropout_rate, ctx), mask


def _embeddings(cfg: BertConfig) -> L.Layer:
    def init(gen):
        def normal(*shape):
            return 0.02 * torch.randn(shape, generator=gen)

        return {"word": normal(cfg.vocab_size, cfg.hidden_size),
                "position": normal(cfg.max_position, cfg.hidden_size),
                "token_type": normal(cfg.type_vocab_size, cfg.hidden_size),
                "ln": norm_params(cfg.hidden_size)}, {}

    def apply(params, state, ids, ctx):
        return embed_apply(params, ids, cfg, ctx), state

    return L.Layer(init, apply)


def _encoder_blocks(cfg: BertConfig,
                    attention_fn: AttentionFn) -> List[L.Layer]:
    if cfg.num_experts > 0 and cfg.moe_every < 1:
        raise ValueError(
            f"moe_every must be >= 1 when num_experts > 0, got "
            f"{cfg.moe_every} (1 = every layer, 2 = every other, ...)")
    return [moe_encoder_layer(
        cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
        cfg.num_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        dropout_rate=cfg.dropout_rate, eps=cfg.layer_norm_eps,
        attention_fn=attention_fn)
        if cfg.num_experts > 0 and (i + 1) % cfg.moe_every == 0
        else encoder_layer_block(
            cfg.hidden_size, cfg.num_heads, cfg.intermediate_size,
            dropout_rate=cfg.dropout_rate, eps=cfg.layer_norm_eps,
            attention_fn=attention_fn) for i in range(cfg.num_layers)]


def head_apply(params, h_cls: torch.Tensor) -> torch.Tensor:
    """tanh pooler + classifier on the [CLS] hidden state, in f32."""
    pooled = torch.tanh(h_cls.float() @ params["pooler"]["w"]
                        + params["pooler"]["b"])
    return pooled @ params["classifier"]["w"] + params["classifier"]["b"]


def _cls_head(cfg: BertConfig, num_classes: int) -> L.Layer:
    def init(gen):
        d = cfg.hidden_size
        return {
            "pooler": {"w": 0.02 * torch.randn((d, d), generator=gen),
                       "b": torch.zeros(d)},
            "classifier": {
                "w": 0.02 * torch.randn((d, num_classes), generator=gen),
                "b": torch.zeros(num_classes)},
        }, {}

    def apply(params, state, x, ctx):
        h, _ = x
        return head_apply(params, h[:, 0, :]), state

    return L.Layer(init, apply)


def bert_for_classification(
    num_classes: int = 2, cfg: BertConfig = BERT_BASE, *,
    attention_fn: AttentionFn = dot_product_attention,
    remat: bool = False,
) -> L.Layer:
    """int ids (B, T) -> logits (B, C). `remat=True` checkpoints each
    encoder layer (`layers.remat`)."""
    blocks = _encoder_blocks(cfg, attention_fn)
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_embeddings(cfg), blocks,
                                _cls_head(cfg, num_classes), nhwc=False)


def bert_base(num_classes: int = 2) -> L.Layer:
    return bert_for_classification(num_classes, BERT_BASE)


def split_stages(num_stages: int, num_classes: int = 2,
                 cfg: BertConfig = BERT_BASE, *,
                 boundaries: Sequence[int] | None = None,
                 attention_fn: AttentionFn = dot_product_attention,
                 ) -> List[L.Layer]:
    """Pipeline stages: the embeddings on stage 0, the encoder layers
    spread, the pooler and classifier on the last (`models/staging.py`).
    """
    blocks = _encoder_blocks(cfg, attention_fn)
    cuts = staging.split_points(num_stages, boundaries, len(blocks))
    return staging.assemble_stages(blocks, _embeddings(cfg),
                                   _cls_head(cfg, num_classes), cuts)


def partition_pytree(tree, num_stages: int, cfg: BertConfig = BERT_BASE, *,
                     boundaries: Sequence[int] | None = None) -> List[dict]:
    """A whole-model params tree -> the `split_stages` trees."""
    cuts = staging.split_points(num_stages, boundaries, cfg.num_layers)
    return staging.partition_tree(tree, cuts)


__all__ = ["BERT_BASE", "BertConfig", "bert_base", "bert_for_classification",
           "embed_apply", "head_apply", "partition_pytree", "split_stages"]
