"""Vision Transformer family, pre-LN (port of `models/vit.py`).

The reference's conventions (torchvision's): a patchify convolution,
a learned class token, learned position embeddings over 1 + HW/P²
tokens, pre-LN encoder blocks (h += Attn(LN(h)); h += MLP(LN(h))), a
final LayerNorm and a linear head on the class token. `vit_b16(1000)`
has torchvision `vit_b_16`'s 86,567,656 parameters.

Input: an NHWC image batch (`staging.staged_model` views it as NCHW);
output: (B, num_classes) logits. The patchify weight is kept in torch's
(O, I, kh, kw) layout (`models/convert.py` moves the reference's HWIO
across); the conv's (B, D, h, w) output is read back in the reference's
row-major patch order. The blocks share `models/transformer.py`'s
attention and FFN with BERT and the GPT; attention is the plain
`dot_product_attention`, as in the reference.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from distributed_model_parallel_tpu_torch.models import layers as L
from distributed_model_parallel_tpu_torch.models import staging
from distributed_model_parallel_tpu_torch.models.transformer import (
    AttentionFn,
    attention_params,
    feed_forward,
    ffn_params,
    multi_head_attention,
    norm_params,
)
from distributed_model_parallel_tpu_torch.ops.attention import (
    dot_product_attention,
)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    dim: int = 768
    num_layers: int = 12
    num_heads: int = 12
    mlp_dim: int = 3072
    dropout_rate: float = 0.0
    layer_norm_eps: float = 1e-6

    @property
    def num_patches(self) -> int:
        if self.image_size % self.patch_size:
            raise ValueError(
                f"image_size {self.image_size} not divisible by "
                f"patch_size {self.patch_size}"
            )
        return (self.image_size // self.patch_size) ** 2


VIT_B16 = ViTConfig()
# CIFAR-scale variant: 32² images, 4×4 patches (64 tokens).
VIT_CIFAR = ViTConfig(
    image_size=32, patch_size=4, dim=192, num_layers=6, num_heads=6,
    mlp_dim=768,
)


def pre_ln_encoder_layer(
    dim: int, num_heads: int, mlp_dim: int, *,
    dropout_rate: float = 0.0, eps: float = 1e-6,
    attention_fn: AttentionFn = dot_product_attention,
) -> L.Layer:
    """Pre-LN block on the (hidden, mask) pair:
    h += Attn(LN(h)); h += MLP(LN(h))."""
    if dim % num_heads:
        raise ValueError(f"dim {dim} not divisible by num_heads {num_heads}")

    def init(gen):
        return {"ln1": norm_params(dim),
                "attn": attention_params(gen, dim),
                "ln2": norm_params(dim),
                "ffn": ffn_params(gen, dim, mlp_dim)}, {}

    def apply(params, state, x, ctx):
        h, mask = x
        hn = L.layernorm(params["ln1"], h, eps)
        a, _ = multi_head_attention(
            params["attn"], (hn, mask), ctx.child(0), num_heads=num_heads,
            dropout_rate=dropout_rate, attention_fn=attention_fn)
        h = h + a
        hn = L.layernorm(params["ln2"], h, eps)
        f, _ = feed_forward(params["ffn"], (hn, mask), ctx.child(1),
                            dropout_rate=dropout_rate)
        return (h + f, mask), state

    return L.Layer(init, apply)


def _vit_stem(cfg: ViTConfig) -> L.Layer:
    """Patchify conv + class token + position embeddings + dropout: the
    NCHW view of (B, S, S, 3) images -> ((B, 1+N, D) tokens, None)."""
    n_tokens = cfg.num_patches + 1
    p = cfg.patch_size

    def init(gen):
        fan_in = 3 * p * p
        w = torch.randn((cfg.dim, 3, p, p), generator=gen) * fan_in ** -0.5
        return {
            "proj": {"w": w.contiguous(memory_format=torch.channels_last),
                     "b": torch.zeros(cfg.dim)},
            "cls": 0.02 * torch.randn((1, 1, cfg.dim), generator=gen),
            "position": 0.02 * torch.randn((1, n_tokens, cfg.dim),
                                           generator=gen),
        }, {}

    def apply(params, state, images, ctx):
        if tuple(images.shape[2:4]) != (cfg.image_size, cfg.image_size):
            raise ValueError(
                f"ViT configured for {cfg.image_size}x{cfg.image_size} "
                f"inputs (patch {p}) got images of shape "
                f"{tuple(images.permute(0, 2, 3, 1).shape)}; pick a "
                "matching ViTConfig/dataset"
            )
        x = images if ctx.dtype is None else images.to(ctx.dtype)
        y = F.conv2d(x, params["proj"]["w"].to(x.dtype), stride=p)
        y = y + params["proj"]["b"].to(x.dtype)[:, None, None]
        b = y.shape[0]
        tokens = y.permute(0, 2, 3, 1).reshape(b, -1, cfg.dim)
        cls = params["cls"].to(tokens.dtype).expand(b, 1, cfg.dim)
        h = torch.cat([cls, tokens], dim=1)
        h = h + params["position"].to(h.dtype)
        return (L.dropout(h, cfg.dropout_rate, ctx), None), state

    return L.Layer(init, apply)


def _vit_head(cfg: ViTConfig, num_classes: int) -> L.Layer:
    fc = L.linear(cfg.dim, num_classes)

    def init(gen):
        return {"ln": norm_params(cfg.dim), "fc": fc.init(gen)[0]}, {}

    def apply(params, state, x, ctx):
        h, _ = x
        hn = L.layernorm(params["ln"], h, cfg.layer_norm_eps)
        logits, _ = fc.apply(params["fc"], {}, hn[:, 0, :], ctx)
        return logits, state

    return L.Layer(init, apply)


def vit(num_classes: int, cfg: ViTConfig = VIT_B16, *,
        attention_fn: AttentionFn = dot_product_attention,
        remat: bool = False) -> L.Layer:
    """Full classifier: NHWC images -> (B, num_classes) logits.
    `remat=True` checkpoints each encoder block (`layers.remat`)."""
    blocks = [
        pre_ln_encoder_layer(
            cfg.dim, cfg.num_heads, cfg.mlp_dim,
            dropout_rate=cfg.dropout_rate, eps=cfg.layer_norm_eps,
            attention_fn=attention_fn)
        for _ in range(cfg.num_layers)
    ]
    if remat:
        blocks = [L.remat(b) for b in blocks]
    return staging.staged_model(_vit_stem(cfg), blocks,
                                _vit_head(cfg, num_classes))


def vit_b16(num_classes: int = 1000, **kw) -> L.Layer:
    """ViT-B/16 (86,567,656 parameters at 1000 classes)."""
    return vit(num_classes, VIT_B16, **kw)


def vit_cifar(num_classes: int = 10, **kw) -> L.Layer:
    """CIFAR-scale ViT (32² images, 4×4 patches)."""
    return vit(num_classes, VIT_CIFAR, **kw)


__all__ = ["VIT_B16", "VIT_CIFAR", "ViTConfig", "pre_ln_encoder_layer",
           "vit", "vit_b16", "vit_cifar"]
