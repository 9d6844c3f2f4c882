"""PET neural modules (PyTorch), on the plain NEF layout.

Counterpart of ``metatrain_tpu/models/pet/modules.py``:

- the fused layer path (``FusedTransformerLayer``, PreLN/RMSNorm/SwiGLU,
  the center token in slot M-1, K1/K2 on the card), and with
  ``fused_gnn=True`` all the fused layers of a GNN layer and the node
  stream between them as one block (``fused_gnn_block``, the GNN block
  kernels on the card; the same parameters);
- the unfused layer path (``TransformerLayer``: PreLN or PostLN, RMSNorm
  or LayerNorm, SwiGLU or SiLU, the center token first in a window of
  M + 1 tokens, the window attention kernels on the card), taken for
  ``fused_layers: false`` and for any layer the fused kernel does not
  cover, as in the JAX package;
- the feedforward and residual featurizers, and the heads.

Module and parameter names follow the flax tree, so
``interop/jax_params.py`` maps a flax parameter tree onto ``state_dict``
keys one to one. Raw fused-layer leaves keep the flax (in, out) layout;
``nn.Linear`` weights are (out, in).

Parameters stay float32; each module computes in ``dtype`` (float32,
bfloat16 or float64), casting weights at use as flax does.

``plain=True`` runs the plain PyTorch versions of the kernels under
autograd (``layer_math`` or ``gnn_block_math``, the stage math,
``attention_math`` and the index_select permute): the reference that the
tests and ``chip_smoke.py`` compare the kernel path against. The default
runs the kernels' ``autograd.Function``s.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.kernels.attention import attention_math, window_attention
from ...ops.kernels.fused_layer import (
    LayerWeights,
    accumulation_dtype,
    fused_transformer_layer,
    layer_math,
    rmsnorm_eps,
)
from ...ops.kernels.gnn_block import (
    CenterWeights,
    flatten_gnn_weights,
    fused_gnn_block,
    gnn_block_math,
)
from ...ops.kernels.permute import permute_math, reverse_pair
from ...ops.kernels.rowblock import rowblock
from .fused_stages import COMBINATION, COMPRESS, EPS_LAYERNORM, HEAD

_TRUNC_NORMAL_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]
EPSILON_ATTN = 1e-15  # floor of the cutoff factor under the attention's log


def lecun_normal_(t: torch.Tensor, fan_in: int, generator: torch.Generator) -> None:
    """flax's ``lecun_normal``: truncated normal in [-2, 2] std, variance
    1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_NORMAL_STD
    nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)


def init_flax_like(module: nn.Module, generator: torch.Generator) -> None:
    """Initialise every parameter with flax's default family, in
    ``named_parameters`` order: Dense kernels lecun_normal, biases zeros,
    norm scales ones, embeddings normal with variance 1 / features."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if isinstance(owner, nn.Embedding):
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif leaf == "bias" or leaf.startswith("b_"):
                p.zero_()
            elif isinstance(owner, (nn.LayerNorm, RMSNorm)) or leaf.startswith("norm_"):
                p.fill_(1.0)
            elif isinstance(owner, nn.Linear):
                lecun_normal_(p, p.shape[1], generator)
            else:  # raw (in, out) fused-layer leaf
                lecun_normal_(p, p.shape[0], generator)


def cutoff_func_bump(values, cutoff, width):
    """C-infinity bump switching function."""
    scaled = (values - (cutoff - width)) / width
    clamped = torch.clamp(scaled, 1e-6, 1.0 - 1e-6)
    return 0.5 * (1.0 + torch.tanh(1.0 / torch.tan(math.pi * clamped)))


def cutoff_func_cosine(values, cutoff, width):
    """Cosine switching function."""
    scaled = (values - (cutoff - width)) / width
    return 0.5 * (1.0 + torch.cos(math.pi * torch.clamp(scaled, 0.0, 1.0)))


def dense(layer: nn.Linear, x: torch.Tensor, dtype) -> torch.Tensor:
    """flax ``nn.Dense(dtype=dtype)``: input and weights cast to ``dtype``."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def embed(layer: nn.Embedding, index: torch.Tensor, dtype) -> torch.Tensor:
    return F.embedding(index, layer.weight.to(dtype))


def dense_kernel(layer: nn.Linear):
    """(in, out) kernel and bias of a Linear, the stage math's layout."""
    return layer.weight.T, layer.bias


class RMSNorm(nn.Module):
    """flax ``nn.RMSNorm``: float32 (float64) statistics, output in the
    input dtype."""

    def __init__(self, width: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(width))

    def forward(self, x):
        acc = accumulation_dtype(x.dtype)
        x32 = x.to(acc)
        r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + rmsnorm_eps(x.dtype))
        return (x32 * r * self.weight.to(x.dtype).to(acc)).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """flax ``nn.LayerNorm(epsilon=1e-5)``: mean and fast variance
    (``E[x^2] - E[x]^2``, clipped at 0) in float32 (float64), the scale and
    bias applied in that dtype, output in the input dtype."""

    def __init__(self, width: int):
        super().__init__(width, eps=EPS_LAYERNORM)

    def forward(self, x):
        acc = accumulation_dtype(x.dtype)
        x32 = x.to(acc)
        mean = torch.mean(x32, dim=-1, keepdim=True)
        var = torch.clamp_min(torch.mean(x32 * x32, dim=-1, keepdim=True) - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.weight.to(acc)
        return ((x32 - mean) * mul + self.bias.to(acc)).to(x.dtype)


def make_norm(kind: str, width: int) -> nn.Module:
    """The JAX package's ``_norm``: RMSNorm, or LayerNorm for any other name."""
    return RMSNorm(width) if kind == "RMSNorm" else LayerNorm(width)


class FeedForward(nn.Module):
    """SwiGLU gated unit ``w_out(v * sigmoid(g))`` with ``[v | g] =
    w_in(x)``, or the SiLU MLP ``w_out(silu(w_in(x)))`` for any other
    activation name."""

    def __init__(self, d_model: int, d_feedforward: int, activation: str = "SwiGLU"):
        super().__init__()
        self.gated = activation.lower() == "swiglu"
        self.w_in = nn.Linear(d_model, (2 if self.gated else 1) * d_feedforward)
        self.w_out = nn.Linear(d_feedforward, d_model)

    def forward(self, x, dtype):
        h = dense(self.w_in, x, dtype)
        if self.gated:
            v, g = torch.chunk(h, 2, dim=-1)
            h = v * torch.sigmoid(g)
        else:
            h = F.silu(h)
        return dense(self.w_out, h, dtype)


class FusedTransformerLayer(nn.Module):
    """PreLN/RMSNorm/SwiGLU layer over [edges | center in slot M-1], run by
    the fused layer (K1/K2 on the card). The node stream (center
    contraction/expansion, center MLP) is plain PyTorch."""

    def __init__(self, d_model, num_heads, d_node, d_feedforward, temperature, dtype, plain):
        super().__init__()
        D = d_model
        self.num_heads, self.dtype, self.plain = num_heads, dtype, plain
        self.scale = 1.0 / ((D // num_heads) ** 0.5 * temperature)
        self.expanded = d_node != D
        shapes = {
            "norm_attn": (D,), "w_qkv": (D, 3 * D), "b_qkv": (3 * D,),
            "w_out": (D, D), "b_out": (D,), "norm_mlp": (D,),
            "w_in": (D, 2 * d_feedforward), "b_in": (2 * d_feedforward,),
            "w_ffn_out": (d_feedforward, D), "b_ffn_out": (D,),
        }
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        if self.expanded:
            self.center_contraction = nn.Linear(d_node, D)
            self.center_expansion = nn.Linear(D, d_node)
            self.norm_center_features = RMSNorm(d_node)
            self.center_mlp = FeedForward(d_node, 2 * d_node)

    def gnn_weights(self):
        """``(LayerWeights, CenterWeights or None)``: this layer's weights
        for the fused GNN block, in the (in, out) layout."""
        lw = LayerWeights(*(getattr(self, f) for f in LayerWeights._fields))
        if not self.expanded:
            return lw, None
        mlp = self.center_mlp
        return lw, CenterWeights(
            w_contr=self.center_contraction.weight.T, b_contr=self.center_contraction.bias,
            w_exp=self.center_expansion.weight.T, b_exp=self.center_expansion.bias,
            norm_c=self.norm_center_features.weight,
            w_in_c=mlp.w_in.weight.T, b_in_c=mlp.w_in.bias,
            w_out_c=mlp.w_out.weight.T, b_out_c=mlp.w_out.bias,
        )

    def forward(self, node, edges, cf_tokens):
        cd = self.dtype
        center = dense(self.center_contraction, node, cd) if self.expanded else node
        w = LayerWeights(*(getattr(self, f) for f in LayerWeights._fields))
        layer = layer_math if self.plain else fused_transformer_layer
        edge_out, center_attn = layer(
            edges.to(cd), center.to(cd), cf_tokens, w, self.num_heads, self.scale
        )
        if not self.expanded:
            # d_node == d_pet: the center takes the raw attention output
            return center_attn, edge_out
        out_node = node + dense(self.center_expansion, center_attn, cd)
        out_node = out_node + self.center_mlp(self.norm_center_features(out_node), cd)
        return out_node, edge_out


class AttentionBlock(nn.Module):
    """Multi-head attention over each atom's window of tokens, with an
    additive (A, T) bias on the keys. ``fused`` (the ``fused_attention``
    hyper) runs :func:`window_attention`, the kernels on the card;
    otherwise, or with ``plain``, the plain version under autograd on any
    device, as the JAX package's pure-XLA choice."""

    def __init__(self, total_dim, num_heads, temperature, fused, plain):
        super().__init__()
        self.num_heads, self.fused, self.plain = num_heads, fused, plain
        self.scale = 1.0 / ((total_dim // num_heads) ** 0.5 * temperature)
        self.input_linear = nn.Linear(total_dim, 3 * total_dim)
        self.output_linear = nn.Linear(total_dim, total_dim)

    def forward(self, x, attn_bias, dtype):
        q, k, v = torch.chunk(dense(self.input_linear, x, dtype), 3, dim=-1)
        if self.fused and not self.plain:
            # the kernels take the bias in float32, as the Pallas call does
            if q.dtype != torch.float64:
                attn_bias = attn_bias.to(torch.float32)
            out = window_attention(q, k, v, attn_bias, self.num_heads, self.scale)
        else:
            out = attention_math(q, k, v, attn_bias, self.num_heads, self.scale)
        return dense(self.output_linear, out.to(x.dtype), dtype)


class TransformerLayer(nn.Module):
    """One unfused transformer layer over [center token | edge tokens]:
    PreLN or PostLN, RMSNorm or LayerNorm, SwiGLU or SiLU. Node features
    live in ``d_node`` and are contracted to ``d_model`` for attention when
    the widths differ."""

    def __init__(self, hp: Dict[str, Any], dtype, plain):
        super().__init__()
        D, d_node = hp["d_pet"], hp["d_node"]
        self.dtype = dtype
        self.post_ln = hp["transformer_type"] != "PreLN"
        self.expanded = d_node != D
        self.attention = AttentionBlock(D, hp["num_heads"], hp["attention_temperature"],
                                        hp.get("fused_attention", True), plain)
        self.norm_attention = make_norm(hp["normalization"], D)
        self.norm_mlp = make_norm(hp["normalization"], D)
        self.mlp = FeedForward(D, hp["d_feedforward"], hp["activation"])
        if self.expanded:
            self.center_contraction = nn.Linear(d_node, D)
            self.center_expansion = nn.Linear(D, d_node)
            self.norm_center_features = make_norm(hp["normalization"], d_node)
            self.center_mlp = FeedForward(d_node, 2 * d_node, hp["activation"])

    def forward(self, node, edges, attn_bias):
        cd = self.dtype
        center = dense(self.center_contraction, node, cd) if self.expanded else node
        tokens = torch.cat([center.to(cd)[:, None], edges.to(cd)], dim=1)
        if self.post_ln:
            tokens = self.norm_attention(tokens + self.attention(tokens, attn_bias, cd))
            tokens = self.norm_mlp(tokens + self.mlp(tokens, cd))
            out_center, out_edges = tokens[:, 0], tokens[:, 1:]
        else:
            new_tokens = self.attention(self.norm_attention(tokens), attn_bias, cd)
            out_center, out_edges = new_tokens[:, 0], new_tokens[:, 1:]
            out_edges = edges + out_edges
            out_edges = out_edges + self.mlp(self.norm_mlp(out_edges), cd)
        if not self.expanded:
            # reference parity: the center takes the raw layer output
            return out_center, out_edges
        out_node = node + dense(self.center_expansion, out_center, cd)
        out_node = out_node + self.center_mlp(self.norm_center_features(out_node), cd)
        return out_node, out_edges


def uses_fused_layer(hp: Dict[str, Any]) -> bool:
    """The JAX package's choice: the fused layer covers PreLN/RMSNorm/SwiGLU
    layers with ``fused_layers`` on; every other layer runs unfused."""
    return (hp.get("fused_layers", True) and hp["normalization"] == "RMSNorm"
            and hp["activation"] == "SwiGLU" and hp["transformer_type"] == "PreLN")


def run_stage(stage, inputs, weights, plain: bool):
    """A row-block stage through K3/K4 (``plain=False``) or its plain math."""
    return stage.math(inputs, weights) if plain else rowblock(stage, inputs, weights)


class CartesianTransformer(nn.Module):
    """One GNN layer: geometric edge tokens -> compress stage -> transformer
    layers over each atom's neighbor window (fused or unfused). With
    ``fused_gnn`` the fused layers and the node stream run as one GNN block
    (unfused configurations ignore it, as in the JAX package)."""

    def __init__(self, hp: Dict[str, Any], num_species: int, is_first: bool, dtype, plain,
                 fused_gnn: bool = False):
        super().__init__()
        d_pet = hp["d_pet"]
        self.dtype, self.plain, self.is_first = dtype, plain, is_first
        self.edge_embedder = nn.Linear(4, d_pet)
        if not is_first:
            self.neighbor_embedder = nn.Embedding(num_species, d_pet)
        self.compress_0 = nn.Linear((2 if is_first else 3) * d_pet, d_pet)
        self.compress_1 = nn.Linear(d_pet, d_pet)
        self.fused = uses_fused_layer(hp)
        for i in range(hp["num_attention_layers"]):
            self.add_module(f"layer_{i}", FusedTransformerLayer(
                d_pet, hp["num_heads"], hp["d_node"], hp["d_feedforward"],
                hp["attention_temperature"], dtype, plain,
            ) if self.fused else TransformerLayer(hp, dtype, plain))
        self.num_attention_layers = hp["num_attention_layers"]
        self.fused_gnn = fused_gnn and self.fused

    def gnn_block(self, node, edges, cf_tokens):
        """Every layer of this GNN layer as one block: ``(node, edges)``."""
        layers = [getattr(self, f"layer_{i}") for i in range(self.num_attention_layers)]
        lws, cws = zip(*(layer.gnn_weights() for layer in layers))
        first = layers[0]
        args = (edges.to(self.dtype), node.to(self.dtype), cf_tokens)
        if self.plain:
            edges, node = gnn_block_math(*args, lws, cws, first.num_heads, first.scale,
                                         first.expanded)
        else:
            edges, node = fused_gnn_block(*args, flatten_gnn_weights(lws, cws, first.expanded),
                                          first.num_heads, first.scale, len(layers),
                                          first.expanded)
        return node, edges

    def forward(self, node, input_messages, nbr_species_index, edge_vectors,
                edge_distances, nbr_mask, cutoff_factors):
        cd = self.dtype
        geom = torch.cat([edge_vectors, edge_distances[:, :, None]], dim=-1)
        edge_emb = dense(self.edge_embedder, geom, cd)
        if self.is_first:
            parts = (edge_emb, input_messages.to(cd))
        else:
            nbr_emb = embed(self.neighbor_embedder, nbr_species_index, cd)
            parts = (edge_emb, nbr_emb, input_messages.to(cd))
        A, M, D = edge_emb.shape
        flat = tuple(p.reshape(A * M, D) for p in parts)
        weights = (*dense_kernel(self.compress_0), *dense_kernel(self.compress_1))
        edges = run_stage(COMPRESS, flat, weights, self.plain).reshape(A, M, D)

        cf = torch.where(nbr_mask, cutoff_factors, 0.0)
        if self.fused:
            # multiplicative weights: padded edges 0, the center token
            # (slot M-1) 1
            attn = torch.cat([cf[:, :-1], torch.ones_like(cf[:, :1])], dim=1)
        else:
            # additive log-cutoff bias over [center | edges]
            attn = torch.log(torch.clamp(
                torch.cat([torch.ones_like(cf[:, :1]), cf], dim=1), min=EPSILON_ATTN))
        if self.fused_gnn:
            return self.gnn_block(node, edges, attn)
        for i in range(self.num_attention_layers):
            node, edges = getattr(self, f"layer_{i}")(node, edges, attn)
        return node, edges


def reverse_edges(x, nbr_reverse, plain: bool):
    """``(x, x reversed over edges)``: the permute kernel's pair (its
    backward fuses the cotangent add), or with ``plain`` the index_select
    under autograd."""
    if not plain:
        return reverse_pair(x, nbr_reverse)
    A, M = x.shape[:2]
    flat = x.reshape((A * M,) + x.shape[2:])
    return x, permute_math(flat, nbr_reverse.reshape(-1)).reshape(x.shape)


class PETBackbone(nn.Module):
    """Species embeddings -> stacked GNN layers. Returns per-readout-layer
    node features (A, d_node) and edge features (A, M, d_pet): one pair for
    the ``feedforward`` featurizer, one per GNN layer for ``residual``."""

    def __init__(self, hp: Dict[str, Any], num_species: int, dtype, plain, fused_gnn=False):
        super().__init__()
        d_pet, d_node = hp["d_pet"], hp["d_node"]
        self.dtype, self.plain = dtype, plain
        self.num_gnn = hp["num_gnn_layers"]
        self.feedforward = hp["featurizer_type"] == "feedforward"
        for i in range(1 if self.feedforward else self.num_gnn):
            self.add_module(f"node_embedder_{i}", nn.Embedding(num_species, d_node))
        self.edge_species_embedder = nn.Embedding(num_species, d_pet)
        for i in range(self.num_gnn):
            self.add_module(f"gnn_layer_{i}", CartesianTransformer(hp, num_species, i == 0, dtype,
                                                                   plain, fused_gnn))
            if self.feedforward:
                self.add_module(f"combination_norm_{i}", nn.LayerNorm(2 * d_pet))
                self.add_module(f"combination_mlp_{i}_0", nn.Linear(2 * d_pet, 2 * d_pet))
                self.add_module(f"combination_mlp_{i}_1", nn.Linear(2 * d_pet, d_pet))

    def forward(self, bd: Dict[str, Any]):
        cd = self.dtype
        nbr_species = bd["neighbor_species_index"]
        input_messages = embed(self.edge_species_embedder, nbr_species, cd)
        common = (nbr_species, bd["edge_vectors"], bd["edge_distances"],
                  bd["nbr_mask"], bd["cutoff_factors"])
        if not self.feedforward:
            node_features, edge_features = [], []
            for i in range(self.num_gnn):
                node = embed(getattr(self, f"node_embedder_{i}"), bd["species_index"], cd)
                node, out_edges = getattr(self, f"gnn_layer_{i}")(node, input_messages, *common)
                node_features.append(node)
                out_edges, reversed_edges = reverse_edges(out_edges, bd["nbr_reverse"], self.plain)
                edge_features.append(out_edges)
                input_messages = 0.5 * (input_messages + reversed_edges)
            return node_features, edge_features

        node = embed(self.node_embedder_0, bd["species_index"], cd)
        for i in range(self.num_gnn):
            node, out_edges = getattr(self, f"gnn_layer_{i}")(node, input_messages, *common)
            out_edges, reversed_edges = reverse_edges(out_edges, bd["nbr_reverse"], self.plain)
            ln = getattr(self, f"combination_norm_{i}")
            weights = (ln.weight, ln.bias,
                       *dense_kernel(getattr(self, f"combination_mlp_{i}_0")),
                       *dense_kernel(getattr(self, f"combination_mlp_{i}_1")))
            A, M, D = out_edges.shape
            flat = (out_edges.reshape(A * M, D), reversed_edges.reshape(A * M, D),
                    input_messages.to(out_edges.dtype).reshape(A * M, D))
            input_messages = run_stage(COMBINATION, flat, weights, self.plain).reshape(A, M, D)
        return [node], [input_messages]


class Head(nn.Module):
    """Two-layer SiLU head."""

    def __init__(self, d_in: int, d_head: int):
        super().__init__()
        self.linear_0 = nn.Linear(d_in, d_head)
        self.linear_1 = nn.Linear(d_head, d_head)

    def forward(self, x, dtype):
        return F.silu(dense(self.linear_1, F.silu(dense(self.linear_0, x, dtype)), dtype))

    def stage_weights(self):
        return (*dense_kernel(self.linear_0), *dense_kernel(self.linear_1))


class PETModule(nn.Module):
    """Backbone + per-target node/edge heads and last layers, one set per
    readout layer of the backbone.

    ``output_shapes``: target name -> {block key string -> flat size}.
    Returns, per requested target, the per-atom prediction of each block
    (A, size): node predictions plus cutoff-weighted sums of edge
    predictions.
    """

    def __init__(self, hp: Dict[str, Any], num_species: int,
                 output_shapes: Dict[str, Dict[str, int]], dtype, plain: bool = False,
                 fused_gnn: bool = False):
        super().__init__()
        unsupported = {
            "long_range": bool(hp.get("long_range", {}).get("enable")),
            "system_conditioning": bool(hp.get("system_conditioning")),
        }
        off_slice = [k for k, bad in unsupported.items() if bad]
        if off_slice:
            raise NotImplementedError(
                f"PET configuration off the ported slice: {off_slice} (the port "
                "runs PET without long range or system conditioning)"
            )
        self.dtype, self.plain = dtype, plain
        self.output_shapes = output_shapes
        self.backbone = PETBackbone(hp, num_species, dtype, plain, fused_gnn)
        d_head = hp["d_head"]
        readouts = 1 if hp["featurizer_type"] == "feedforward" else hp["num_gnn_layers"]
        for target, shapes in output_shapes.items():
            safe = target.replace(":", "_")
            for i in range(readouts):
                self.add_module(f"node_head_{safe}_{i}", Head(hp["d_node"], d_head))
                self.add_module(f"edge_head_{safe}_{i}", Head(hp["d_pet"], d_head))
                for key, size in shapes.items():
                    self.add_module(f"node_last_{safe}_{i}_{key}", nn.Linear(d_head, size))
                    self.add_module(f"edge_last_{safe}_{i}_{key}", nn.Linear(d_head, size))

    def forward(self, bd: Dict[str, Any], requested: Sequence[str]):
        cd = self.dtype
        node_features, edge_features = self.backbone(bd)
        cf = torch.where(bd["nbr_mask"], bd["cutoff_factors"], 0.0)
        results: Dict[str, Dict[str, torch.Tensor]] = {}
        for target, shapes in self.output_shapes.items():
            if target not in requested:
                continue
            safe = target.replace(":", "_")
            sums: Dict[str, torch.Tensor] = {}
            for layer_i, (nf, ef) in enumerate(zip(node_features, edge_features)):
                node_ll = getattr(self, f"node_head_{safe}_{layer_i}")(nf, cd)
                edge_head = getattr(self, f"edge_head_{safe}_{layer_i}")
                A, M, D = ef.shape
                edge_ll = run_stage(
                    HEAD, (ef.to(cd).reshape(A * M, D),), edge_head.stage_weights(), self.plain
                ).reshape(A, M, -1)
                for key in shapes:
                    node_pred = dense(getattr(self, f"node_last_{safe}_{layer_i}_{key}"), node_ll, cd)
                    edge_pred = dense(getattr(self, f"edge_last_{safe}_{layer_i}_{key}"), edge_ll, cd)
                    total = node_pred + torch.sum(edge_pred * cf[:, :, None], dim=1)
                    sums[key] = sums[key] + total if key in sums else total
            results[target] = sums
        return results
