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
- the feedforward and residual featurizers, and the heads;
- system conditioning (``SystemConditioningEmbedding``, added to the node
  stream after every GNN layer) and the long-range featurizer
  (``engine/long_range.py``, mixed into every readout's node features).

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
    int8_scales_for,
    int8_scores_applicable,
    layer_math,
    layer_probe_stats,
    rmsnorm_eps,
    w8a8_applicable,
    w8a8_transformer_layer,
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
    ``named_parameters`` order: Dense kernels lecun_normal (zeros for a
    Linear marked ``zero_init``, flax's ``kernel_init=zeros``), biases
    zeros, norm scales ones, embeddings normal with variance 1 / features."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            owner_name, _, leaf = name.rpartition(".")
            owner = module.get_submodule(owner_name)
            if getattr(owner, "zero_init", False):
                p.zero_()
            elif isinstance(owner, nn.Embedding):
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
    """C-infinity bump switching function. ``cutoff`` is a number or a
    tensor that broadcasts against ``values`` (per-pair adaptive cutoffs)."""
    scaled = (values - (cutoff - width)) / width
    clamped = torch.clamp(scaled, 1e-6, 1.0 - 1e-6)
    return 0.5 * (1.0 + torch.tanh(1.0 / torch.tan(math.pi * clamped)))


def cutoff_func_cosine(values, cutoff, width):
    """Cosine switching function; ``cutoff`` as in :func:`cutoff_func_bump`."""
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
    contraction/expansion, center MLP) is plain PyTorch.

    With ``int8_static`` (set by ``PET(..., int8_static=True)``) and
    ``int8_calib`` (an ``Int8Calib``, set by ``PET.calibrate_int8`` or
    ``interop.jax_params.int8_calib_from_jax``; neither is a parameter nor
    saved, as the JAX package's registry), a bfloat16 call with no weight
    that requires grad runs the static W8A8 layer (K1-W8A8/K2-W8A8 on the
    card) under the JAX package's gate; without a calibration it raises.
    While ``int8_probe`` is a list, the layer runs exact and appends its
    ``layer_probe_stats`` to it.

    With ``int8_scores`` (set by ``PET(..., int8_scores=True)``), a
    bfloat16 call in the q-side layout that W8A8 does not take runs the
    dynamic int8 scores (the absmax pass, K1-int8 and K2-int8 / K2-dW-int8
    on the card; with ``plain``, ``layer_math`` with the plain scales under
    autograd), in inference and in training; the calibration probe runs
    exact."""

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
        self.int8_static = False
        self.int8_calib = None
        self.int8_probe = None
        self.int8_scores = False
        self.path = ""  # the module's name in PET, for messages

    def layer_weights(self) -> LayerWeights:
        return LayerWeights(*(getattr(self, f) for f in LayerWeights._fields))

    def _int8_calib(self, dtype, w: LayerWeights):
        """The calibration the W8A8 path takes, or None for the exact
        layer; raises where the JAX package's ``MTT_INT8_STATIC=1`` raises."""
        if not (self.int8_static and self.int8_probe is None and dtype == torch.bfloat16
                and not any(x.requires_grad for x in w)):
            return None
        if self.int8_calib is None:
            raise RuntimeError(
                f"int8_static=True but no int8 calibration is registered for layer "
                f"{self.path!r}; run PET.calibrate_int8 on a representative batch first"
            )
        return self.int8_calib

    def gnn_weights(self):
        """``(LayerWeights, CenterWeights or None)``: this layer's weights
        for the fused GNN block, in the (in, out) layout."""
        lw = self.layer_weights()
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
        w = self.layer_weights()
        args = (edges.to(cd), center.to(cd), cf_tokens, w, self.num_heads, self.scale)
        if self.int8_probe is not None:
            self.int8_probe.append(layer_probe_stats(*args))
        calib = self._int8_calib(cd, w)
        if w8a8_applicable(args[0], w, self.num_heads, calib):
            edge_out, center_attn = w8a8_transformer_layer(*args, calib, self.plain)
        elif (self.int8_scores and self.int8_probe is None
              and int8_scores_applicable(args[0], self.num_heads)):
            if self.plain:
                scales = int8_scales_for(args[0], args[1], w, self.num_heads, plain=True)
                edge_out, center_attn = layer_math(*args, int8_scales=scales)
            else:
                edge_out, center_attn = fused_transformer_layer(*args, int8_scores=True)
        else:
            layer = layer_math if self.plain else fused_transformer_layer
            edge_out, center_attn = layer(*args)
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
        """``bd["conditioning"]`` (A, d_node), where present, is added to the
        node features after every GNN layer."""
        cd = self.dtype
        conditioning = bd.get("conditioning")
        nbr_species = bd["neighbor_species_index"]
        input_messages = embed(self.edge_species_embedder, nbr_species, cd)
        common = (nbr_species, bd["edge_vectors"], bd["edge_distances"],
                  bd["nbr_mask"], bd["cutoff_factors"])
        if not self.feedforward:
            node_features, edge_features = [], []
            for i in range(self.num_gnn):
                node = embed(getattr(self, f"node_embedder_{i}"), bd["species_index"], cd)
                node, out_edges = getattr(self, f"gnn_layer_{i}")(node, input_messages, *common)
                if conditioning is not None:
                    node = node + conditioning
                node_features.append(node)
                out_edges, reversed_edges = reverse_edges(out_edges, bd["nbr_reverse"], self.plain)
                edge_features.append(out_edges)
                input_messages = 0.5 * (input_messages + reversed_edges)
            return node_features, edge_features

        node = embed(self.node_embedder_0, bd["species_index"], cd)
        for i in range(self.num_gnn):
            node, out_edges = getattr(self, f"gnn_layer_{i}")(node, input_messages, *common)
            if conditioning is not None:
                node = node + conditioning
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


class SystemConditioningEmbedding(nn.Module):
    """Charge and spin-multiplicity conditioning, broadcast to the atoms:
    per-system embeddings of the integer charge (clipped to [-max_charge,
    max_charge]) and spin multiplicity (clipped to [1, max_spin]), summed,
    SiLU, and a zero-initialised ``gate``, so that a model is unchanged by
    it at initialisation. The broadcast to atoms is a one-hot product."""

    def __init__(self, d_out: int, max_charge: int = 10, max_spin_multiplicity: int = 10):
        super().__init__()
        self.max_charge, self.max_spin = int(max_charge), int(max_spin_multiplicity)
        self.charge_embedding = nn.Embedding(2 * self.max_charge + 1, d_out)
        self.spin_embedding = nn.Embedding(self.max_spin, d_out)
        self.gate = nn.Linear(d_out, d_out)
        self.gate.zero_init = True

    def forward(self, charge, spin_multiplicity, system_index, dtype):
        charge_idx = torch.clamp(charge.to(torch.int32) + self.max_charge, 0, 2 * self.max_charge)
        spin_idx = torch.clamp(spin_multiplicity.to(torch.int32) - 1, 0, self.max_spin - 1)
        combined = F.silu(embed(self.charge_embedding, charge_idx.long(), dtype)
                          + embed(self.spin_embedding, spin_idx.long(), dtype))
        gated = dense(self.gate, combined, dtype)  # (S, d_out)
        return F.one_hot(system_index, gated.shape[0]).to(dtype) @ gated


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
    readout layer of the backbone; with ``system_conditioning``, the
    conditioning embedding; with ``long_range.enable``, the long-range
    featurizer on the last node features, every readout's node features
    becoming ``(nf + lr) / sqrt(2)``.

    ``output_shapes``: target name -> {block key string -> flat size}.
    Returns, per requested target, the per-atom prediction of each block
    (A, size): node predictions plus cutoff-weighted sums of edge
    predictions; under ``_ll_features::<target>`` its heads' outputs (the
    node and the edge head's, one of each per readout layer), and under
    ``_node_features``/``_edge_features`` the backbone's readout features.
    """

    def __init__(self, hp: Dict[str, Any], num_species: int,
                 output_shapes: Dict[str, Dict[str, int]], dtype, plain: bool = False,
                 fused_gnn: bool = False):
        super().__init__()
        self.dtype, self.plain = dtype, plain
        self.output_shapes = output_shapes
        self.system_conditioning = None
        if hp.get("system_conditioning"):
            self.system_conditioning = SystemConditioningEmbedding(
                hp["d_node"], hp.get("max_charge", 10), hp.get("max_spin_multiplicity", 10))
        self.backbone = PETBackbone(hp, num_species, dtype, plain, fused_gnn)
        self.long_range = None
        lr = hp.get("long_range") or {}
        if lr.get("enable"):
            from ...engine.long_range import LongRangeFeaturizer

            self.long_range = LongRangeFeaturizer(
                hp["d_node"], hp["d_node"], dtype, float(hp["cutoff"]),
                smearing=float(lr.get("smearing", 1.4)),
                n_kmax=int(lr.get("n_kmax", 4)), method=str(lr.get("method", "ewald")),
                mesh=int(lr.get("mesh", 32)))
        d_head = hp["d_head"]
        readouts = 1 if hp["featurizer_type"] == "feedforward" else hp["num_gnn_layers"]
        self.last_layer_feature_size = 2 * d_head * readouts
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
        if self.system_conditioning is not None:
            bd = dict(bd, conditioning=self.system_conditioning(
                bd["charge"], bd["spin_multiplicity"], bd["system_index"], cd))
        node_features, edge_features = self.backbone(bd)
        if self.long_range is not None:
            lr_features = self.long_range(node_features[-1], bd)
            node_features = [(nf + lr_features) * (0.5**0.5) for nf in node_features]
        cf = torch.where(bd["nbr_mask"], bd["cutoff_factors"], 0.0)
        results: Dict[str, Any] = {"_node_features": node_features,
                                   "_edge_features": edge_features}
        for target, shapes in self.output_shapes.items():
            if target not in requested:
                continue
            safe = target.replace(":", "_")
            sums: Dict[str, torch.Tensor] = {}
            node_lls, edge_lls = [], []
            for layer_i, (nf, ef) in enumerate(zip(node_features, edge_features)):
                node_ll = getattr(self, f"node_head_{safe}_{layer_i}")(nf, cd)
                edge_head = getattr(self, f"edge_head_{safe}_{layer_i}")
                A, M, D = ef.shape
                edge_ll = run_stage(
                    HEAD, (ef.to(cd).reshape(A * M, D),), edge_head.stage_weights(), self.plain
                ).reshape(A, M, -1)
                node_lls.append(node_ll)
                edge_lls.append(edge_ll)
                for key in shapes:
                    node_pred = dense(getattr(self, f"node_last_{safe}_{layer_i}_{key}"), node_ll, cd)
                    edge_pred = dense(getattr(self, f"edge_last_{safe}_{layer_i}_{key}"), edge_ll, cd)
                    total = node_pred + torch.sum(edge_pred * cf[:, :, None], dim=1)
                    sums[key] = sums[key] + total if key in sums else total
            results[target] = sums
            results[f"_ll_features::{target}"] = (node_lls, edge_lls)
        return results
