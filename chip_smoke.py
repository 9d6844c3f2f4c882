"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root: ``python3 chip_smoke.py``. It needs a CUDA
device and exits non-zero without one. Phases (any failure propagates):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: the kernels of ``metatrain_tpu_torch/csrc`` with nvcc for
   sm_90a (one nvcc per source, in parallel).
3. fused slice: PET at its defaults (random weights from a seeded
   generator) on the 10,976-atom Cu FCC crystal of ``bench.py``, served in
   bfloat16 by ``Calculator.compute(forces=True, stress=True)`` for a few
   MD-style steps with Verlet reuse. Every launch counter starts at 0 just
   before those calls, and every kernel of the path (K1-K4, the permute
   and the accumulate permute) must have launched in them; the pair
   searches must have run in the native neighbor library. Energy, forces
   and virial must be finite; the bf16 kernel path must match the f32
   plain path (energy rel <= 1 %, force rel-RMSE <= 5 %, or 1.25 x the bf16
   plain path's own error where that is larger) and the f32 kernel path
   the f32 plain path (energy rel <= 1e-5, force rel-RMSE <= 1e-4). Then ms
   per force call and atom-steps/s of the kernel and plain paths in both
   dtypes, and a torch.profiler breakdown of the bf16 kernel path.
4. unfused slice: the same for PET with ``fused_layers: false`` (the
   layout of a v1 checkpoint at the default widths): the window attention
   forward and backward, both permutes and the row-block stages must
   launch; then, with the same gates and no timing, LayerNorm / SiLU /
   PostLN layers with the residual featurizer (2 GNN layers of 1
   attention layer).
5. training: 8 frames of Cu FCC 8^3 * 4 = 2,048 atoms (a = 3.6 A, jitter
   0.1 A, ``default_rng(2)``) labelled with a Lennard-Jones energy and its
   analytic forces, written as extended xyz, then the port's
   ``train_model`` at the PET defaults in float32 (batch 2, 2 epochs,
   validation 0.25, forces weight 10). Every counter starts at 0 just
   before it; K1, K3, K2-dW and K4-dW (all three stages) must launch in it
   and the second-order replays must run; every logged loss must be
   finite; ``model.ckpt`` must reload into a PET that gives the trained
   model's energy.
6. training parity: one step's loss and parameter gradients on 2 frames,
   float32 kernel path vs float32 plain path, for the trained fused model
   and for a random unfused one (whose step must launch the attention and
   permute kernels and replay the attention's backward): loss rel <=
   1e-5, global gradient rel L2 <= 1e-4, each parameter tensor rel L2 <=
   1e-3.
7. training timing: ms per step and atom-steps/s (host clock around
   synchronised steps after a warm-up step) with the peak device memory,
   for the kernel and plain paths on the 2 x 2,048-atom batch and for the
   kernel path on the 10,976-atom crystal as a batch of one.
8. kernel vs plain at the shapes the served calls gave the kernels (the
   calculator's padded atom count A and slot count M, D = 128, 8 heads,
   d_ff = 256; rows = A * M for the row-block stages and the permutes;
   windows of T = M + 1 for the attention), float32 and bfloat16, with
   CUDA-event times of both, the bound (the larger of bytes over 3.35 TB/s
   and operations over 989 TFLOP/s bf16 / 67 f32) and, where one PyTorch
   call computes the same function, its time. float32: max |kernel -
   plain| <= 1e-4 max |plain| (sums are reassociated); bfloat16: relative
   RMS <= 2e-2 (the plain version rounds at the same points, but products
   and sums run in another order). The permutes must equal index_select
   (+ add) bit for bit. The weight gradients of K2-dW and K4-dW sum over
   up to A * M rows: float32 max |kernel - plain| <= 1e-3 max |plain| per
   tensor, bfloat16 relative RMS <= 2e-2; two launches on the same inputs
   must give bitwise-equal weight gradients.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Details also go to
``chiprun_out/chip_smoke.json``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

F32_BOUND, BF16_BOUND, DW_F32_BOUND = 1e-4, 2e-2, 1e-3
STAGE_NAMES = ("compress", "combination", "head")


def fail(message: str):
    raise RuntimeError(message)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean CUDA-event time of ``fn`` after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(kernel_outs, plain_outs, dtype):
    """(max abs error, worst bound ratio) over all outputs; raises when a
    bound is exceeded."""
    max_err, worst = 0.0, 0.0
    for k, p in zip(kernel_outs, plain_outs):
        k, p = k.float(), p.float()
        if not torch.isfinite(k).all():
            fail("kernel output is not finite")
        err = (k - p).abs().max().item()
        max_err = max(max_err, err)
        if dtype == torch.float32:
            ratio = err / (F32_BOUND * max(p.abs().max().item(), 1e-30))
        else:
            rel = ((k - p).pow(2).mean().sqrt() / p.pow(2).mean().sqrt().clamp_min(1e-30)).item()
            ratio = rel / BF16_BOUND
        worst = max(worst, ratio)
    if worst > 1.0:
        fail(f"kernel disagrees with its plain version ({dtype}): {worst:.3g} x the bound")
    return max_err, worst


def compare_dw(kernel_dw, plain_dw, dtype):
    """(max abs error, worst bound ratio) over weight gradients, per tensor;
    raises when a bound is exceeded."""
    max_err, worst = 0.0, 0.0
    for k, p in zip(kernel_dw, plain_dw):
        k, p = k.float(), p.float()
        if not torch.isfinite(k).all():
            fail("weight gradient is not finite")
        err = (k - p).abs().max().item()
        max_err = max(max_err, err)
        if dtype == torch.float32:
            ratio = err / (DW_F32_BOUND * max(p.abs().max().item(), 1e-30))
        else:
            rel = ((k - p).pow(2).mean().sqrt() / p.pow(2).mean().sqrt().clamp_min(1e-30)).item()
            ratio = rel / BF16_BOUND
        worst = max(worst, ratio)
    if worst > 1.0:
        fail(f"weight gradients disagree with the plain version ({dtype}): {worst:.3g} x the bound")
    return max_err, worst


# H100 SXM peaks (NVIDIA data sheet): memory, and dense float32 off the
# tensor cores and bfloat16 on them
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}


def record_bound(entry, tag, nbytes, flops, dtype):
    """The least time the card could take for ``nbytes`` moved and
    ``flops`` done: the larger of the two over their peaks."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_OPS_PER_S[dtype] * 1e3
    entry[f"bound_ms_{tag}"] = max(t_bytes, t_ops)
    entry[f"bound_by_{tag}"] = "bytes" if t_bytes >= t_ops else "operations"


def check_dw(name, tag, dtype, k_fn, p_fn, n_inputs, report):
    """Kernel vs plain of a weight-gradient variant: the input cotangents
    at the usual bounds, the weight gradients at theirs, and two launches
    with bitwise-equal weight gradients."""
    k_out, again, p_out = k_fn(), k_fn(), p_fn()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(k_out[n_inputs:], again[n_inputs:])):
        fail(f"{name}: two launches gave different weight gradients")
    err_in, worst_in = compare(k_out[:n_inputs], p_out[:n_inputs], dtype)
    err_w, worst_w = compare_dw(k_out[n_inputs:], p_out[n_inputs:], dtype)
    entry = report.setdefault(name, {})
    entry[f"max_abs_err_{tag}"] = max(err_in, err_w)
    entry[f"dw_max_abs_err_{tag}"] = err_w
    entry[f"bound_ratio_{tag}"] = max(worst_in, worst_w)
    entry[f"bitwise_repeat_{tag}"] = True
    entry[f"ms_{tag}"] = cuda_ms(k_fn)
    entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)


def layer_case(A, M, D, H, F, gen, device):
    from metatrain_tpu_torch.ops.kernels.fused_layer import LayerWeights

    def lecun(*shape):
        return torch.randn(*shape, generator=gen) / math.sqrt(shape[0])

    w = LayerWeights(
        norm_attn=1 + 0.1 * torch.randn(D, generator=gen), w_qkv=lecun(D, 3 * D),
        b_qkv=0.1 * torch.randn(3 * D, generator=gen), w_out=lecun(D, D),
        b_out=0.1 * torch.randn(D, generator=gen), norm_mlp=1 + 0.1 * torch.randn(D, generator=gen),
        w_in=lecun(D, 2 * F), b_in=0.1 * torch.randn(2 * F, generator=gen),
        w_ffn_out=lecun(F, D), b_ffn_out=0.1 * torch.randn(D, generator=gen),
    )
    edges = torch.randn(A, M, D, generator=gen)
    center = torch.randn(A, D, generator=gen)
    # realistic cutoff weights: a ragged set of real neighbors in (0, 1],
    # zeros in the padded slots, 1 for the center in slot M-1
    n_real = torch.randint(M // 2, M - 1, (A, 1), generator=gen)
    cf = torch.rand(A, M, generator=gen) * (torch.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    g_edge = torch.randn(A, M, D, generator=gen)
    g_center = torch.randn(A, D, generator=gen)
    to = dict(device=device)
    return (edges.to(**to), center.to(**to), cf.to(**to), LayerWeights(*(x.to(**to) for x in w)),
            g_edge.to(**to), g_center.to(**to))


def check_fused_layer(A, M, D, H, F, gen, device, report):
    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    edges, center, cf, w, g_edge, g_center = layer_case(A, M, D, H, F, gen, device)
    scale = 1.0 / math.sqrt(D // H)
    # products per layer: the dense ones over A * M rows and the attention
    dense = A * M * (8 * D * D + 6 * D * F)
    attention = 4 * A * H * M * M * (D // H)
    n_weights = sum(x.numel() for x in w)
    for dtype in (torch.float32, torch.bfloat16):
        s_ = torch.tensor([], dtype=dtype).element_size()
        act = A * M * D * s_ + A * D * s_  # one (edges, center) pair
        for name, nbytes, flops in (
            ("fused_layer_fwd", 2 * act + A * M * 4 + n_weights * s_, dense + attention),
            ("fused_layer_bwd", 4 * act + 2 * A * M * 4 + n_weights * s_, 2 * dense + 3 * attention),
            ("fused_layer_bwd_dw", 4 * act + 2 * A * M * 4 + n_weights * (s_ + 4),
             3 * dense + 3 * attention),
        ):
            entry = report.setdefault(name, {"library_ms": None})
            record_bound(entry, "f32" if dtype == torch.float32 else "bf16", nbytes, flops, dtype)
        e, c, ge, gc = (x.to(dtype) for x in (edges, center, g_edge, g_center))
        fwd_k = fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)
        fwd_p = fl.layer_math(e, c, cf, w, H, scale)
        bwd_k = fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)
        bwd_p = fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)
        torch.cuda.synchronize()
        tag = "f32" if dtype == torch.float32 else "bf16"
        for name, k_out, p_out, k_fn, p_fn in (
            ("fused_layer_fwd", fwd_k, fwd_p,
             lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale),
             lambda: fl.layer_math(e, c, cf, w, H, scale)),
            ("fused_layer_bwd", bwd_k, bwd_p,
             lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale),
             lambda: fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale)),
        ):
            err, worst = compare(k_out, p_out, dtype)
            entry = report.setdefault(name, {})
            entry[f"max_abs_err_{tag}"] = err
            entry[f"bound_ratio_{tag}"] = worst
            entry[f"ms_{tag}"] = cuda_ms(k_fn)
            entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
        del fwd_k, fwd_p, bwd_k, bwd_p
        torch.cuda.empty_cache()
        check_dw(
            "fused_layer_bwd_dw", tag, dtype,
            lambda: (lambda o: (*o[:3], *o[3]))(
                fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, weight_grads=True)),
            lambda: (lambda o: (*o[:3], *o[3]))(
                fl.layer_bwd_math(e, c, cf, w, ge, gc, H, scale, weight_grads=True)),
            3, report,
        )
        torch.cuda.empty_cache()


def stage_cases(rows, D, gen, device):
    """(stage, inputs, weights) at the main path's widths."""
    from metatrain_tpu_torch.models.pet.fused_stages import COMBINATION, COMPRESS, HEAD

    def lecun(i, o):
        return (torch.randn(i, o, generator=gen) / math.sqrt(i)).to(device)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(device)

    def x():
        return torch.randn(rows, D, generator=gen).to(device)

    return [
        (COMPRESS, (x(), x(), x()), (lecun(3 * D, D), vec(D), lecun(D, D), vec(D))),
        (COMPRESS, (x(), x()), (lecun(2 * D, D), vec(D), lecun(D, D), vec(D))),
        (COMBINATION, (x(), x(), x()),
         (vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D), vec(2 * D), lecun(2 * D, D), vec(D))),
        (HEAD, (x(),), (lecun(D, D), vec(D), lecun(D, D), vec(D))),
    ]


def check_rowblock(rows, D, gen, device, report):
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    for stage, inputs, weights in stage_cases(rows, D, gen, device):
        for dtype in (torch.float32, torch.bfloat16):
            xs = tuple(t.to(dtype) for t in inputs)
            g = torch.randn(rows, weights[-1].shape[0], generator=gen).to(device, dtype)
            tag = "f32" if dtype == torch.float32 else "bf16"
            cases = (
                (f"rowblock_fwd[{stage.name}]",
                 lambda: (rb.rowblock_fwd_cuda(stage, xs, weights),),
                 lambda: (stage.math(xs, weights),)),
                (f"rowblock_bwd[{stage.name}]",
                 lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g),
                 lambda: stage.bwd(xs, weights, g)),
            )
            (_, _), (w0, _, w1, _) = rb._split_weights(stage, weights)
            rows_, d_part = xs[0].shape
            s_ = xs[0].element_size()
            flops = 2 * rows_ * (w0.shape[0] * w0.shape[1] + w1.shape[0] * w1.shape[1])
            n_w = sum(x.numel() for x in weights)
            io_in = len(xs) * rows_ * d_part * s_
            io_g = rows_ * w1.shape[1] * s_
            n_grads = rb._n_input_grads(stage, len(xs))
            sizes = {
                f"rowblock_fwd[{stage.name}]": (io_in + io_g + n_w * s_, flops),
                f"rowblock_bwd[{stage.name}]": (
                    io_in + io_g + n_grads * rows_ * d_part * s_ + n_w * s_, 2 * flops),
                f"rowblock_bwd_dw[{stage.name}]": (
                    io_in + io_g + n_grads * rows_ * d_part * s_ + n_w * (s_ + 4), 3 * flops),
            }
            for name, k_fn, p_fn in cases:
                k_out, p_out = k_fn(), p_fn()
                torch.cuda.synchronize()
                err, worst = compare(k_out, p_out, dtype)
                entry = report.setdefault(name, {"library_ms": None})
                # the 3-part compress is the wider case: keep its numbers
                if f"max_abs_err_{tag}" in entry and len(xs) < 3:
                    continue
                record_bound(entry, tag, *sizes[name], dtype)
                entry[f"max_abs_err_{tag}"] = err
                entry[f"bound_ratio_{tag}"] = worst
                entry[f"ms_{tag}"] = cuda_ms(k_fn)
                entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
            # the 2-part compress is checked too; the 3-part one's numbers stay
            dw_report = {} if len(xs) < 3 and stage.name == "compress" else report
            dw_name = f"rowblock_bwd_dw[{stage.name}]"
            record_bound(dw_report.setdefault(dw_name, {"library_ms": None}), tag,
                         *sizes[dw_name], dtype)
            check_dw(
                f"rowblock_bwd_dw[{stage.name}]", tag, dtype,
                lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True),
                lambda: stage.bwd(xs, weights, g, weight_grads=True),
                len(xs), dw_report,
            )


def involution(rows, gen):
    """A random involutive permutation of ``rows`` (pairs, some fixed
    points), as the reversed-edge index is."""
    order = torch.randperm(rows, generator=gen)
    n = (rows // 2) * 9 // 10
    rev = torch.arange(rows)
    rev[order[:n]] = order[n:2 * n]
    rev[order[n:2 * n]] = order[:n]
    return rev


def check_permute(rows, D, gen, device, report):
    """Permute kernels vs index_select (+ add): bitwise equal."""
    from metatrain_tpu_torch.ops.kernels import permute as pk

    rev = involution(rows, gen).to(device)
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        x = torch.randn(rows, D, generator=gen).to(device, dtype)
        acc = torch.randn(rows, D, generator=gen).to(device, dtype)
        s_ = x.element_size()
        for name, k_fn, p_fn, n_rows in (
            ("permute", lambda: pk.permute_cuda(x, rev), lambda: pk.permute_math(x, rev), 2),
            ("permute_acc", lambda: pk.permute_cuda(x, rev, acc),
             lambda: pk.permute_math(x, rev, acc), 3),
        ):
            k_out, p_out = k_fn(), p_fn()
            torch.cuda.synchronize()
            if not torch.equal(k_out, p_out):
                fail(f"{name} ({dtype}) is not bitwise equal to index_select")
            entry = report.setdefault(name, {})
            entry[f"max_abs_err_{tag}"] = (k_out.float() - p_out.float()).abs().max().item()
            entry[f"bitwise_{tag}"] = True
            entry[f"ms_{tag}"] = cuda_ms(k_fn)
            # the plain version is the library call: index_select (+ add)
            entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
            entry[f"library_ms_{tag}"] = entry[f"plain_ms_{tag}"]
            record_bound(entry, tag, n_rows * rows * D * s_ + rows * 8, (n_rows - 2) * rows * D,
                         dtype)
            del k_out, p_out


def attention_case(A, T, D, gen, device):
    """q, k, v, g and a log-cutoff bias [0 | log(clip(cf, 1e-15))] with a
    ragged set of real neighbors, as the unfused layers give them."""
    q, k, v, g = (torch.randn(A, T, D, generator=gen) for _ in range(4))
    n_real = torch.randint((T - 1) // 2, T - 1, (A, 1), generator=gen)
    cf = torch.rand(A, T - 1, generator=gen) * (torch.arange(T - 1)[None] < n_real)
    bias = torch.log(torch.clamp(torch.cat([torch.ones(A, 1), cf], dim=1), min=1e-15))
    return [x.to(device) for x in (q, k, v, g, bias)]


def library_attention(q, k, v, bias, g, H, scale):
    """(forward, backward) callables of F.scaled_dot_product_attention on
    (A, H, T, hd) with the bias as an additive float mask: the yardstick
    ``library_ms``, never on the port's path."""
    import torch.nn.functional as F

    A, T, D = q.shape

    def heads(x):
        return x.view(A, T, H, D // H).transpose(1, 2).detach().requires_grad_(True)

    q4, k4, v4, g4 = heads(q), heads(k), heads(v), heads(g).detach()
    mask = bias.to(q.dtype)[:, None, None, :].detach().requires_grad_(True)

    def fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask, scale=scale)

    out = fwd()
    return fwd, lambda: torch.autograd.grad(out, (q4, k4, v4, mask), g4, retain_graph=True)


def check_attention(A, T, D, H, gen, device, report):
    """Window attention kernels vs their plain versions at the served
    shapes; float32 and bfloat16."""
    from metatrain_tpu_torch.ops.kernels import attention as ak

    q, k, v, g, bias = attention_case(A, T, D, gen, device)
    scale = 1.0 / math.sqrt(D // H)
    matmul = 2 * A * H * T * T * (D // H)  # one of the attention's products
    for dtype in (torch.float32, torch.bfloat16):
        tag = "f32" if dtype == torch.float32 else "bf16"
        qd, kd, vd, gd = (x.to(dtype) for x in (q, k, v, g))
        s_ = qd.element_size()
        window = A * T * D * s_
        cases = (
            ("window_attention_fwd", 4 * window + A * T * 4, 2 * matmul,
             lambda: (ak.window_attention_fwd_cuda(qd, kd, vd, bias, H, scale),),
             lambda: (ak.attention_math(qd, kd, vd, bias, H, scale),)),
            ("window_attention_bwd", 7 * window + 2 * A * T * 4, 5 * matmul,
             lambda: ak.window_attention_bwd_cuda(qd, kd, vd, bias, gd, H, scale),
             lambda: ak.attention_bwd_math(qd, kd, vd, bias, gd, H, scale)),
        )
        lib_fwd, lib_bwd = library_attention(qd, kd, vd, bias, gd, H, scale)
        for (name, nbytes, flops, k_fn, p_fn), lib_fn in zip(cases, (lib_fwd, lib_bwd)):
            k_out, p_out = k_fn(), p_fn()
            torch.cuda.synchronize()
            err, worst = compare(k_out, p_out, dtype)
            del k_out, p_out
            torch.cuda.empty_cache()
            entry = report.setdefault(name, {})
            entry[f"max_abs_err_{tag}"] = err
            entry[f"bound_ratio_{tag}"] = worst
            entry[f"ms_{tag}"] = cuda_ms(k_fn)
            entry[f"plain_ms_{tag}"] = cuda_ms(p_fn)
            entry[f"library_ms_{tag}"] = cuda_ms(lib_fn)
            record_bound(entry, tag, nbytes, flops, dtype)
        del lib_fwd, lib_bwd
        torch.cuda.empty_cache()


def bench_crystal(n_cells: int = 14):
    """The bench system: n_cells^3 * 4 Cu atoms, a = 3.6 A, jitter 0.05."""
    from metatrain_tpu_torch.containers import System

    a = 3.6
    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    rng = np.random.default_rng(0)
    frac = np.concatenate([
        base + np.array([i, j, k])
        for i in range(n_cells) for j in range(n_cells) for k in range(n_cells)
    ])
    cell = np.eye(3) * a * n_cells
    positions = frac / n_cells @ cell + rng.normal(0, 0.05, size=(len(frac), 3))
    return System(positions, np.full(len(frac), 29, dtype=np.int32), cell, np.ones(3, dtype=bool))


UNFUSED = {"fused_layers": False}
# LayerNorm / SiLU / PostLN layers and the residual featurizer; two GNN
# layers of one attention layer each, so the residual message mix (and the
# accumulate permute of its backward) is on the path
UNFUSED_ALT = {"fused_layers": False, "normalization": "LayerNorm", "activation": "SiLU",
               "transformer_type": "PostLN", "featurizer_type": "residual",
               "num_gnn_layers": 2, "num_attention_layers": 1}
FUSED_KERNELS = ["fused_layer_fwd", "fused_layer_bwd", "permute", "permute_acc"] + [
    f"rowblock_{d}[{s}]" for d in ("fwd", "bwd") for s in ("compress", "combination", "head")
]
UNFUSED_KERNELS = ["window_attention_fwd", "window_attention_bwd", "permute", "permute_acc",
                   "rowblock_fwd[compress]", "rowblock_bwd[compress]",
                   "rowblock_fwd[head]", "rowblock_bwd[head]"]


def energy_info():
    from metatrain_tpu_torch.data.target_info import DatasetInfo, get_energy_target_info

    return DatasetInfo("angstrom", [29], {"energy": get_energy_target_info("eV")})


def random_state(hypers):
    """PET weights for ``hypers`` from a seeded generator."""
    from metatrain_tpu_torch.models.pet import PET

    seed_model = PET(hypers, energy_info())
    seed_model.init_weights(torch.Generator().manual_seed(0))
    return seed_model.module.state_dict()


def make_pet(dtype, plain, state, device, hypers=None):
    from metatrain_tpu_torch.models.pet import PET

    model = PET(hypers or {}, energy_info(), compute_dtype=dtype, plain=plain).to(device)
    model.module.load_state_dict(state)
    return model


def rel_errors(res, ref):
    e_rel = abs(res["energy"] - ref["energy"]) / abs(ref["energy"])
    f_rel = float(np.sqrt(np.mean((res["forces"] - ref["forces"]) ** 2))
                  / np.sqrt(np.mean(ref["forces"] ** 2)))
    return e_rel, f_rel


def profile_calls(calc, system, calls=2):
    """Device time per force call by kernel from a ``torch.profiler`` trace
    of ``calls`` calls, the device's busy time and its idle share of the
    host-clock time of the traced calls."""
    from torch.profiler import ProfilerActivity, profile

    calc.compute(system, forces=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            calc.compute(system, forces=True)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / calls * 1e3
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        kernels[evt.key] = (evt.self_cuda_time_total if us is None else us) / 1e3 / calls
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:16]
    return {"wall_ms_per_call": wall, "device_busy_ms_per_call": busy,
            "idle_share": 1.0 - busy / wall, "kernels_ms_per_call": dict(top)}


def check_slice(device, hypers, expected, n_cells=14, steps=3, timing=True):
    """Serve the force call of PET with ``hypers`` (random weights); returns
    its report, with the served batch's (A, M) under ``padded``."""
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.containers import System
    from metatrain_tpu_torch.ops.kernels import _lib

    state = random_state(hypers)
    calcs = {
        "kernel_bf16": Calculator(make_pet(torch.bfloat16, False, state, device, hypers)),
        "kernel_f32": Calculator(make_pet(torch.float32, False, state, device, hypers)),
        "plain_f32": Calculator(make_pet(torch.float32, True, state, device, hypers)),
        "plain_bf16": Calculator(make_pet(torch.bfloat16, True, state, device, hypers)),
    }
    system = bench_crystal(n_cells)
    n = len(system)
    rng = np.random.default_rng(1)
    report = {"hypers": hypers, "atoms": n}

    # the served force calls: every counter starts at 0 here
    calc = calcs["kernel_bf16"]
    _lib.LAUNCHES.clear()
    positions = system.positions.copy()
    for _ in range(steps):
        current = System(positions, system.types, system.cell, system.pbc)
        res = calc.compute(current, forces=True, stress=True)
        for key in ("forces", "stress", "virial"):
            if not np.isfinite(res[key]).all():
                fail(f"{key} not finite")
        if not math.isfinite(res["energy"]) or res["forces"].shape != (n, 3):
            fail("energy not finite or forces of the wrong shape")
        positions = positions + rng.normal(0.0, 0.01, positions.shape)
    torch.cuda.synchronize()
    launches = dict(_lib.LAUNCHES)
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched in the served force calls: {missing}")
    report["launches"] = launches
    report["launches_per_call"] = {k: v / steps for k, v in launches.items()}
    report["padded"] = [calc._last_batch.n_atoms_padded, calc._last_batch.max_neighbors]

    final = System(positions, system.types, system.cell, system.pbc)
    results = {k: c.compute(final, forces=True, stress=True) for k, c in calcs.items()}
    for key, res in results.items():
        if not (math.isfinite(res["energy"]) and np.isfinite(res["forces"]).all()
                and np.isfinite(res["virial"]).all()):
            fail(f"{key}: non-finite output")
    e16, f16 = rel_errors(results["kernel_bf16"], results["plain_f32"])
    e32, f32 = rel_errors(results["kernel_f32"], results["plain_f32"])
    e16_plain, f16_plain = rel_errors(results["plain_bf16"], results["plain_f32"])
    report["parity"] = {
        "bf16_kernel_vs_f32_plain": {"energy_rel": e16, "force_rel_rmse": f16},
        "f32_kernel_vs_f32_plain": {"energy_rel": e32, "force_rel_rmse": f32},
        "bf16_plain_vs_f32_plain": {"energy_rel": e16_plain, "force_rel_rmse": f16_plain},
        "bf16_kernel_vs_bf16_plain": dict(zip(("energy_rel", "force_rel_rmse"), rel_errors(
            results["kernel_bf16"], results["plain_bf16"]))),
        "energy_plain_f32": results["plain_f32"]["energy"],
    }
    # bfloat16: within 1 % (energy) and 5 % (forces) of the float32 plain
    # path, or, where the plain path in bfloat16 is itself further off
    # (the model's own bfloat16 rounding), within 1.25 x its error
    if not (e16 <= max(1e-2, 1.25 * e16_plain) and f16 <= max(5e-2, 1.25 * f16_plain)):
        fail(f"bf16 kernel path vs f32 plain: energy {e16:.3g}, forces {f16:.3g} "
             f"(bf16 plain path: {e16_plain:.3g}, {f16_plain:.3g})")
    if not (e32 <= 1e-5 and f32 <= 1e-4):
        fail(f"f32 kernel path vs f32 plain: energy {e32:.3g}, forces {f32:.3g}")
    if not timing:
        return report

    # host clock around synchronised calls, each path warmed up; two
    # rounds in opposite orders so that no path always runs first
    samples = {key: [] for key in calcs}
    for order in (list(calcs), list(calcs)[::-1]):
        for key in order:
            calcs[key].compute(final, forces=True, stress=False)
            torch.cuda.synchronize()
            reps = 5
            t0 = time.perf_counter()
            for _ in range(reps):
                calcs[key].compute(final, forces=True, stress=False)
            torch.cuda.synchronize()
            samples[key].append((time.perf_counter() - t0) / reps * 1e3)
    report["timing"] = {
        key: {"ms_per_force_call": float(np.mean(ms)), "rounds_ms": ms,
              "atom_steps_per_s": n / (float(np.mean(ms)) * 1e-3)}
        for key, ms in samples.items()
    }
    report["profile_kernel_bf16"] = profile_calls(calcs["kernel_bf16"], final)
    return report


def fcc_frame(n_cells, rng, jitter):
    """n_cells^3 * 4 Cu atoms, a = 3.6 A, Gaussian jitter of ``jitter`` A."""
    from metatrain_tpu_torch.containers import System

    base = np.array([[0, 0, 0], [0.5, 0.5, 0], [0.5, 0, 0.5], [0, 0.5, 0.5]])
    frac = np.concatenate([
        base + np.array([i, j, k])
        for i in range(n_cells) for j in range(n_cells) for k in range(n_cells)
    ])
    cell = np.eye(3) * 3.6 * n_cells
    positions = frac / n_cells @ cell + rng.normal(0, jitter, size=(len(frac), 3))
    return System(positions, np.full(len(frac), 29, dtype=np.int32), cell, np.ones(3, dtype=bool))


def lennard_jones(system, epsilon=0.4093, sigma=2.338, cutoff=4.5):
    """Cu Lennard-Jones (Halicioglu & Pound 1975) energy and analytic forces."""
    from metatrain_tpu_torch.ops.neighbors import neighbor_pairs

    c, n, s = neighbor_pairs(system.positions, system.cell, system.pbc, cutoff)
    r_vec = system.positions[n] - system.positions[c] + s @ system.cell
    r = np.linalg.norm(r_vec, axis=1)
    x6 = (sigma / r) ** 6
    de_dr = 4 * epsilon * (-12 * x6**2 + 6 * x6) / r
    forces = np.zeros_like(system.positions)
    np.add.at(forces, c, de_dr[:, None] * r_vec / r[:, None])
    np.add.at(forces, n, -de_dr[:, None] * r_vec / r[:, None])
    return float((4 * epsilon * (x6**2 - x6)).sum()), forces


def write_labelled(path, frames):
    from metatrain_tpu_torch.data.readers.extxyz import write_xyz

    labels = [lennard_jones(f) for f in frames]
    write_xyz(str(path), frames, per_atom_arrays=[{"forces": f} for _, f in labels],
              info=[{"energy": e} for e, _ in labels])


TRAIN_LOSS = {"energy": {"type": "mse", "weight": 1.0,
                         "gradients": {"positions": {"weight": 10.0}}}}


def dataset_section(path):
    return {"systems": {"read_from": str(path), "length_unit": "angstrom"},
            "targets": {"energy": {"key": "energy", "unit": "eV", "forces": "on"}}}


def check_training(device, report, workdir):
    """``train_model`` at the PET defaults in float32; returns the trained
    model."""
    import csv

    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.cli.train import train_model
    from metatrain_tpu_torch.interop.jax_params import pet_from_checkpoint
    from metatrain_tpu_torch.ops.kernels import _lib

    rng = np.random.default_rng(2)
    frames = [fcc_frame(8, rng, 0.1) for _ in range(8)]
    path = workdir / "cu_lj.xyz"
    write_labelled(path, frames)
    options = {
        "seed": 0, "base_precision": 32, "device": "cuda",
        "architecture": {"name": "pet", "training": {
            "batch_size": 2, "num_epochs": 2, "loss": TRAIN_LOSS}},
        "training_set": dataset_section(path),
        "validation_set": 0.25, "test_set": 0.0,
    }
    # the training run: every counter starts at 0 here
    _lib.LAUNCHES.clear()
    _lib.REPLAYS.clear()
    t0 = time.perf_counter()
    model, _ = train_model(options, output_dir=str(workdir), checkpoint_dir=str(workdir))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, replays = dict(_lib.LAUNCHES), dict(_lib.REPLAYS)
    expected = ["fused_layer_fwd", "fused_layer_bwd_dw"] + [
        f"rowblock_{d}[{s}]" for d in ("fwd", "bwd_dw") for s in STAGE_NAMES
    ]
    missing = [k for k in expected if launches.get(k, 0) == 0]
    if missing:
        fail(f"kernels not launched in the training run: {missing}")
    no_replay = [k for k in ["fused_layer"] + [f"rowblock[{s}]" for s in STAGE_NAMES]
                 if replays.get(k, 0) == 0]
    if no_replay:
        fail(f"second-order replays not run in the training run: {no_replay}")

    with open(workdir / "train.csv") as f:
        rows = list(csv.DictReader(f))
    losses = [float(r[k]) for r in rows for k in ("train loss", "val loss")]
    if len(rows) != 2 or not all(math.isfinite(x) for x in losses):
        fail(f"training logged {len(rows)} epochs with losses {losses}")

    reloaded = pet_from_checkpoint(workdir / "model.ckpt", compute_dtype=torch.float32,
                                   device=device)
    e_trained = Calculator(model).compute(frames[0], forces=False)["energy"]
    e_reloaded = Calculator(reloaded).compute(frames[0], forces=False)["energy"]
    if not abs(e_reloaded - e_trained) <= 1e-6 * abs(e_trained):
        fail(f"model.ckpt reloads to energy {e_reloaded}, the trained model gives {e_trained}")
    report["train_launches"] = launches
    report["train_replays"] = replays
    report["training"] = {"seconds": seconds, "atoms_per_frame": len(frames[0]),
                          "epochs": rows, "energy_trained": e_trained,
                          "energy_reloaded": e_reloaded}
    return model


def training_setup(path, state, plain, device, samples, hypers=None):
    """A PET in float32 (kernel or plain path) with ``state``, its
    parameters, loss function and one collated batch of ``samples``."""
    from metatrain_tpu_torch.data.collate import CollateFn
    from metatrain_tpu_torch.data.dataset import get_dataset, get_dataset_info
    from metatrain_tpu_torch.engine.loss import LossAggregator
    from metatrain_tpu_torch.engine.trainer import _compute_loss_and_errors
    from metatrain_tpu_torch.models.pet import PET
    from metatrain_tpu_torch.utils.config import expand_dataset_config

    dataset, infos = get_dataset(expand_dataset_config(dataset_section(path)))
    info = get_dataset_info([dataset], infos, "angstrom")
    model = PET(hypers or {}, info, compute_dtype=torch.float32, plain=plain).to(device)
    model.module.load_state_dict(state)
    batch = CollateFn(model.cutoff, infos, dtype=torch.float32, device=device)(
        [dataset[i] for i in samples])
    loss_agg = LossAggregator(infos, TRAIN_LOSS)
    scales = {"energy": [torch.ones(1, device=device)]}

    def loss_and_errors(b, is_training):
        return _compute_loss_and_errors(model, loss_agg, infos, [], scales, b, is_training)

    params = [p for p in model.parameters() if p.requires_grad]
    n_atoms = int(batch.systems.atom_mask.sum())
    return model, params, loss_and_errors, batch, n_atoms


def check_training_parity(path, state, device, hypers=None, expected=(), replayed=()):
    """One step's loss and gradients: float32 kernel path vs plain path.
    Every counter starts at 0 before the kernel path's step; the kernels
    ``expected`` must launch in it and the ops ``replayed`` must run their
    second-order replay."""
    from metatrain_tpu_torch.ops.kernels import _lib

    results, report = {}, {}
    for key, plain in (("kernel", False), ("plain", True)):
        model, params, loss_fn, batch, _ = training_setup(path, state, plain, device, [0, 1],
                                                          hypers)
        if not plain:
            _lib.LAUNCHES.clear()
            _lib.REPLAYS.clear()
        loss, _ = loss_fn(batch, True)
        grads = torch.autograd.grad(loss, params)
        if not plain:
            torch.cuda.synchronize()
            report["launches"], report["replays"] = dict(_lib.LAUNCHES), dict(_lib.REPLAYS)
            missing = [k for k in expected if _lib.LAUNCHES.get(k, 0) == 0]
            missing += [f"replay {k}" for k in replayed if _lib.REPLAYS.get(k, 0) == 0]
            if missing:
                fail(f"not run in the training step: {missing}")
        results[key] = (loss.detach(), [g.detach() for g in grads],
                        [n for n, p in model.named_parameters() if p.requires_grad])
        del model, params, batch
        torch.cuda.empty_cache()
    (lk, gk, names), (lp, gp, _) = results["kernel"], results["plain"]
    loss_rel = abs(lk.item() - lp.item()) / abs(lp.item())
    flat_k, flat_p = torch.cat([g.flatten() for g in gk]), torch.cat([g.flatten() for g in gp])
    global_rel = ((flat_k - flat_p).norm() / flat_p.norm()).item()
    per_tensor = {}
    for name, a, b in zip(names, gk, gp):
        ref = b.norm().item()
        # a tensor the loss does not reach has a zero gradient on both paths
        per_tensor[name] = (a - b).norm().item() / ref if ref > 0 else (a - b).norm().item()
    worst_name = max(per_tensor, key=per_tensor.get)
    report.update({"loss_kernel": lk.item(), "loss_plain": lp.item(),
                   "loss_rel": loss_rel, "grad_global_rel_l2": global_rel,
                   "grad_worst_tensor": worst_name,
                   "grad_worst_tensor_rel_l2": per_tensor[worst_name]})
    if not (loss_rel <= 1e-5 and global_rel <= 1e-4 and per_tensor[worst_name] <= 1e-3):
        fail(f"training step, f32 kernel vs plain: {report}")
    return report


def time_training(workdir, state, device, report, steps=3):
    """ms per training step, atom-steps/s and peak device memory."""
    from metatrain_tpu_torch.engine.trainer import make_optimizer, train_step

    bench_path = workdir / "bench_lj.xyz"
    write_labelled(bench_path, [bench_crystal()])
    timing = {}
    for key, path, plain, samples in (
        ("kernel_f32_2x2048", workdir / "cu_lj.xyz", False, [0, 1]),
        ("plain_f32_2x2048", workdir / "cu_lj.xyz", True, [0, 1]),
        ("kernel_f32_10976", bench_path, False, [0]),
    ):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        model, params, loss_fn, batch, n_atoms = training_setup(path, state, plain, device, samples)
        optimizer = make_optimizer(params, None)
        train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            loss, _ = train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / steps * 1e3
        if not math.isfinite(loss.item()):
            fail(f"{key}: training loss not finite")
        timing[key] = {"ms_per_step": ms, "atoms": n_atoms,
                       "atom_steps_per_s": n_atoms / (ms * 1e-3),
                       "max_memory_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9}
        del model, params, optimizer, batch, loss
    torch.cuda.empty_cache()
    report["training_timing"] = timing


SOURCES = {
    "fused_layer_fwd": ("metatrain_tpu_torch/csrc/fused_layer_fwd.cu",
                        "metatrain_tpu/ops/pallas/fused_layer.py:1161"),
    "fused_layer_bwd": ("metatrain_tpu_torch/csrc/fused_layer_bwd.cu",
                        "metatrain_tpu/ops/pallas/fused_layer.py:1269"),
    "rowblock_fwd": ("metatrain_tpu_torch/csrc/rowblock_fwd.cu",
                     "metatrain_tpu/ops/pallas/rowblock.py:113"),
    "rowblock_bwd": ("metatrain_tpu_torch/csrc/rowblock_bwd.cu",
                     "metatrain_tpu/ops/pallas/rowblock.py:279"),
    "fused_layer_bwd_dw": ("metatrain_tpu_torch/csrc/fused_layer_bwd.cu",
                           "metatrain_tpu/ops/pallas/fused_layer.py:1269 (weight_grads=True)"),
    "rowblock_bwd_dw": ("metatrain_tpu_torch/csrc/rowblock_bwd.cu",
                        "metatrain_tpu/ops/pallas/rowblock.py:279 (weight_grads=True)"),
    "permute": ("metatrain_tpu_torch/csrc/permute.cu",
                "metatrain_tpu/ops/pallas/color_gather.py:834 and :635"),
    "permute_acc": ("metatrain_tpu_torch/csrc/permute.cu",
                    "metatrain_tpu/ops/pallas/color_gather.py:834 and :635 (acc)"),
    "window_attention_fwd": ("metatrain_tpu_torch/csrc/window_attention_fwd.cu",
                             "metatrain_tpu/ops/pallas/attention.py:412"),
    "window_attention_bwd": ("metatrain_tpu_torch/csrc/window_attention_bwd.cu",
                             "metatrain_tpu/ops/pallas/attention.py:500"),
}
UNFUSED_PATH = ("permute", "permute_acc", "window_attention_fwd", "window_attention_bwd")


def check_neighbor_backend(report):
    """The served calls' pair searches ran in the native cell list."""
    from metatrain_tpu_torch.ops import neighbors

    backends = dict(neighbors.BACKENDS)
    report["neighbor_backends"] = backends
    if neighbors._native_library() is None or backends.get("kdtree", 0) or not backends.get("native"):
        fail(f"the native neighbor library did not build the lists: {backends}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from metatrain_tpu_torch.models.pet import DEFAULT_MODEL_HYPERS
    from metatrain_tpu_torch.ops import neighbors
    from metatrain_tpu_torch.ops.kernels import _lib

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    _lib.library()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.1f} s", flush=True)

    report = {"card": card, "build_s": build_s}
    neighbors.BACKENDS.clear()
    report["slice"] = check_slice(device, {}, FUSED_KERNELS)
    check_neighbor_backend(report)
    A, M = report["slice"]["padded"]
    print("slice:", json.dumps({k: report["slice"][k] for k in ("padded", "launches", "parity")}
                               | {"neighbor_backends": report["neighbor_backends"]}), flush=True)
    print(f"force call ({card}):", json.dumps(report["slice"]["timing"]), flush=True)
    print("force call profile:", json.dumps(report["slice"]["profile_kernel_bf16"]), flush=True)
    torch.cuda.empty_cache()

    for key, hypers, kwargs in (("unfused", UNFUSED, {}),
                                ("unfused_alt", UNFUSED_ALT, {"steps": 2, "timing": False})):
        report[key] = check_slice(device, hypers, UNFUSED_KERNELS, **kwargs)
        print(f"{key} slice:", json.dumps({k: report[key][k] for k in ("padded", "launches",
                                                                        "parity")}), flush=True)
        torch.cuda.empty_cache()
    print(f"unfused force call ({card}):", json.dumps(report["unfused"]["timing"]), flush=True)
    print("unfused force call profile:", json.dumps(report["unfused"]["profile_kernel_bf16"]),
          flush=True)
    A_u, M_u = report["unfused"]["padded"]

    with tempfile.TemporaryDirectory() as tmp:
        workdir = Path(tmp)
        trained = check_training(device, report, workdir)
        state = {k: v.detach().clone() for k, v in trained.module.state_dict().items()}
        del trained
        print("training:", json.dumps({k: report[k] for k in ("train_launches", "train_replays")}
                                      | {"seconds": report["training"]["seconds"]}), flush=True)
        report["training_parity"] = check_training_parity(workdir / "cu_lj.xyz", state, device)
        print("training parity:", json.dumps(report["training_parity"]), flush=True)
        report["training_parity_unfused"] = check_training_parity(
            workdir / "cu_lj.xyz", random_state(UNFUSED), device, UNFUSED,
            expected=("window_attention_fwd", "window_attention_bwd", "permute", "permute_acc"),
            replayed=("window_attention",))
        print("training parity, unfused:", json.dumps(report["training_parity_unfused"]),
              flush=True)
        torch.cuda.empty_cache()
        time_training(workdir, state, device, report)
        print(f"training step ({card}):", json.dumps(report["training_timing"]), flush=True)

    hp = DEFAULT_MODEL_HYPERS
    D, H, F = hp["d_pet"], hp["num_heads"], hp["d_feedforward"]
    gen = torch.Generator().manual_seed(0)
    kernels: dict = {}
    check_fused_layer(A, M, D, H, F, gen, device, kernels)
    check_rowblock(A * M, D, gen, device, kernels)
    check_permute(A_u * M_u, D, gen, device, kernels)
    check_attention(A_u, M_u + 1, D, H, gen, device, kernels)
    report["kernels"] = kernels
    print(f"kernel vs plain ({card}):", json.dumps(kernels), flush=True)

    out_dir = Path("chiprun_out")
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    # the served paths run in bfloat16 and the training path in float32:
    # each entry leads with the errors and times of its path's dtype, and
    # its launches are those of its path's run (the unfused force calls for
    # the kernels that path added)
    entries = []
    for name, entry in kernels.items():
        source, replaces = SOURCES[name.split("[")[0]]
        trains = "_dw" in name
        lead, other = ("f32", "bf16") if trains else ("bf16", "f32")
        path = ("train_launches" if trains else
                "unfused" if name in UNFUSED_PATH else "slice")
        launches = (report[path] if trains else report[path]["launches"])[name]
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": launches, "dtype": "float32" if trains else "bfloat16"}
        for tag, suffix in ((lead, ""), (other, f"_{other}")):
            out[f"max_abs_err{suffix}"] = entry[f"max_abs_err_{tag}"]
            out[f"ms{suffix}"] = entry[f"ms_{tag}"]
            out[f"plain_ms{suffix}"] = entry[f"plain_ms_{tag}"]
            out[f"bound_ms{suffix}"] = entry[f"bound_ms_{tag}"]
            out[f"bound_by{suffix}"] = entry[f"bound_by_{tag}"]
            out[f"library_ms{suffix}"] = entry.get(f"library_ms_{tag}", entry.get("library_ms"))
        entries.append(out)
    if len(entries) != 16:
        fail(f"expected 16 kernel entries, got {sorted(kernels)}")
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
