"""CUDA-event times of the fused-layer kernels K1, K2 and K2-dW at one shape,
of K3's and K4's bf16 compress, combination and head at A x M rows, and of
the float32 compress and combination's K3, K4 and K4-dW there.

Usage, on a machine with a CUDA device::

    python metatrain_tpu_torch/tools/layer_times.py [--root DIR] [--A 11392] [--M 64]
        [--D 128] [--H 8] [--F 256] [--reps 10]

``--root`` is the checkout whose ``metatrain_tpu_torch`` is timed (the
current directory by default), so that two trees can be compared on one
card: run the script once per tree, in the order A, B, B, A. Inputs are
made from a seeded generator, as ``chip_smoke.py``'s kernel checks make
them. Prints one JSON line: the card (``nvidia-smi`` name and power limit),
the shape and, per kernel and dtype, the mean ms over ``--reps`` launches
after one warm-up launch. Where the tree has the Hopper K2
(``fused_layer_bwd_cuda(..., sm90=)``), ``fused_layer_bwd_ms_bf16`` is
its time at shapes it takes and ``fused_layer_bwd_general_ms_bf16`` the
general body's; likewise ``fused_layer_fwd_ms_bf16`` and
``fused_layer_fwd_general_ms_bf16`` where it has the Hopper K1, and
``fused_layer_fwd_ms_f32`` and ``fused_layer_fwd_general_ms_f32`` where it
has the Hopper float32 K1 (``_lib.k1_f32_sm90_takes``; the general body's
digest then under ``fused_layer_fwd_general_f32``, which a tree without it
gives under ``fused_layer_fwd_f32``). In bfloat16, also the dynamic int8
scores' absmax passes where the tree has the Hopper one
(``int8_absmax_sm90_ms_bf16`` beside the general ``int8_absmax_ms_bf16``),
K1-int8 and K2-int8 (``fused_layer_{fwd,bwd}_int8_ms_bf16``: the Hopper K1
and K2's int8-score mode where the tree has it, the general bodies
before) on the scales of the call's own pass (the Hopper pass's where the
tree has it, else the general pass's; on the general pass's also as
``fused_layer_{fwd,bwd}_int8_on_general_scales``, comparable with a tree
whose Hopper pair took those) and their general bodies (``sm90=False``,
``fused_layer_{fwd,bwd}_int8_general_ms_bf16``) on the general pass's;
and the static W8A8 layer's K1-W8A8 and K2-W8A8 on a calibration from the
plain probe (``fused_layer_{fwd,bwd}_w8a8_ms_bf16``: the Hopper K1 and K2's
W8A8 mode where the tree has it, the general bodies before) and their
general bodies (``fused_layer_{fwd,bwd}_w8a8_general_ms_bf16``).
Then K4
(``rowblock_bwd_cuda``) in bfloat16 at A x M rows for the 3-part and the
2-part compress, the combination and the head
(``rowblock_bwd[<stage>]_ms_bf16``:
the Hopper K4 where the tree has it, ``rowblock_bwd_cuda(..., sm90=)``;
``..._general_ms_bf16`` its general body there), then K3
(``rowblock_fwd_cuda``) on the same inputs (``rowblock_fwd[<stage>]_ms_bf16``:
the Hopper K3 where the tree has it, ``rowblock_fwd_cuda(..., sm90=)``;
``..._general_ms_bf16`` its general body there). Then the float32
3-part and 2-part compress and the combination at A x M rows: K4
(``rowblock_bwd[<stage>]_ms_f32``: the Hopper float32 K4 where the tree has
it), K4-dW (``rowblock_bwd_dw[<stage>]_ms_f32``, the two-pass K4-dW there)
and K3 (``rowblock_fwd[<stage>]_ms_f32``: the Hopper float32 K3 where the
tree has it, ``_lib.k3_f32_sm90_takes``; ``..._general_ms_f32`` its general
body there). Then the float32 head at A x M rows, last: K4, K4-dW and K3
(``rowblock_{bwd,bwd_dw,fwd}[head]_ms_f32``: the Hopper float32 head where
the tree has it) and their general bodies (``sm90=False``,
``..._general[head]_ms_f32``). Under ``digests``, a SHA-256 prefix of
each output's bytes per kernel and dtype, from the first launch: two
trees whose digests agree computed the same bits.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import math
import subprocess
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".")
    for name, default in (("A", 11392), ("M", 64), ("D", 128), ("H", 8), ("F", 256),
                          ("reps", 10)):
        parser.add_argument(f"--{name}", type=int, default=default)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import torch

    from metatrain_tpu_torch.ops.kernels import fused_layer as fl

    if not torch.cuda.is_available():
        print("layer_times: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    A, M, D, H, F = args.A, args.M, args.D, args.H, args.F
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)

    def lecun(*shape):
        return torch.randn(*shape, generator=gen) / math.sqrt(shape[0])

    w = fl.LayerWeights(
        1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 3 * D),
        0.1 * torch.randn(3 * D, generator=gen), lecun(D, D), 0.1 * torch.randn(D, generator=gen),
        1 + 0.1 * torch.randn(D, generator=gen), lecun(D, 2 * F),
        0.1 * torch.randn(2 * F, generator=gen), lecun(F, D), 0.1 * torch.randn(D, generator=gen))
    w = fl.LayerWeights(*(x.to(dev) for x in w))
    n_real = torch.randint(M // 2, M - 1, (A, 1), generator=gen)
    cf = torch.rand(A, M, generator=gen) * (torch.arange(M)[None] < n_real)
    cf[:, M - 1] = 1.0
    cf = cf.to(dev)
    tensors = [torch.randn(A, M, D, generator=gen), torch.randn(A, D, generator=gen),
               torch.randn(A, M, D, generator=gen), torch.randn(A, D, generator=gen)]
    scale = 1.0 / math.sqrt(D // H)

    def cuda_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.reps

    def digest(outs):
        flat = [*outs[:3], *outs[3]] if len(outs) == 4 else outs
        return [hashlib.sha256(x.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
                .hexdigest()[:16] for x in flat]

    times, digests = {}, {}
    has_sm90 = "sm90" in inspect.signature(fl.fused_layer_bwd_cuda).parameters
    has_k1_sm90 = "sm90" in inspect.signature(fl.fused_layer_fwd_cuda).parameters
    has_k1_f32 = hasattr(fl._lib, "k1_f32_sm90_takes")
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        e, c, ge, gc = (x.to(dev, dtype) for x in tensors)
        if has_k1_sm90 and dtype == torch.bfloat16:
            times["fused_layer_fwd_general_ms_bf16"] = cuda_ms(
                lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, sm90=False))
        if has_k1_f32 and dtype == torch.float32:
            general = lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, sm90=False)  # noqa: E731
            digests["fused_layer_fwd_general_f32"] = digest(general())
            times["fused_layer_fwd_general_ms_f32"] = cuda_ms(general)
        if has_sm90 and dtype == torch.bfloat16:
            times["fused_layer_bwd_general_ms_bf16"] = cuda_ms(
                lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale, sm90=False))
        for name, fn in (
            ("fused_layer_fwd", lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale)),
            ("fused_layer_bwd", lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale)),
            ("fused_layer_bwd_dw", lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale,
                                                                   weight_grads=True)),
        ):
            digests[f"{name}_{tag}"] = digest(fn())
            times[f"{name}_ms_{tag}"] = cuda_ms(fn)
        if dtype == torch.bfloat16:
            # each body on the scales of its own absmax pass: the general
            # bodies on the general pass's, the Hopper K1/K2-int8 on the
            # Hopper pass's where the tree has it (and, as *_on_general_scales,
            # on the general pass's too: the keys a tree without it digests)
            if hasattr(fl, "int8_absmax_sm90_cuda"):
                BA = fl.int8_block_atoms(M)
                for name, fn in (
                        ("int8_absmax_sm90", lambda: (fl.int8_absmax_sm90_cuda(e, c, w, H, BA),)),
                        ("int8_absmax", lambda: (fl.int8_absmax_cuda(e, c, w, BA),))):
                    digests[f"{name}_{tag}"] = digest(fn())
                    times[f"{name}_ms_{tag}"] = cuda_ms(fn)
                general = fl.int8_scales_for(e, c, w, H, sm90=False)
                own = fl.int8_scales_for(e, c, w, H)
                runs = (("fused_layer_fwd_int8", {}, own), ("fused_layer_bwd_int8", {}, own),
                        ("fused_layer_fwd_int8_on_general_scales", {}, general),
                        ("fused_layer_bwd_int8_on_general_scales", {}, general),
                        ("fused_layer_fwd_int8_general", {"sm90": False}, general),
                        ("fused_layer_bwd_int8_general", {"sm90": False}, general))
            else:
                scales = fl.int8_scales_for(e, c, w)
                runs = tuple((name, kw, scales) for name, kw in (
                    ("fused_layer_fwd_int8", {}), ("fused_layer_bwd_int8", {}),
                    ("fused_layer_fwd_int8_general", {"sm90": False}),
                    ("fused_layer_bwd_int8_general", {"sm90": False})))
            for name, kw, s8 in runs:
                if "fwd" in name:
                    fn = lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, int8_scales=s8, **kw)  # noqa: E731
                else:
                    fn = lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale,  # noqa: E731
                                                         int8_scales=s8, **kw)
                digests[f"{name}_{tag}"] = digest(fn())
                times[f"{name}_ms_{tag}"] = cuda_ms(fn)
            # the W8A8 layer (its calibration draws nothing from gen)
            calib = fl.Int8Calib.from_stats(fl.layer_probe_stats(e, c, cf, w, H, scale).tolist(), w)
            w8a8 = (calib, fl.quantize_layer_weights(w, calib))
            for name, kw in (("fused_layer_fwd_w8a8", {}), ("fused_layer_bwd_w8a8", {}),
                             ("fused_layer_fwd_w8a8_general", {"sm90": False}),
                             ("fused_layer_bwd_w8a8_general", {"sm90": False})):
                if "fwd" in name:
                    fn = lambda: fl.fused_layer_fwd_cuda(e, c, cf, w, H, scale, w8a8=w8a8, **kw)  # noqa: E731
                else:
                    fn = lambda: fl.fused_layer_bwd_cuda(e, c, cf, w, ge, gc, H, scale,  # noqa: E731
                                                         w8a8=w8a8, **kw)
                digests[f"{name}_{tag}"] = digest(fn())
                times[f"{name}_ms_{tag}"] = cuda_ms(fn)
        del e, c, ge, gc
        torch.cuda.empty_cache()
    # K3's and K4's bf16 stages at the row-block stages' rows
    from metatrain_tpu_torch.models.pet.fused_stages import COMBINATION, COMPRESS, HEAD
    from metatrain_tpu_torch.ops.kernels import rowblock as rb

    rows, bf = A * M, torch.bfloat16
    has_k4_sm90 = "sm90" in inspect.signature(rb.rowblock_bwd_cuda).parameters
    has_k3_sm90 = "sm90" in inspect.signature(rb.rowblock_fwd_cuda).parameters

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=gen)).to(dev)

    # (the head last, so the earlier stages' inputs are those of trees
    # without it)
    for key, stage, n_parts in (("compress3", COMPRESS, 3), ("compress2", COMPRESS, 2),
                                ("combination", COMBINATION, 3), ("head", HEAD, 1)):
        xs = tuple(torch.randn(rows, D, generator=gen).to(dev, bf) for _ in range(n_parts))
        if stage is not COMBINATION:
            weights = (lecun(n_parts * D, D).to(dev), vec(D), lecun(D, D).to(dev), vec(D))
        else:
            weights = (vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D).to(dev), vec(2 * D),
                       lecun(2 * D, D).to(dev), vec(D))
        g = torch.randn(rows, D, generator=gen).to(dev, bf)
        variants = [("", {})] + ([("_general", {"sm90": False})] if has_k4_sm90 else [])
        for suffix, kw in variants:
            fn = lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, **kw)  # noqa: E731
            digests[f"rowblock_bwd[{key}]{suffix}_bf16"] = digest(fn())
            times[f"rowblock_bwd[{key}]{suffix}_ms_bf16"] = cuda_ms(fn)
        variants = [("", {})] + ([("_general", {"sm90": False})] if has_k3_sm90 else [])
        for suffix, kw in variants:
            fn = lambda: (rb.rowblock_fwd_cuda(stage, xs, weights, **kw),)  # noqa: E731
            digests[f"rowblock_fwd[{key}]{suffix}_bf16"] = digest(fn())
            times[f"rowblock_fwd[{key}]{suffix}_ms_bf16"] = cuda_ms(fn)
        del xs, g
        torch.cuda.empty_cache()
    # the float32 compress and combination: K4, K4-dW and K3
    has_k3_f32 = hasattr(rb._lib, "k3_f32_sm90_takes")
    for key, stage, n_parts in (("compress3", COMPRESS, 3), ("compress2", COMPRESS, 2),
                                ("combination", COMBINATION, 3)):
        xs = tuple(torch.randn(rows, D, generator=gen).to(dev) for _ in range(n_parts))
        if stage is not COMBINATION:
            weights = (lecun(n_parts * D, D).to(dev), vec(D), lecun(D, D).to(dev), vec(D))
        else:
            weights = (vec(2 * D, 1.0), vec(2 * D), lecun(2 * D, 2 * D).to(dev), vec(2 * D),
                       lecun(2 * D, D).to(dev), vec(D))
        g = torch.randn(rows, D, generator=gen).to(dev)
        runs = [("rowblock_bwd", lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g)),
                ("rowblock_bwd_dw",
                 lambda: rb.rowblock_bwd_cuda(stage, xs, weights, g, weight_grads=True)),
                ("rowblock_fwd", lambda: (rb.rowblock_fwd_cuda(stage, xs, weights),))]
        if has_k3_f32:
            runs.append(("rowblock_fwd_general",
                         lambda: (rb.rowblock_fwd_cuda(stage, xs, weights, sm90=False),)))
        for name, fn in runs:
            digests[f"{name}[{key}]_f32"] = digest(fn())
            times[f"{name}[{key}]_ms_f32"] = cuda_ms(fn)
        del xs, g
        torch.cuda.empty_cache()
    # the float32 head last (so the earlier stages' inputs are those of
    # trees without it): K4, K4-dW and K3, and the general bodies beside
    xs = (torch.randn(rows, D, generator=gen).to(dev),)
    weights = (lecun(D, D).to(dev), vec(D), lecun(D, D).to(dev), vec(D))
    g = torch.randn(rows, D, generator=gen).to(dev)
    for name, fn in (
            ("rowblock_bwd", lambda: rb.rowblock_bwd_cuda(HEAD, xs, weights, g)),
            ("rowblock_bwd_dw", lambda: rb.rowblock_bwd_cuda(HEAD, xs, weights, g, weight_grads=True)),
            ("rowblock_fwd", lambda: (rb.rowblock_fwd_cuda(HEAD, xs, weights),)),
            ("rowblock_bwd_general", lambda: rb.rowblock_bwd_cuda(HEAD, xs, weights, g, sm90=False)),
            ("rowblock_bwd_dw_general",
             lambda: rb.rowblock_bwd_cuda(HEAD, xs, weights, g, weight_grads=True, sm90=False)),
            ("rowblock_fwd_general", lambda: (rb.rowblock_fwd_cuda(HEAD, xs, weights, sm90=False),))):
        digests[f"{name}[head]_f32"] = digest(fn())
        times[f"{name}[head]_ms_f32"] = cuda_ms(fn)
    del xs, g
    torch.cuda.empty_cache()
    print(json.dumps({"card": card, "root": args.root, "shape": [A, M, D, H, F], **times,
                      "digests": digests}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
