"""ms per float32 force call and per float32 training step of one tree's
kernel path, with the fused-layer and row-block kernels each launched, on a
CUDA device.

Usage, on a machine with a CUDA device and nvcc::

    python metatrain_tpu_torch/tools/f32_path_times.py [--root DIR] [--calls 5] [--steps 3]

``--root`` is the checkout whose ``metatrain_tpu_torch`` and
``chip_smoke.py`` are used (the current directory by default), so that two
trees can be compared on one card: run the script once per tree, in the
order A, B, B, A. The cases are ``chip_smoke.py``'s: PET at its defaults
with weights from a seeded generator, in float32 on the kernel path, served
by ``Calculator.compute(forces=True)`` on the 10,976-atom Cu crystal
(phase 3's timing: host clock around synchronised calls after a warm-up
call), and one training step (``train_step``, forces weight 10) on 2 x
2,048 atoms of phase 5's frames (phase 7's timing). Prints one JSON line:
the card (``nvidia-smi`` name and power limit), the root, per path the mean
ms, the peak device memory and the launches per call or step by counter.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=".")
    parser.add_argument("--calls", type=int, default=5)
    parser.add_argument("--steps", type=int, default=3)
    args = parser.parse_args()
    sys.path.insert(0, str(Path(args.root).resolve()))

    import numpy as np
    import torch

    import chip_smoke as cs
    from metatrain_tpu_torch.calculator import Calculator
    from metatrain_tpu_torch.engine.trainer import make_optimizer, train_step
    from metatrain_tpu_torch.ops.kernels import _lib

    if not torch.cuda.is_available():
        print("f32_path_times: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    device = torch.device("cuda", 0)
    state = cs.random_state({})
    out = {"card": card, "root": args.root}

    # the force call on the crystal
    calc = Calculator(cs.make_pet(torch.float32, False, state, device))
    crystal = cs.bench_crystal()
    calc.compute(crystal, forces=True)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    _lib.LAUNCHES.clear()
    t0 = time.perf_counter()
    for _ in range(args.calls):
        calc.compute(crystal, forces=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / args.calls * 1e3
    out["force_call"] = {"atoms": len(crystal), "ms_per_call": ms,
                         "max_memory_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9,
                         "launches_per_call": {k: v / args.calls for k, v in _lib.LAUNCHES.items()}}
    del calc
    torch.cuda.empty_cache()

    # one training step on 2 x 2,048 atoms
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "cu_lj.xyz"
        rng = np.random.default_rng(2)
        cs.write_labelled(path, [cs.fcc_frame(8, rng, 0.1) for _ in range(2)])
        torch.cuda.reset_peak_memory_stats(device)
        model, params, loss_fn, batch, n_atoms = cs.training_setup(path, state, False, device, [0, 1])
        optimizer = make_optimizer(params, None)
        train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)  # warm-up
        torch.cuda.synchronize()
        _lib.LAUNCHES.clear()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            train_step(params, optimizer, loss_fn, batch, 1e-5, 1.0)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / args.steps * 1e3
        out["training_step"] = {
            "atoms": n_atoms, "ms_per_step": ms,
            "max_memory_allocated_gb": torch.cuda.max_memory_allocated(device) / 1e9,
            "launches_per_step": {k: v / args.steps for k, v in _lib.LAUNCHES.items()}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
